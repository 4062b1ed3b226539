"""NeRF MLP backbone with the NeRF-SOS semantic head (``nn.Module``).

Port of ``nerfsos_tpu/models/mlp.py``. Parameter names are the reference
torch names (``models/nerf_mlp.py`` in VITA-Group/NeRF-SOS), so a reference
state dict loads with ``load_state_dict``:

- ``pts_linears.i``: the depth x width trunk, with the skip concat
  ``[pts_embed, h]`` after the relu of every layer in ``skips``;
- ``alpha_linear`` (W->1), ``feature_linear`` (W->W), ``views_linears.0``
  (W+dirs -> W/2), ``rgb_linear``;
- ``semantic_linear`` = Sequential(Linear, ReLU, Linear), keys ``.0``/``.2``,
  fed ``[h, pts_embed]`` when ``sem_with_coord``;
- output channels ``[rgb, alpha, semantics]``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


class NeRFMLP(nn.Module):
    """Point-wise NeRF MLP: ``(pts_embed [N, Ce], views_embed [N, Cv]) -> raw [N, C]``."""

    def __init__(self, input_ch: int, input_ch_views: int, depth: int = 8, width: int = 256,
                 skips: Sequence[int] = (4,), use_viewdirs: bool = True, output_ch: int = 4,
                 use_semantics: bool = False, sem_layer: int = 2, sem_dim: int = 2,
                 sem_with_coord: bool = False, sem_with_geo: bool = False):
        super().__init__()
        if use_semantics and sem_layer > 2:
            raise NotImplementedError("sem_layer > 2 is not ported yet")
        if use_semantics and sem_with_geo:
            raise NotImplementedError("the geo_map_sem gate is not ported yet")
        self.depth, self.width = depth, width
        self.skips = tuple(skips)
        self.use_viewdirs = use_viewdirs
        self.use_semantics = use_semantics
        self.sem_with_coord = sem_with_coord

        in_dims = [input_ch] + [width + (input_ch if i in self.skips else 0)
                                for i in range(depth - 1)]
        self.pts_linears = nn.ModuleList([nn.Linear(k, width) for k in in_dims])
        # width of h after the trunk (the skip concat may follow the last layer)
        self.h_dim = width + (input_ch if depth - 1 in self.skips else 0)

        if not use_viewdirs:
            self.output_linear = nn.Linear(self.h_dim, output_ch)
            return
        self.alpha_linear = nn.Linear(self.h_dim, 1)
        self.feature_linear = nn.Linear(self.h_dim, width)
        self.views_linears = nn.ModuleList([nn.Linear(width + input_ch_views, width // 2)])
        self.rgb_linear = nn.Linear(width // 2, output_ch - 1)
        if use_semantics:
            sem_in = self.h_dim + (input_ch if sem_with_coord else 0)
            self.semantic_linear = nn.Sequential(
                nn.Linear(sem_in, width // 2), nn.ReLU(), nn.Linear(width // 2, sem_dim))

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i, layer in enumerate(self.pts_linears):
            h = F.relu(layer(h))
            if i in self.skips:
                h = torch.cat([x, h], dim=-1)
        return h

    def forward(self, pts_embed: torch.Tensor,
                views_embed: Optional[torch.Tensor]) -> torch.Tensor:
        return self.forward_parts(pts_embed, views_embed)[0]

    def forward_parts(self, pts_embed: torch.Tensor, views_embed: Optional[torch.Tensor]
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(raw, the semantic head's input ``sem_in = [h, pts_embed]`` or ``h``;
        None without the head)."""
        h = self.trunk(pts_embed)
        if not self.use_viewdirs:
            return self.output_linear(h), None
        alpha = self.alpha_linear(h)
        feature = self.feature_linear(h)
        hv = F.relu(self.views_linears[0](torch.cat([feature, views_embed], dim=-1)))
        parts = [self.rgb_linear(hv), alpha]
        sem_in = None
        if self.use_semantics:
            sem_in = torch.cat([h, pts_embed], dim=-1) if self.sem_with_coord else h
            parts.append(self.semantic_linear(sem_in))
        return torch.cat(parts, dim=-1), sem_in
