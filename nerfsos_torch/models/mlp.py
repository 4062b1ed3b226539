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
- output channels ``[rgb, alpha, semantics]``;
- every layer's initial weights drawn as the JAX package's flax ``Dense``
  draws them (:func:`flax_dense_init_`), not by torch's ``nn.Linear`` law.

Two bf16 semantics live here, and they differ:

- ``compute_dtype=torch.bfloat16`` (the eager route: ``--no_fused_field``
  and configurations outside ``supports_fused``) is flax's ``nn.Dense(dtype=
  bf16, param_dtype=f32)`` as the JAX ``NeRFMLP`` runs it: the input, the
  weight and the bias cast to bf16, a bf16 product and a bf16 bias add, the
  activations bf16 from ``pts_embed.astype(bf16)`` on, the outputs cast back
  to float32;
- :func:`bf16_operands_dense` is what the fused kernels compute at bf16
  (the Pallas kernels' ``_mm_pl`` on bf16 operands, and the port's CUDA
  kernels): each product's operands rounded to bf16, the product
  accumulated in float32, the float32 bias added, the activations float32.
  The kernels' plain versions pass it as ``dense``.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

# dense(layer, x): one Linear layer's output on x, in some precision
Dense = Callable[[nn.Linear, torch.Tensor], torch.Tensor]


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16 (to nearest even), kept in float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def bf16_operands_dense(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """The fused kernels' bf16 product: ``x`` and the weight rounded to bf16,
    the product accumulated in float32, the float32 bias added."""
    return F.linear(round_bf16(x), round_bf16(layer.weight), layer.bias)


def float32_dense(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return layer(x)


@torch.no_grad()
def flax_dense_init_(layer: nn.Module) -> None:
    """flax ``nn.Dense``'s (and ``nn.Conv``'s) default initialisation (the
    JAX ``NeRFMLP``'s and ``VisionTransformer``'s): the weight from
    ``lecun_normal``, a standard normal truncated at +-2 scaled to variance
    1 / fan_in (a Linear's inputs, a convolution's inputs times its window),
    and a zero bias; from torch's global generator."""
    nn.init.trunc_normal_(layer.weight, a=-2.0, b=2.0)
    # flax's truncated_normal stddev: 1 / the std of a normal truncated at +-2
    layer.weight.mul_(math.sqrt(1.0 / layer.weight[0].numel()) / 0.87962566103423978)
    layer.bias.zero_()


class NeRFMLP(nn.Module):
    """Point-wise NeRF MLP: ``(pts_embed [N, Ce], views_embed [N, Cv]) -> raw [N, C]``.
    ``compute_dtype``: float32, or bfloat16 with flax's semantics (the
    module docstring); the parameters stay float32. A ``dense`` given to
    :meth:`trunk` or :meth:`forward_parts` replaces every layer's product
    (and the activations stay float32)."""

    def __init__(self, input_ch: int, input_ch_views: int, depth: int = 8, width: int = 256,
                 skips: Sequence[int] = (4,), use_viewdirs: bool = True, output_ch: int = 4,
                 use_semantics: bool = False, sem_layer: int = 2, sem_dim: int = 2,
                 sem_with_coord: bool = False, sem_with_geo: bool = False,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise NotImplementedError(f"compute_dtype {compute_dtype}")
        self.compute_dtype = compute_dtype
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
        else:
            self.alpha_linear = nn.Linear(self.h_dim, 1)
            self.feature_linear = nn.Linear(self.h_dim, width)
            self.views_linears = nn.ModuleList([nn.Linear(width + input_ch_views, width // 2)])
            self.rgb_linear = nn.Linear(width // 2, output_ch - 1)
        if use_viewdirs and use_semantics:
            sem_in = self.h_dim + (input_ch if sem_with_coord else 0)
            self.semantic_linear = nn.Sequential(
                nn.Linear(sem_in, width // 2), nn.ReLU(), nn.Linear(width // 2, sem_dim))
        for m in self.modules():
            if isinstance(m, nn.Linear):
                flax_dense_init_(m)

    def product(self, dense: Optional[Dense]) -> Dense:
        """``dense``, or the module's own product at its compute dtype."""
        if dense is not None:
            return dense
        if self.compute_dtype == torch.float32:
            return float32_dense
        cd = self.compute_dtype
        return lambda layer, x: (torch.matmul(x.to(cd), layer.weight.to(cd).t())
                                 + layer.bias.to(cd))

    def _input(self, x: torch.Tensor, dense: Optional[Dense]) -> torch.Tensor:
        """An input of the MLP at the activations' dtype (flax's ``.astype``)."""
        return x if dense is not None else x.to(self.compute_dtype)

    def trunk(self, x: torch.Tensor, dense: Optional[Dense] = None) -> torch.Tensor:
        mm = self.product(dense)
        x = self._input(x, dense)
        h = x
        for i, layer in enumerate(self.pts_linears):
            h = F.relu(mm(layer, h))
            if i in self.skips:
                h = torch.cat([x, h], dim=-1)
        return h

    def forward(self, pts_embed: torch.Tensor,
                views_embed: Optional[torch.Tensor]) -> torch.Tensor:
        return self.forward_parts(pts_embed, views_embed)[0]

    def forward_parts(self, pts_embed: torch.Tensor, views_embed: Optional[torch.Tensor],
                      dense: Optional[Dense] = None
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(raw float32, the semantic head's input ``sem_in = [h, pts_embed]``
        or ``h`` at the activations' dtype; None without the head)."""
        mm = self.product(dense)
        pts_embed = self._input(pts_embed, dense)
        h = self.trunk(pts_embed, dense)
        if not self.use_viewdirs:
            return mm(self.output_linear, h).to(torch.float32), None
        alpha = mm(self.alpha_linear, h)
        feature = mm(self.feature_linear, h)
        hv = F.relu(mm(self.views_linears[0],
                       torch.cat([feature, self._input(views_embed, dense)], dim=-1)))
        parts = [mm(self.rgb_linear, hv), alpha]
        sem_in = None
        if self.use_semantics:
            sem_in = torch.cat([h, pts_embed], dim=-1) if self.sem_with_coord else h
            lin0, lin2 = self.semantic_linear[0], self.semantic_linear[2]
            parts.append(mm(lin2, F.relu(mm(lin0, sem_in))))
        return torch.cat(parts, dim=-1).to(torch.float32), sem_in
