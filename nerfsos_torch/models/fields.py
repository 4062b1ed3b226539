"""Radiance fields: positional encoding + MLP, queried point-wise.

Port of ``nerfsos_tpu/models/fields.py`` (``NeRFField``, ``MipNeRFField``).
Each module holds one ``mlp`` child, so a ``NeRFNet``'s state-dict keys are
the reference's ``{nerf,nerf_fine}.mlp.*`` and a ``MipNeRFNet``'s
``mip.mlp.*``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from nerfsos_torch.core import encoding
from nerfsos_torch.models.mlp import Dense, NeRFMLP


class NeRFField(nn.Module):
    """Classic NeRF field: PE(pts) [+ PE(dirs)] -> NeRFMLP -> raw channels.
    The PE is float32; ``compute_dtype`` is the MLP's (flax's bf16 semantics
    at bfloat16, ``models/mlp.py``), and a ``dense`` given to
    :meth:`forward`, :meth:`forward_parts` or :meth:`sigma` replaces its
    products (the fused kernels' plain versions)."""

    def __init__(self, net_depth: int = 8, net_width: int = 256, skips: Sequence[int] = (4,),
                 use_viewdirs: bool = True, use_embed: bool = True, multires: int = 10,
                 multires_views: int = 4, conv_embed: bool = False, output_ch: int = 4,
                 use_semantics: bool = False, sem_layer: int = 2, sem_dim: int = 2,
                 sem_with_coord: bool = False, sem_with_geo: bool = False,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if conv_embed:
            raise NotImplementedError("conv_embed is not ported yet")
        self.use_viewdirs, self.use_embed = use_viewdirs, use_embed
        self.multires, self.multires_views = multires, multires_views
        input_ch = encoding.pe_dim(3, multires) if use_embed else 3
        input_ch_views = encoding.pe_dim(3, multires_views) if use_embed else 3
        self.mlp = NeRFMLP(input_ch, input_ch_views, depth=net_depth, width=net_width,
                           skips=skips, use_viewdirs=use_viewdirs, output_ch=output_ch,
                           use_semantics=use_semantics, sem_layer=sem_layer, sem_dim=sem_dim,
                           sem_with_coord=sem_with_coord, sem_with_geo=sem_with_geo,
                           compute_dtype=compute_dtype)

    def embed(self, pts: torch.Tensor) -> torch.Tensor:
        if not self.use_embed:
            return pts
        return encoding.positional_encoding_fused(pts, self.multires, float(self.multires - 1))

    def embed_views(self, dirs: torch.Tensor) -> torch.Tensor:
        if not self.use_embed:
            return dirs
        return encoding.positional_encoding_fused(dirs, self.multires_views,
                                                  float(self.multires_views - 1))

    def forward(self, pts: torch.Tensor, viewdirs: Optional[torch.Tensor],
                dense: Optional[Dense] = None) -> torch.Tensor:
        """``pts [..., S, 3]``, ``viewdirs [..., 3]`` (unit, broadcast over S)
        -> raw ``[..., S, 4 (+ sem_dim)]``."""
        return self.forward_parts(pts, viewdirs, dense)[0]

    def forward_parts(self, pts: torch.Tensor, viewdirs: Optional[torch.Tensor],
                      dense: Optional[Dense] = None
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(raw ``[..., S, C]``, the semantic head's input ``[N, sem_in]`` over
        the flattened points, or None without the head)."""
        lead = pts.shape[:-1]
        emb = self.embed(pts).reshape(-1, self.mlp.pts_linears[0].in_features)
        demb = None
        if self.use_viewdirs:
            d = viewdirs[..., None, :].expand(pts.shape)
            demb = self.embed_views(d).reshape(emb.shape[0], -1)
        out, sem_in = self.mlp.forward_parts(emb, demb, dense)
        return out.reshape(*lead, out.shape[-1]), sem_in

    def sigma(self, pts: torch.Tensor, dense: Optional[Dense] = None) -> torch.Tensor:
        """Densities only ``[..., S]`` (float32): the trunk and the alpha head."""
        lead = pts.shape[:-1]
        emb = self.embed(pts).reshape(-1, self.mlp.pts_linears[0].in_features)
        h = self.mlp.trunk(emb, dense)
        layer = self.mlp.alpha_linear if self.use_viewdirs else self.mlp.output_linear
        out = self.mlp.product(dense)(layer, h)[:, 3 if not self.use_viewdirs else 0]
        return out.to(torch.float32).reshape(lead)


class MipNeRFField(nn.Module):
    """mip-NeRF field: IPE(mean, cov) [+ PE(dirs)] -> NeRFMLP -> raw
    ``(rgb, sigma)``. The trunk's input is the 60-wide IPE at ``multires``
    10, with no raw-input columns; no semantic head. The IPE is float32;
    ``compute_dtype`` is the MLP's (flax's bf16 semantics at bfloat16), and
    a ``dense`` given to :meth:`forward` replaces its products (the mip
    kernels' plain versions)."""

    def __init__(self, net_depth: int = 8, net_width: int = 256, skips: Sequence[int] = (4,),
                 use_viewdirs: bool = True, use_embed: bool = True, multires: int = 10,
                 multires_views: int = 4, output_ch: int = 4,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.use_viewdirs, self.use_embed = use_viewdirs, use_embed
        self.multires, self.multires_views = multires, multires_views
        input_ch = encoding.ipe_dim(3, multires) if use_embed else 3
        input_ch_views = encoding.pe_dim(3, multires_views) if use_embed else 3
        self.mlp = NeRFMLP(input_ch, input_ch_views, depth=net_depth, width=net_width,
                           skips=skips, use_viewdirs=use_viewdirs, output_ch=output_ch,
                           compute_dtype=compute_dtype)

    def embed(self, mean: torch.Tensor, cov: torch.Tensor) -> torch.Tensor:
        if not self.use_embed:
            return mean
        return encoding.integrated_positional_encoding(mean, cov, self.multires,
                                                       float(self.multires - 1))

    def embed_views(self, dirs: torch.Tensor) -> torch.Tensor:
        if not self.use_embed:
            return dirs
        return encoding.positional_encoding_fused(dirs, self.multires_views,
                                                  float(self.multires_views - 1))

    def forward(self, mean: torch.Tensor, cov: torch.Tensor, viewdirs: Optional[torch.Tensor],
                dense: Optional[Dense] = None) -> torch.Tensor:
        """Gaussians ``mean, cov [..., S, 3]`` (diagonal covariances),
        ``viewdirs [..., 3]`` (unit, broadcast over S) -> raw ``[..., S, 4]``."""
        lead = mean.shape[:-1]
        emb = self.embed(mean, cov).reshape(-1, self.mlp.pts_linears[0].in_features)
        demb = None
        if self.use_viewdirs:
            d = viewdirs[..., None, :].expand(mean.shape)
            demb = self.embed_views(d).reshape(emb.shape[0], -1)
        out = self.mlp.forward_parts(emb, demb, dense)[0]
        return out.reshape(*lead, out.shape[-1])
