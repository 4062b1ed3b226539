"""Volumetric compositing (quadrature rule), classic and mip-NeRF.

Port of ``nerfsos_tpu/core/render.py``: the 1e10 far padding, the ‖rays_d‖
distance scaling (directions are unnormalized), the ``+1e-10`` inside the
exclusive transmittance product, the vacancy-depth override and the white
background applied to both rgb and semantics.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F


def exclusive_cumprod_1m(alpha: torch.Tensor) -> torch.Tensor:
    """Transmittance ``T_i = prod_{j<i} (1 - alpha_j + 1e-10)``."""
    shifted = torch.cat([torch.ones_like(alpha[..., :1]), 1.0 - alpha[..., :-1] + 1e-10], dim=-1)
    return torch.cumprod(shifted, dim=-1)


def sigma_to_weights(sigma: torch.Tensor, z_vals: torch.Tensor, rays_d: torch.Tensor, *,
                     raw_noise_std: float = 0.0,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Quadrature weights ``[R, S]`` from raw densities ``[R, S]``."""
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], dim=-1)
    dists = dists * torch.linalg.norm(rays_d[..., None, :], dim=-1)
    if raw_noise_std > 0.0:
        sigma = sigma + torch.randn(sigma.shape, generator=generator, device=sigma.device,
                                    dtype=sigma.dtype) * raw_noise_std
    alpha = 1.0 - torch.exp(-F.relu(sigma) * dists)
    return alpha * exclusive_cumprod_1m(alpha)


def volumetric_render(raw: torch.Tensor, z_vals: torch.Tensor, rays_d: torch.Tensor, *,
                      raw_noise_std: float = 0.0, white_bkgd: bool = False,
                      use_semantics: bool = False,
                      generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """Composite raw ``[R, S, 4 + sem]`` (rgb, sigma, semantics) into per-ray maps."""
    weights = sigma_to_weights(raw[..., 3], z_vals, rays_d,
                               raw_noise_std=raw_noise_std, generator=generator)
    rgb_map = torch.sum(weights[..., None] * torch.sigmoid(raw[..., :3]), dim=-2)
    depth_map = torch.sum(weights * z_vals, dim=-1, keepdim=True)
    acc_map = torch.sum(weights, dim=-1, keepdim=True)
    sem_map = torch.sum(weights[..., None] * raw[..., 4:], dim=-2) if use_semantics else None
    return finish_maps(rgb_map, depth_map, acc_map, weights, sem_map, white_bkgd)


def finish_maps(rgb_map: torch.Tensor, depth_map: torch.Tensor, acc_map: torch.Tensor,
                weights: torch.Tensor, sem_map: Optional[torch.Tensor],
                white_bkgd: bool) -> Dict[str, torch.Tensor]:
    """Per-ray finishing of the weighted sums: the vacancy depth, disp, and the
    white background on rgb and semantics."""
    depth_map = torch.where(acc_map <= 1e-10, torch.full_like(depth_map, 1e10), depth_map)
    disp_map = 1.0 / torch.clamp(depth_map / acc_map, min=1e-10)
    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc_map)
    out = dict(rgb=rgb_map, disp=disp_map, acc=acc_map, weights=weights, depth=depth_map)
    if sem_map is not None:
        out["semantics"] = sem_map + (1.0 - acc_map) if white_bkgd else sem_map
    return out


def mip_volumetric_render(raw: torch.Tensor, z_vals: torch.Tensor, rays_d: torch.Tensor, *,
                          raw_noise_std: float = 0.0, white_bkgd: bool = False,
                          generator: Optional[torch.Generator] = None
                          ) -> Dict[str, torch.Tensor]:
    """mip-NeRF compositing over intervals: raw ``[R, S, 4]`` with sigma
    last, z ``[R, S + 1]`` fenceposts. Depths use the interval midpoints and
    the distances are the fenceposts' gaps times ‖d‖, with no far pad."""
    mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    dists = (z_vals[..., 1:] - z_vals[..., :-1]) * torch.linalg.norm(rays_d[..., None, :], dim=-1)
    sigma = raw[..., -1]
    if raw_noise_std > 0.0:
        sigma = sigma + torch.randn(sigma.shape, generator=generator, device=sigma.device,
                                    dtype=sigma.dtype) * raw_noise_std
    alpha = 1.0 - torch.exp(-F.relu(sigma) * dists)
    weights = alpha * exclusive_cumprod_1m(alpha)
    rgb_map = torch.sum(weights[..., None] * torch.sigmoid(raw[..., :-1]), dim=-2)
    depth_map = torch.sum(weights * mids, dim=-1, keepdim=True)
    acc_map = torch.sum(weights, dim=-1, keepdim=True)
    return finish_maps(rgb_map, depth_map, acc_map, weights, None, white_bkgd)
