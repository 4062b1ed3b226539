"""Ray samplers: stratified (coarse) and inverse-CDF importance (fine).

Port of ``nerfsos_tpu/core/sampling.py``. ``torch.searchsorted`` and
``torch.gather`` take the place of the TPU's comparison sums and one-hot
contractions; explicit ``torch.Generator``s take the place of JAX keys.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def stratified_sample(near: torch.Tensor, far: torch.Tensor, n_samples: int,
                      perturb: float = 0.0, lindisp: bool = False,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Uniform z-values in ``[near, far]`` (``[R, 1]`` each) with optional jitter."""
    t_vals = torch.linspace(0.0, 1.0, n_samples, device=near.device, dtype=near.dtype)
    if not lindisp:
        z_vals = near * (1.0 - t_vals) + far * t_vals
    else:
        z_vals = 1.0 / (1.0 / near * (1.0 - t_vals) + 1.0 / far * t_vals)
    if perturb > 0.0:
        mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        upper = torch.cat([mids, z_vals[..., -1:]], dim=-1)
        lower = torch.cat([z_vals[..., :1], mids], dim=-1)
        t_rand = torch.rand(z_vals.shape, generator=generator, device=z_vals.device,
                            dtype=z_vals.dtype)
        z_vals = lower + (upper - lower) * t_rand
    return z_vals


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_importance: int,
               det: bool = False, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverse-CDF sampling of ``n_importance`` z-values per ray.

    ``bins [..., B]`` are bin edges, ``weights [..., B-1]`` unnormalized. Keeps
    the reference's ``+1e-5`` weight floor and ``denom < 1e-5 -> 1`` guard.
    """
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # [..., B]

    u_shape = cdf.shape[:-1] + (n_importance,)
    if det:
        u = torch.linspace(0.0, 1.0, n_importance, device=cdf.device, dtype=cdf.dtype)
        u = u.expand(u_shape).contiguous()
    else:
        u = torch.rand(u_shape, generator=generator, device=cdf.device, dtype=cdf.dtype)

    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    B = cdf.shape[-1]
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=B - 1)
    nb = bins.shape[-1]
    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    bins_below = torch.gather(bins, -1, torch.clamp(below, max=nb - 1))
    bins_above = torch.gather(bins, -1, torch.clamp(above, max=nb - 1))

    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)


def importance_sample(z_vals: torch.Tensor, weights: torch.Tensor, n_importance: int,
                      det: bool = False, generator: Optional[torch.Generator] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hierarchical resampling over the coarse interval midpoints (edge weights
    dropped). Returns ``(z_all [..., S+I] sorted, z_samples [..., I])``."""
    z_mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    z_samples = sample_pdf(z_mids, weights[..., 1:-1], n_importance, det=det,
                           generator=generator).detach()
    z_all, _ = torch.sort(torch.cat([z_vals, z_samples], dim=-1), dim=-1)
    return z_all, z_samples


def points_along_rays(rays_o: torch.Tensor, rays_d: torch.Tensor,
                      z_vals: torch.Tensor) -> torch.Tensor:
    """``pts = o + d * z``: ``[..., S, 3]``. The product is rounded before the
    sum, as the kernels compute it."""
    return rays_o[..., None, :] + rays_d[..., None, :] * z_vals[..., :, None]
