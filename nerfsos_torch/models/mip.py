"""mip-NeRF: conical-frustum Gaussians, the integrated PE and blurpool
resampling (``nn.Module``).

Port of ``nerfsos_tpu/models/mip.py``:

- :func:`cast_rays` lifts the frustum between consecutive z fenceposts (or a
  cylinder) to a diagonal Gaussian with the stable closed forms, in the op
  order of the kernels (``frustum_moments``), so the kernels and the plain
  route form bit-identical means;
- the coarse and fine passes share one field, the child ``mip``: its state
  dict keys are ``mip.mlp.*`` (the JAX package's ``{"mip": {"mlp": ...}}``);
- the fine pass resamples from the blurpooled coarse weights over the
  interval midpoints; the coarse outputs come back under a ``'0'`` suffix,
  with the fine ``z_std``, in eval too;
- the net builds cone frustums (the cylinder lives on in :func:`cast_rays`
  only); with ``fused_field`` each pass is one kernel
  (``ops/fused_render.py``): K9 for renders without gradient or noise, and
  K10a with K10b as its backward for training; otherwise the plain route,
  ``MipNeRFField`` + ``mip_volumetric_render``, which draws its noise from
  the generator;
- ``forward`` chunks the rays by ``ray_block`` and threads ``radii``;
- :meth:`MipNeRFNet.field_query` queries the field at given Gaussians, on
  K11 when fused (``engines/eval.export_density``);
- ``compute_dtype="bfloat16"``: the eager field runs flax's bf16 semantics
  (``models/mlp.py``; the IPE stays float32), and a fused net runs K9,
  K10a, K10b and K11 in their bf16 modes.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from nerfsos_torch.core import sampling
from nerfsos_torch.core.render import mip_volumetric_render
from nerfsos_torch.models.fields import MipNeRFField
from nerfsos_torch.models.nerf import NeRFConfig, _chunk_seeds, compute_dtype_of
from nerfsos_torch.ops import fused_field as ff
from nerfsos_torch.ops import fused_render as fr

_F4_15 = float(np.float32(4.0 / 15.0))
_F5_12 = float(np.float32(5.0 / 12.0))


def lift_gaussian(rays_d: torch.Tensor, t_mean: torch.Tensor, t_var: torch.Tensor,
                  r_var: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A 1-D Gaussian along each ray (``[R, S]`` moments) lifted to 3-D:
    (means ``d t_mean``, diagonal covariances ``[R, S, 3]``)."""
    d = rays_d[..., None, :]
    d_outer = d * d
    d_mag_sq = torch.clamp(d[..., 0:1] * d[..., 0:1] + d[..., 1:2] * d[..., 1:2]
                           + d[..., 2:3] * d[..., 2:3], min=1e-10)
    mean = d * t_mean[..., None]
    cov = t_var[..., None] * d_outer + r_var[..., None] * (1.0 - d_outer / d_mag_sq)
    return mean, cov


def frustum_moments(t0: torch.Tensor, t1: torch.Tensor, radius: torch.Tensor,
                    stable: bool = True) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(t_mean, t_var, r_var) of a conical frustum between ``t0`` and ``t1``.
    The stable forms are written in the kernels' op order (one rounding per
    operation, left to right, ``hw^4 = (hw hw)(hw hw)``)."""
    if stable:
        mu = (t0 + t1) * 0.5
        hw = (t1 - t0) * 0.5
        hw2 = hw * hw
        hw4 = hw2 * hw2
        denom = 3.0 * mu * mu + hw2
        t_mean = mu + (2.0 * mu * hw * hw) / denom
        t_var = hw2 / 3.0 - _F4_15 * ((hw4 * (12.0 * mu * mu - hw2)) / (denom * denom))
        r_var = (radius * radius) * ((mu * mu) / 4.0 + _F5_12 * hw * hw - _F4_15 * hw4 / denom)
    else:
        t_mean = (3 * (t1**4 - t0**4)) / (4 * (t1**3 - t0**3))
        r_var = radius**2 * (3 / 20 * (t1**5 - t0**5) / (t1**3 - t0**3))
        t_var = 3 / 5 * (t1**5 - t0**5) / (t1**3 - t0**3) - t_mean**2
    return t_mean, t_var, r_var


def conical_frustum_to_gaussian(rays_d: torch.Tensor, t0: torch.Tensor, t1: torch.Tensor,
                                base_radius: torch.Tensor, stable: bool = True):
    return lift_gaussian(rays_d, *frustum_moments(t0, t1, base_radius, stable))


def cylinder_to_gaussian(rays_d: torch.Tensor, t0: torch.Tensor, t1: torch.Tensor,
                         radius: torch.Tensor):
    t_mean = (t0 + t1) / 2
    r_var = radius**2 / 4
    t_var = (t1 - t0) ** 2 / 12
    return lift_gaussian(rays_d, t_mean, t_var, r_var)


def cast_rays(z_vals: torch.Tensor, rays_o: torch.Tensor, rays_d: torch.Tensor,
              radii: torch.Tensor, ray_shape: str = "cone"):
    """The Gaussians of the intervals between fenceposts ``z_vals [R, S+1]``
    (``radii [R, 1]``): (means, cov_diags), each ``[R, S, 3]``."""
    t0, t1 = z_vals[..., :-1], z_vals[..., 1:]
    radii = radii.expand(t0.shape)
    if ray_shape == "cone":
        means, covs = conical_frustum_to_gaussian(rays_d, t0, t1, radii)
    elif ray_shape == "cylinder":
        means, covs = cylinder_to_gaussian(rays_d, t0, t1, radii)
    else:
        raise ValueError(f"Unknown ray shape: {ray_shape}")
    return rays_o[..., None, :] + means, covs


def blurpool_weights(weights: torch.Tensor) -> torch.Tensor:
    """Edge-pad, pairwise max, 2-tap blur."""
    pad = torch.cat([weights[..., :1], weights, weights[..., -1:]], dim=-1)
    wmax = torch.maximum(pad[..., :-1], pad[..., 1:])
    return 0.5 * (wmax[..., :-1] + wmax[..., 1:])


class MipNeRFNet(nn.Module):
    """mip-NeRF renderer: one field ``mip`` shared by the coarse and fine passes."""

    def __init__(self, cfg: NeRFConfig):
        super().__init__()
        if cfg.use_semantics:
            raise ValueError("MipNeRFNet does not support use_semantics; "
                             "construct with use_semantics=False")
        self.cfg = cfg
        self.compute_dtype = compute_dtype_of(cfg.compute_dtype)
        self.mip = MipNeRFField(net_depth=cfg.netdepth, net_width=cfg.netwidth, skips=(4,),
                                use_viewdirs=cfg.use_viewdirs, use_embed=cfg.use_embed,
                                multires=cfg.multires, multires_views=cfg.multires_views,
                                compute_dtype=self.compute_dtype)
        self.fused = cfg.fused_field and fr.supports_fused(cfg)

    def field_query(self, mean: torch.Tensor, cov: torch.Tensor,
                    viewdirs: torch.Tensor) -> torch.Tensor:
        """raw ``[N, 4]`` of the field at the Gaussians ``mean`` and diagonal
        ``cov [N, 3]``, each seen from its ``viewdirs [N, 3]``: K11 when
        fused (at the net's compute dtype), else the field."""
        if self.fused:
            return ff.fused_mip_field_apply(self.mip, mean.contiguous(), cov.contiguous(),
                                            viewdirs.contiguous(), self.compute_dtype)
        return self.mip(mean[:, None, :], cov[:, None, :], viewdirs)[:, 0]

    def render_rays(self, rays_o: torch.Tensor, rays_d: torch.Tensor,
                    viewdirs: Optional[torch.Tensor], near: torch.Tensor, far: torch.Tensor,
                    radii: torch.Tensor, *, perturb: float, raw_noise_std: float,
                    generator: Optional[torch.Generator] = None, train: bool = False,
                    noise_seeds: Tuple[int, int] = (0, 0)) -> Dict[str, torch.Tensor]:
        """Render one chunk of rays (``[R, 3]`` each; near/far/radii ``[R, 1]``)."""
        cfg = self.cfg
        det = perturb == 0.0
        z_vals = sampling.stratified_sample(near, far, cfg.n_samples, perturb=perturb,
                                            lindisp=cfg.lindisp, generator=generator)
        if self.fused and viewdirs is not None:
            odvr = torch.cat([rays_o, rays_d, viewdirs, radii], dim=1).contiguous()
            fused_train = train or raw_noise_std > 0.0
            cd = self.compute_dtype

            def render(z, seed):
                if fused_train:
                    maps, w = fr.fused_mip_train_render(self.mip, odvr, z.contiguous(),
                                                        noise_std=raw_noise_std, seed=seed,
                                                        compute_dtype=cd)
                else:
                    maps, w = fr.fused_mip_render(self.mip, odvr, z.contiguous(), cd)
                return fr.finish_mip_maps(maps, w, cfg.white_bkgd)
        else:
            def render(z, seed):
                means, covs = cast_rays(z, rays_o, rays_d, radii)
                return mip_volumetric_render(self.mip(means, covs, viewdirs), z, rays_d,
                                             raw_noise_std=raw_noise_std,
                                             white_bkgd=cfg.white_bkgd, generator=generator)

        ret = render(z_vals, noise_seeds[0])
        if cfg.n_importance <= 0:
            return ret
        ret0 = ret
        z_mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        z_all, z_samples = sampling.importance_sample(
            z_mids, blurpool_weights(ret0["weights"].detach()), cfg.n_importance, det=det,
            generator=generator)
        ret = render(z_all, noise_seeds[1])
        ret["z_std"] = torch.std(z_samples, dim=-1, correction=0)
        ret.update({k + "0": v for k, v in ret0.items()})
        return ret

    def forward(self, ray_batch: torch.Tensor, bounds: Tuple[Any, Any], radii: Any,
                train: bool = False, generator: Optional[torch.Generator] = None,
                **overrides: Any) -> Dict[str, torch.Tensor]:
        """Render ``ray_batch [2, ..., 3]`` with base radii ``radii`` (a scalar
        or per ray); outputs keep the leading shape."""
        cfg = self.cfg
        perturb = overrides.pop("perturb", cfg.perturb if train else 0.0)
        raw_noise_std = overrides.pop("raw_noise_std", cfg.raw_noise_std if train else 0.0)
        seeds = overrides.pop("noise_seeds", (0, 0))
        rays_o = ray_batch[0].reshape(-1, 3).to(torch.float32)
        rays_d = ray_batch[1].reshape(-1, 3).to(torch.float32)
        lead_shape = ray_batch.shape[1:-1]
        R = rays_o.shape[0]
        viewdirs = None
        if cfg.use_viewdirs:
            viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        near, far, radii = (torch.as_tensor(b, dtype=torch.float32, device=rays_o.device)
                            .expand(R).reshape(R, 1) for b in (*bounds, radii))
        chunks = []
        for i in range(0, R, cfg.ray_block):
            sl = slice(i, i + cfg.ray_block)
            chunks.append(self.render_rays(
                rays_o[sl], rays_d[sl], None if viewdirs is None else viewdirs[sl],
                near[sl], far[sl], radii[sl], perturb=perturb, raw_noise_std=raw_noise_std,
                generator=generator, train=train,
                noise_seeds=_chunk_seeds(seeds, i // cfg.ray_block), **overrides))
        out = {k: torch.cat([c[k] for c in chunks], dim=0) for k in chunks[0]}
        return {k: v.reshape(*lead_shape, *v.shape[1:]) for k, v in out.items()}
