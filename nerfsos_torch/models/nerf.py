"""Coarse/fine NeRF rendering (``nn.Module``).

Port of ``nerfsos_tpu/models/nerf.py``. ``NeRFNet`` holds the coarse field
``nerf`` and, when ``n_importance > 0``, the fine field ``nerf_fine``: the
reference's module names, so a reference state dict loads with
``load_state_dict``. Behaviour:

- coarse stratified sample -> coarse field -> composite; det/random inverse-CDF
  resample (detached, sorted) -> fine field -> composite; coarse outputs
  under a ``'0'`` suffix and the fine ``z_std`` (biased);
- ``coarse_outputs=False`` (eval renders) runs the coarse pass density-only;
  with ``fused_field`` and a supported config it runs the two fused kernels
  (``ops/fused_render.py``: K1, importance sampling, K2, ``finish_maps``);
- with the coarse outputs (train renders) and ``fused_field`` it runs the
  differentiable train render twice (K4, importance sampling on the coarse
  weights, K4), whose backward is K5 under ``frozen_backbone``; the sigma
  noise of each pass comes from an integer seed (``noise_seeds``, the
  step's pair from ``engines/trainer.step_randomness``);
- every other pass of a fused net queries the field through the field
  kernels (``ops/fused_field.py``), as the JAX package's planar route does:
  a net with no fine pass (``n_importance <= 0``) through the field
  forward (K8d), whose backward is the field backward (K8f), and a
  density-only coarse pass with noise through the sigma forward (K8e), its
  fine pass through K8d; the noise is drawn from the generator outside the
  kernels, as in the plain route;
- ``forward`` chunks the rays by ``ray_block``. Rays are independent, so the
  ragged last chunk needs no padding (the JAX version pads to a fixed block
  shape for its compiled scan);
- ``compute_dtype="bfloat16"``: the eager fields run flax's bf16 semantics
  (``models/mlp.py``), and a fused net runs every kernel in its bf16 mode:
  K1-K6 (K4's train render with K5 or K6 as its backward; the RGB step's K3
  in ``engines/trainer.py``) and the field kernels, each with the rounding
  of the JAX route it replaces: the planar twins' (K8d, K8e, K8f) for the
  renders and the backward, the row-major K8b's for ``field_query``
  (``export_density`` calls JAX's row-major ``fused_field_apply``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from nerfsos_torch.core import sampling
from nerfsos_torch.core.render import sigma_to_weights, volumetric_render
from nerfsos_torch.models.fields import NeRFField
from nerfsos_torch.ops import fused_field as ff
from nerfsos_torch.ops import fused_render as fr


@dataclasses.dataclass(frozen=True)
class NeRFConfig:
    """Model and render configuration (the fields of ``nerfsos_tpu``'s
    ``NeRFConfig`` that the port reads)."""

    netdepth: int = 8
    netwidth: int = 256
    netdepth_fine: int = 8
    netwidth_fine: int = 256
    n_samples: int = 64
    n_importance: int = 64
    use_viewdirs: bool = True
    use_embed: bool = True
    multires: int = 10
    multires_views: int = 4
    conv_embed: bool = False
    perturb: float = 1.0
    raw_noise_std: float = 0.0
    white_bkgd: bool = False
    lindisp: bool = False
    use_semantics: bool = False
    skips: tuple = (4,)
    sem_layer: int = 2
    sem_dim: int = 2
    sem_with_coord: bool = False
    sem_with_geo: bool = False
    ray_block: int = 4096  # rays per chunk of forward()
    compute_dtype: str = "float32"
    fused_field: bool = False  # the fused kernels (ops/fused_render.py)
    # --fix_backbone: the fused train render's backward is the semantic-head
    # sweep K5 (every other leaf gets no gradient)
    frozen_backbone: bool = False

    @property
    def shared_fine(self) -> bool:
        return self.n_importance <= 0


def _chunk_seeds(seeds: Tuple[int, int], chunk: int) -> Tuple[int, int]:
    """The noise seeds of ray chunk ``chunk``: the given pair for the first,
    a pair derived from it and the chunk's index for the others (the
    kernels' noise is a hash of the point's index in its call)."""
    if chunk == 0:
        return seeds
    words = np.random.SeedSequence([*seeds, chunk]).generate_state(2, np.uint64)
    return int(words[0] % (2**31 - 1)), int(words[1] % (2**31 - 1))


def compute_dtype_of(name: str) -> torch.dtype:
    """``--compute_dtype``'s torch dtype."""
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    if name not in dtypes:
        raise NotImplementedError(f"compute_dtype={name!r}: float32 or bfloat16")
    return dtypes[name]


def _field(cfg: NeRFConfig, fine: bool) -> NeRFField:
    return NeRFField(
        net_depth=cfg.netdepth_fine if fine else cfg.netdepth,
        net_width=cfg.netwidth_fine if fine else cfg.netwidth,
        skips=tuple(cfg.skips), use_viewdirs=cfg.use_viewdirs, use_embed=cfg.use_embed,
        multires=cfg.multires, multires_views=cfg.multires_views, conv_embed=cfg.conv_embed,
        output_ch=4, use_semantics=cfg.use_semantics, sem_layer=cfg.sem_layer,
        sem_dim=cfg.sem_dim, sem_with_coord=cfg.sem_with_coord, sem_with_geo=cfg.sem_with_geo,
        compute_dtype=compute_dtype_of(cfg.compute_dtype))


class NeRFNet(nn.Module):
    """Coarse/fine renderer with the reference's ``nerf`` / ``nerf_fine`` children."""

    def __init__(self, cfg: NeRFConfig):
        super().__init__()
        self.compute_dtype = compute_dtype_of(cfg.compute_dtype)
        self.cfg = cfg
        self.nerf = _field(cfg, fine=False)
        self.nerf_fine = None if cfg.shared_fine else _field(cfg, fine=True)
        self.fused = cfg.fused_field and fr.supports_fused(cfg)
        self.bf16 = self.compute_dtype == torch.bfloat16

    @property
    def fine_field(self) -> NeRFField:
        return self.nerf if self.nerf_fine is None else self.nerf_fine

    def _raw(self, field: NeRFField, pts: torch.Tensor,
             viewdirs: Optional[torch.Tensor]) -> torch.Tensor:
        """raw ``[R, S, C]`` of ``field`` at ``pts [R, S, 3]`` seen from
        ``viewdirs [R, 3]``: the field kernels when fused, else the field."""
        if not self.fused:
            return field(pts, viewdirs)
        dirs = viewdirs[:, None, :].expand(pts.shape).reshape(-1, 3)
        raw = ff.fused_field_apply(field, pts.reshape(-1, 3), dirs, self.compute_dtype)
        return raw.reshape(*pts.shape[:-1], raw.shape[-1])

    def _sigma(self, pts: torch.Tensor) -> torch.Tensor:
        """The coarse field's densities ``[R, S]`` at ``pts [R, S, 3]``: the
        sigma kernel when fused, else the field."""
        if not self.fused:
            return self.nerf.sigma(pts)
        return ff.fused_sigma_apply(self.nerf, pts.reshape(-1, 3),
                                    self.compute_dtype).reshape(pts.shape[:-1])

    def field_query(self, pts: torch.Tensor, viewdirs: torch.Tensor) -> torch.Tensor:
        """raw ``[N, C]`` of the fine field (the coarse one of a net with no
        fine pass) at ``pts [N, 3]``, each seen from its ``viewdirs [N, 3]``:
        the field kernel when fused (``engines/eval.export_density``; at bf16
        K8b's head rule, as JAX's export takes the row-major kernel), else
        the field. Forward only."""
        if self.fused:
            return ff.field_forward(self.fine_field, pts.contiguous(), viewdirs.contiguous(),
                                    self.compute_dtype, f32_heads=True)
        return self.fine_field(pts[:, None, :], viewdirs)[:, 0]

    def render_rays(self, rays_o: torch.Tensor, rays_d: torch.Tensor,
                    viewdirs: Optional[torch.Tensor], near: torch.Tensor, far: torch.Tensor, *,
                    perturb: float, raw_noise_std: float,
                    generator: Optional[torch.Generator] = None,
                    coarse_outputs: bool = True,
                    noise_seeds: Tuple[int, int] = (0, 0)) -> Dict[str, torch.Tensor]:
        """Render one chunk of rays (``[R, 3]`` each; near/far ``[R, 1]``)."""
        cfg = self.cfg
        n_importance = cfg.n_importance
        det = perturb == 0.0
        z_vals = sampling.stratified_sample(near, far, cfg.n_samples, perturb=perturb,
                                            lindisp=cfg.lindisp, generator=generator)
        sigma_only = not coarse_outputs and n_importance > 0
        if self.fused and coarse_outputs and n_importance > 0 and viewdirs is not None:
            odv = torch.cat([rays_o, rays_d, viewdirs], dim=1).contiguous()
            kw = dict(noise_std=raw_noise_std, frozen=cfg.frozen_backbone,
                      compute_dtype=self.compute_dtype)
            maps0, w0 = fr.fused_train_render(self.nerf, odv, z_vals.contiguous(),
                                              seed=noise_seeds[0], **kw)
            ret0 = fr.finish_maps(maps0, w0, cfg.use_semantics, cfg.white_bkgd)
            z_all, z_samples = sampling.importance_sample(z_vals, w0.detach(), n_importance,
                                                          det=det, generator=generator)
            maps, w = fr.fused_train_render(self.fine_field, odv, z_all.contiguous(),
                                            seed=noise_seeds[1], **kw)
            ret = fr.finish_maps(maps, w, cfg.use_semantics, cfg.white_bkgd)
            ret["z_std"] = torch.std(z_samples, dim=-1, correction=0)
            ret.update({k + "0": v for k, v in ret0.items()})
            return ret
        if self.fused and sigma_only and raw_noise_std == 0.0 and viewdirs is not None:
            od = torch.cat([rays_o, rays_d], dim=1)
            weights = fr.fused_coarse_weights(self.nerf, od, z_vals, self.compute_dtype)
            z_all, z_samples = sampling.importance_sample(z_vals, weights, n_importance,
                                                          det=det, generator=generator)
            maps, w_fine = fr.fused_render(self.fine_field, torch.cat([od, viewdirs], dim=1),
                                           z_all, self.compute_dtype)
            ret = fr.finish_maps(maps, w_fine, cfg.use_semantics, cfg.white_bkgd)
            ret["z_std"] = torch.std(z_samples, dim=-1, correction=0)
            return ret

        pts = sampling.points_along_rays(rays_o, rays_d, z_vals)
        if sigma_only:
            ret = {"weights": sigma_to_weights(self._sigma(pts), z_vals, rays_d,
                                               raw_noise_std=raw_noise_std,
                                               generator=generator)}
        else:
            ret = volumetric_render(self._raw(self.nerf, pts, viewdirs), z_vals, rays_d,
                                    raw_noise_std=raw_noise_std, white_bkgd=cfg.white_bkgd,
                                    use_semantics=cfg.use_semantics, generator=generator)
        if n_importance <= 0:
            return ret

        ret0 = ret
        z_all, z_samples = sampling.importance_sample(z_vals, ret0["weights"], n_importance,
                                                      det=det, generator=generator)
        pts = sampling.points_along_rays(rays_o, rays_d, z_all)
        ret = volumetric_render(self._raw(self.fine_field, pts, viewdirs), z_all, rays_d,
                                raw_noise_std=raw_noise_std, white_bkgd=cfg.white_bkgd,
                                use_semantics=cfg.use_semantics, generator=generator)
        ret["z_std"] = torch.std(z_samples, dim=-1, correction=0)
        if coarse_outputs:
            for k, v in ret0.items():
                ret[k + "0"] = v
        return ret

    def forward(self, ray_batch: torch.Tensor, bounds: Tuple[Any, Any], train: bool = False,
                generator: Optional[torch.Generator] = None,
                **overrides: Any) -> Dict[str, torch.Tensor]:
        """Render ``ray_batch [2, ..., 3]`` (origins, directions); ``bounds`` are
        (near, far) scalars or per-ray tensors. Outputs keep the leading shape."""
        cfg = self.cfg
        perturb = overrides.pop("perturb", cfg.perturb if train else 0.0)
        raw_noise_std = overrides.pop("raw_noise_std", cfg.raw_noise_std if train else 0.0)
        rays_o = ray_batch[0].reshape(-1, 3).to(torch.float32)
        rays_d = ray_batch[1].reshape(-1, 3).to(torch.float32)
        lead_shape = ray_batch.shape[1:-1]
        R = rays_o.shape[0]
        viewdirs = None
        if cfg.use_viewdirs:
            viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        near, far = (torch.as_tensor(b, dtype=torch.float32, device=rays_o.device)
                     .expand(R).reshape(R, 1) for b in bounds)

        seeds = overrides.pop("noise_seeds", (0, 0))
        chunks = []
        for i in range(0, R, cfg.ray_block):
            sl = slice(i, i + cfg.ray_block)
            chunks.append(self.render_rays(
                rays_o[sl], rays_d[sl], None if viewdirs is None else viewdirs[sl],
                near[sl], far[sl], perturb=perturb, raw_noise_std=raw_noise_std,
                generator=generator, noise_seeds=_chunk_seeds(seeds, i // cfg.ray_block),
                **overrides))
        out = {k: torch.cat([c[k] for c in chunks], dim=0) for k in chunks[0]}
        return {k: v.reshape(*lead_shape, *v.shape[1:]) for k, v in out.items()}
