"""Fused eval render: field + volumetric composite in one kernel per pass.

Port of the eval half of ``nerfsos_tpu/ops/pallas/fused_render.py``:

- :func:`fused_coarse_weights` (K1, replaces ``fused_coarse_weights_planar``):
  ``od [R, 6]`` (origins, unnormalized directions) and ``z [R, S]`` ->
  quadrature weights ``[R, S]`` from the density trunk alone;
- :func:`fused_render` (K2, replaces ``fused_render_planar``): ``odv [R, 9]``
  (plus unit viewdirs) and ``z`` -> ``maps [R, 5 + sem]`` with columns
  ``(w·sigmoid(rgb) x3, w·z, w, w·sem...)`` and weights ``[R, S]``;
- :func:`finish_maps`: vacancy depth, disp and white background on the maps.

Each wrapper takes its plain PyTorch version (:func:`coarse_weights_plain`,
:func:`render_plain`, same signature) for tensors on the CPU, and for CUDA
tensors launches the hand-written kernel in ``csrc/fused_render.cu`` or
raises; it never falls back. ``<wrapper>.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from nerfsos_torch import _build
from nerfsos_torch.core import render
from nerfsos_torch.core.sampling import points_along_rays

_MAX_SEM = 8


def supports_fused(cfg) -> bool:
    """Configurations the fused kernels cover (a config decision, made up
    front): viewdirs with PE, no conv_embed, a 2-layer semantic head without
    the geo gate, the skip at layer 4, and what fits the kernel's descriptor
    and shared memory (depth <= 10, width <= 256, sem_dim <= 8)."""
    return (cfg.use_viewdirs and cfg.use_embed and not cfg.conv_embed
            and (not cfg.use_semantics
                 or (cfg.sem_layer <= 2 and not cfg.sem_with_geo and cfg.sem_dim <= _MAX_SEM))
            and tuple(cfg.skips) == (4,)
            and max(cfg.netdepth, cfg.netdepth_fine) + 6 <= _build.MAX_LAYERS
            and max(cfg.netwidth, cfg.netwidth_fine) <= 256)


# ----------------------------------------------------------------- plain versions


def _composite_weights(sigma: torch.Tensor, z: torch.Tensor, rays_d: torch.Tensor) -> torch.Tensor:
    """Weights exactly as the kernels form them: ``e = exp(-relu(σ)·D)``,
    transmittance = exclusive product of ``e + 1e-10``, ``w = (1 - e)·T``."""
    dists = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 1e10)], dim=-1)
    e = torch.exp(-F.relu(sigma) * (dists * torch.linalg.norm(rays_d, dim=-1, keepdim=True)))
    T = torch.cumprod(torch.cat([torch.ones_like(e[:, :1]), e[:, :-1] + 1e-10], dim=-1), dim=-1)
    return (1.0 - e) * T


def coarse_weights_plain(field: nn.Module, od: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Plain version of K1: ``od [R, 6]``, ``z [R, S]`` -> weights ``[R, S]``."""
    sigma = field.sigma(points_along_rays(od[:, 0:3], od[:, 3:6], z))
    return _composite_weights(sigma, z, od[:, 3:6])


def render_plain(field: nn.Module, odv: torch.Tensor,
                 z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2: ``odv [R, 9]``, ``z [R, S]`` -> (maps, weights)."""
    raw = field(points_along_rays(odv[:, 0:3], odv[:, 3:6], z), odv[:, 6:9])
    w = _composite_weights(raw[..., 3], z, odv[:, 3:6])
    cols = [torch.sum(w[..., None] * torch.sigmoid(raw[..., :3]), dim=1),
            torch.sum(w * z, dim=1, keepdim=True), torch.sum(w, dim=1, keepdim=True)]
    if raw.shape[-1] > 4:
        cols.append(torch.sum(w[..., None] * raw[..., 4:], dim=1))
    return torch.cat(cols, dim=-1), w


def finish_maps(maps: torch.Tensor, weights: torch.Tensor, use_semantics: bool,
                white_bkgd: bool) -> Dict[str, torch.Tensor]:
    """Per-ray finishing on the ``[R, C]`` maps (``core.render.finish_maps``
    on their columns)."""
    return render.finish_maps(maps[:, 0:3], maps[:, 3:4], maps[:, 4:5], weights,
                              maps[:, 5:] if use_semantics else None, white_bkgd)


# ----------------------------------------------------------------- packing


def _pad8(x: int) -> int:
    return (x + 7) // 8 * 8


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round fp32 to TF32 (10 mantissa bits), to nearest with ties away from
    zero, as ``cvt.rna.tf32.f32`` does."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _field_layers(field: nn.Module) -> List[Tuple[nn.Linear, List[int]]]:
    """Kernel layer order (trunk, alpha, feature, views_0, rgb [, sem_0, sem_1]),
    each with the sizes of the input segments it reads, in order."""
    mlp = field.mlp
    E = mlp.pts_linears[0].in_features
    W = mlp.width
    out = []
    for i, lin in enumerate(mlp.pts_linears):
        out.append((lin, [E] if i == 0 else ([E, W] if i - 1 in mlp.skips else [W])))
    h = [E, W] if mlp.depth - 1 in mlp.skips else [W]
    out += [(mlp.alpha_linear, h), (mlp.feature_linear, h),
            (mlp.views_linears[0], [W, mlp.views_linears[0].in_features - W]),
            (mlp.rgb_linear, [mlp.rgb_linear.in_features])]
    if mlp.use_semantics:
        sem0, sem1 = mlp.semantic_linear[0], mlp.semantic_linear[2]
        out += [(sem0, h + ([E] if mlp.sem_with_coord else [])), (sem1, [sem1.in_features])]
    for lin, segs in out:
        assert sum(segs) == lin.in_features
    return out


def pack_field(field: nn.Module) -> Tuple[torch.Tensor, _build.MLPDesc]:
    """All weights of a field in one fp32 buffer plus the descriptor the
    kernel reads. Each layer is ``W^T`` (``[in, out]``, the layout the kernel
    reads coalesced) with every input segment and the output width padded to
    a multiple of 8 by zero rows and columns, then the TF32 high and low parts
    of that matrix (``hi = tf32(W^T)``, ``lo = tf32(W^T - hi)``: the 3xTF32
    operands of the tensor-core layers), then the zero-padded bias."""
    mlp = field.mlp
    layers = _field_layers(field)
    desc = _build.MLPDesc()
    parts, off = [], 0
    for i, (lin, segs) in enumerate(layers):
        wt = lin.weight.detach().t()
        kpad, npad = sum(_pad8(k) for k in segs), _pad8(lin.out_features)
        w = wt.new_zeros((kpad, npad))
        r = rp = 0
        for k in segs:
            w[rp:rp + k, :lin.out_features] = wt[r:r + k]
            r, rp = r + k, rp + _pad8(k)
        b = wt.new_zeros(npad)
        b[:lin.out_features] = lin.bias.detach()
        hi = _tf32(w)
        lo = _tf32(w - hi)
        desc.layer[i] = _build.MLPLayer(off, off + 3 * w.numel(), kpad, lin.out_features)
        parts += [w.reshape(-1), hi.reshape(-1), lo.reshape(-1), b]
        off += 3 * w.numel() + b.numel()
    depth = mlp.depth
    wide = list(range(depth)) + [depth + 1, depth + 2] + ([depth + 4] if mlp.use_semantics else [])
    desc.depth = depth
    desc.skip = mlp.skips[0] if mlp.skips else -1
    desc.hrows = _pad8(max(layers[i][0].out_features for i in wide))
    desc.emb_dim = mlp.pts_linears[0].in_features
    desc.demb_dim = mlp.views_linears[0].in_features - mlp.feature_linear.out_features
    desc.sem_dim = layers[-1][0].out_features if mlp.use_semantics else 0
    desc.sem_with_coord = int(mlp.use_semantics and mlp.sem_with_coord)
    return torch.cat(parts).to(torch.float32).contiguous(), desc


def _packed(field: nn.Module, device: torch.device) -> Tuple[torch.Tensor, _build.MLPDesc]:
    """``pack_field`` once per weight state: the cache key holds each
    parameter's storage and version counter, so ``load_state_dict`` or any
    in-place update repacks."""
    key = (device, tuple((p.data_ptr(), p._version) for p in field.parameters()))
    cached = getattr(field, "_fused_pack", None)
    if cached is None or cached[0] != key:
        buf, desc = pack_field(field)
        cached = (key, buf.to(device), desc)
        field._fused_pack = cached
    return cached[1], cached[2]


# ----------------------------------------------------------------- wrappers


def _check_inputs(field: nn.Module, rays: torch.Tensor, cols: int, z: torch.Tensor) -> None:
    if rays.device != z.device:
        raise ValueError(f"rays on {rays.device}, z on {z.device}")
    for name, t in (("rays", rays), ("z", z)):
        if t.dtype != torch.float32:
            raise NotImplementedError(f"{name}: the kernels take float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if rays.dim() != 2 or rays.shape[1] != cols or z.dim() != 2 or z.shape[0] != rays.shape[0]:
        raise ValueError(f"expected rays [R, {cols}] and z [R, S], got "
                         f"{tuple(rays.shape)} and {tuple(z.shape)}")
    p = next(field.parameters())
    if p.device != rays.device or p.dtype != torch.float32:
        raise NotImplementedError(f"field weights must be float32 on {rays.device}, "
                                  f"got {p.dtype} on {p.device}")


def _rays_per_cta(S: int) -> int:
    return max(1, 64 // S)


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def fused_coarse_weights(field: nn.Module, od: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """K1: coarse eval pass, ``od [R, 6]``, ``z [R, S]`` -> weights ``[R, S]``."""
    if od.device.type == "cpu":
        return coarse_weights_plain(field, od, z)
    if od.device.type != "cuda":
        raise NotImplementedError(f"no kernel for device {od.device}")
    _check_inputs(field, od, 6, z)
    R, S = z.shape
    weights = torch.empty((R, S), device=od.device, dtype=torch.float32)
    if R == 0:
        return weights
    buf, desc = _packed(field, od.device)
    with torch.cuda.device(od.device):
        code = _build.library().nerf_coarse_weights(
            od.data_ptr(), z.data_ptr(), buf.data_ptr(), ctypes.byref(desc),
            weights.data_ptr(), R, S, _rays_per_cta(S), _stream(od.device))
    _build.check(code, "fused_coarse_weights")
    fused_coarse_weights.launches += 1
    return weights


def fused_render(field: nn.Module, odv: torch.Tensor,
                 z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: fine eval pass, ``odv [R, 9]``, ``z [R, S]`` -> (maps, weights)."""
    if odv.device.type == "cpu":
        return render_plain(field, odv, z)
    if odv.device.type != "cuda":
        raise NotImplementedError(f"no kernel for device {odv.device}")
    _check_inputs(field, odv, 9, z)
    R, S = z.shape
    buf, desc = _packed(field, odv.device)
    maps = torch.empty((R, 5 + desc.sem_dim), device=odv.device, dtype=torch.float32)
    weights = torch.empty((R, S), device=odv.device, dtype=torch.float32)
    if R == 0:
        return maps, weights
    with torch.cuda.device(odv.device):
        code = _build.library().nerf_render(
            odv.data_ptr(), z.data_ptr(), buf.data_ptr(), ctypes.byref(desc),
            maps.data_ptr(), weights.data_ptr(), R, S, _rays_per_cta(S), _stream(odv.device))
    _build.check(code, "fused_render")
    fused_render.launches += 1
    return maps, weights


fused_coarse_weights.launches = 0
fused_render.launches = 0
