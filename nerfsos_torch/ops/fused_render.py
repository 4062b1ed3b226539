"""Fused render and train kernels: field + volumetric composite in one
kernel per pass.

Port of ``nerfsos_tpu/ops/pallas/fused_render.py``'s eval kernels, its RGB
train kernel and the SOS finetune's train forward and backward kernels:

- :func:`fused_coarse_weights` (K1, replaces ``fused_coarse_weights_planar``):
  ``od [R, 6]`` (origins, unnormalized directions) and ``z [R, S]`` ->
  quadrature weights ``[R, S]`` from the density trunk alone;
- :func:`fused_render` (K2, replaces ``fused_render_planar``): ``odv [R, 9]``
  (plus unit viewdirs) and ``z`` -> ``maps [R, 5 + sem]`` with columns
  ``(w·sigmoid(rgb) x3, w·z, w, w·sem...)`` and weights ``[R, S]``: K4's
  kernel without noise and without ``sem_in``;
- :func:`fused_rgb_train_grads` (K3, replaces ``fused_rgb_train_grads`` and
  its ``_train_render_bwd_kernel`` in ``rgb_loss`` mode): ``odv``, ``z`` and
  ``gt [R, 3]`` -> the unscaled gradients of ``sum((rgb_map - gt)^2)`` for
  every parameter of the field, the maps and the weights, with the sigma
  noise of :func:`noise_plain`;
- :func:`train_render` (K4, replaces ``_train_render_fwd_impl`` and its
  ``_train_render_kernel``): the train forward, maps and weights with the
  sigma noise of :func:`noise_plain`, and on request the semantic head's
  input ``sem_in`` per point (the JAX ``stream_semin`` residual);
- :func:`frozen_sem_grads` (K5, replaces ``_train_render_frozen_bwd_impl``
  and its ``_train_frozen_bwd_kernel``): the ``--fix_backbone`` backward,
  dW/db of the semantic head alone from ``sem_in``, the weights and the
  maps' cotangent;
- :func:`train_render_grads` (K6, replaces ``_train_render_bwd`` and its
  ``_train_render_bwd_kernel`` with map cotangents): the full backward of
  the train render, dW/db of every layer from the maps' and the weights'
  cotangents, recomputing the forward with the same noise;
- :func:`fused_train_render`: K4 with K5 or K6 as a
  ``torch.autograd.Function`` (replaces ``fused_train_render_planar`` and
  its custom VJP);
- :func:`finish_maps`: vacancy depth, disp and white background on the maps.

and its mip-NeRF kernels, which take ``odvr [R, 10]`` (origins, directions,
unit viewdirs, base radii) and ``z [R, S + 1]`` fenceposts, build each
interval's cone-frustum Gaussian and its integrated PE in the kernel, and
composite over the intervals (midpoint depths, no far pad) into
``maps [R, 5]`` and weights ``[R, S]``:

- :func:`fused_mip_render` (K9, replaces ``fused_mip_render_planar`` and its
  ``_mip_render_kernel``): the eval pass, K4's kernel in its mip mode;
- :func:`mip_train_render` (K10a, replaces ``_mip_train_fwd_impl`` and its
  ``_mip_train_kernel``): the train forward with the sigma noise of
  :func:`noise_plain` at point ``ray * S + interval``;
- :func:`mip_train_render_grads` (K10b, replaces ``_mip_train_bwd`` and its
  ``_mip_train_bwd_kernel``): dW/db of every layer from the maps' and the
  weights' cotangents, recomputing the forward with the same noise;
- :func:`fused_mip_train_render`: K10a with K10b as its backward
  (replaces ``fused_mip_train_render_planar``);
- :func:`finish_mip_maps`: the mip finishing of the maps.

Each wrapper takes its plain PyTorch version (:func:`coarse_weights_plain`,
:func:`render_plain`, :func:`rgb_train_grads_plain`,
:func:`train_render_plain`, :func:`frozen_sem_grads_plain`,
:func:`train_render_grads_plain`, :func:`mip_render_plain`,
:func:`mip_train_render_plain`, :func:`mip_train_render_grads_plain`, same
signature) for tensors on the CPU, and for CUDA tensors launches the
hand-written kernel in ``csrc/train_render.cu`` or raises; it never falls
back. ``<wrapper>.launches`` counts kernel launches.

K1-K6 and the mip kernels K9, K10a and K10b also run at
``compute_dtype=torch.bfloat16`` (``--compute_dtype bfloat16``; replaces the
Pallas kernels' bf16 mode):
every product's operands rounded to bf16 (to nearest even), the product
accumulated in float32 and the float32 bias added
(``models/mlp.bf16_operands_dense``), the activations rounded where the JAX
kernels' ``.astype(bf16)`` rounds them, ``sem_in`` stored in bf16, the
composite in float32; K5 as ``_train_frozen_bwd_kernel`` at bf16
(:func:`frozen_sem_grads_plain`), K3 and K6 as ``_train_render_bwd_kernel``
at bf16 (:func:`_train_grads_bf16`: the reverse sweep's products on bf16
operands, its cotangents rounded where JAX rounds them); K9 and K10a as
``_mip_render_kernel`` and ``_mip_train_kernel`` at bf16 (the integrated PE
formed in float32, then rounded), K10b as ``_mip_train_bwd_kernel`` at bf16
(K6's bf16 sweep without the semantic head, :func:`bf16_mip_forward`).
Their bf16 launches count in ``<wrapper>.launches_bf16``, as do those of
the field kernels' bf16 modes (``ops/fused_field.py``: K8a–K8f, K11).
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from nerfsos_torch import _build
from nerfsos_torch.core import render
from nerfsos_torch.core.sampling import points_along_rays
from nerfsos_torch.models.mlp import Dense, bf16_operands_dense, float32_dense, round_bf16

_MAX_SEM = 8


def is_bf16(compute_dtype: torch.dtype) -> bool:
    """Whether a kernel runs its bf16 mode (float32 and bfloat16 only)."""
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(f"the kernels run float32 or bfloat16, not {compute_dtype}")
    return compute_dtype == torch.bfloat16


def kernel_dense(compute_dtype: torch.dtype) -> Dense:
    """The product the kernels compute at ``compute_dtype``."""
    return bf16_operands_dense if is_bf16(compute_dtype) else float32_dense


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


def coarse_weights_plain(field: nn.Module, od: torch.Tensor, z: torch.Tensor,
                         compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version of K1: ``od [R, 6]``, ``z [R, S]`` -> weights ``[R, S]``."""
    sigma = field.sigma(points_along_rays(od[:, 0:3], od[:, 3:6], z),
                        kernel_dense(compute_dtype))
    return _composite_weights(sigma, z, od[:, 3:6])


def _maps(raw: torch.Tensor, sigma: torch.Tensor, z: torch.Tensor,
          rays_d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Maps ``[R, 5 + sem]`` and weights from the field's raw output, with
    ``sigma`` in place of its density column."""
    w = _composite_weights(sigma, z, rays_d)
    cols = [torch.sum(w[..., None] * torch.sigmoid(raw[..., :3]), dim=1),
            torch.sum(w * z, dim=1, keepdim=True), torch.sum(w, dim=1, keepdim=True)]
    if raw.shape[-1] > 4:
        cols.append(torch.sum(w[..., None] * raw[..., 4:], dim=1))
    return torch.cat(cols, dim=-1), w


def render_plain(field: nn.Module, odv: torch.Tensor, z: torch.Tensor,
                 compute_dtype: torch.dtype = torch.float32
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2: ``odv [R, 9]``, ``z [R, S]`` -> (maps, weights)."""
    raw = field(points_along_rays(odv[:, 0:3], odv[:, 3:6], z), odv[:, 6:9],
                kernel_dense(compute_dtype))
    return _maps(raw, raw[..., 3], z, odv[:, 3:6])


_U32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c`` wrapped to uint32, for uint32 values held in int64 (split in
    16-bit halves of ``c`` so no product leaves int64)."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _U32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """The SplitMix32-style avalanche of the TPU kernel (logical shifts)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x84ECE28B)
    return x ^ (x >> 16)


def noise_seed(seed: int) -> int:
    """The seed as the kernels see it: the TPU kernel takes it as a float32
    carrying an integer, so a seed above 2^24 loses its low bits."""
    return int(np.float32(seed)) & _U32


def noise_hash(seed: int, n: int, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two uint32 hashes (in int64) of points ``0 .. n-1``; point
    ``(ray r, sample s)`` of an ``[R, S]`` batch is index ``r * S + s``."""
    idx = torch.arange(n, dtype=torch.int64, device=device)
    h1 = _mix32(_mul32((idx + noise_seed(seed)) & _U32, 0x9E3779B9))
    h2 = _mix32((h1 + 0x7E3779B9) & _U32)
    return h1, h2


def noise_plain(seed: int, R: int, S: int, std: float, device=None) -> torch.Tensor:
    """Sigma noise ``[R, S]`` of the train kernels: N(0, std) per point by the
    hash and Box-Muller (``_noise_lanes`` of the TPU kernel)."""
    h1, h2 = noise_hash(seed, R * S, device)
    u1 = (h1 >> 8).to(torch.float32) * 2.0**-24
    u2 = (h2 >> 8).to(torch.float32) * 2.0**-24
    r = torch.sqrt(-2.0 * torch.log1p(-u1))
    two_pi = float(np.float32(2.0 * 3.14159265358979))
    return ((std * r) * torch.cos(two_pi * u2)).reshape(R, S)


def _rgb_objective(gt: torch.Tensor, white_bkgd: bool):
    """K3's loss on the maps of rays ``r0 ..``: ``sum((rgb_map - gt)^2)``
    (``rgb_map + 1 - acc`` under ``white_bkgd``)."""
    def objective(maps: torch.Tensor, w: torch.Tensor, r0: int) -> torch.Tensor:
        rgbm = maps[:, 0:3] + (1.0 - maps[:, 4:5]) if white_bkgd else maps[:, 0:3]
        return torch.sum((rgbm - gt[r0:r0 + maps.shape[0]]) ** 2)
    return objective


def _cotangent_objective(dmaps: torch.Tensor, dweights: Optional[torch.Tensor]):
    """K6's ``sum(dmaps * maps) + sum(dweights * weights)`` on rays ``r0 ..``."""
    def objective(maps: torch.Tensor, w: torch.Tensor, r0: int) -> torch.Tensor:
        obj = torch.sum(dmaps[r0:r0 + maps.shape[0]] * maps)
        if dweights is not None:
            obj = obj + torch.sum(dweights[r0:r0 + maps.shape[0]] * w)
        return obj
    return objective


def _bf16_gate(act: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """A relu-gated cotangent as JAX's bf16 sweep keeps it:
    ``bf16([act > 0] d)``."""
    return round_bf16(torch.where(act > 0, d, torch.zeros_like(d)))


def bf16_sweep(field: nn.Module, grads: Dict[str, torch.Tensor], e: torch.Tensor,
               dv: torch.Tensor, acts: List[torch.Tensor], feat: torch.Tensor,
               hv: torch.Tensor, s_act: Optional[torch.Tensor], d_rgb: torch.Tensor,
               d_sig: torch.Tensor, d_sem: Optional[torch.Tensor], pe_cotangents: bool = False
               ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """The bf16 reverse sweep of ``_train_render_bwd_kernel`` over points
    (rows) from the forward's bf16 activations (``e`` the point PE, ``dv``
    the view PE, each trunk layer's output, ``feat``, ``hv``, ``s_act``) and
    the composite's float32 cotangents of the rgb logits, sigma and (with
    ``d_sem``: K6 with the semantic head, which it then sweeps) the
    semantics; adds each leaf's gradient into ``grads`` (by parameter name).
    Every product multiplies bf16 operands in float32 (``dW = bf16(dY)^T
    bf16(X)``, ``dX = bf16(dY) bf16(W)``); ``dhv``, ``d_feat``, ``ds`` and
    every trunk ``dpre`` are rounded to bf16 after their relu gate and their
    bias sums add the rounded values, while the bias sums of ``d_rgb``,
    ``d_sigma`` and ``d_sem`` add the unrounded ones; ``dh`` is the float32
    sum of the feature, alpha and sem_0 input gradients. ``pe_cotangents``
    (K8c, ``_field_bwd_kernel`` at bf16): also returns the float32
    cotangents of ``e`` (gathered from sem_0's coordinate columns, the skip
    input's emb columns and layer 0, in that order) and of ``dv`` (the views
    layer's), unrounded; else None."""
    mlp = field.mlp
    E = mlp.pts_linears[0].in_features
    names = {id(p): n for n, p in field.named_parameters()}

    def add(lin: nn.Linear, dy: torch.Tensor, x: torch.Tensor, db: torch.Tensor) -> None:
        grads[names[id(lin.weight)]] += round_bf16(dy).t() @ round_bf16(x)
        grads[names[id(lin.bias)]] += db.sum(0)

    def dx(dy: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
        return round_bf16(dy) @ round_bf16(lin.weight.detach())

    ins, h = [], e
    for i, a in enumerate(acts):
        ins.append(h)
        h = torch.cat([e, a], -1) if i in mlp.skips else a
    hv_in = torch.cat([feat, dv], -1)
    add(mlp.rgb_linear, d_rgb, hv, d_rgb)
    dhv = _bf16_gate(hv, dx(d_rgb, mlp.rgb_linear))
    add(mlp.views_linears[0], dhv, hv_in, dhv)
    dhv_in = dx(dhv, mlp.views_linears[0])
    d_feat = round_bf16(dhv_in[:, :feat.shape[1]])
    add(mlp.feature_linear, d_feat, h, d_feat)
    add(mlp.alpha_linear, d_sig, h, d_sig)
    dh = dx(d_feat, mlp.feature_linear) + dx(d_sig, mlp.alpha_linear)
    d_e = torch.zeros_like(e) if pe_cotangents else None
    if d_sem is not None:
        lin0, lin2 = mlp.semantic_linear[0], mlp.semantic_linear[2]
        add(lin2, d_sem, s_act, d_sem)
        ds = _bf16_gate(s_act, dx(d_sem, lin2))
        add(lin0, ds, torch.cat([h, e], -1) if mlp.sem_with_coord else h, ds)
        dsem_in = dx(ds, lin0)
        dh = dh + dsem_in[:, :h.shape[1]]
        if pe_cotangents and mlp.sem_with_coord:
            d_e = d_e + dsem_in[:, h.shape[1]:]
    for i in range(mlp.depth - 1, -1, -1):
        if i in mlp.skips:
            if pe_cotangents:
                d_e = d_e + dh[:, :E]
            dh = dh[:, E:]  # the skip input's emb columns
        dpre = _bf16_gate(acts[i], dh)
        add(mlp.pts_linears[i], dpre, ins[i], dpre)
        if i > 0 or pe_cotangents:
            dh = dx(dpre, mlp.pts_linears[i])
    if not pe_cotangents:
        return None
    return d_e + dh, dhv_in[:, feat.shape[1]:]


def bf16_train_forward(field: nn.Module, odv: torch.Tensor, z: torch.Tensor
                       ) -> Dict[str, object]:
    """The forward of ``_train_render_bwd_kernel`` at bf16 over the points
    of ``odv [R, 9]``, ``z [R, S]`` (rows, point ``ray * S + sample``): the
    activations it keeps in bf16 (``e`` the point PE, ``dv`` the view PE,
    ``acts`` each trunk layer's ``bf16(relu(.))``, ``feat``, ``hv`` and,
    with the semantic head, ``s_act``), every product on bf16 operands with
    float32 accumulation and the float32 bias (:func:`bf16_operands_dense`),
    and the heads' float32 outputs (``heads``: the rgb logits, sigma
    without noise and the semantics)."""
    pts = points_along_rays(odv[:, 0:3], odv[:, 3:6], z)
    n = pts.shape[0] * z.shape[1]
    e = field.embed(pts).reshape(n, field.mlp.pts_linears[0].in_features)
    return _bf16_mlp_forward(field, e, field.embed_views(odv[:, None, 6:9].expand(pts.shape))
                             .reshape(n, -1))


def bf16_mip_forward(field: nn.Module, odvr: torch.Tensor, z: torch.Tensor
                     ) -> Dict[str, object]:
    """The forward of ``_mip_train_bwd_kernel`` at bf16 over the intervals
    of ``odvr [R, 10]``, fenceposts ``z [R, S + 1]`` (rows, point ``ray * S +
    interval``): :func:`bf16_train_forward`'s activations and heads with the
    integrated PE of the intervals' cone-frustum Gaussians (float32, then
    rounded to bf16) as ``e``."""
    from nerfsos_torch.models.mip import cast_rays

    means, covs = cast_rays(z, odvr[:, 0:3], odvr[:, 3:6], odvr[:, 9:10])
    n = means.shape[0] * means.shape[1]
    e = field.embed(means, covs).reshape(n, field.mlp.pts_linears[0].in_features)
    return _bf16_mlp_forward(field, e, field.embed_views(odvr[:, None, 6:9].expand(means.shape))
                             .reshape(n, -1))


def _bf16_mlp_forward(field: nn.Module, e: torch.Tensor, dv: torch.Tensor) -> Dict[str, object]:
    """The bf16 forwards' MLP on the float32 point and view encodings ``e``
    and ``dv`` (rows), each rounded to bf16 first."""
    mlp = field.mlp
    dense = bf16_operands_dense
    e, dv = round_bf16(e), round_bf16(dv)
    acts, h = [], e
    for i, lin in enumerate(mlp.pts_linears):
        acts.append(round_bf16(F.relu(dense(lin, h))))
        h = torch.cat([e, acts[-1]], -1) if i in mlp.skips else acts[-1]
    feat = round_bf16(dense(mlp.feature_linear, h))
    hv = round_bf16(F.relu(dense(mlp.views_linears[0], torch.cat([feat, dv], -1))))
    out = dict(e=e, dv=dv, acts=acts, feat=feat, hv=hv, s_act=None,
               heads=[dense(mlp.rgb_linear, hv), dense(mlp.alpha_linear, h)])
    if mlp.use_semantics:
        out["s_act"] = round_bf16(F.relu(dense(mlp.semantic_linear[0], torch.cat([h, e], -1)
                                              if mlp.sem_with_coord else h)))
        out["heads"].append(dense(mlp.semantic_linear[2], out["s_act"]))
    return out


def _train_grads_bf16(field: nn.Module, odv: torch.Tensor, z: torch.Tensor, objective, *,
                      noise_std: float, seed: int, sweep_sem: bool, mip: bool = False
                      ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor, torch.Tensor]:
    """K3's and K6's bf16 semantics (``_train_render_bwd_kernel`` at
    compute_dtype bfloat16), over chunks of rays; returns (grads by
    parameter name, maps, weights): :func:`bf16_train_forward`; the
    composite and its cotangent in float32 (autograd of ``objective`` with
    respect to the rgb logits, sigma and the semantics); then
    :func:`bf16_sweep`, the semantic head swept with ``sweep_sem`` (K6 with
    the head; K3's head gets zeros, its cotangent being zero). ``mip``
    (K10b, ``_mip_train_bwd_kernel`` at bf16): ``odv`` is odvr ``[R, 10]``
    and ``z`` fenceposts ``[R, S + 1]``, the forward
    :func:`bf16_mip_forward`, the composite the mip one."""
    R, S = z.shape[0], z.shape[1] - int(mip)
    z = z.detach()
    noise = noise_plain(seed, R, S, noise_std, z.device) if noise_std > 0.0 else None
    grads = {n: torch.zeros_like(p) for n, p in field.named_parameters()}
    maps, weights = [], []
    step = max(1, _PLAIN_CHUNK_POINTS // max(S, 1))
    with torch.no_grad():
        for r0 in range(0, max(R, 1), step):  # one (empty) chunk when R == 0
            o, zc = odv[r0:r0 + step], z[r0:r0 + step]
            f = (bf16_mip_forward if mip else bf16_train_forward)(field, o, zc)
            heads = [t.requires_grad_() for t in f["heads"]]
            with torch.enable_grad():
                raw = torch.cat(heads, -1).view(o.shape[0], S, -1)
                sigma = raw[..., 3] if noise is None else raw[..., 3] + noise[r0:r0 + step]
                m, w = (_mip_maps if mip else _maps)(raw, sigma, zc, o[:, 3:6])
                d_rgb, d_sig, *d_sem = torch.autograd.grad(objective(m, w, r0), heads,
                                                           allow_unused=True)
            maps.append(m.detach())
            weights.append(w.detach())
            if zc.numel():
                bf16_sweep(field, grads, f["e"], f["dv"], f["acts"], f["feat"], f["hv"],
                           f["s_act"], d_rgb, d_sig, d_sem[0] if sweep_sem else None)
    return grads, torch.cat(maps), torch.cat(weights)


def rgb_train_grads_plain(field: nn.Module, odv: torch.Tensor, z: torch.Tensor,
                          gt: torch.Tensor, *, white_bkgd: bool, noise_std: float,
                          seed: int, compute_dtype: torch.dtype = torch.float32
                          ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor, torch.Tensor]:
    """Plain version of K3: autograd of ``sum((rgb_map - gt)^2)`` through the
    field and the composite, with :func:`noise_plain` added to sigma before
    its relu (``rgb_map + 1 - acc`` under ``white_bkgd``; z is detached).

    Returns (grads keyed by ``field.named_parameters()`` names, UNSCALED: the
    caller multiplies by ``rgb_w / (R * 3)``; maps ``[R, 5 + sem]``; weights
    ``[R, S]``). The semantic columns of the maps get no cotangent, so the
    semantic head's grads are zeros. Every parameter gets its gradient,
    whether it requires one or not (a ``--fix_backbone`` optimizer drops
    the frozen ones). At bf16 the JAX kernel's bf16 sweep
    (:func:`_train_grads_bf16`)."""
    if is_bf16(compute_dtype):
        return _train_grads_bf16(field, odv, z, _rgb_objective(gt, white_bkgd),
                                 noise_std=noise_std, seed=seed, sweep_sem=False)
    R, S = z.shape
    z = z.detach()
    leaves = {n: p.detach().requires_grad_() for n, p in field.named_parameters()}
    with torch.enable_grad():
        raw = torch.func.functional_call(
            field, leaves, (points_along_rays(odv[:, 0:3], odv[:, 3:6], z), odv[:, 6:9]))
        sigma = raw[..., 3]
        if noise_std > 0.0:
            sigma = sigma + noise_plain(seed, R, S, noise_std, z.device)
        maps, w = _maps(raw, sigma, z, odv[:, 3:6])
        rgbm = maps[:, 0:3] + (1.0 - maps[:, 4:5]) if white_bkgd else maps[:, 0:3]
        loss = torch.sum((rgbm - gt) ** 2)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    out = {n: torch.zeros_like(p) if g is None else g
           for (n, p), g in zip(leaves.items(), grads)}
    return out, maps.detach(), w.detach()


_PLAIN_CHUNK_POINTS = 1 << 20  # points per chunk of the plain versions below


def train_render_plain(field: nn.Module, odv: torch.Tensor, z: torch.Tensor, *,
                       noise_std: float, seed: int, save_semin: bool,
                       compute_dtype: torch.dtype = torch.float32
                       ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Plain version of K4: ``odv [R, 9]``, ``z [R, S]`` -> (maps ``[R, 5 + sem]``,
    weights ``[R, S]``, and with ``save_semin`` the semantic head's input
    ``sem_in [R * S, C]`` (point ``ray * S + sample``; bf16 at bf16), else
    None), with :func:`noise_plain` added to sigma before its relu. Runs in
    chunks of rays so that the flagship batch fits on the card."""
    R, S = z.shape
    noise = noise_plain(seed, R, S, noise_std, z.device) if noise_std > 0.0 else None
    maps, weights, sem_in = [], [], []
    step = max(1, _PLAIN_CHUNK_POINTS // max(S, 1))
    dense = kernel_dense(compute_dtype)
    with torch.no_grad():
        for r0 in range(0, max(R, 1), step):  # one (empty) chunk when R == 0
            o, zc = odv[r0:r0 + step], z[r0:r0 + step]
            raw, si = field.forward_parts(points_along_rays(o[:, 0:3], o[:, 3:6], zc), o[:, 6:9],
                                          dense)
            sigma = raw[..., 3] if noise is None else raw[..., 3] + noise[r0:r0 + step]
            m, w = _maps(raw, sigma, zc, o[:, 3:6])
            maps.append(m)
            weights.append(w)
            if save_semin:
                sem_in.append(si.to(compute_dtype))
    return torch.cat(maps), torch.cat(weights), torch.cat(sem_in) if save_semin else None


def train_render_grads_plain(field: nn.Module, odv: torch.Tensor, z: torch.Tensor,
                             dmaps: torch.Tensor, dweights: Optional[torch.Tensor], *,
                             noise_std: float, seed: int,
                             compute_dtype: torch.dtype = torch.float32
                             ) -> Dict[str, torch.Tensor]:
    """Plain version of K6: the VJP of :func:`train_render_plain`'s maps and
    weights, ``sum(dmaps * maps) + sum(dweights * weights)`` differentiated
    with respect to every parameter of the field (``dweights=None``: a zero
    cotangent), keyed by ``field.named_parameters()`` names; z is constant.
    Runs in chunks of rays, each chunk's graph freed before the next. At
    bf16 the JAX kernel's bf16 sweep (:func:`_train_grads_bf16`, the
    semantic head swept)."""
    if is_bf16(compute_dtype):
        return _train_grads_bf16(field, odv, z, _cotangent_objective(dmaps, dweights),
                                 noise_std=noise_std, seed=seed,
                                 sweep_sem=field.mlp.use_semantics)[0]
    R, S = z.shape
    z = z.detach()
    noise = noise_plain(seed, R, S, noise_std, z.device) if noise_std > 0.0 else None
    leaves = {n: p.detach().requires_grad_() for n, p in field.named_parameters()}
    grads = {n: torch.zeros_like(p) for n, p in leaves.items()}
    step = max(1, _PLAIN_CHUNK_POINTS // max(S, 1))
    with torch.enable_grad():
        for r0 in range(0, R, step):
            o, zc = odv[r0:r0 + step], z[r0:r0 + step]
            raw = torch.func.functional_call(
                field, leaves, (points_along_rays(o[:, 0:3], o[:, 3:6], zc), o[:, 6:9]))
            sigma = raw[..., 3] if noise is None else raw[..., 3] + noise[r0:r0 + step]
            m, w = _maps(raw, sigma, zc, o[:, 3:6])
            obj = torch.sum(dmaps[r0:r0 + step] * m)
            if dweights is not None:
                obj = obj + torch.sum(dweights[r0:r0 + step] * w)
            for n, g in zip(leaves, torch.autograd.grad(obj, list(leaves.values()),
                                                        allow_unused=True)):
                if g is not None:
                    grads[n] += g
    return grads


_SEM_NAMES = ("mlp.semantic_linear.0.weight", "mlp.semantic_linear.0.bias",
              "mlp.semantic_linear.2.weight", "mlp.semantic_linear.2.bias")


def frozen_sem_grads_plain(field: nn.Module, sem_in: torch.Tensor, weights: torch.Tensor,
                           dmaps: torch.Tensor, compute_dtype: torch.dtype = torch.float32
                           ) -> Dict[str, torch.Tensor]:
    """Plain version of K5: the gradients of ``sum(dmaps[:, 5:] * sem_map)``
    with respect to the semantic head's four leaves alone, where
    ``sem_map = sum_s w[r, s] * semantic_linear(sem_in[r * S + s])`` and the
    weights ``w`` are held constant. Keyed by ``_SEM_NAMES`` (the field's
    parameter names). At bf16 (``sem_in`` bf16) the JAX kernel's bf16
    backward (:func:`_frozen_sem_grads_bf16`)."""
    if is_bf16(compute_dtype):
        return _frozen_sem_grads_bf16(field, sem_in, weights, dmaps)
    R, S = weights.shape
    lin0, lin2 = field.mlp.semantic_linear[0], field.mlp.semantic_linear[2]
    leaves = [t.detach().requires_grad_() for t in (lin0.weight, lin0.bias, lin2.weight,
                                                    lin2.bias)]
    with torch.enable_grad():
        s_act = F.relu(F.linear(sem_in, leaves[0], leaves[1]))
        sem = F.linear(s_act, leaves[2], leaves[3])
        sem_map = (weights.reshape(-1, 1) * sem).reshape(R, S, -1).sum(1)
        grads = torch.autograd.grad(torch.sum(dmaps[:, 5:] * sem_map), leaves)
    return dict(zip(_SEM_NAMES, grads))


def _frozen_sem_grads_bf16(field: nn.Module, sem_in: torch.Tensor, weights: torch.Tensor,
                           dmaps: torch.Tensor) -> Dict[str, torch.Tensor]:
    """K5's bf16 semantics (``_train_frozen_bwd_kernel`` at compute_dtype
    bfloat16), over chunks of points: ``s_act = bf16(relu(sem_in
    bf16(W0)^T + b0))``; ``d_sem = dmaps[ray, 5:] w``, ``d_sem_c =
    bf16(d_sem)``; ``dW1 = d_sem_c^T s_act``, ``db1 = sum d_sem``; ``ds =
    bf16([s_act > 0] d_sem_c bf16(W1))``; ``dW0 = ds^T sem_in``, ``db0 = sum
    ds``; every product accumulated in float32."""
    R, S = weights.shape
    lin0, lin2 = field.mlp.semantic_linear[0], field.mlp.semantic_linear[2]
    w0, w1 = round_bf16(lin0.weight.detach()), round_bf16(lin2.weight.detach())
    b0 = lin0.bias.detach()
    d_all = (dmaps[:, 5:].repeat_interleave(S, dim=0) * weights.reshape(-1, 1)).to(torch.float32)
    grads = [torch.zeros_like(lin0.weight), torch.zeros_like(lin0.bias),
             torch.zeros_like(lin2.weight), torch.zeros_like(lin2.bias)]
    with torch.no_grad():
        for p0 in range(0, R * S, _PLAIN_CHUNK_POINTS):
            x = sem_in[p0:p0 + _PLAIN_CHUNK_POINTS].to(torch.float32)
            d_sem = d_all[p0:p0 + _PLAIN_CHUNK_POINTS]
            s_act = round_bf16(F.relu(x @ w0.t() + b0))
            dc = round_bf16(d_sem)
            ds = round_bf16(torch.where(s_act > 0, dc @ w1, torch.zeros_like(s_act)))
            grads[0] += ds.t() @ x
            grads[1] += ds.sum(0)
            grads[2] += dc.t() @ s_act
            grads[3] += d_sem.sum(0)
    return dict(zip(_SEM_NAMES, grads))


def finish_maps(maps: torch.Tensor, weights: torch.Tensor, use_semantics: bool,
                white_bkgd: bool) -> Dict[str, torch.Tensor]:
    """Per-ray finishing on the ``[R, C]`` maps (``core.render.finish_maps``
    on their columns)."""
    return render.finish_maps(maps[:, 0:3], maps[:, 3:4], maps[:, 4:5], weights,
                              maps[:, 5:] if use_semantics else None, white_bkgd)


def _mip_raw(field: nn.Module, odvr: torch.Tensor, z: torch.Tensor,
             params: Optional[Dict[str, torch.Tensor]] = None,
             dense: Optional[Dense] = None) -> torch.Tensor:
    """The field's raw ``[R, S, 4]`` (with ``params`` in place of its own
    parameters, when given; ``dense`` its products) on the cone-frustum
    Gaussians of the intervals between the fenceposts ``z [R, S + 1]``."""
    from nerfsos_torch.models.mip import cast_rays

    means, covs = cast_rays(z, odvr[:, 0:3], odvr[:, 3:6], odvr[:, 9:10])
    args = (means, covs, odvr[:, 6:9])
    if params is None:
        return field(*args, dense=dense)
    return torch.func.functional_call(field, params, args)


def _mip_maps(raw: torch.Tensor, sigma: torch.Tensor, z: torch.Tensor,
              rays_d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mip maps ``[R, 5]`` ``(w·sigmoid(rgb) x3, w·mid, w)`` and weights
    ``[R, S]``, as the kernels form them: ``D = (t1 - t0)·‖d‖`` with no far
    pad, ``e = exp(-relu(σ)·D)``, transmittance = exclusive product of
    ``e + 1e-10``, ``w = (1 - e)·T``."""
    e = torch.exp(-F.relu(sigma) * ((z[:, 1:] - z[:, :-1])
                                    * torch.linalg.norm(rays_d, dim=-1, keepdim=True)))
    T = torch.cumprod(torch.cat([torch.ones_like(e[:, :1]), e[:, :-1] + 1e-10], dim=-1), dim=-1)
    w = (1.0 - e) * T
    mids = (z[:, :-1] + z[:, 1:]) * 0.5
    return torch.cat([torch.sum(w[..., None] * torch.sigmoid(raw[..., :3]), dim=1),
                      torch.sum(w * mids, dim=1, keepdim=True),
                      torch.sum(w, dim=1, keepdim=True)], dim=-1), w


def mip_train_render_plain(field: nn.Module, odvr: torch.Tensor, z: torch.Tensor, *,
                           noise_std: float, seed: int,
                           compute_dtype: torch.dtype = torch.float32
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K10a: ``odvr [R, 10]``, fenceposts ``z [R, S + 1]``
    -> (maps ``[R, 5]``, weights ``[R, S]``), with :func:`noise_plain` added
    to sigma before its relu. Runs in chunks of rays. At bf16 every product
    on bf16 operands (:func:`kernel_dense`): the integrated PE, each relu
    output, feat, the view PE and hv rounded where they are read, as
    ``_mip_train_kernel`` rounds them."""
    R, S = z.shape[0], z.shape[1] - 1
    noise = noise_plain(seed, R, S, noise_std, z.device) if noise_std > 0.0 else None
    maps, weights = [], []
    step = max(1, _PLAIN_CHUNK_POINTS // max(S, 1))
    dense = kernel_dense(compute_dtype)
    with torch.no_grad():
        for r0 in range(0, max(R, 1), step):  # one (empty) chunk when R == 0
            o, zc = odvr[r0:r0 + step], z[r0:r0 + step]
            raw = _mip_raw(field, o, zc, dense=dense)
            sigma = raw[..., 3] if noise is None else raw[..., 3] + noise[r0:r0 + step]
            m, w = _mip_maps(raw, sigma, zc, o[:, 3:6])
            maps.append(m)
            weights.append(w)
    return torch.cat(maps), torch.cat(weights)


def mip_render_plain(field: nn.Module, odvr: torch.Tensor, z: torch.Tensor,
                     compute_dtype: torch.dtype = torch.float32
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K9: ``odvr [R, 10]``, fenceposts ``z [R, S + 1]`` ->
    (maps ``[R, 5]``, weights ``[R, S]``)."""
    return mip_train_render_plain(field, odvr, z, noise_std=0.0, seed=0,
                                  compute_dtype=compute_dtype)


def mip_train_render_grads_plain(field: nn.Module, odvr: torch.Tensor, z: torch.Tensor,
                                 dmaps: torch.Tensor, dweights: Optional[torch.Tensor], *,
                                 noise_std: float, seed: int,
                                 compute_dtype: torch.dtype = torch.float32
                                 ) -> Dict[str, torch.Tensor]:
    """Plain version of K10b: the VJP of :func:`mip_train_render_plain`'s
    maps and weights with respect to every parameter of the field
    (``dweights=None``: a zero cotangent), keyed by
    ``field.named_parameters()`` names; rays and z are constant. Runs in
    chunks of rays, each chunk's graph freed before the next. At bf16 the
    JAX kernel's bf16 sweep (:func:`_train_grads_bf16` with ``mip``)."""
    if is_bf16(compute_dtype):
        return _train_grads_bf16(field, odvr, z, _cotangent_objective(dmaps, dweights),
                                 noise_std=noise_std, seed=seed, sweep_sem=False, mip=True)[0]
    R, S = z.shape[0], z.shape[1] - 1
    z = z.detach()
    noise = noise_plain(seed, R, S, noise_std, z.device) if noise_std > 0.0 else None
    leaves = {n: p.detach().requires_grad_() for n, p in field.named_parameters()}
    grads = {n: torch.zeros_like(p) for n, p in leaves.items()}
    step = max(1, _PLAIN_CHUNK_POINTS // max(S, 1))
    with torch.enable_grad():
        for r0 in range(0, R, step):
            o, zc = odvr[r0:r0 + step], z[r0:r0 + step]
            raw = _mip_raw(field, o, zc, leaves)
            sigma = raw[..., 3] if noise is None else raw[..., 3] + noise[r0:r0 + step]
            m, w = _mip_maps(raw, sigma, zc, o[:, 3:6])
            obj = torch.sum(dmaps[r0:r0 + step] * m)
            if dweights is not None:
                obj = obj + torch.sum(dweights[r0:r0 + step] * w)
            for n, g in zip(leaves, torch.autograd.grad(obj, list(leaves.values()),
                                                        allow_unused=True)):
                if g is not None:
                    grads[n] += g
    return grads


def finish_mip_maps(maps: torch.Tensor, weights: torch.Tensor,
                    white_bkgd: bool) -> Dict[str, torch.Tensor]:
    """Mip per-ray finishing on the ``[R, 5]`` maps: vacancy depth, disp and
    the white background (``core.render.finish_maps`` without semantics)."""
    return render.finish_maps(maps[:, 0:3], maps[:, 3:4], maps[:, 4:5], weights, None,
                              white_bkgd)


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


def _padded_wt(lin: nn.Linear, segs: List[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """``W^T`` (``[in, out]``) with every input segment and the output width
    padded to a multiple of 8 by zero rows and columns, and the zero-padded
    bias."""
    wt = lin.weight.detach().t()
    kpad, npad = sum(_pad8(k) for k in segs), _pad8(lin.out_features)
    w = wt.new_zeros((kpad, npad))
    r = rp = 0
    for k in segs:
        w[rp:rp + k, :lin.out_features] = wt[r:r + k]
        r, rp = r + k, rp + _pad8(k)
    b = wt.new_zeros(npad)
    b[:lin.out_features] = lin.bias.detach()
    return w, b


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
        w, b = _padded_wt(lin, segs)
        hi = _tf32(w)
        lo = _tf32(w - hi)
        desc.layer[i] = _build.MLPLayer(off, off + 3 * w.numel(), w.shape[0], lin.out_features)
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


_RING_WIDTHS = (8, 16, 32, 64, 128, 256)  # K4's wgmma widths (csrc/wg_tile.cuh wg_layer_n)


def _ring_n(n: int) -> int:
    """The wgmma width K4 multiplies a layer of ``n`` outputs at."""
    for w in _RING_WIDTHS:
        if w >= n:
            return w
    raise NotImplementedError(f"K4 takes layers of at most {_RING_WIDTHS[-1]} outputs, got {n}")


def ring_layers(field: nn.Module) -> List[int]:
    """The layers K4 multiplies on wgmma, by kernel layer index, in the
    order its ring delivers them (``ring_order`` in ``csrc/wg_tile.cuh``):
    the trunk, sem_0 (with the semantic head), feature, views."""
    depth = field.mlp.depth
    return (list(range(depth)) + ([depth + 4] if field.mlp.use_semantics else [])
            + [depth + 1, depth + 2])


def _ring_index(field: nn.Module, attr: str, layers: Sequence[_build.MLPLayer],
                order: List[int], numel: int, device: torch.device,
                h_layers: Sequence[int] = (), bf16: bool = False
                ) -> Tuple[torch.Tensor, _build.RingDesc]:
    """Where each float of a ring's buffer lies in the packed buffer its
    ``layers`` describe (``numel`` floats in ``pack_field``'s per-layer
    format; index ``numel`` for a padding row or column, read as 0), for the
    layers in ``order``, and the ring's descriptor (``hrows``: the widest N
    of ``h_layers``): kept on the field under ``attr`` for the layers'
    shapes, per device. ``bf16``: :func:`pack_ring`'s bf16 layout (each
    entry of a layer's float32 ``W^T`` once, two a float32 word after the
    gather's rounding; ``off`` and ``stage_floats`` in words)."""
    key = (tuple((layers[i].w, layers[i].k, layers[i].n) for i in order), numel, device, bf16)
    cached = field.__dict__.get(attr)
    if cached is None or cached[0] != key:
        rd = _build.RingDesc()
        parts, off = [], 0
        for i in order:
            L = layers[i]
            ldn, n = _pad8(L.n), _ring_n(L.n)
            if bf16:
                s, j, h, r, c = torch.meshgrid(
                    *(torch.arange(x) for x in (-(-L.k // 16), n // 8, 2, 8, 8)), indexing="ij")
                row, col = 16 * s + bf16_k_rows()[8 * h + c], 8 * j + r
                src, valid = L.w + row * ldn + col, (col < ldn) & (row < L.k)
            else:
                s, part, j, h, r, c = torch.meshgrid(
                    *(torch.arange(x) for x in (L.k // 8, 2, n // 8, 2, 8, 4)), indexing="ij")
                row, col = 8 * s + 4 * h + c, 8 * j + r
                src = L.w + (1 + part) * L.k * ldn + row * ldn + col  # the hi, then the lo parts
                valid = col < ldn
            parts.append(torch.where(valid, src, numel).reshape(-1))
            rd.off[i], rd.ncols[i] = off, n
            off += parts[-1].numel() // (2 if bf16 else 1)
        rd.hrows = max((rd.ncols[i] for i in h_layers), default=0)
        rd.stage_floats = (8 if bf16 else 16) * max(rd.ncols[i] for i in order)
        cached = (key, torch.cat(parts).to(device), rd)
        field.__dict__[attr] = cached
    return cached[1], cached[2]


def gather_ring(field: nn.Module, attr: str, buf: torch.Tensor,
                layers: Sequence[_build.MLPLayer], order: List[int],
                h_layers: Sequence[int] = (), bf16: bool = False
                ) -> Tuple[torch.Tensor, _build.RingDesc]:
    """A ring buffer from the packed buffer ``buf`` (``pack_field``'s
    per-layer format, ``layers`` its descriptors): one gather of the TF32
    parts (``bf16``: of the float32 entries, then rounded to bf16; its index
    kept under ``attr`` + ``_bf16``) of the layers in ``order``, so each
    layer is split once per weight state; see :func:`pack_ring`."""
    idx, rd = _ring_index(field, attr + ("_bf16" if bf16 else ""), layers, order, buf.numel(),
                          buf.device, h_layers, bf16)
    ring = torch.cat([buf, buf.new_zeros(1)])[idx]
    if bf16:
        ring = ring.to(torch.bfloat16).view(torch.float32)
    return ring, _build.RingDesc.from_buffer_copy(rd)


def _ring_from(field: nn.Module, buf: torch.Tensor, fdesc: _build.MLPDesc, bf16: bool = False
               ) -> Tuple[torch.Tensor, _build.RingDesc]:
    """:func:`pack_ring` from ``pack_field``'s buffer ``buf`` of ``field``."""
    depth = field.mlp.depth
    return gather_ring(field, "_ring_index", buf, fdesc.layer, ring_layers(field),
                       list(range(depth)) + [depth + 1], bf16)


def pack_ring(field: nn.Module, bf16: bool = False) -> Tuple[torch.Tensor, _build.RingDesc]:
    """The weights of the 128-point tile (K4, and K3's and K6's forward) for
    its ring of shared-memory stages, and the ring's descriptor (``stages``
    left 0: the wrapper sets it per call). For each of :func:`ring_layers`,
    ``pack_field``'s padded ``W^T [kpad, npad]`` with its columns padded
    further to the wgmma width ``N`` (:func:`_ring_n`) is cut into k-slices
    of 8 rows, each one stage: the slice's TF32 high parts, then its low
    parts (``pack_field``'s), each as ``[N / 8][2][8][4]`` with element
    ``(j, h, r, c) = W^T[8 s + 4 h + c][8 j + r]`` (wgmma's K-major core
    matrices of 8 outputs x 4 inputs, the two k halves of an output group
    side by side). ``hrows`` is the widest ``N`` of the trunk and feature
    (the rows each warpgroup's ``h`` tile holds).

    ``bf16`` (K1, K2 and K4 at bf16): ``W^T`` rounded to bf16, its rows
    padded to a multiple of 16, cut into k16 slices of 16 rows, each one
    stage of ``[N / 8][2][8][8]`` bf16 with element ``(j, h, r, c) =
    W^T[16 s + 8 h + c // 2 + 4 (c % 2)][8 j + r]`` (core matrices of 8
    outputs x 8 inputs, 16 B, the two k halves side by side: the TF32
    layout's LBO and SBO; k position ``8 h + c`` holds row ``8 h + c // 2 +
    4 (c % 2)``, :func:`bf16_k_rows`). The buffer is float32 words, two
    bf16 each; ``off`` and ``stage_floats`` count words."""
    return _ring_from(field, *pack_field(field), bf16)


def bf16_k_rows() -> torch.Tensor:
    """The input row (of 16) at each k position of a bf16 k16 step of K4's
    tile: ``8 h + t + 4 e`` at ``2 t + e + 8 h``, so that a thread's A
    operands are the rows fp32 mode loads (``csrc/wg_tile.cuh`` wg_layer)."""
    q = torch.arange(16)
    return 8 * (q // 8) + (q % 8) // 2 + 4 * (q % 2)


def _bwd_matrix(blocks: List[torch.Tensor]) -> torch.Tensor:
    """Row blocks ``[rows_i, n]`` stacked, each padded to a multiple of 8 rows,
    and the columns padded to a multiple of 8."""
    n = blocks[0].shape[1]
    w = blocks[0].new_zeros((sum(_pad8(b.shape[0]) for b in blocks), _pad8(n)))
    r = 0
    for b in blocks:
        w[r:r + b.shape[0], :n] = b
        r += _pad8(b.shape[0])
    return w


def pack_train_bwd(field: nn.Module) -> Tuple[torch.Tensor, List[_build.MLPLayer]]:
    """The input-gradient matrices of K3's reverse sweep, in ``pack_field``'s
    per-layer format (matrix, its TF32 high and low parts, a zero bias), by
    the forward layer index they serve: trunk ``i >= 1`` gets ``W_i`` on the
    columns of its ``h`` input (``dh_{i-1} = W_i[:, h]^T dY_i``); alpha's
    slot gets ``[W_feature; W_alpha]`` on the columns of ``h``; views gets
    ``W_views`` on the feature columns; rgb gets ``W_rgb``; with the
    semantic head (K6), sem_0 gets its weight on the columns of ``h`` and
    sem_1 its whole weight. The emb columns of a skip input, of the semantic
    head's input and layer 0 need no input gradient. K3 reads none of the
    semantic head's entries, which come last in the buffer."""
    mlp = field.mlp
    depth, W, E = mlp.depth, mlp.width, mlp.pts_linears[0].in_features

    def cols(lin: nn.Linear, a: int) -> torch.Tensor:
        return lin.weight.detach()[:, a:a + W]

    mats = {i: [cols(mlp.pts_linears[i], E if i - 1 in mlp.skips else 0)]
            for i in range(1, depth)}
    a = E if depth - 1 in mlp.skips else 0
    mats[depth] = [cols(mlp.feature_linear, a), cols(mlp.alpha_linear, a)]
    mats[depth + 2] = [cols(mlp.views_linears[0], 0)]
    mats[depth + 3] = [mlp.rgb_linear.weight.detach()]
    if mlp.use_semantics:
        mats[depth + 4] = [cols(mlp.semantic_linear[0], a)]
        mats[depth + 5] = [mlp.semantic_linear[2].weight.detach()]
    return pack_bwd_matrices(mats)


def pack_bwd_matrices(mats: Dict[int, List[torch.Tensor]]
                      ) -> Tuple[torch.Tensor, List[_build.MLPLayer]]:
    """Row blocks of input-gradient matrices by forward layer index, each as
    ``_bwd_matrix`` stacks them, in ``pack_field``'s per-layer format (the
    matrix, its TF32 high and low parts, a zero bias): one buffer and the
    layers' descriptors (empty for the indices not given)."""
    descs = [_build.MLPLayer() for _ in range(_build.MAX_LAYERS)]
    parts, off = [], 0
    for i, blocks in mats.items():
        w = _bwd_matrix(blocks)
        hi = _tf32(w)
        descs[i] = _build.MLPLayer(off, off + 3 * w.numel(), w.shape[0], blocks[0].shape[1])
        parts += [w.reshape(-1), hi.reshape(-1), _tf32(w - hi).reshape(-1), w.new_zeros(w.shape[1])]
        off += 3 * w.numel() + w.shape[1]
    return torch.cat(parts).to(torch.float32).contiguous(), descs


def bwd_ring_layers(field: nn.Module) -> List[int]:
    """The input-gradient products of the reverse sweep by forward layer
    index (:func:`pack_train_bwd`'s entries), in the order
    ``train_reverse_kernel`` runs them: rgb, views, alpha's slot
    ``[W_feature; W_alpha]``, with the semantic head sem_1 and sem_0, then
    the trunk from layer ``depth - 1`` down to 1."""
    depth = field.mlp.depth
    return ([depth + 3, depth + 2, depth]
            + ([depth + 5, depth + 4] if field.mlp.use_semantics else [])
            + list(range(depth - 1, 0, -1)))


def _bwd_ring_from(field: nn.Module, buf: torch.Tensor, bwd: List[_build.MLPLayer],
                   bf16: bool = False) -> Tuple[torch.Tensor, _build.RingDesc]:
    return gather_ring(field, "_bwd_ring_index", buf, bwd, bwd_ring_layers(field), bf16=bf16)


def pack_bwd_ring(field: nn.Module, bf16: bool = False) -> Tuple[torch.Tensor, _build.RingDesc]:
    """The reverse sweep's input-gradient matrices for its ring of
    shared-memory stages (``csrc/train_sweep.cuh`` bwd_layer), and the
    ring's descriptor: :func:`pack_train_bwd`'s matrices ``Wb [k = dY rows,
    n = input rows]`` in :func:`bwd_ring_layers`' order, each cut as
    :func:`pack_ring` cuts a layer's ``W^T`` (per k-slice of 8 dY rows the
    TF32 high parts, then the low parts, element ``(j, h, r, c) = Wb[8 s +
    4 h + c][8 j + r]``, the columns padded to the wgmma width ``N``:
    ``off``/``ncols`` by forward layer index; ``stages`` and ``hrows`` are
    not read).

    ``bf16`` (K3 and K6 at bf16): each ``Wb`` rounded to bf16, its rows
    padded to a multiple of 16 and cut into k16 slices as :func:`pack_ring`
    cuts a layer in its bf16 layout (element ``(j, h, r, c) = Wb[16 s + 8 h
    + c // 2 + 4 (c % 2)][8 j + r]``, :func:`bf16_k_rows`' order, so that a
    thread's A operands are the dY rows fp32 mode loads); two bf16 a float32
    word, ``off`` in words."""
    return _bwd_ring_from(field, *pack_train_bwd(field), bf16)


def _cached(field: nn.Module, device: torch.device, attr: str, pack):
    """``pack(field)`` once per weight state: the cache key holds each
    parameter's storage and version counter, so ``load_state_dict``, an
    optimizer step or any in-place update repacks."""
    key = (device, tuple((p.data_ptr(), p._version) for p in field.parameters()))
    cached = getattr(field, attr, None)
    if cached is None or cached[0] != key:
        buf, desc = pack(field)
        cached = (key, buf.to(device), desc)
        setattr(field, attr, cached)
    return cached[1], cached[2]


def _packed(field: nn.Module, device: torch.device) -> Tuple[torch.Tensor, _build.MLPDesc]:
    return _cached(field, device, "_fused_pack", pack_field)


def _ring(field: nn.Module, device: torch.device,
          bf16: bool = False) -> Tuple[torch.Tensor, _build.RingDesc]:
    """:func:`pack_ring` on ``device`` once per weight state, gathered from
    the cached :func:`_packed` buffer (``bf16``: its bf16 layout, cached
    apart)."""
    return _cached(field, device, "_ring_bf16_pack" if bf16 else "_ring_pack",
                   lambda f: _ring_from(f, *_packed(f, device), bf16))


def _train_bwd(field: nn.Module, device: torch.device
               ) -> Tuple[torch.Tensor, List[_build.MLPLayer]]:
    return _cached(field, device, "_fused_train_pack", pack_train_bwd)


def _bwd_ring(field: nn.Module, device: torch.device,
              bf16: bool = False) -> Tuple[torch.Tensor, _build.RingDesc]:
    """:func:`pack_bwd_ring` on ``device`` once per weight state, from the
    cached :func:`pack_train_bwd` buffer (``bf16``: its bf16 layout, cached
    apart)."""
    return _cached(field, device, "_bwd_ring_bf16_pack" if bf16 else "_bwd_ring_pack",
                   lambda f: _bwd_ring_from(f, *_train_bwd(f, device), bf16))


# K3's workspace planes (csrc/train_render.cu ``enum Plane``; K6 adds s_act,
# d_sem and ds after the trunk's) and its chunks
_P_EMB, _P_DEMB, _P_FEAT, _P_HV, _P_DRGB, _P_DSIG, _P_DPV, _P_DFEAT, _P_DA, _P_DB, _P_ACT0 = \
    range(11)
_KLD = 72          # floats a tile row (csrc/tile_mlp.cuh kLd)
_TILE = 64         # points a tile
_CHUNK_POINTS = 512
_MAX_SMEM = 232448  # shared memory a block can use on sm_90
# The reverse sweep takes about _REV_POINTS points of several forward
# chunks at once (a group: the CTA's partial dW is read and written once a
# group), its workspace within _REV_BYTES.
_REV_POINTS = 2048
_REV_BYTES = 4 << 30


def _rays_per_chunk(S: int) -> int:
    return max(1, _CHUNK_POINTS // S)


def _rev_group(nchunks: int, grid: int, chunk_points: int, chunk_ws: int) -> int:
    """Forward chunks a reverse sweep takes at once: about ``_REV_POINTS``
    points, no more than the waves of ``grid`` chunks, and ``grid`` groups'
    workspace (``chunk_ws`` floats a chunk) within ``_REV_BYTES``."""
    group = max(1, min(-(-nchunks // grid), _REV_POINTS // max(chunk_points, 1)))
    while group > 1 and 4 * grid * group * chunk_ws > _REV_BYTES:
        group -= 1
    return group


def _sweep_launch(field: nn.Module, fdesc: _build.MLPDesc, bwd: List[_build.MLPLayer], R: int,
                  S: int, device: torch.device, sem: bool = False, input_grads: bool = False,
                  rays_per_chunk: Optional[int] = None) -> Tuple[_build.TrainDesc, int, int]:
    """The train kernels' descriptor, grid (a CTA an SM, at most one a
    chunk) and group (:func:`_rev_group`) for ``R`` rays (or points) of
    ``S`` samples; the descriptor's planes hold a group of chunks."""
    one = train_desc(field, fdesc, bwd, S, sem, input_grads, rays_per_chunk)
    nchunks = -(-R // one.rays_per_chunk)
    grid = max(1, min(nchunks, torch.cuda.get_device_properties(device).multi_processor_count))
    group = _rev_group(nchunks, grid, one.rays_per_chunk * S, one.ws_size)
    return (train_desc(field, fdesc, bwd, S, sem, input_grads, one.rays_per_chunk, group),
            grid, group)


def grad_layout(field: nn.Module, sem: bool = False) -> Tuple[List[Tuple[int, int]], int]:
    """K3's gradient buffer: ``(dW offset, db offset)`` of every layer but the
    semantic head (with ``sem``, K6's: every layer), in kernel order (dW
    ``[k][pad8(n)]`` in ``pack_field``'s padded ``W^T`` layout, db
    ``[pad8(n)]``), and its size in floats."""
    offs, off = [], 0
    layers = _field_layers(field)
    for lin, segs in (layers if sem else layers[:field.mlp.depth + 4]):
        kpad, npad = sum(_pad8(k) for k in segs), _pad8(lin.out_features)
        offs.append((off, off + kpad * npad))
        off += kpad * npad + npad
    return offs, off


def train_desc(field: nn.Module, fdesc: _build.MLPDesc, bwd: List[_build.MLPLayer],
               S: int, sem: bool = False, input_grads: bool = False,
               rays_per_chunk: Optional[int] = None, group: int = 1) -> _build.TrainDesc:
    """K3's descriptor for ``S`` samples a ray: the forward and backward
    layers, the gradient layout and one CTA's workspace planes, sized for
    ``group`` chunks (the reverse sweep's, each chunk's subs after the last
    one's) of ``rays_per_chunk`` rays (default ``_rays_per_chunk(S)``; K3's
    and K6's forward take :func:`_wg_plan`'s). ``sem``
    (K6 with the semantic head): the semantic head's gradients and three
    planes more, after the trunk's: s_act, d_sem and ds. ``input_grads``
    (the field backward's input-gradient mode, K8c): two planes after
    those three (empty without the head), the cotangents of the point PE
    and of the view PE."""
    mlp = field.mlp
    W = mlp.width
    d = _build.TrainDesc()
    d.f = fdesc
    for i, L in enumerate(bwd):
        d.bwd[i] = L
    offs, d.grad_size = grad_layout(field, sem)
    for i, (gw, gb) in enumerate(offs):
        d.gw[i], d.gb[i] = gw, gb
    d.rays_per_chunk = rays_per_chunk or _rays_per_chunk(S)
    nsub = group * -(-d.rays_per_chunk * S // _TILE)
    rows = [_pad8(fdesc.emb_dim), _pad8(fdesc.demb_dim), _pad8(W), _pad8(W // 2), 8, 8,
            _pad8(W // 2), _pad8(W), _pad8(W), _pad8(W)] + [_pad8(W)] * mlp.depth
    if sem:
        hidden = _pad8(mlp.semantic_linear[0].out_features)
        rows += [hidden, 8, hidden]
    if input_grads:
        rows += ([] if sem else [0, 0, 0]) + [_pad8(fdesc.emb_dim), _pad8(fdesc.demb_dim)]
    off = 0
    for p, r in enumerate(rows):
        d.plane[p], d.rows[p] = off, r
        off += r * _KLD * nsub
    d.ws_size = off
    return d


def unpack_grads(field: nn.Module, flat: torch.Tensor, sem: bool = False
                 ) -> Dict[str, torch.Tensor]:
    """K3's (``sem``: K6's) gradient buffer -> grads keyed by
    ``field.named_parameters()`` names: the inverse of ``pack_field``'s
    layout (the padding rows of every input segment and the padding columns
    dropped, ``W^T`` transposed back). A layer outside the buffer (the
    semantic head, which K3 does not sweep) gets zeros."""
    names = {id(p): n for n, p in field.named_parameters()}
    offs, _ = grad_layout(field, sem)
    out = {}
    for i, (lin, segs) in enumerate(_field_layers(field)):
        if i >= len(offs):
            out[names[id(lin.weight)]] = torch.zeros_like(lin.weight)
            out[names[id(lin.bias)]] = torch.zeros_like(lin.bias)
            continue
        gw, gb = offs[i]
        npad, n = _pad8(lin.out_features), lin.out_features
        dw = flat[gw:gb].view(-1, npad)
        rows, r = [], 0
        for k in segs:
            rows.append(dw[r:r + k, :n])
            r += _pad8(k)
        out[names[id(lin.weight)]] = torch.cat(rows).t().contiguous()
        out[names[id(lin.bias)]] = flat[gb:gb + n].clone()
    return out


# K5 (csrc/train_render.cu frozen_sem_kernel): CTAs a cluster, sem_0 outputs
# a CTA, points a tile, W0 k-slices a ring stage, sem_in columns, most W0
# ring stages, bytes of a CTA's barriers
_SEM_RANKS, _SEM_COLS, _SEM_PTS, _SEM_KS, _MAX_SEM_ROWS, _MAX_SEM_WSTAGES, _SEM_BARS = \
    4, 32, 64, 4, 384, 6, 256


def pack_frozen(field: nn.Module, bf16: bool = False) -> Tuple[torch.Tensor, _build.FrozenDesc]:
    """K5's weights and descriptor (``xstages``/``wstages`` left 0: the
    wrapper sets them, :func:`_frozen_plan`). For each cluster rank ``r``
    (sem_0's outputs ``32 r .. 32 r + 31``), ``W0^T [C, hidden]`` with its
    rows padded to a multiple of 32 and its columns to 128 by zeros is cut
    into k-slices of 8 rows, each the slice's TF32 high parts, then its low
    parts, as ``[4][2][8][4]`` with element ``(j, h, r8, c) = W0^T[8 s +
    4 h + c][32 r + 8 j + r8]`` (:func:`pack_ring`'s wgmma B layout at
    N = 32); then sem_0's bias and sem_1's weight ``[sem_dim, hidden]``.
    The gradient buffer holds dW0 as ``W0^T [C, hidden]``, db0, dW1 as
    ``W1^T [hidden, sem_dim]`` and db1.

    ``bf16`` (K5 at bf16, ``d.bf16``): ``W0^T`` rounded to bf16, its rows
    padded to a multiple of 64, in k16 slices of 16 rows as ``[4][2][8][8]``
    bf16 with element ``(j, h, r8, c) = W0^T[16 s + 8 h + c][32 r + 8 j +
    r8]`` (``kslices`` counts k16 slices); two bf16 a float32 word."""
    lin0, lin2 = field.mlp.semantic_linear[0], field.mlp.semantic_linear[2]
    C, hidden, sem = lin0.in_features, lin0.out_features, lin2.out_features
    rows = 16 if bf16 else 8  # a k-slice's
    kslices = -(-C // (rows * _SEM_KS)) * _SEM_KS
    cols = _SEM_RANKS * _SEM_COLS
    wt = lin0.weight.detach().new_zeros((rows * kslices, cols))
    wt[:C, :min(hidden, cols)] = lin0.weight.detach().t()[:, :cols]
    if bf16:
        ring = (wt.to(torch.bfloat16).view(kslices, 2, 8, _SEM_RANKS, _SEM_COLS // 8, 8)
                .permute(3, 0, 4, 1, 5, 2).reshape(-1).view(torch.float32))
    else:
        hi = _tf32(wt)
        parts = torch.stack([hi, _tf32(wt - hi)])  # [part, 8 s + 4 h + c, 32 rank + 8 j + r8]
        ring = (parts.view(2, kslices, 2, 4, _SEM_RANKS, _SEM_COLS // 8, 8)
                .permute(4, 1, 0, 5, 2, 6, 3).reshape(-1))
    d = _build.FrozenDesc()
    d.bf16 = int(bf16)
    d.b0 = ring.numel()
    d.w1 = d.b0 + hidden
    d.C, d.kslices, d.hidden, d.sem_dim, d.n_maps = C, kslices, hidden, sem, 5 + sem
    d.gw0, d.gb0 = 0, C * hidden
    d.gw1 = d.gb0 + hidden
    d.gb1 = d.gw1 + hidden * sem
    d.grad_size = d.gb1 + sem
    buf = torch.cat([ring, lin0.bias.detach(), lin2.weight.detach().reshape(-1)])
    return buf.to(torch.float32).contiguous(), d


def unpack_frozen(field: nn.Module, flat: torch.Tensor, d: _build.FrozenDesc
                  ) -> Dict[str, torch.Tensor]:
    """K5's gradient buffer -> the semantic head's grads keyed by ``_SEM_NAMES``."""
    grads = (flat[d.gw0:d.gb0].view(d.C, d.hidden).t().contiguous(), flat[d.gb0:d.gw1].clone(),
             flat[d.gw1:d.gb1].view(d.hidden, d.sem_dim).t().contiguous(),
             flat[d.gb1:d.grad_size].clone())
    return dict(zip(_SEM_NAMES, grads))


def _sem_stage_bytes(d: _build.FrozenDesc) -> int:
    """Bytes of a W0 ring stage of K5: ``_SEM_KS`` k-slices (TF32 parts of
    8 rows, or bf16 of 16 rows)."""
    return (2 if d.bf16 else 4) * 16 * _SEM_COLS * _SEM_KS


def _frozen_smem(d: _build.FrozenDesc) -> int:
    """K5's shared memory (``frozen_smem`` in ``csrc/train_render.cu``): the
    barriers, the sem_in tile stages (bf16 at bf16), the tile's ds (TF32
    parts; bf16 at bf16, in the same room) and the W0 ring's stages."""
    return (_SEM_BARS + (2 if d.bf16 else 4) * d.xstages * _SEM_PTS * d.C
            + 4 * 2 * _SEM_PTS * _SEM_COLS + d.wstages * _sem_stage_bytes(d))


def _frozen_plan(d: _build.FrozenDesc) -> _build.FrozenDesc:
    """``d`` with K5's stages: two sem_in tile stages where they fit beside
    ds and at least two W0 stages, else one; as many W0 stages (2 to
    ``_MAX_SEM_WSTAGES``) as the rest holds. Raises for a head K5 does not
    take."""
    if d.C > _MAX_SEM_ROWS or d.hidden > _SEM_RANKS * _SEM_COLS or d.sem_dim > _MAX_SEM:
        raise NotImplementedError(f"semantic head {d.C} -> {d.hidden} -> {d.sem_dim} is "
                                  "outside K5")
    plan = _build.FrozenDesc.from_buffer_copy(d)
    for plan.xstages in (2, 1):
        plan.wstages = 2
        if _frozen_smem(plan) <= _MAX_SMEM:
            while (plan.wstages < _MAX_SEM_WSTAGES
                   and _frozen_smem(plan) + _sem_stage_bytes(plan) <= _MAX_SMEM):
                plan.wstages += 1
            return plan
    raise NotImplementedError(f"semantic head {d.C} -> {d.hidden}: K5's stages need "
                              f"{_frozen_smem(plan)} B of shared memory")


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


def _count(fn, bf16: bool) -> None:
    """One launch of ``fn``'s kernel in its fp32 or bf16 mode."""
    if bf16:
        fn.launches_bf16 += 1
    else:
        fn.launches += 1


def fused_coarse_weights(field: nn.Module, od: torch.Tensor, z: torch.Tensor,
                         compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K1: coarse eval pass, ``od [R, 6]``, ``z [R, S]`` -> weights ``[R, S]``;
    see :func:`coarse_weights_plain`. One launch of K4's kernel in its
    sigma-only mode (``csrc/train_render.cu``: the 128-point tile's trunk
    through its ring, the alpha head, the composite without noise), a CTA a
    chunk of :func:`_wg_plan`'s rays; at bf16 in the tile's bf16 mode."""
    if od.device.type == "cpu":
        return coarse_weights_plain(field, od, z, compute_dtype)
    if od.device.type != "cuda":
        raise NotImplementedError(f"no kernel for device {od.device}")
    _check_inputs(field, od, 6, z)
    bf16 = is_bf16(compute_dtype)
    R, S = z.shape
    weights = torch.empty((R, S), device=od.device, dtype=torch.float32)
    if R == 0:
        return weights
    buf, fdesc = _packed(field, od.device)
    rbuf, ring = _ring(field, od.device, bf16)
    desc = _build.TrainDesc()
    desc.f = fdesc
    desc.f.bf16 = int(bf16)
    desc.rays_per_chunk, rd = _wg_plan(fdesc, ring, S)
    with torch.cuda.device(od.device):
        code = _build.library().nerf_coarse_weights(
            od.data_ptr(), z.data_ptr(), buf.data_ptr(), rbuf.data_ptr(), ctypes.byref(desc),
            ctypes.byref(rd), weights.data_ptr(), R, S, _build.stream(od.device))
    _build.check(code, "fused_coarse_weights")
    _count(fused_coarse_weights, bf16)
    return weights


def fused_render(field: nn.Module, odv: torch.Tensor, z: torch.Tensor,
                 compute_dtype: torch.dtype = torch.float32
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: fine eval pass, ``odv [R, 9]``, ``z [R, S]`` -> (maps, weights);
    see :func:`render_plain`. One launch of K4's kernel without noise and
    without ``sem_in`` (:func:`train_render`'s 128-point tile, the weights
    from :func:`pack_ring` through its ring; the two functions are the same
    there), counted in ``fused_render.launches`` (``launches_bf16`` at
    bf16)."""
    if odv.device.type == "cpu":
        return render_plain(field, odv, z, compute_dtype)
    if odv.device.type != "cuda":
        raise NotImplementedError(f"no kernel for device {odv.device}")
    _check_inputs(field, odv, 9, z)
    bf16 = is_bf16(compute_dtype)
    maps, weights, _ = _tile_forward(field, odv, z, 0.0, 0, False, bf16)
    if z.shape[0] > 0:
        _count(fused_render, bf16)
    return maps, weights


def fused_rgb_train_grads(field: nn.Module, odv: torch.Tensor, z: torch.Tensor, gt: torch.Tensor,
                          *, white_bkgd: bool, noise_std: float, seed: int,
                          compute_dtype: torch.dtype = torch.float32
                          ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor, torch.Tensor]:
    """K3: one RGB train pass, ``odv [R, 9]``, ``z [R, S]``, ``gt [R, 3]`` ->
    (unscaled grads by parameter name, maps ``[R, 5 + sem]``, weights
    ``[R, S]``); see :func:`rgb_train_grads_plain`. ``seed`` (an int) seeds the
    sigma noise when ``noise_std > 0``. One call launches the forward (on
    K4's 128-point tile, the weights from :func:`pack_ring` through its ring)
    and the reverse-sweep kernels (the input-gradient matrices from
    :func:`pack_bwd_ring` through the reverse sweep's ring) once per wave of
    chunks and the reduction, and adds one to ``launches``. At bf16 the
    kernels' bf16 modes (the rings in their bf16 layouts), counted in
    ``launches_bf16``."""
    if odv.device.type == "cpu":
        return rgb_train_grads_plain(field, odv, z, gt, white_bkgd=white_bkgd,
                                     noise_std=noise_std, seed=seed, compute_dtype=compute_dtype)
    if odv.device.type != "cuda":
        raise NotImplementedError(f"no kernel for device {odv.device}")
    _check_inputs(field, odv, 9, z)
    if gt.device != odv.device or gt.dtype != torch.float32 or not gt.is_contiguous():
        raise ValueError(f"gt must be contiguous float32 on {odv.device}")
    if tuple(gt.shape) != (odv.shape[0], 3):
        raise ValueError(f"expected gt [R, 3], got {tuple(gt.shape)}")
    bf16 = is_bf16(compute_dtype)
    flat, maps, weights, _ = _train_grads_launch(field, odv, z, gt, None, noise_std=noise_std,
                                                 seed=seed, white_bkgd=white_bkgd, bf16=bf16)
    if z.shape[0] > 0:
        _count(fused_rgb_train_grads, bf16)
    return unpack_grads(field, flat), maps, weights


def _train_grads_launch(field: nn.Module, odv: torch.Tensor, z: torch.Tensor, aux: torch.Tensor,
                        dweights: Optional[torch.Tensor], *, noise_std: float, seed: int,
                        white_bkgd: Optional[bool], bf16: bool):
    """K3's (``white_bkgd`` given: ``aux`` is gt) or K6's (``white_bkgd``
    None: ``aux`` is dmaps, with ``dweights``) launches on checked CUDA
    inputs, none for ``R == 0``: the storing forward on K4's tile (a chunk
    of :func:`_wg_plan`'s rays, the weights from :func:`pack_ring` through
    its ring) and the reverse sweep in waves (the input-gradient matrices
    from :func:`pack_bwd_ring` through its ring), then the reduction; with
    ``bf16`` both in their bf16 modes, the rings in their bf16 layouts.
    Returns the flat gradient buffer, K3's maps and weights (None for K6)
    and ``(workspace, train_desc, grid, group)``: after a call of one wave
    (a chunk a CTA, group 1) each CTA's slice of the workspace holds its
    chunk's planes."""
    R, S = z.shape
    k3 = white_bkgd is not None
    sem = field.mlp.use_semantics and not k3
    buf, fdesc = _packed(field, odv.device)
    rbuf, ring = _ring(field, odv.device, bf16)
    rpc, rd = _wg_plan(fdesc, ring, S)
    bwd = _train_bwd(field, odv.device)[1]
    bring, brd = _bwd_ring(field, odv.device, bf16)
    desc, grid, group = _sweep_launch(field, fdesc, bwd, R, S, odv.device, sem,
                                      rays_per_chunk=rpc)
    desc.f.bf16 = int(bf16)
    maps = weights = None
    if k3:
        maps = torch.empty((R, 5 + fdesc.sem_dim), device=odv.device, dtype=torch.float32)
        weights = torch.empty((R, S), device=odv.device, dtype=torch.float32)
    flat = torch.zeros(desc.grad_size, device=odv.device, dtype=torch.float32)
    work = torch.empty(grid * desc.ws_size if R > 0 else 0, device=odv.device,
                       dtype=torch.float32)
    if R > 0:
        partial = torch.empty(grid * desc.grad_size, device=odv.device, dtype=torch.float32)
        lib = _build.library()
        with torch.cuda.device(odv.device):
            if k3:
                code = lib.nerf_rgb_train_grads(
                    odv.data_ptr(), z.data_ptr(), aux.data_ptr(), buf.data_ptr(),
                    rbuf.data_ptr(), bring.data_ptr(), ctypes.byref(desc), ctypes.byref(rd),
                    ctypes.byref(brd), maps.data_ptr(), weights.data_ptr(), partial.data_ptr(),
                    work.data_ptr(), flat.data_ptr(), R, S, grid, group, noise_seed(seed),
                    float(noise_std), int(white_bkgd), _build.stream(odv.device))
            else:
                code = lib.nerf_train_render_grads(
                    odv.data_ptr(), z.data_ptr(), aux.data_ptr(),
                    None if dweights is None else dweights.data_ptr(), buf.data_ptr(),
                    rbuf.data_ptr(), bring.data_ptr(), ctypes.byref(desc), ctypes.byref(rd),
                    ctypes.byref(brd), partial.data_ptr(), work.data_ptr(), flat.data_ptr(), R,
                    S, grid, group, noise_seed(seed), float(noise_std),
                    _build.stream(odv.device))
        _build.check(code, "fused_rgb_train_grads" if k3 else "train_render_grads")
    return flat, maps, weights, (work, desc, grid, group)


def _wg_smem(fdesc: _build.MLPDesc, rd: _build.RingDesc, rays_per_chunk: int, S: int) -> int:
    """Shared memory of K4's kernel (K4, K2, K1, K9, K10a) and of K3's, K6's
    and K10b's forward (``wg_smem`` in ``csrc/train_render.cu``): the
    ring's barriers and stages, two warpgroups' emb, demb and h tiles of
    64 points, and the chunk's composite strip."""
    rows = _pad8(fdesc.emb_dim) + _pad8(fdesc.demb_dim) + rd.hrows
    strip = -(-rays_per_chunk * S * (6 + fdesc.sem_dim) // 4) * 4
    return 128 + 4 * (rd.stages * rd.stage_floats + 2 * rows * _TILE + strip)


def _wg_plan(fdesc: _build.MLPDesc, ring: _build.RingDesc, S: int) -> Tuple[int, _build.RingDesc]:
    """The 128-point tile's chunk (K4's kernel in each of its modes, and K3's,
    K6's and K10b's forward's: ``_rays_per_chunk(S)``, fewer rays where the strip
    and two ring stages would not fit) and its ring descriptor with as many
    stages (2 to ``MAX_RING_STAGES``) as the rest of shared memory holds."""
    rd = _build.RingDesc.from_buffer_copy(ring)
    rd.stages = 2
    rpc = _rays_per_chunk(S)
    while rpc > 1 and _wg_smem(fdesc, rd, rpc, S) > _MAX_SMEM:
        rpc -= 1
    if _wg_smem(fdesc, rd, rpc, S) > _MAX_SMEM:
        raise NotImplementedError(f"S={S}: K4's tiles, ring and composite strip need "
                                  f"{_wg_smem(fdesc, rd, rpc, S)} B of shared memory")
    while (rd.stages < _build.MAX_RING_STAGES
           and _wg_smem(fdesc, rd, rpc, S) + 4 * rd.stage_floats <= _MAX_SMEM):
        rd.stages += 1
    return rpc, rd


def _tile_forward(field: nn.Module, odv: torch.Tensor, z: torch.Tensor, noise_std: float,
                  seed: int, save_semin: bool, bf16: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """One launch of K4's kernel (``csrc/train_render.cu``
    ``train_render_wg_kernel``) on checked CUDA inputs, none for ``R == 0``:
    a CTA a chunk of :func:`_wg_plan`'s rays in tiles of 128 points, the
    weights from :func:`pack_ring` through its ring; raises where the plan
    does not fit. ``bf16``: the tile's bf16 mode, ``sem_in`` in bf16."""
    R, S = z.shape
    buf, fdesc = _packed(field, odv.device)
    rbuf, ring = _ring(field, odv.device, bf16)
    desc = _build.TrainDesc()
    desc.f = fdesc
    desc.f.bf16 = int(bf16)
    desc.rays_per_chunk, rd = _wg_plan(fdesc, ring, S)
    maps = torch.empty((R, 5 + fdesc.sem_dim), device=odv.device, dtype=torch.float32)
    weights = torch.empty((R, S), device=odv.device, dtype=torch.float32)
    sem_in = (torch.empty((R * S, field.mlp.semantic_linear[0].in_features), device=odv.device,
                          dtype=torch.bfloat16 if bf16 else torch.float32)
              if save_semin else None)
    if R > 0:
        with torch.cuda.device(odv.device):
            code = _build.library().nerf_train_render(
                odv.data_ptr(), z.data_ptr(), buf.data_ptr(), rbuf.data_ptr(), ctypes.byref(desc),
                ctypes.byref(rd), maps.data_ptr(), weights.data_ptr(),
                None if sem_in is None else sem_in.data_ptr(), R, S, noise_seed(seed),
                float(noise_std), _build.stream(odv.device))
        _build.check(code, "nerf_train_render")
    return maps, weights, sem_in


def train_render(field: nn.Module, odv: torch.Tensor, z: torch.Tensor, *, noise_std: float,
                 seed: int, save_semin: bool, compute_dtype: torch.dtype = torch.float32
                 ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """K4: the train forward, ``odv [R, 9]``, ``z [R, S]`` -> (maps, weights,
    ``sem_in [R * S, C]`` (bf16 at bf16) or None); see
    :func:`train_render_plain`. One launch: a CTA a chunk of rays in tiles
    of 128 points, the weights from :func:`pack_ring` through its ring
    (``csrc/wg_tile.cuh``; at bf16 in its bf16 mode)."""
    if odv.device.type == "cpu":
        return train_render_plain(field, odv, z, noise_std=noise_std, seed=seed,
                                  save_semin=save_semin, compute_dtype=compute_dtype)
    if odv.device.type != "cuda":
        raise NotImplementedError(f"no kernel for device {odv.device}")
    _check_inputs(field, odv, 9, z)
    if save_semin and not field.mlp.use_semantics:
        raise ValueError("save_semin needs the semantic head")
    bf16 = is_bf16(compute_dtype)
    out = _tile_forward(field, odv, z, noise_std, seed, save_semin, bf16)
    if z.shape[0] > 0:
        _count(train_render, bf16)
    return out


_FROZEN_CLUSTERS: Dict[Tuple[torch.device, int], int] = {}


def _frozen_clusters(device: torch.device, d: _build.FrozenDesc) -> int:
    """K5's clusters that run at once on ``device`` with ``d``'s shared
    memory (the card's occupancy calculator: four SMs of one GPC each), so
    that one wave of clusters covers the points; per device and size."""
    key = (device, _frozen_smem(d))
    if key not in _FROZEN_CLUSTERS:
        n = ctypes.c_int()
        with torch.cuda.device(device):
            _build.check(_build.library().nerf_frozen_sem_clusters(ctypes.byref(d),
                                                                    ctypes.byref(n)),
                         "nerf_frozen_sem_clusters")
        _FROZEN_CLUSTERS[key] = max(1, n.value)
    return _FROZEN_CLUSTERS[key]


def frozen_sem_grads(field: nn.Module, sem_in: torch.Tensor, weights: torch.Tensor,
                     dmaps: torch.Tensor, compute_dtype: torch.dtype = torch.float32
                     ) -> Dict[str, torch.Tensor]:
    """K5: the semantic head's gradients from the stored ``sem_in [R * S, C]``
    (of ``compute_dtype``: bf16 at bf16), the forward's ``weights [R, S]``
    and the maps' cotangent ``dmaps [R, 5 + sem]``; see
    :func:`frozen_sem_grads_plain`. One call launches the kernel (clusters
    of four CTAs, each cluster over a run of 64-point tiles of sem_in
    multicast to its CTAs, each CTA 32 of sem_0's outputs, a partial
    gradient buffer a cluster; at bf16 in its bf16 mode) and the reduction
    of the partials in cluster order, and adds one to ``launches``
    (``launches_bf16``)."""
    if sem_in.device.type == "cpu":
        return frozen_sem_grads_plain(field, sem_in, weights, dmaps, compute_dtype)
    if sem_in.device.type != "cuda":
        raise NotImplementedError(f"no kernel for device {sem_in.device}")
    bf16 = is_bf16(compute_dtype)
    R, S = weights.shape
    C = field.mlp.semantic_linear[0].in_features
    for name, t, shape, dtype in (
            ("sem_in", sem_in, (R * S, C), compute_dtype),
            ("weights", weights, (R, S), torch.float32),
            ("dmaps", dmaps, (R, 5 + field.mlp.semantic_linear[2].out_features), torch.float32)):
        if t.device != sem_in.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dtype} on {sem_in.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"expected {name} {shape}, got {tuple(t.shape)}")
    if sem_in.data_ptr() % 16:
        raise ValueError("sem_in must start on a 16-byte boundary (its tiles are bulk copies)")
    if bf16:
        buf, d = _cached(field, sem_in.device, "_frozen_pack_bf16",
                         lambda f: pack_frozen(f, bf16=True))
    else:
        buf, d = _cached(field, sem_in.device, "_frozen_pack", pack_frozen)
    d = _frozen_plan(d)
    flat = torch.zeros(d.grad_size, device=sem_in.device, dtype=torch.float32)
    P = R * S
    if P > 0:
        ntiles = -(-P // _SEM_PTS)
        per = -(-ntiles // min(ntiles, _frozen_clusters(sem_in.device, d)))
        clusters = -(-ntiles // per)
        partial = torch.empty(clusters * d.grad_size, device=sem_in.device, dtype=torch.float32)
        with torch.cuda.device(sem_in.device):
            code = _build.library().nerf_frozen_sem_grads(
                sem_in.data_ptr(), weights.data_ptr(), dmaps.data_ptr(), buf.data_ptr(),
                ctypes.byref(d), partial.data_ptr(), flat.data_ptr(), P, S, clusters, per,
                _build.stream(sem_in.device))
        _build.check(code, "frozen_sem_grads")
        _count(frozen_sem_grads, bf16)
    return unpack_frozen(field, flat, d)


def train_render_grads(field: nn.Module, odv: torch.Tensor, z: torch.Tensor,
                       dmaps: torch.Tensor, dweights: Optional[torch.Tensor], *,
                       noise_std: float, seed: int,
                       compute_dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """K6: the gradients of every parameter of the field from the maps'
    cotangent ``dmaps [R, 5 + sem]`` and the weights' ``dweights [R, S]``
    (None: zero), recomputing the forward of ``odv [R, 9]``, ``z [R, S]``
    with the noise of ``seed``; see :func:`train_render_grads_plain`. One call
    launches K3's forward (on K4's tile) and reverse-sweep kernels (its
    input-gradient products through the ring of :func:`pack_bwd_ring`) in
    their cotangent mode once per wave of chunks and the reduction, and adds
    one to ``launches``. At bf16 the kernels' bf16 modes, counted in
    ``launches_bf16``."""
    if odv.device.type == "cpu":
        return train_render_grads_plain(field, odv, z, dmaps, dweights, noise_std=noise_std,
                                        seed=seed, compute_dtype=compute_dtype)
    if odv.device.type != "cuda":
        raise NotImplementedError(f"no kernel for device {odv.device}")
    _check_inputs(field, odv, 9, z)
    R, S = z.shape
    buf, fdesc = _packed(field, odv.device)
    for name, t, shape in (("dmaps", dmaps, (R, 5 + fdesc.sem_dim)),
                           ("dweights", dweights, (R, S))):
        if t is None:
            continue
        if t.device != odv.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 on {odv.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"expected {name} {shape}, got {tuple(t.shape)}")
    bf16 = is_bf16(compute_dtype)
    flat, *_ = _train_grads_launch(field, odv, z, dmaps, dweights, noise_std=noise_std,
                                   seed=seed, white_bkgd=None, bf16=bf16)
    if R > 0:
        _count(train_render_grads, bf16)
    return unpack_grads(field, flat, field.mlp.use_semantics)


class _TrainRender(torch.autograd.Function):
    """K4 forward. Backward with ``frozen``: K5, only the semantic head's
    leaves get gradients (every other leaf None; the weights' cotangent is
    dropped, as nothing but the semantic columns of the maps depends on the
    head). Without ``frozen``: K6, every leaf from the maps' and the
    weights' cotangents. Rays and z get no cotangent; an output that nothing
    used gets None as its cotangent (a zero one). K4, K5 and K6 run at
    ``compute_dtype``."""

    @staticmethod
    def forward(ctx, field, odv, z, noise_std, seed, frozen, save, compute_dtype, *params):
        maps, w, sem_in = train_render(field, odv, z, noise_std=noise_std, seed=seed,
                                       save_semin=save, compute_dtype=compute_dtype)
        ctx.field, ctx.frozen, ctx.save, ctx.noise = field, frozen, save, (noise_std, seed)
        ctx.compute_dtype = compute_dtype
        ctx.maps_shape = maps.shape
        ctx.set_materialize_grads(False)
        if save:
            ctx.save_for_backward(sem_in, w)
        elif not frozen:
            ctx.save_for_backward(odv, z)
        return maps, w

    @staticmethod
    def backward(ctx, dmaps, dweights):
        names = [n for n, _ in ctx.field.named_parameters()]
        grads = {}
        if ctx.frozen:
            if ctx.save and dmaps is not None:
                sem_in, w = ctx.saved_tensors
                grads = frozen_sem_grads(ctx.field, sem_in, w, dmaps.contiguous(),
                                         ctx.compute_dtype)
        elif dmaps is not None or dweights is not None:
            odv, z = ctx.saved_tensors
            if dmaps is None:
                dmaps = odv.new_zeros(ctx.maps_shape)
            grads = train_render_grads(ctx.field, odv, z, dmaps.contiguous(),
                                       None if dweights is None else dweights.contiguous(),
                                       noise_std=ctx.noise[0], seed=ctx.noise[1],
                                       compute_dtype=ctx.compute_dtype)
        return (None,) * 8 + tuple(grads.get(n) for n in names)


def fused_train_render(field: nn.Module, odv: torch.Tensor, z: torch.Tensor, *,
                       noise_std: float, seed: int, frozen: bool,
                       compute_dtype: torch.dtype = torch.float32
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The differentiable train render of one pass (replaces
    ``fused_train_render_planar``): ``odv [R, 9]``, ``z [R, S]`` -> (maps
    ``[R, 5 + sem]``, weights ``[R, S]``) through K4. With ``frozen`` (the
    ``--fix_backbone`` finetune) its backward is K5; ``sem_in`` is stored
    only when a gradient can be asked for. Without ``frozen`` the backward is
    K6, which recomputes the forward and stores no ``sem_in``. At bf16 K4,
    K5 and K6 run their bf16 modes."""
    params = list(field.parameters())
    grad = torch.is_grad_enabled() and any(p.requires_grad for p in params)
    save = frozen and field.mlp.use_semantics and grad
    return _TrainRender.apply(field, odv, z, float(noise_std), int(seed), bool(frozen), save,
                              compute_dtype, *params)


def _mip_shapes(field: nn.Module, odvr: torch.Tensor, z: torch.Tensor) -> Tuple[int, int]:
    """Checks the inputs of a mip kernel; returns (R, S intervals)."""
    _check_inputs(field, odvr, 10, z)
    if z.shape[1] < 2:
        raise ValueError(f"z holds fenceposts [R, S + 1] with S >= 1, got {tuple(z.shape)}")
    if field.mlp.use_semantics:
        raise NotImplementedError("the mip kernels have no semantic head")
    return z.shape[0], z.shape[1] - 1


def _mip_forward(field: nn.Module, odvr: torch.Tensor, z: torch.Tensor, noise_std: float,
                 seed: int, bf16: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of K4's kernel in its mip mode (K9 without noise, K10a
    with; ``csrc/train_render.cu`` ``train_render_wg_kernel<kInMip>``) on
    checked CUDA inputs, none for ``R == 0``: a CTA a chunk of
    :func:`_wg_plan`'s rays in tiles of 128 intervals, the weights from
    :func:`pack_ring` through its ring; raises where the plan does not fit.
    ``bf16``: the tile's bf16 mode, the ring in its bf16 layout."""
    R, S = _mip_shapes(field, odvr, z)
    buf, fdesc = _packed(field, odvr.device)
    rbuf, ring = _ring(field, odvr.device, bf16)
    desc = _build.TrainDesc()
    desc.f = fdesc
    desc.f.bf16 = int(bf16)
    desc.rays_per_chunk, rd = _wg_plan(fdesc, ring, S)
    maps = torch.empty((R, 5), device=odvr.device, dtype=torch.float32)
    weights = torch.empty((R, S), device=odvr.device, dtype=torch.float32)
    if R > 0:
        with torch.cuda.device(odvr.device):
            code = _build.library().nerf_mip_render(
                odvr.data_ptr(), z.data_ptr(), buf.data_ptr(), rbuf.data_ptr(),
                ctypes.byref(desc), ctypes.byref(rd), maps.data_ptr(), weights.data_ptr(), R, S,
                noise_seed(seed), float(noise_std), _build.stream(odvr.device))
        _build.check(code, "nerf_mip_render")
    return maps, weights


def fused_mip_render(field: nn.Module, odvr: torch.Tensor, z: torch.Tensor,
                     compute_dtype: torch.dtype = torch.float32
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K9: the mip eval pass, ``odvr [R, 10]``, fenceposts ``z [R, S + 1]``
    -> (maps ``[R, 5]``, weights ``[R, S]``); see :func:`mip_render_plain`.
    One launch of K4's kernel in its mip mode without noise
    (:func:`_mip_forward`; at bf16 in its bf16 mode), counted in
    ``fused_mip_render.launches`` (``launches_bf16``)."""
    if odvr.device.type == "cpu":
        return mip_render_plain(field, odvr, z, compute_dtype)
    if odvr.device.type != "cuda":
        raise NotImplementedError(f"no kernel for device {odvr.device}")
    bf16 = is_bf16(compute_dtype)
    out = _mip_forward(field, odvr, z, 0.0, 0, bf16)
    if z.shape[0] > 0:
        _count(fused_mip_render, bf16)
    return out


def mip_train_render(field: nn.Module, odvr: torch.Tensor, z: torch.Tensor, *,
                     noise_std: float, seed: int, compute_dtype: torch.dtype = torch.float32
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K10a: the mip train forward, ``odvr [R, 10]``, ``z [R, S + 1]`` ->
    (maps, weights) with the sigma noise of ``seed``; see
    :func:`mip_train_render_plain`. One launch of K4's kernel in its mip
    mode (:func:`_mip_forward`; at bf16 in its bf16 mode)."""
    if odvr.device.type == "cpu":
        return mip_train_render_plain(field, odvr, z, noise_std=noise_std, seed=seed,
                                      compute_dtype=compute_dtype)
    if odvr.device.type != "cuda":
        raise NotImplementedError(f"no kernel for device {odvr.device}")
    bf16 = is_bf16(compute_dtype)
    out = _mip_forward(field, odvr, z, noise_std, seed, bf16)
    if z.shape[0] > 0:
        _count(mip_train_render, bf16)
    return out


def _mip_grads_launch(field: nn.Module, odvr: torch.Tensor, z: torch.Tensor,
                      dmaps: torch.Tensor, dweights: Optional[torch.Tensor], noise_std: float,
                      seed: int, bf16: bool = False):
    """K10b's launches on checked CUDA inputs (none for ``R == 0``): K6's
    storing forward on K4's tile in its mip mode (a chunk of
    :func:`_wg_plan`'s rays, the weights from :func:`pack_ring` through its
    ring) and reverse sweep in waves, and the reduction; with ``bf16`` both
    in their bf16 modes, the rings in their bf16 layouts. Returns the flat
    gradient buffer and ``(workspace, train_desc, grid, group)``, as
    :func:`_train_grads_launch` does."""
    R, S = z.shape[0], z.shape[1] - 1
    buf, fdesc = _packed(field, odvr.device)
    rbuf, ring = _ring(field, odvr.device, bf16)
    rpc, rd = _wg_plan(fdesc, ring, S)
    bwd = _train_bwd(field, odvr.device)[1]
    bring, brd = _bwd_ring(field, odvr.device, bf16)
    desc, grid, group = _sweep_launch(field, fdesc, bwd, R, S, odvr.device, rays_per_chunk=rpc)
    desc.f.bf16 = int(bf16)
    flat = torch.zeros(desc.grad_size, device=odvr.device, dtype=torch.float32)
    work = torch.empty(grid * desc.ws_size if R > 0 else 0, device=odvr.device,
                       dtype=torch.float32)
    if R > 0:
        partial = torch.empty(grid * desc.grad_size, device=odvr.device, dtype=torch.float32)
        with torch.cuda.device(odvr.device):
            code = _build.library().nerf_mip_train_render_grads(
                odvr.data_ptr(), z.data_ptr(), dmaps.data_ptr(),
                None if dweights is None else dweights.data_ptr(), buf.data_ptr(),
                rbuf.data_ptr(), bring.data_ptr(), ctypes.byref(desc), ctypes.byref(rd),
                ctypes.byref(brd), partial.data_ptr(), work.data_ptr(), flat.data_ptr(), R, S,
                grid, group, noise_seed(seed), float(noise_std), _build.stream(odvr.device))
        _build.check(code, "mip_train_render_grads")
    return flat, (work, desc, grid, group)


def mip_train_render_grads(field: nn.Module, odvr: torch.Tensor, z: torch.Tensor,
                           dmaps: torch.Tensor, dweights: Optional[torch.Tensor], *,
                           noise_std: float, seed: int,
                           compute_dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """K10b: the gradients of every parameter of the mip field from the
    maps' cotangent ``dmaps [R, 5]`` and the weights' ``dweights [R, S]``
    (None: zero), recomputing the forward of ``odvr [R, 10]``,
    ``z [R, S + 1]`` with the noise of ``seed``; see
    :func:`mip_train_render_grads_plain`. One call launches K6's forward (on
    K4's tile in its mip mode, a chunk of :func:`_wg_plan`'s rays, the
    weights from :func:`pack_ring` through its ring) and reverse-sweep
    kernels (through the ring of :func:`pack_bwd_ring`) in their mip
    cotangent mode once per wave of chunks and the reduction, and adds one
    to ``launches``. At bf16 the kernels' bf16 modes, counted in
    ``launches_bf16``."""
    if odvr.device.type == "cpu":
        return mip_train_render_grads_plain(field, odvr, z, dmaps, dweights,
                                            noise_std=noise_std, seed=seed,
                                            compute_dtype=compute_dtype)
    if odvr.device.type != "cuda":
        raise NotImplementedError(f"no kernel for device {odvr.device}")
    R, S = _mip_shapes(field, odvr, z)
    for name, t, shape in (("dmaps", dmaps, (R, 5)), ("dweights", dweights, (R, S))):
        if t is None:
            continue
        if t.device != odvr.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 on {odvr.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"expected {name} {shape}, got {tuple(t.shape)}")
    bf16 = is_bf16(compute_dtype)
    flat, _ = _mip_grads_launch(field, odvr, z, dmaps, dweights, noise_std, seed, bf16)
    if R > 0:
        _count(mip_train_render_grads, bf16)
    return unpack_grads(field, flat)


class _MipTrainRender(torch.autograd.Function):
    """K10a forward, K10b backward: every leaf from the maps' and the
    weights' cotangents; rays and z get none. An output that nothing used
    gets None as its cotangent (a zero one). Both run at ``compute_dtype``."""

    @staticmethod
    def forward(ctx, field, odvr, z, noise_std, seed, compute_dtype, *params):
        maps, w = mip_train_render(field, odvr, z, noise_std=noise_std, seed=seed,
                                   compute_dtype=compute_dtype)
        ctx.field, ctx.noise, ctx.maps_shape = field, (noise_std, seed), maps.shape
        ctx.compute_dtype = compute_dtype
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(odvr, z)
        return maps, w

    @staticmethod
    def backward(ctx, dmaps, dweights):
        names = [n for n, _ in ctx.field.named_parameters()]
        grads = {}
        if dmaps is not None or dweights is not None:
            odvr, z = ctx.saved_tensors
            if dmaps is None:
                dmaps = odvr.new_zeros(ctx.maps_shape)
            grads = mip_train_render_grads(ctx.field, odvr, z, dmaps.contiguous(),
                                           None if dweights is None else dweights.contiguous(),
                                           noise_std=ctx.noise[0], seed=ctx.noise[1],
                                           compute_dtype=ctx.compute_dtype)
        return (None,) * 6 + tuple(grads.get(n) for n in names)


def fused_mip_train_render(field: nn.Module, odvr: torch.Tensor, z: torch.Tensor, *,
                           noise_std: float, seed: int,
                           compute_dtype: torch.dtype = torch.float32
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The differentiable mip train render of one pass (replaces
    ``fused_mip_train_render_planar``): ``odvr [R, 10]``, ``z [R, S + 1]``
    -> (maps ``[R, 5]``, weights ``[R, S]``) through K10a, whose backward is
    K10b (it recomputes the forward; nothing is stored but the inputs). At
    bf16 both run their bf16 modes."""
    return _MipTrainRender.apply(field, odvr, z, float(noise_std), int(seed), compute_dtype,
                                 *field.parameters())


for _fn in (fused_coarse_weights, fused_render, fused_rgb_train_grads, train_render,
            frozen_sem_grads, train_render_grads, fused_mip_render, mip_train_render,
            mip_train_render_grads):
    _fn.launches = 0
    _fn.launches_bf16 = 0  # the bf16 modes' launches
del _fn
