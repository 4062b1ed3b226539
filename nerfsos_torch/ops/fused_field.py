"""The radiance field queried point by point: its forward, its density
alone and its backward, as hand-written CUDA kernels.

Port of ``nerfsos_tpu/ops/pallas/fused_field.py`` and of K11, one kernel per
role (``csrc/fused_field.cu``). The JAX package's row-major and
channel-major twins differ in their IO layout alone; the port's is the
plain ``NeRFField``'s, ``[N, 3]`` in and ``[N, C]`` out:

- :func:`fused_sigma_apply` (K8a ``fused_sigma_apply`` and K8e
  ``fused_sigma_apply_planar``): ``pts [N, 3]`` -> sigma ``[N]`` from the
  trunk and the alpha head;
- :func:`field_forward` (K8b ``_fused_forward`` and K8d
  ``_fused_forward_pl``): ``pts, dirs [N, 3]`` -> raw ``[N, 4 + sem]``
  (rgb logits, sigma, semantics);
- :func:`fused_mip_field_apply` (K11 ``fused_mip_apply_planar``): the mip
  field at diagonal Gaussians ``mean, cov [N, 3]`` seen from ``dirs`` ->
  raw ``[N, 4]``; also at ``compute_dtype=torch.bfloat16`` (the tile's bf16
  mode: the integrated PE formed in float32, then rounded, every product
  on bf16 operands, as ``_field_kernel_pl`` at bf16), counted in
  ``launches_bf16``;
- :func:`field_grads` (K8f ``_fused_backward_pl``, and K8c
  ``_fused_backward`` in its input-gradient mode): the gradients of every
  parameter from a cotangent ``g [N, 4 + sem]`` of raw, and in the
  input-gradient mode those of ``pts`` and ``dirs``;
- :func:`fused_field_apply`: :func:`field_forward` with :func:`field_grads`
  as its backward (``_FieldFn``); the input-gradient mode runs when
  autograd asks for the points' or the directions' gradient, which stands
  in for the JAX package's ``cfg.field_input_grads``.

The three forwards run K4's 128-point tile (``csrc/wg_tile.cuh``) in its
point-list modes (``csrc/fused_field.cu`` ``field_wg_kernel``): a CTA a run
of :func:`_field_plan`'s tiles, the weights from ``fused_render.pack_ring``
through the tile's ring. The backward's forward runs the same tile in its
storing point-list mode (``field_bwd_forward_kernel``), with the same ring.
Each wrapper runs its plain PyTorch version (:func:`sigma_plain`,
:func:`field_plain`, :func:`mip_field_plain`, :func:`field_grads_plain`,
same signature) for tensors on the CPU, and for CUDA tensors launches its
kernel or raises; it never falls back.
``<wrapper>.launches`` counts the launches
(``field_grads.input_grad_launches`` those in the input-gradient mode).
The weights are packed by ``ops/fused_render.py``'s packers.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from nerfsos_torch import _build
from nerfsos_torch.ops import fused_render as fr

# ----------------------------------------------------------------- plain versions


def field_plain(field: nn.Module, pts: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Plain version of the field forward: the ``NeRFField`` at ``pts [N, 3]``
    seen from ``dirs [N, 3]`` -> raw ``[N, 4 + sem]``."""
    return field(pts[:, None, :], dirs)[:, 0]


def sigma_plain(field: nn.Module, pts: torch.Tensor) -> torch.Tensor:
    """Plain version of the sigma forward: ``NeRFField.sigma`` of ``pts
    [N, 3]`` -> ``[N]``."""
    return field.sigma(pts)


def mip_field_plain(field: nn.Module, mean: torch.Tensor, cov: torch.Tensor,
                    dirs: torch.Tensor, compute_dtype: torch.dtype = torch.float32
                    ) -> torch.Tensor:
    """Plain version of K11: the ``MipNeRFField`` at the Gaussians ``mean``
    and diagonal ``cov [N, 3]`` seen from ``dirs [N, 3]`` -> raw ``[N, 4]``,
    its products those of the kernel at ``compute_dtype``
    (``fused_render.kernel_dense``)."""
    return field(mean[:, None, :], cov[:, None, :], dirs,
                 dense=fr.kernel_dense(compute_dtype))[:, 0]


def field_grads_plain(field: nn.Module, pts: torch.Tensor, dirs: torch.Tensor, g: torch.Tensor,
                      *, input_grads: bool
                      ) -> Tuple[Dict[str, torch.Tensor], Optional[torch.Tensor],
                                 Optional[torch.Tensor]]:
    """Plain version of the field backward: autograd of ``sum(g *
    field_plain(field, pts, dirs))``. Returns (the gradient of every
    parameter, keyed by ``field.named_parameters()`` names; with
    ``input_grads`` those of ``pts`` and ``dirs`` ``[N, 3]``, else None and
    None). Runs in chunks of points, each chunk's graph freed before the
    next."""
    leaves = {n: p.detach().requires_grad_() for n, p in field.named_parameters()}
    grads = {n: torch.zeros_like(p) for n, p in leaves.items()}
    dpts, ddirs = [], []
    step = fr._PLAIN_CHUNK_POINTS
    with torch.enable_grad():
        for i in range(0, pts.shape[0], step):
            p = pts[i:i + step].detach().requires_grad_(input_grads)
            d = dirs[i:i + step].detach().requires_grad_(input_grads)
            raw = torch.func.functional_call(field, leaves, (p[:, None, :], d))[:, 0]
            wrt = list(leaves.values()) + ([p, d] if input_grads else [])
            out = torch.autograd.grad(torch.sum(g[i:i + step] * raw), wrt, allow_unused=True)
            for n, gn in zip(leaves, out):
                if gn is not None:
                    grads[n] += gn
            if input_grads:
                dpts.append(out[-2])
                ddirs.append(out[-1])
    if not input_grads:
        return grads, None, None
    empty = pts.new_zeros((0, 3))
    return grads, torch.cat(dpts) if dpts else empty, torch.cat(ddirs) if ddirs else empty


# ----------------------------------------------------------------- packing


def pack_input_bwd(field: nn.Module) -> Tuple[torch.Tensor, List[_build.MLPLayer]]:
    """K8c's input-gradient matrices, by the forward layer index they serve
    (``fused_render.pack_bwd_matrices``' format): the emb columns of every
    layer that reads the point PE (layer 0 whole, the layer after the skip;
    when the skip follows the last layer, feature and alpha stacked as
    ``[W_feature; W_alpha]`` and sem_0's h segment), sem_0's coordinate
    columns (one matrix with its h segment's emb columns when both read
    emb: both multiply the same cotangent), and the views layer's
    view-PE columns."""
    mlp = field.mlp
    depth, W, E = mlp.depth, mlp.width, mlp.pts_linears[0].in_features
    skip_last = depth - 1 in mlp.skips
    mats = {0: [mlp.pts_linears[0].weight.detach()]}
    for i in range(1, depth):
        if i - 1 in mlp.skips:
            mats[i] = [mlp.pts_linears[i].weight.detach()[:, :E]]
    if skip_last:
        mats[depth] = [mlp.feature_linear.weight.detach()[:, :E],
                       mlp.alpha_linear.weight.detach()[:, :E]]
    mats[depth + 2] = [mlp.views_linears[0].weight.detach()[:, W:]]
    if mlp.use_semantics and (skip_last or mlp.sem_with_coord):
        w0 = mlp.semantic_linear[0].weight.detach()
        emb = w0.new_zeros((w0.shape[0], E))
        if skip_last:
            emb = emb + w0[:, :E]
        if mlp.sem_with_coord:
            emb = emb + w0[:, -E:]
        mats[depth + 4] = [emb]
    return fr.pack_bwd_matrices(mats)


def input_ring_layers(field: nn.Module) -> List[int]:
    """K8c's input-gradient products by forward layer index (the entries of
    :func:`pack_input_bwd`), in the order ``train_reverse_kernel`` runs them:
    views, alpha's slot (the skip after the last layer), sem_0, then the
    layer after the skip and layer 0."""
    mlp = field.mlp
    depth = mlp.depth
    skip_last = depth - 1 in mlp.skips
    return ([depth + 2] + ([depth] if skip_last else [])
            + ([depth + 4] if mlp.use_semantics and (skip_last or mlp.sem_with_coord) else [])
            + [i for i in range(depth - 1, 0, -1) if i - 1 in mlp.skips] + [0])


def _input_ring_from(field: nn.Module, buf: torch.Tensor, ibwd: List[_build.MLPLayer]
                     ) -> Tuple[torch.Tensor, _build.RingDesc]:
    return fr.gather_ring(field, "_input_ring_index", buf, ibwd, input_ring_layers(field))


def pack_input_ring(field: nn.Module) -> Tuple[torch.Tensor, _build.RingDesc]:
    """K8c's input-gradient matrices (:func:`pack_input_bwd`) for the reverse
    sweep's ring, cut as ``fused_render.pack_bwd_ring`` cuts the backward
    matrices, in :func:`input_ring_layers`' order."""
    return _input_ring_from(field, *pack_input_bwd(field))


# ----------------------------------------------------------------- wrappers


def _check_points(field: nn.Module, n: int, **tensors: torch.Tensor) -> None:
    """Each tensor ``[n, 3]`` (the cotangent ``g``: ``[n, C]``), contiguous
    float32 on the device of the first, with the field's weights there."""
    device = next(iter(tensors.values())).device
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} on {t.device}, expected {device}")
        if t.dtype != torch.float32:
            raise NotImplementedError(f"{name}: the kernels take float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dim() != 2 or t.shape[0] != n or (name != "g" and t.shape[1] != 3):
            raise ValueError(f"expected {name} [{n}, {'C' if name == 'g' else 3}], "
                             f"got {tuple(t.shape)}")
    p = next(field.parameters())
    if p.device != device or p.dtype != torch.float32:
        raise NotImplementedError(f"field weights must be float32 on {device}, "
                                  f"got {p.dtype} on {p.device}")


_TILE_POINTS = 128  # points a tile of K4's tile (csrc/wg_tile.cuh kWgTile)


def _field_smem(fdesc: _build.MLPDesc, rd: _build.RingDesc, heads: bool) -> int:
    """Shared memory of ``field_wg_kernel`` (``field_smem`` in
    ``csrc/fused_field.cu``): the ring's barriers and stages, two
    warpgroups' emb, demb and h tiles of 64 points, and with ``heads`` the
    tile's strip of its points' rgb logits and semantics."""
    rows = fr._pad8(fdesc.emb_dim) + fr._pad8(fdesc.demb_dim) + rd.hrows
    strip = _TILE_POINTS * (3 + fdesc.sem_dim) if heads else 0
    return 128 + 4 * (rd.stages * rd.stage_floats + 2 * rows * fr._TILE + strip)


def _field_ring(fdesc: _build.MLPDesc, ring: _build.RingDesc, heads: bool) -> _build.RingDesc:
    """The point-list tile's ring descriptor (the field forwards' and the
    field backward's forward) with as many stages (2 to ``MAX_RING_STAGES``)
    as the rest of shared memory holds; raises where two do not fit."""
    rd = _build.RingDesc.from_buffer_copy(ring)
    rd.stages = 2
    if _field_smem(fdesc, rd, heads) > fr._MAX_SMEM:
        raise NotImplementedError(f"the field's tiles and ring need "
                                  f"{_field_smem(fdesc, rd, heads)} B of shared memory")
    while (rd.stages < _build.MAX_RING_STAGES
           and _field_smem(fdesc, rd, heads) + 4 * rd.stage_floats <= fr._MAX_SMEM):
        rd.stages += 1
    return rd


def _field_plan(fdesc: _build.MLPDesc, ring: _build.RingDesc, N: int, sms: int, heads: bool
                ) -> Tuple[int, _build.RingDesc]:
    """The field forwards' launch: ``per``, the 128-point tiles a CTA runs
    (consecutive, about one CTA an SM of ``sms``, one wave), and
    :func:`_field_ring`'s descriptor."""
    ntiles = max(1, -(-N // _TILE_POINTS))
    return -(-ntiles // min(ntiles, sms)), _field_ring(fdesc, ring, heads)


def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _field_launch(field: nn.Module, name: str, out: torch.Tensor, heads: bool,
                  *inputs: torch.Tensor, bf16: bool = False) -> None:
    """One launch of the library's field forward ``name``
    (``nerf_field_sigma``, ``nerf_field`` or ``nerf_mip_field``) on checked
    ``inputs`` of ``N > 0`` rows into ``out``: the packed weights, the ring
    of ``fused_render.pack_ring`` (the trunk's stages alone unless
    ``heads``) and :func:`_field_plan`'s tiles a CTA and ring stages.
    ``bf16`` (``nerf_mip_field`` alone): the tile's bf16 mode, the ring in
    its bf16 layout."""
    device, N = out.device, out.shape[0]
    buf, fdesc = fr._packed(field, device)
    rbuf, ring = fr._ring(field, device, bf16)
    per, rd = _field_plan(fdesc, ring, N, _sm_count(device), heads)
    desc = _build.TrainDesc()
    desc.f = fdesc
    desc.f.bf16 = int(bf16)
    with torch.cuda.device(device):
        code = getattr(_build.library(), name)(
            *(t.data_ptr() for t in inputs), buf.data_ptr(), rbuf.data_ptr(), ctypes.byref(desc),
            ctypes.byref(rd), out.data_ptr(), N, per, _build.stream(device))
    _build.check(code, name)


def _on_card(t: torch.Tensor) -> bool:
    """False for a CPU tensor (the plain version runs); True for a CUDA one;
    raises for any other device."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise NotImplementedError(f"no kernel for device {t.device}")
    return True


def fused_sigma_apply(field: nn.Module, pts: torch.Tensor) -> torch.Tensor:
    """The sigma forward (K8a/K8e): ``pts [N, 3]`` -> sigma ``[N]``; see
    :func:`sigma_plain`. One launch of K4's tile in its sigma-only point-list
    mode (the trunk's ring stages, the alpha head)."""
    if not _on_card(pts):
        return sigma_plain(field, pts)
    N = pts.shape[0]
    _check_points(field, N, pts=pts)
    sigma = torch.empty(N, device=pts.device, dtype=torch.float32)
    if N > 0:
        _field_launch(field, "nerf_field_sigma", sigma, False, pts)
        fused_sigma_apply.launches += 1
    return sigma


def field_forward(field: nn.Module, pts: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """The field forward (K8b/K8d): ``pts, dirs [N, 3]`` -> raw
    ``[N, 4 + sem]``; see :func:`field_plain`. One launch of K4's tile in
    its point-list mode (every layer through the ring)."""
    if not _on_card(pts):
        return field_plain(field, pts, dirs)
    N = pts.shape[0]
    _check_points(field, N, pts=pts, dirs=dirs)
    sem = field.mlp.semantic_linear[2].out_features if field.mlp.use_semantics else 0
    raw = torch.empty((N, 4 + sem), device=pts.device, dtype=torch.float32)
    if N > 0:
        _field_launch(field, "nerf_field", raw, True, pts, dirs)
        field_forward.launches += 1
    return raw


def fused_mip_field_apply(field: nn.Module, mean: torch.Tensor, cov: torch.Tensor,
                          dirs: torch.Tensor, compute_dtype: torch.dtype = torch.float32
                          ) -> torch.Tensor:
    """K11: the ``MipNeRFField`` at ``mean, cov [N, 3]`` seen from ``dirs
    [N, 3]`` -> raw ``[N, 4]``; see :func:`mip_field_plain`. One launch of
    K4's tile in its Gaussian point-list mode (the Gaussians in h's scratch
    rows, their integrated PE; at bf16 in its bf16 mode, counted in
    ``launches_bf16``). Forward only, as the JAX package's only caller of
    K11 is a render."""
    if not _on_card(mean):
        return mip_field_plain(field, mean, cov, dirs, compute_dtype)
    N = mean.shape[0]
    _check_points(field, N, mean=mean, cov=cov, dirs=dirs)
    if field.mlp.use_semantics:
        raise NotImplementedError("the mip field kernel has no semantic head")
    bf16 = fr.is_bf16(compute_dtype)
    raw = torch.empty((N, 4), device=mean.device, dtype=torch.float32)
    if N > 0:
        _field_launch(field, "nerf_mip_field", raw, True, mean, cov, dirs, bf16=bf16)
        fr._count(fused_mip_field_apply, bf16)
    return raw


def field_grads(field: nn.Module, pts: torch.Tensor, dirs: torch.Tensor, g: torch.Tensor, *,
                input_grads: bool, compute_dtype: torch.dtype = torch.float32
                ) -> Tuple[Dict[str, torch.Tensor], Optional[torch.Tensor],
                           Optional[torch.Tensor]]:
    """The field backward (K8f; K8c with ``input_grads``): the gradients of
    every parameter from the cotangent ``g [N, 4 + sem]`` of raw at ``pts,
    dirs [N, 3]``, and with ``input_grads`` those of pts and dirs; see
    :func:`field_grads_plain`. One call launches the forward (K4's tile in
    its storing point-list mode, the weights through the ring of
    ``fused_render.pack_ring`` with :func:`_field_ring`'s stages) and the
    reverse-sweep kernels (its input-gradient products through the ring of
    ``fused_render.pack_bwd_ring``, and with ``input_grads`` of
    :func:`pack_input_ring`) once per wave of 512-point chunks and the
    reduction of the CTAs' partial gradients, and adds one to ``launches``
    (and, with ``input_grads``, to ``input_grad_launches``). It has no bf16
    mode: ``compute_dtype`` bfloat16 raises, on any device."""
    if fr.is_bf16(compute_dtype):
        raise NotImplementedError("compute_dtype bfloat16: the field backward K8c/K8f "
                                  "(field_grads) has no bf16 mode yet")
    if not _on_card(pts):
        return field_grads_plain(field, pts, dirs, g, input_grads=input_grads)
    N = pts.shape[0]
    sem = field.mlp.use_semantics
    _check_points(field, N, pts=pts, dirs=dirs, g=g)
    buf, fdesc = fr._packed(field, pts.device)
    if g.shape[1] != 4 + fdesc.sem_dim:
        raise ValueError(f"expected g [{N}, {4 + fdesc.sem_dim}], got {tuple(g.shape)}")
    rbuf, ring = fr._ring(field, pts.device)
    bwd = fr._train_bwd(field, pts.device)[1]
    bring, brd = fr._bwd_ring(field, pts.device)
    desc, grid, group = fr._sweep_launch(field, fdesc, bwd, N, 1, pts.device, sem,
                                         input_grads=input_grads)
    rd = _field_ring(fdesc, ring, True)
    iring, ird, dpts, ddirs = None, _build.RingDesc(), None, None
    if input_grads:
        ibuf, ibwd = fr._cached(field, pts.device, "_field_input_pack", pack_input_bwd)
        iring, ird = fr._cached(field, pts.device, "_field_input_ring",
                                lambda f: _input_ring_from(f, ibuf, ibwd))
        for i, L in enumerate(ibwd):
            desc.ibwd[i] = L
        dpts = torch.empty((N, 3), device=pts.device, dtype=torch.float32)
        ddirs = torch.empty((N, 3), device=pts.device, dtype=torch.float32)
    flat = torch.zeros(desc.grad_size, device=pts.device, dtype=torch.float32)
    if N > 0:
        partial = torch.empty(grid * desc.grad_size, device=pts.device, dtype=torch.float32)
        work = torch.empty(grid * desc.ws_size, device=pts.device, dtype=torch.float32)
        with torch.cuda.device(pts.device):
            code = _build.library().nerf_field_grads(
                pts.data_ptr(), dirs.data_ptr(), g.data_ptr(), buf.data_ptr(), rbuf.data_ptr(),
                bring.data_ptr(), None if iring is None else iring.data_ptr(),
                ctypes.byref(desc), ctypes.byref(rd), ctypes.byref(brd), ctypes.byref(ird),
                partial.data_ptr(), work.data_ptr(), flat.data_ptr(),
                None if dpts is None else dpts.data_ptr(),
                None if ddirs is None else ddirs.data_ptr(), N, grid, group,
                _build.stream(pts.device))
        _build.check(code, "field_grads")
        field_grads.launches += 1
        field_grads.input_grad_launches += int(input_grads)
    return fr.unpack_grads(field, flat, sem), dpts, ddirs


class _FieldFn(torch.autograd.Function):
    """The field forward (K8b/K8d) with the field backward as its backward:
    every parameter gets its gradient (K8f), and ``pts``/``dirs`` get theirs
    only when autograd asks for them (K8c's input-gradient mode); None
    otherwise. A raw that nothing used gets None as its cotangent."""

    @staticmethod
    def forward(ctx, field, pts, dirs, *params):
        ctx.field = field
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(pts, dirs)
        return field_forward(field, pts, dirs)

    @staticmethod
    def backward(ctx, g):
        names = [n for n, _ in ctx.field.named_parameters()]
        if g is None:
            return (None,) * (3 + len(names))
        pts, dirs = ctx.saved_tensors
        want_pts, want_dirs = ctx.needs_input_grad[1], ctx.needs_input_grad[2]
        grads, dpts, ddirs = field_grads(ctx.field, pts, dirs, g.contiguous(),
                                         input_grads=want_pts or want_dirs)
        return (None, dpts if want_pts else None, ddirs if want_dirs else None,
                *(grads[n] for n in names))


def fused_field_apply(field: nn.Module, pts: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """The differentiable field query (replaces ``fused_field_apply`` and
    ``fused_field_apply_planar``): ``pts, dirs [N, 3]`` -> raw
    ``[N, 4 + sem]`` through the field forward, whose backward is the field
    backward (``_FieldFn``)."""
    return _FieldFn.apply(field, pts, dirs, *field.parameters())


fused_sigma_apply.launches = 0
field_forward.launches = 0
fused_mip_field_apply.launches = 0
fused_mip_field_apply.launches_bf16 = 0
field_grads.launches = 0
field_grads.input_grad_launches = 0
