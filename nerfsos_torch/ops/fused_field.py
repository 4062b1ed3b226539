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
  raw ``[N, 4]``;
- :func:`field_grads` (K8f ``_fused_backward_pl``, and K8c
  ``_fused_backward`` in its input-gradient mode): the gradients of every
  parameter from a cotangent ``g [N, 4 + sem]`` of raw, and in the
  input-gradient mode those of ``pts`` and ``dirs``;
- :func:`fused_field_apply`: :func:`field_forward` with :func:`field_grads`
  as its backward (``_FieldFn``); the input-gradient mode runs when
  autograd asks for the points' or the directions' gradient, which stands
  in for the JAX package's ``cfg.field_input_grads``.

Each also runs at ``compute_dtype=torch.bfloat16`` (the JAX kernels at
compute_dtype bfloat16), counted in ``<wrapper>.launches_bf16``: every
product on bf16 operands with float32 accumulation and bias, the PE (K11:
the integrated PE) formed in float32, then rounded. The field forward's
twins differ there: K8b (``_field_kernel``, the row-major route of
``export_density``) keeps the heads' hidden activations ``s`` and ``hv``
in float32 before sem_1 and rgb, K8d (``_field_kernel_pl``, the planar
route of renders and ``--N_importance 0`` training) rounds them; the
forward takes the rule as ``f32_heads`` (K8b's). The backward (K8c/K8f at
bf16) rounds ``g`` to bf16 before anything reads it, the bias sums
included, and keeps K8c's PE cotangents and chain rule in float32.

The three forwards run K4's 128-point tile (``csrc/wg_tile.cuh``) in its
point-list modes (``csrc/fused_field.cu`` ``field_wg_kernel``): a CTA a run
of :func:`_field_plan`'s tiles, the weights from ``fused_render.pack_ring``
through the tile's ring. The backward's forward runs the same tile in its
storing point-list mode (``field_bwd_forward_kernel``), with the same ring.
Each wrapper runs its plain PyTorch version (:func:`sigma_plain`,
:func:`field_plain`, :func:`mip_field_plain`, :func:`field_grads_plain`,
same signature) for tensors on the CPU, and for CUDA tensors launches its
kernel or raises; it never falls back.
``<wrapper>.launches`` counts the fp32 launches and
``<wrapper>.launches_bf16`` the bf16 ones (``field_grads.input_grad_launches``
and ``input_grad_launches_bf16`` those in the input-gradient mode;
``field_forward.launches_bf16_f32_heads`` those under K8b's head rule, a
kernel of its own, which ``launches_bf16`` does not count).
The weights are packed by ``ops/fused_render.py``'s packers.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from nerfsos_torch import _build
from nerfsos_torch.models.mlp import Dense, bf16_operands_dense, round_bf16
from nerfsos_torch.ops import fused_render as fr

# ----------------------------------------------------------------- plain versions


def f32_heads_dense(field: nn.Module) -> Dense:
    """K8b's product at bf16: :func:`~nerfsos_torch.models.mlp.bf16_operands_dense`
    but for sem_1 and rgb, whose float32 input meets a bf16-rounded weight
    (``_field_kernel``'s fp32 ``s`` and ``hv`` times its bf16 weights)."""
    mlp = field.mlp
    heads = [mlp.rgb_linear] + ([mlp.semantic_linear[2]] if mlp.use_semantics else [])

    def dense(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        if any(layer is h for h in heads):
            return F.linear(x, round_bf16(layer.weight), layer.bias)
        return bf16_operands_dense(layer, x)
    return dense


def field_plain(field: nn.Module, pts: torch.Tensor, dirs: torch.Tensor,
                compute_dtype: torch.dtype = torch.float32, f32_heads: bool = False
                ) -> torch.Tensor:
    """Plain version of the field forward: the ``NeRFField`` at ``pts [N, 3]``
    seen from ``dirs [N, 3]`` -> raw ``[N, 4 + sem]``, its products the
    kernel's at ``compute_dtype`` (``fused_render.kernel_dense``; at bf16
    with ``f32_heads`` K8b's, :func:`f32_heads_dense`)."""
    bf16 = fr.is_bf16(compute_dtype)
    dense = f32_heads_dense(field) if bf16 and f32_heads else fr.kernel_dense(compute_dtype)
    return field(pts[:, None, :], dirs, dense=dense)[:, 0]


def sigma_plain(field: nn.Module, pts: torch.Tensor,
                compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version of the sigma forward: ``NeRFField.sigma`` of ``pts
    [N, 3]`` -> ``[N]``, its products the kernel's at ``compute_dtype``."""
    return field.sigma(pts, dense=fr.kernel_dense(compute_dtype))


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
                      *, input_grads: bool, compute_dtype: torch.dtype = torch.float32
                      ) -> Tuple[Dict[str, torch.Tensor], Optional[torch.Tensor],
                                 Optional[torch.Tensor]]:
    """Plain version of the field backward: autograd of ``sum(g *
    field_plain(field, pts, dirs))``. Returns (the gradient of every
    parameter, keyed by ``field.named_parameters()`` names; with
    ``input_grads`` those of ``pts`` and ``dirs`` ``[N, 3]``, else None and
    None). Runs in chunks of points, each chunk's graph freed before the
    next. At bf16 the JAX kernels' bf16 sweep (:func:`_field_grads_bf16`)."""
    if fr.is_bf16(compute_dtype):
        return _field_grads_bf16(field, pts, dirs, g, input_grads)
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


def _field_grads_bf16(field: nn.Module, pts: torch.Tensor, dirs: torch.Tensor, g: torch.Tensor,
                      input_grads: bool
                      ) -> Tuple[Dict[str, torch.Tensor], Optional[torch.Tensor],
                                 Optional[torch.Tensor]]:
    """The bf16 semantics of K8f and K8c (``_fused_backward_pl`` and
    ``_fused_backward`` at compute_dtype bfloat16), in chunks of points:
    ``fused_render._bf16_mlp_forward`` on the float32 PE of pts and dirs,
    then ``fused_render.bf16_sweep`` on ``g`` rounded to bf16 (both JAX
    backwards round it first, so their bias sums add the rounded values);
    with ``input_grads`` the sweep's float32 PE cotangents run back through
    the PE's chain rule (autograd of the float32 PE)."""
    grads = {n: torch.zeros_like(p) for n, p in field.named_parameters()}
    sem = field.mlp.use_semantics
    dpts, ddirs = [], []
    step = fr._PLAIN_CHUNK_POINTS
    with torch.no_grad():
        for i in range(0, pts.shape[0], step):
            p, d, gc = pts[i:i + step], dirs[i:i + step], round_bf16(g[i:i + step])
            f = fr._bf16_mlp_forward(field, field.embed(p), field.embed_views(d))
            pe = fr.bf16_sweep(field, grads, f["e"], f["dv"], f["acts"], f["feat"], f["hv"],
                               f["s_act"], gc[:, 0:3], gc[:, 3:4], gc[:, 4:] if sem else None,
                               pe_cotangents=input_grads)
            if input_grads:
                with torch.enable_grad():
                    p, d = p.detach().requires_grad_(), d.detach().requires_grad_()
                    dp, dd = torch.autograd.grad((field.embed(p), field.embed_views(d)), (p, d),
                                                 pe)
                dpts.append(dp)
                ddirs.append(dd)
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


def _input_ring_from(field: nn.Module, buf: torch.Tensor, ibwd: List[_build.MLPLayer],
                     bf16: bool = False) -> Tuple[torch.Tensor, _build.RingDesc]:
    return fr.gather_ring(field, "_input_ring_index", buf, ibwd, input_ring_layers(field),
                          bf16=bf16)


def pack_input_ring(field: nn.Module, bf16: bool = False) -> Tuple[torch.Tensor, _build.RingDesc]:
    """K8c's input-gradient matrices (:func:`pack_input_bwd`) for the reverse
    sweep's ring, cut as ``fused_render.pack_bwd_ring`` cuts the backward
    matrices (``bf16``: in its bf16 layout), in :func:`input_ring_layers`'
    order."""
    return _input_ring_from(field, *pack_input_bwd(field), bf16)


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
                  *inputs: torch.Tensor, bf16: bool = False,
                  f32_heads: Optional[bool] = None) -> None:
    """One launch of the library's field forward ``name``
    (``nerf_field_sigma``, ``nerf_field`` or ``nerf_mip_field``) on checked
    ``inputs`` of ``N > 0`` rows into ``out``: the packed weights, the ring
    of ``fused_render.pack_ring`` (the trunk's stages alone unless
    ``heads``) and :func:`_field_plan`'s tiles a CTA and ring stages.
    ``bf16``: the tile's bf16 mode, the ring in its bf16 layout;
    ``f32_heads`` (``nerf_field`` alone, which takes it): K8b's head rule."""
    device, N = out.device, out.shape[0]
    buf, fdesc = fr._packed(field, device)
    rbuf, ring = fr._ring(field, device, bf16)
    per, rd = _field_plan(fdesc, ring, N, _sm_count(device), heads)
    desc = _build.TrainDesc()
    desc.f = fdesc
    desc.f.bf16 = int(bf16)
    rule = () if f32_heads is None else (int(f32_heads),)
    with torch.cuda.device(device):
        code = getattr(_build.library(), name)(
            *(t.data_ptr() for t in inputs), buf.data_ptr(), rbuf.data_ptr(), ctypes.byref(desc),
            ctypes.byref(rd), out.data_ptr(), N, per, *rule, _build.stream(device))
    _build.check(code, name)


def _on_card(t: torch.Tensor) -> bool:
    """False for a CPU tensor (the plain version runs); True for a CUDA one;
    raises for any other device."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise NotImplementedError(f"no kernel for device {t.device}")
    return True


def fused_sigma_apply(field: nn.Module, pts: torch.Tensor,
                      compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The sigma forward (K8a/K8e): ``pts [N, 3]`` -> sigma ``[N]``; see
    :func:`sigma_plain`. One launch of K4's tile in its sigma-only point-list
    mode (the trunk's ring stages, the alpha head; at bf16 in its bf16 mode,
    counted in ``launches_bf16``)."""
    if not _on_card(pts):
        return sigma_plain(field, pts, compute_dtype)
    N = pts.shape[0]
    _check_points(field, N, pts=pts)
    bf16 = fr.is_bf16(compute_dtype)
    sigma = torch.empty(N, device=pts.device, dtype=torch.float32)
    if N > 0:
        _field_launch(field, "nerf_field_sigma", sigma, False, pts, bf16=bf16)
        fr._count(fused_sigma_apply, bf16)
    return sigma


def field_forward(field: nn.Module, pts: torch.Tensor, dirs: torch.Tensor,
                  compute_dtype: torch.dtype = torch.float32, f32_heads: bool = False
                  ) -> torch.Tensor:
    """The field forward (K8b/K8d): ``pts, dirs [N, 3]`` -> raw
    ``[N, 4 + sem]``; see :func:`field_plain`. One launch of K4's tile in
    its point-list mode (every layer through the ring; at bf16 in its bf16
    mode with K8b's head rule when ``f32_heads``, counted in
    ``launches_bf16_f32_heads``, else K8d's, counted in ``launches_bf16``)."""
    if not _on_card(pts):
        return field_plain(field, pts, dirs, compute_dtype, f32_heads)
    N = pts.shape[0]
    _check_points(field, N, pts=pts, dirs=dirs)
    bf16 = fr.is_bf16(compute_dtype)
    sem = field.mlp.semantic_linear[2].out_features if field.mlp.use_semantics else 0
    raw = torch.empty((N, 4 + sem), device=pts.device, dtype=torch.float32)
    if N > 0:
        _field_launch(field, "nerf_field", raw, True, pts, dirs, bf16=bf16,
                      f32_heads=bf16 and f32_heads)
        if bf16 and f32_heads:
            field_forward.launches_bf16_f32_heads += 1
        else:
            fr._count(field_forward, bf16)
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
    reduction of the CTAs' partial gradients (:func:`_field_grads_launch`),
    and adds one to ``launches`` (and, with ``input_grads``, to
    ``input_grad_launches``); at bf16 the kernels' bf16 modes, the rings in
    their bf16 layouts, counted in ``launches_bf16`` (and
    ``input_grad_launches_bf16``)."""
    if not _on_card(pts):
        return field_grads_plain(field, pts, dirs, g, input_grads=input_grads,
                                 compute_dtype=compute_dtype)
    N = pts.shape[0]
    _check_points(field, N, pts=pts, dirs=dirs, g=g)
    bf16 = fr.is_bf16(compute_dtype)
    flat, dpts, ddirs, _ = _field_grads_launch(field, pts, dirs, g, input_grads, bf16)
    if N > 0:
        fr._count(field_grads, bf16)
        if input_grads:
            if bf16:
                field_grads.input_grad_launches_bf16 += 1
            else:
                field_grads.input_grad_launches += 1
    return fr.unpack_grads(field, flat, field.mlp.use_semantics), dpts, ddirs


def _field_grads_launch(field: nn.Module, pts: torch.Tensor, dirs: torch.Tensor,
                        g: torch.Tensor, input_grads: bool, bf16: bool):
    """The field backward's launches on checked CUDA inputs (none for ``N
    == 0``; see :func:`field_grads`), with ``bf16`` in the kernels' bf16
    modes. Returns the flat gradient buffer, dpts and ddirs (None without
    ``input_grads``) and ``(workspace, train_desc, grid, group)``: after a
    call of one wave (a chunk a CTA, group 1) each CTA's slice of the
    workspace holds its chunk's planes."""
    N, device = pts.shape[0], pts.device
    sem = field.mlp.use_semantics
    buf, fdesc = fr._packed(field, device)
    if g.shape[1] != 4 + fdesc.sem_dim:
        raise ValueError(f"expected g [{N}, {4 + fdesc.sem_dim}], got {tuple(g.shape)}")
    rbuf, ring = fr._ring(field, device, bf16)
    bwd = fr._train_bwd(field, device)[1]
    bring, brd = fr._bwd_ring(field, device, bf16)
    desc, grid, group = fr._sweep_launch(field, fdesc, bwd, N, 1, device, sem,
                                         input_grads=input_grads)
    desc.f.bf16 = int(bf16)
    rd = _field_ring(fdesc, ring, True)
    iring, ird, dpts, ddirs = None, _build.RingDesc(), None, None
    if input_grads:
        ibuf, ibwd = fr._cached(field, device, "_field_input_pack", pack_input_bwd)
        iring, ird = fr._cached(field, device, "_field_input_ring_bf16" if bf16
                                else "_field_input_ring",
                                lambda f: _input_ring_from(f, ibuf, ibwd, bf16))
        for i, L in enumerate(ibwd):
            desc.ibwd[i] = L
        dpts = torch.empty((N, 3), device=device, dtype=torch.float32)
        ddirs = torch.empty((N, 3), device=device, dtype=torch.float32)
    flat = torch.zeros(desc.grad_size, device=device, dtype=torch.float32)
    work = torch.empty(grid * desc.ws_size if N > 0 else 0, device=device, dtype=torch.float32)
    if N > 0:
        partial = torch.empty(grid * desc.grad_size, device=device, dtype=torch.float32)
        with torch.cuda.device(device):
            code = _build.library().nerf_field_grads(
                pts.data_ptr(), dirs.data_ptr(), g.data_ptr(), buf.data_ptr(), rbuf.data_ptr(),
                bring.data_ptr(), None if iring is None else iring.data_ptr(),
                ctypes.byref(desc), ctypes.byref(rd), ctypes.byref(brd), ctypes.byref(ird),
                partial.data_ptr(), work.data_ptr(), flat.data_ptr(),
                None if dpts is None else dpts.data_ptr(),
                None if ddirs is None else ddirs.data_ptr(), N, grid, group,
                _build.stream(device))
        _build.check(code, "field_grads")
    return flat, dpts, ddirs, (work, desc, grid, group)


class _FieldFn(torch.autograd.Function):
    """The field forward (K8d's rule at bf16) with the field backward as its
    backward, both at ``compute_dtype``: every parameter gets its gradient
    (K8f), and ``pts``/``dirs`` get theirs only when autograd asks for them
    (K8c's input-gradient mode); None otherwise. A raw that nothing used
    gets None as its cotangent."""

    @staticmethod
    def forward(ctx, field, compute_dtype, pts, dirs, *params):
        ctx.field, ctx.compute_dtype = field, compute_dtype
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(pts, dirs)
        return field_forward(field, pts, dirs, compute_dtype)

    @staticmethod
    def backward(ctx, g):
        names = [n for n, _ in ctx.field.named_parameters()]
        if g is None:
            return (None,) * (4 + len(names))
        pts, dirs = ctx.saved_tensors
        want_pts, want_dirs = ctx.needs_input_grad[2], ctx.needs_input_grad[3]
        grads, dpts, ddirs = field_grads(ctx.field, pts, dirs, g.contiguous(),
                                         input_grads=want_pts or want_dirs,
                                         compute_dtype=ctx.compute_dtype)
        return (None, None, dpts if want_pts else None, ddirs if want_dirs else None,
                *(grads[n] for n in names))


def fused_field_apply(field: nn.Module, pts: torch.Tensor, dirs: torch.Tensor,
                      compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The differentiable field query (replaces ``fused_field_apply`` and
    ``fused_field_apply_planar``; at bf16 the planar twins' semantics, K8d
    and K8f, which every differentiable JAX route takes): ``pts, dirs [N,
    3]`` -> raw ``[N, 4 + sem]`` through the field forward, whose backward
    is the field backward (``_FieldFn``)."""
    return _FieldFn.apply(field, compute_dtype, pts, dirs, *field.parameters())


fused_sigma_apply.launches = 0
fused_sigma_apply.launches_bf16 = 0
field_forward.launches = 0
field_forward.launches_bf16 = 0
field_forward.launches_bf16_f32_heads = 0
fused_mip_field_apply.launches = 0
fused_mip_field_apply.launches_bf16 = 0
field_grads.launches = 0
field_grads.launches_bf16 = 0
field_grads.input_grad_launches = 0
field_grads.input_grad_launches_bf16 = 0
