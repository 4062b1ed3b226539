"""The SOS step's geometry-correlation loss in its quad form (K7).

Port of ``nerfsos_tpu/ops/pallas/flash_corr.py``'s ``flash_geo_pair_quad``:
the neg sweep (points x the negative patch's points) and the self sweep
(points x points) stacked on the batch axis, each with the coarse and the
fine head's channel-normalised codes, give the four helper means
``(neg coarse, neg fine, self coarse, self fine)`` of
``-cd * (fd - rowmean + gmean - shift)``, where ``fd`` and ``cd`` are the
clamped inverse-L1 kernel ``min(1 / (sum |a - b| + 0.05), max_depth)`` of
the points and of the codes, the row means and the halves' global means
come from ``fd`` (the pointwise recentering), and ``fd`` is no-grad.

Three kernels in ``csrc/flash_corr.cu``, each behind a wrapper with the
same signature as its plain version here:

- :func:`geo_row_stats` (K7a, replaces ``_row_stats`` / ``_rowsum_kernel``):
  ``rowmean [2B, N]`` and the two halves' means ``gm [2]``;
- :func:`geo_quad_means` (K7f, replaces ``_flash_geo_fwd_quad`` /
  ``_loss_kernel_quad``): the four means;
- :func:`geo_quad_grads` (K7g, replaces ``_flash_geo_bwd_quad`` /
  ``_bwd_kernel_quad``): the codes' cotangents.

Layouts: points ``f1, f2 [2B, N, 3]`` and codes ``[2B, N, S]`` (the JAX
code keeps ``f2`` and ``c2`` as ``[2B, C, N]``). The plain versions form
the pairwise tiles a block of rows at a time. A wrapper takes its plain
version for CPU tensors and launches its kernel or raises for CUDA tensors;
``<wrapper>.launches`` counts calls that launched.
"""
from __future__ import annotations

from typing import Tuple

import torch

from nerfsos_torch import _build

_MAX_S = 8
_THREADS = 128  # csrc/flash_corr.cu kThreads
_ROW_BLOCK = 256  # rows a block of the plain versions


def _l1(a: torch.Tensor, b: torch.Tensor, start_zero: bool) -> torch.Tensor:
    """``sum_c |a[..., c] - b[..., c]|`` in channel order: from 0 for the
    points (the Pallas ``_fd_tile``), from the first channel for the codes
    (``_l1_tile``)."""
    acc = torch.zeros_like(a[..., 0] - b[..., 0]) if start_zero else (a[..., 0] - b[..., 0]).abs()
    for c in range(0 if start_zero else 1, a.shape[-1]):
        acc = acc + (a[..., c] - b[..., c]).abs()
    return acc


def _fd(f1_blk: torch.Tensor, f2: torch.Tensor, max_depth: float) -> torch.Tensor:
    """fd ``[2B, bi, N]`` of a block of rows ``[2B, bi, 3]`` against all columns."""
    return torch.clamp(1.0 / (_l1(f1_blk[:, :, None, :], f2[:, None, :, :], True) + 0.05),
                       max=max_depth)


def _blocks(n: int):
    return [slice(i, min(i + _ROW_BLOCK, n)) for i in range(0, n, _ROW_BLOCK)]


def geo_row_stats_plain(f1: torch.Tensor, f2: torch.Tensor,
                        max_depth: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K7a: ``rowmean [2B, N]`` (the row sums of fd over N)
    and ``gm [2]``, the mean of rowmean over rows ``[0, B)`` and ``[B, 2B)``."""
    B2, N, _ = f1.shape
    rowmean = torch.cat([_fd(f1[:, blk], f2, max_depth).sum(-1) for blk in _blocks(N)], 1) / N
    half = B2 // 2
    return rowmean, torch.stack([rowmean[:half].mean(), rowmean[half:].mean()])


def _fd2_blk(f1, f2, rowmean, gm, shifts, blk, max_depth):
    """``fd - rowmean + (gm - shift)`` of a block of rows, per half."""
    half = f1.shape[0] // 2
    off = torch.stack([gm[0] - shifts[0], gm[1] - shifts[1]]).repeat_interleave(half)
    return _fd(f1[:, blk], f2, max_depth) - rowmean[:, blk, None] + off[:, None, None]


def geo_quad_means_plain(f1, f2, c1a, c2a, c1b, c2b, rowmean, gm, shift_lo: float,
                         shift_hi: float, max_depth: float) -> torch.Tensor:
    """Plain version of K7f: ``[4]`` = (neg coarse, neg fine, self coarse,
    self fine), each the sum of ``-cd * fd2`` over its half's ``(b, p, q)``
    divided by ``B N N`` (B the rows of a half)."""
    B2, N, _ = f1.shape
    tot = f1.new_zeros((2, B2))
    for blk in _blocks(N):
        fd2 = _fd2_blk(f1, f2, rowmean, gm, (shift_lo, shift_hi), blk, max_depth)
        for h, (c1, c2) in enumerate(((c1a, c2a), (c1b, c2b))):
            cd = torch.clamp(1.0 / (_l1(c1[:, blk, None, :], c2[:, None, :, :], False) + 0.05),
                             max=max_depth)
            tot[h] += (-cd * fd2).sum((1, 2))
    half = B2 // 2
    sums = torch.stack([tot[0, :half].sum(), tot[1, :half].sum(), tot[0, half:].sum(),
                        tot[1, half:].sum()])
    return sums / float(half * N * N)


def geo_quad_grads_plain(f1, f2, c1a, c2a, c1b, c2b, rowmean, gm, coeff, shift_lo: float,
                         shift_hi: float, max_depth: float
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K7g: ``coeff [4]`` (the four outputs' cotangents over
    ``B N N``) -> ``(dc1a, dc2a, dc1b, dc2b)``, each ``[2B, N, S]``:
    ``dd = [r <= max_depth] coeff fd2 r^2`` with ``r = 1 / (L1(c1, c2) + 0.05)``
    times ``sign(c1 - c2)`` summed over columns (dc1) and times
    ``-sign(c1 - c2)`` summed over rows (dc2)."""
    B2, N, _ = f1.shape
    half = B2 // 2
    outs = [torch.zeros_like(c) for c in (c1a, c2a, c1b, c2b)]
    for blk in _blocks(N):
        fd2 = _fd2_blk(f1, f2, rowmean, gm, (shift_lo, shift_hi), blk, max_depth)
        for h, (c1, c2) in enumerate(((c1a, c2a), (c1b, c2b))):
            co = torch.stack([coeff[h], coeff[2 + h]]).repeat_interleave(half)
            diff = c1[:, blk, None, :] - c2[:, None, :, :]  # [2B, bi, N, S]
            r = 1.0 / (_l1(c1[:, blk, None, :], c2[:, None, :, :], False) + 0.05)
            dd = torch.where(r <= max_depth, co[:, None, None] * fd2 * r * r,
                             torch.zeros_like(r))
            sg = torch.sign(diff)
            outs[2 * h][:, blk] = (dd[..., None] * sg).sum(2)
            outs[2 * h + 1] += (dd[..., None] * -sg).sum(1)
    return tuple(outs)


# ----------------------------------------------------------------- wrappers


def _check(*tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("K7 takes contiguous float32 tensors on one device")
    f1, f2 = tensors[0], tensors[1]
    if f1.dim() != 3 or f1.shape[2] != 3 or f2.shape != f1.shape or f1.shape[0] % 2:
        raise ValueError(f"expected points [2B, N, 3], got {tuple(f1.shape)}, {tuple(f2.shape)}")
    for c in tensors[2:6]:
        if c.shape[:2] != f1.shape[:2] or not 1 <= c.shape[2] <= _MAX_S:
            raise ValueError(f"expected codes [2B, N, S <= {_MAX_S}], got {tuple(c.shape)}")


def _ptrs(*tensors: torch.Tensor):
    return [t.data_ptr() for t in tensors]



def geo_row_stats(f1: torch.Tensor, f2: torch.Tensor,
                  max_depth: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7a; see :func:`geo_row_stats_plain`."""
    if f1.device.type == "cpu":
        return geo_row_stats_plain(f1, f2, max_depth)
    if f1.device.type != "cuda":
        raise NotImplementedError(f"no kernel for device {f1.device}")
    B2, N, _ = f1.shape
    _check(f1, f2)
    rowmean = torch.empty((B2, N), device=f1.device, dtype=torch.float32)
    gm = torch.empty(2, device=f1.device, dtype=torch.float32)
    with torch.cuda.device(f1.device):
        code = _build.library().geo_row_stats(*_ptrs(f1, f2, rowmean, gm), B2, N,
                                              float(max_depth), _build.stream(f1.device))
    _build.check(code, "geo_row_stats")
    geo_row_stats.launches += 1
    return rowmean, gm


def geo_quad_means(f1, f2, c1a, c2a, c1b, c2b, rowmean, gm, shift_lo: float, shift_hi: float,
                   max_depth: float) -> torch.Tensor:
    """K7f; see :func:`geo_quad_means_plain`. Per CTA partial sums, then
    their sum in CTA order: deterministic."""
    if f1.device.type == "cpu":
        return geo_quad_means_plain(f1, f2, c1a, c2a, c1b, c2b, rowmean, gm, shift_lo,
                                    shift_hi, max_depth)
    if f1.device.type != "cuda":
        raise NotImplementedError(f"no kernel for device {f1.device}")
    _check(f1, f2, c1a, c2a, c1b, c2b, rowmean, gm)
    B2, N, S = c1a.shape
    partial = torch.empty(B2 * -(-N // _THREADS) * 2, device=f1.device, dtype=torch.float32)
    out = torch.empty(4, device=f1.device, dtype=torch.float32)
    with torch.cuda.device(f1.device):
        code = _build.library().geo_quad_means(
            *_ptrs(f1, f2, c1a, c2a, c1b, c2b, rowmean, gm, partial, out), B2, N, S,
            float(shift_lo), float(shift_hi), float(max_depth), _build.stream(f1.device))
    _build.check(code, "geo_quad_means")
    geo_quad_means.launches += 1
    return out


def geo_quad_grads(f1, f2, c1a, c2a, c1b, c2b, rowmean, gm, coeff, shift_lo: float,
                   shift_hi: float, max_depth: float):
    """K7g; see :func:`geo_quad_grads_plain`. A row sweep (dc1) and a column
    sweep (dc2), each sum taken by one thread: deterministic."""
    if f1.device.type == "cpu":
        return geo_quad_grads_plain(f1, f2, c1a, c2a, c1b, c2b, rowmean, gm, coeff, shift_lo,
                                    shift_hi, max_depth)
    if f1.device.type != "cuda":
        raise NotImplementedError(f"no kernel for device {f1.device}")
    _check(f1, f2, c1a, c2a, c1b, c2b, rowmean, gm, coeff)
    B2, N, S = c1a.shape
    outs = [torch.empty_like(c) for c in (c1a, c2a, c1b, c2b)]
    with torch.cuda.device(f1.device):
        code = _build.library().geo_quad_grads(
            *_ptrs(f1, f2, c1a, c2a, c1b, c2b, rowmean, gm, coeff, *outs), B2, N, S,
            float(shift_lo), float(shift_hi), float(max_depth), _build.stream(f1.device))
    _build.check(code, "geo_quad_grads")
    geo_quad_grads.launches += 1
    return tuple(outs)


geo_row_stats.launches = 0
geo_quad_means.launches = 0
geo_quad_grads.launches = 0


class _GeoQuad(torch.autograd.Function):
    """K7a + K7f forward, K7g backward; the points get no gradient."""

    @staticmethod
    def forward(ctx, f1, f2, c1a, c2a, c1b, c2b, shift_lo, shift_hi, max_depth):
        rowmean, gm = geo_row_stats(f1, f2, max_depth)
        out = geo_quad_means(f1, f2, c1a, c2a, c1b, c2b, rowmean, gm, shift_lo, shift_hi,
                             max_depth)
        ctx.save_for_backward(f1, f2, c1a, c2a, c1b, c2b, rowmean, gm)
        ctx.args = (shift_lo, shift_hi, max_depth)
        return out

    @staticmethod
    def backward(ctx, g):
        f1, f2, c1a, c2a, c1b, c2b, rowmean, gm = ctx.saved_tensors
        B2, N, _ = f1.shape
        coeff = (g / float(B2 // 2 * N * N)).to(torch.float32).contiguous()
        grads = geo_quad_grads(f1, f2, c1a, c2a, c1b, c2b, rowmean, gm, coeff, *ctx.args)
        return (None, None, *grads, None, None, None)


def flash_geo_pair_quad(feats: torch.Tensor, neg_feats: torch.Tensor, c0n: torch.Tensor,
                        c0n_neg: torch.Tensor, c1n: torch.Tensor, c1n_neg: torch.Tensor,
                        shift_neg: float, shift_self: float, max_depth: float
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The SOS step's four geometry helper means (neg coarse, neg fine, self
    coarse, self fine). ``feats``, ``neg_feats [B, 3, H, W]`` are points (no
    gradient), the codes ``[B, S, H, W]`` channel-normalised; gradients reach
    the codes through K7g."""
    B, C, H, W = feats.shape
    N, S = H * W, c0n.shape[1]

    def rows(x: torch.Tensor, ch: int) -> torch.Tensor:
        return x.reshape(B, ch, N).transpose(1, 2)

    f1 = torch.cat([rows(feats, C), rows(feats, C)]).detach().contiguous()
    f2 = torch.cat([rows(neg_feats, C), rows(feats, C)]).detach().contiguous()
    c1a = torch.cat([rows(c0n, S), rows(c0n, S)]).contiguous()
    c2a = torch.cat([rows(c0n_neg, S), rows(c0n, S)]).contiguous()
    c1b = torch.cat([rows(c1n, S), rows(c1n, S)]).contiguous()
    c2b = torch.cat([rows(c1n_neg, S), rows(c1n, S)]).contiguous()
    out = _GeoQuad.apply(f1, f2, c1a, c2a, c1b, c2b, float(shift_neg), float(shift_self),
                         float(max_depth))
    return out[0], out[1], out[2], out[3]
