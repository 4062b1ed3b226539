"""The geometry-correlation loss (K7): the helper means
``-cd * (fd - rowmean + gmean - shift)`` over every pixel pair of a patch.

Port of ``nerfsos_tpu/ops/pallas/flash_corr.py``. ``fd`` and ``cd`` are the
clamped inverse-L1 kernel ``min(1 / (sum |a - b| + 0.05), max_depth)`` of
the points and of the channel-normalised codes, the row means and the
global means come from ``fd`` (the pointwise recentering), and ``fd`` is
no-grad. Three forms, for ``halves`` x ``heads`` means:

- :func:`geo_helper_mean` (one mean, replaces ``flash_geo_helper_mean``);
- :func:`geo_helper_mean_pair` (two heads on one sweep, replaces
  ``flash_geo_helper_mean_pair``);
- :func:`flash_geo_pair_quad` (the SOS step's neg sweep and self sweep
  stacked on the batch axis, each with the coarse and the fine head: the
  four means (neg coarse, neg fine, self coarse, self fine)).

Their kernels, one family in ``csrc/flash_corr.cu``, each behind a wrapper
with the same signature as its plain version here:

- :func:`geo_row_stats` (K7a, replaces ``_row_stats`` / ``_rowsum_kernel``):
  ``rowmean [B2, N]`` and one global mean a half ``gm [halves]``, from
  pair tiles of 256 rows (no codes: 8 rows a lane) x ``TILE_COLS``
  columns (:func:`row_stats_scratch`);
- :func:`geo_single_means` / :func:`geo_single_grads` (K7b / K7c, replace
  ``_loss_kernel`` / ``_bwd_kernel``): one half, one head;
- :func:`geo_pair_means` / :func:`geo_pair_grads` (K7d / K7e, replace
  ``_loss_kernel2`` / ``_bwd_kernel2``): one half, two heads;
- :func:`geo_quad_means` / :func:`geo_quad_grads` (K7f / K7g, replace
  ``_loss_kernel_quad`` / ``_bwd_kernel_quad``): two halves, two heads.

Layouts: points ``f1, f2 [B2, N, 3]`` and codes ``[B2, N, S]`` (the JAX
code keeps ``f2`` and ``c2`` as ``[B2, C, N]``). The plain versions form
the pairwise tiles a block of rows at a time. The loss and gradient
kernels sweep pair tiles of ``32 tile_rows(heads, S)`` rows x
``TILE_COLS`` columns (:func:`tile_grid`) and leave one partial a tile
in a scratch buffer that the wrapper allocates (:func:`means_scratch`,
:func:`grads_scratch`). A wrapper takes its plain version for CPU tensors
and launches its kernel or raises for CUDA tensors; ``<wrapper>.launches``
counts calls that launched.
"""
from __future__ import annotations

from typing import Tuple

import torch

from nerfsos_torch import _build

_MAX_S = 8
_ROW_BLOCK = 256  # rows a block of the plain versions
TILE_COLS = 256  # columns a pair tile (csrc/flash_corr.cu kTileCols: 4 warps of 64)


def tile_rows(heads: int, S: int) -> int:
    """Rows a lane of a pair tile (csrc/flash_corr.cu ``Tile::kRows``):
    fewer as the ``heads * S`` code values a row takes registers."""
    k = heads * S
    return 8 if k <= 4 else 4 if k <= 8 else 2


def tile_grid(N: int, S: int, heads: int) -> Tuple[int, int]:
    """(column tiles, row tiles) of a batch row's N x N pairs."""
    return -(-N // TILE_COLS), -(-N // (32 * tile_rows(heads, S)))


def row_stats_scratch(B2: int, N: int) -> int:
    """Floats of K7a's partials: a ``[B2, N]`` slice of row sums a column
    tile (``tile_grid(N, 0, 0)``: 256-row tiles), then one sum a 128-row
    block of each batch row."""
    return (tile_grid(N, 0, 0)[0] * N + -(-N // 128)) * B2


def means_scratch(B2: int, N: int, S: int, heads: int) -> int:
    """Floats of the loss sweep's partials: one a tile and head."""
    cols, rows = tile_grid(N, S, heads)
    return B2 * rows * cols * heads


def grads_scratch(B2: int, N: int, S: int, heads: int) -> int:
    """Floats of the gradient sweep's partials: a ``[B2, N, heads S]``
    slice of dc1 a column tile, then one of dc2 a row tile."""
    cols, rows = tile_grid(N, S, heads)
    return (cols + rows) * B2 * N * heads * S


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


def geo_row_stats_plain(f1: torch.Tensor, f2: torch.Tensor, max_depth: float,
                        halves: int = 2) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K7a: ``rowmean [B2, N]`` (the row sums of fd over N)
    and ``gm [halves]``, the mean of rowmean over each half's rows (with
    ``halves`` 2, rows ``[0, B)`` and ``[B, 2B)``)."""
    B2, N, _ = f1.shape
    rowmean = torch.cat([_fd(f1[:, blk], f2, max_depth).sum(-1) for blk in _blocks(N)], 1) / N
    return rowmean, torch.stack([r.mean() for r in rowmean.chunk(halves)])


def _means_plain(f1, f2, codes, rowmean, gm, shifts, max_depth: float) -> torch.Tensor:
    """``[halves * heads]``, half-major: per half (``len(gm)`` of them, shift
    ``shifts[half]``) and per head (``codes``, a list of ``(c1, c2)``) the sum
    of ``-cd * fd2`` over the half's ``(b, p, q)`` divided by ``B N N`` (B
    the rows of a half)."""
    B2, N, _ = f1.shape
    halves = gm.shape[0]
    tot = f1.new_zeros((len(codes), B2))
    for blk in _blocks(N):
        fd2 = _fd2_blk(f1, f2, rowmean, gm, shifts, blk, max_depth)
        for h, (c1, c2) in enumerate(codes):
            cd = torch.clamp(1.0 / (_l1(c1[:, blk, None, :], c2[:, None, :, :], False) + 0.05),
                             max=max_depth)
            tot[h] += (-cd * fd2).sum((1, 2))
    sums = torch.stack([t.sum() for half in tot.chunk(halves, 1) for t in half])
    return sums / float(B2 // halves * N * N)


def _grads_plain(f1, f2, codes, rowmean, gm, coeff, shifts, max_depth: float):
    """The codes' cotangents ``(dc1, dc2)`` of each head in turn, each
    ``[B2, N, S]``, from ``coeff [halves * heads]`` (the means' cotangents
    over ``B N N``, half-major): ``dd = [r <= max_depth] coeff fd2 r^2`` with
    ``r = 1 / (L1(c1, c2) + 0.05)`` times ``sign(c1 - c2)`` summed over
    columns (dc1) and times ``-sign(c1 - c2)`` summed over rows (dc2)."""
    B2, N, _ = f1.shape
    halves, heads = gm.shape[0], len(codes)
    outs = [torch.zeros_like(c) for pair in codes for c in pair]
    for blk in _blocks(N):
        fd2 = _fd2_blk(f1, f2, rowmean, gm, shifts, blk, max_depth)
        for h, (c1, c2) in enumerate(codes):
            co = torch.stack([coeff[k * heads + h] for k in range(halves)]).repeat_interleave(
                B2 // halves)
            diff = c1[:, blk, None, :] - c2[:, None, :, :]  # [B2, bi, N, S]
            r = 1.0 / (_l1(c1[:, blk, None, :], c2[:, None, :, :], False) + 0.05)
            dd = torch.where(r <= max_depth, co[:, None, None] * fd2 * r * r,
                             torch.zeros_like(r))
            sg = torch.sign(diff)
            outs[2 * h][:, blk] = (dd[..., None] * sg).sum(2)
            outs[2 * h + 1] += (dd[..., None] * -sg).sum(1)
    return tuple(outs)


def _fd2_blk(f1, f2, rowmean, gm, shifts, blk, max_depth):
    """``fd - rowmean + (gm - shift)`` of a block of rows, per half."""
    halves = gm.shape[0]
    off = torch.stack([gm[k] - shifts[k] for k in range(halves)]).repeat_interleave(
        f1.shape[0] // halves)
    return _fd(f1[:, blk], f2, max_depth) - rowmean[:, blk, None] + off[:, None, None]


def geo_single_means_plain(f1, f2, c1, c2, rowmean, gm, shift: float,
                           max_depth: float) -> torch.Tensor:
    """Plain version of K7b: ``[1]``, the mean of ``-cd * fd2`` over
    ``(b, p, q)`` (one half: ``gm [1]``)."""
    return _means_plain(f1, f2, [(c1, c2)], rowmean, gm, (shift,), max_depth)


def geo_single_grads_plain(f1, f2, c1, c2, rowmean, gm, coeff, shift: float,
                           max_depth: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K7c: ``coeff [1]`` -> ``(dc1, dc2)``."""
    return _grads_plain(f1, f2, [(c1, c2)], rowmean, gm, coeff, (shift,), max_depth)


def geo_pair_means_plain(f1, f2, c1a, c2a, c1b, c2b, rowmean, gm, shift: float,
                         max_depth: float) -> torch.Tensor:
    """Plain version of K7d: ``[2]``, the single mean of heads a and b on one
    sweep."""
    return _means_plain(f1, f2, [(c1a, c2a), (c1b, c2b)], rowmean, gm, (shift,), max_depth)


def geo_pair_grads_plain(f1, f2, c1a, c2a, c1b, c2b, rowmean, gm, coeff, shift: float,
                         max_depth: float):
    """Plain version of K7e: ``coeff [2]`` -> ``(dc1a, dc2a, dc1b, dc2b)``."""
    return _grads_plain(f1, f2, [(c1a, c2a), (c1b, c2b)], rowmean, gm, coeff, (shift,),
                        max_depth)


def geo_quad_means_plain(f1, f2, c1a, c2a, c1b, c2b, rowmean, gm, shift_lo: float,
                         shift_hi: float, max_depth: float) -> torch.Tensor:
    """Plain version of K7f: ``[4]`` = (neg coarse, neg fine, self coarse,
    self fine), each the sum of ``-cd * fd2`` over its half's ``(b, p, q)``
    divided by ``B N N`` (B the rows of a half)."""
    return _means_plain(f1, f2, [(c1a, c2a), (c1b, c2b)], rowmean, gm, (shift_lo, shift_hi),
                        max_depth)


def geo_quad_grads_plain(f1, f2, c1a, c2a, c1b, c2b, rowmean, gm, coeff, shift_lo: float,
                         shift_hi: float, max_depth: float
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K7g: ``coeff [4]`` (the four outputs' cotangents over
    ``B N N``) -> ``(dc1a, dc2a, dc1b, dc2b)``, each ``[2B, N, S]``."""
    return _grads_plain(f1, f2, [(c1a, c2a), (c1b, c2b)], rowmean, gm, coeff,
                        (shift_lo, shift_hi), max_depth)


# ----------------------------------------------------------------- wrappers


def _check(f1, f2, codes, *rest, halves: int) -> None:
    tensors = [f1, f2, *codes, *rest]
    for t in tensors:
        if t.device != f1.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("K7 takes contiguous float32 tensors on one device")
    if f1.dim() != 3 or f1.shape[2] != 3 or f2.shape != f1.shape or f1.shape[0] % halves:
        raise ValueError(f"expected points [B2, N, 3] with B2 a multiple of {halves}, got "
                         f"{tuple(f1.shape)}, {tuple(f2.shape)}")
    for c in codes:
        if c.shape[:2] != f1.shape[:2] or not 1 <= c.shape[2] <= _MAX_S:
            raise ValueError(f"expected codes [B2, N, S <= {_MAX_S}], got {tuple(c.shape)}")


def _ptrs(*tensors):
    return [None if t is None else t.data_ptr() for t in tensors]


def _device(f1: torch.Tensor) -> bool:
    """True for CPU tensors (the plain version), False for CUDA ones (the
    kernel); raises for any other device."""
    if f1.device.type == "cpu":
        return True
    if f1.device.type != "cuda":
        raise NotImplementedError(f"no kernel for device {f1.device}")
    return False


def geo_row_stats(f1: torch.Tensor, f2: torch.Tensor, max_depth: float,
                  halves: int = 2) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7a; see :func:`geo_row_stats_plain`. The pair tiles' row sums, then
    their sums in tile order and each half's mean (deterministic)."""
    if _device(f1):
        return geo_row_stats_plain(f1, f2, max_depth, halves)
    B2, N, _ = f1.shape
    _check(f1, f2, (), halves=halves)
    rowmean = torch.empty((B2, N), device=f1.device, dtype=torch.float32)
    gm = torch.empty(halves, device=f1.device, dtype=torch.float32)
    n = row_stats_scratch(B2, N)
    scratch = torch.empty(n, device=f1.device, dtype=torch.float32)
    with torch.cuda.device(f1.device):
        code = _build.library().geo_row_stats(*_ptrs(f1, f2, rowmean, gm, scratch), n, B2, N,
                                              halves, float(max_depth),
                                              _build.stream(f1.device))
    _build.check(code, "geo_row_stats")
    geo_row_stats.launches += 1
    return rowmean, gm


def _means(what, f1, f2, codes, rowmean, gm, shifts, max_depth) -> torch.Tensor:
    """The loss sweep for ``len(gm)`` halves x ``len(codes) // 2`` heads:
    one partial sum a pair tile, then their sums in a fixed order
    (deterministic)."""
    heads, halves = len(codes) // 2, gm.shape[0]
    _check(f1, f2, codes, rowmean, gm, halves=halves)
    B2, N, S = codes[0].shape
    c1b, c2b = codes[2:] if heads == 2 else (None, None)
    n = means_scratch(B2, N, S, heads)
    partial = torch.empty(n, device=f1.device, dtype=torch.float32)
    out = torch.empty(halves * heads, device=f1.device, dtype=torch.float32)
    with torch.cuda.device(f1.device):
        code = _build.library().geo_means(
            *_ptrs(f1, f2, codes[0], codes[1], c1b, c2b, rowmean, gm, partial, out), n, B2, N,
            S, heads, halves, float(shifts[0]), float(shifts[-1]), float(max_depth),
            _build.stream(f1.device))
    _build.check(code, what)
    return out


def _grads(what, f1, f2, codes, rowmean, gm, coeff, shifts, max_depth):
    """One sweep over the pair tiles (each pair once: its terms go to the
    tile's dc1 and dc2 partials), then the partials summed in tile order
    (deterministic); ``(dc1, dc2)`` of each head."""
    heads, halves = len(codes) // 2, gm.shape[0]
    _check(f1, f2, codes, rowmean, gm, coeff, halves=halves)
    B2, N, S = codes[0].shape
    outs = [torch.empty_like(c) for c in codes]
    c1b, c2b = codes[2:] if heads == 2 else (None, None)
    dc1b, dc2b = outs[2:] if heads == 2 else (None, None)
    n = grads_scratch(B2, N, S, heads)
    scratch = torch.empty(n, device=f1.device, dtype=torch.float32)
    with torch.cuda.device(f1.device):
        code = _build.library().geo_grads(
            *_ptrs(f1, f2, codes[0], codes[1], c1b, c2b, rowmean, gm, coeff, scratch, outs[0],
                   outs[1], dc1b, dc2b), n, B2, N, S, heads, halves, float(shifts[0]),
            float(shifts[-1]), float(max_depth), _build.stream(f1.device))
    _build.check(code, what)
    return tuple(outs)


def geo_single_means(f1, f2, c1, c2, rowmean, gm, shift: float,
                     max_depth: float) -> torch.Tensor:
    """K7b; see :func:`geo_single_means_plain`."""
    if _device(f1):
        return geo_single_means_plain(f1, f2, c1, c2, rowmean, gm, shift, max_depth)
    out = _means("geo_single_means", f1, f2, (c1, c2), rowmean, gm, (shift,), max_depth)
    geo_single_means.launches += 1
    return out


def geo_single_grads(f1, f2, c1, c2, rowmean, gm, coeff, shift: float, max_depth: float):
    """K7c; see :func:`geo_single_grads_plain`."""
    if _device(f1):
        return geo_single_grads_plain(f1, f2, c1, c2, rowmean, gm, coeff, shift, max_depth)
    out = _grads("geo_single_grads", f1, f2, (c1, c2), rowmean, gm, coeff, (shift,), max_depth)
    geo_single_grads.launches += 1
    return out


def geo_pair_means(f1, f2, c1a, c2a, c1b, c2b, rowmean, gm, shift: float,
                   max_depth: float) -> torch.Tensor:
    """K7d; see :func:`geo_pair_means_plain`."""
    if _device(f1):
        return geo_pair_means_plain(f1, f2, c1a, c2a, c1b, c2b, rowmean, gm, shift, max_depth)
    out = _means("geo_pair_means", f1, f2, (c1a, c2a, c1b, c2b), rowmean, gm, (shift,),
                 max_depth)
    geo_pair_means.launches += 1
    return out


def geo_pair_grads(f1, f2, c1a, c2a, c1b, c2b, rowmean, gm, coeff, shift: float,
                   max_depth: float):
    """K7e; see :func:`geo_pair_grads_plain`."""
    if _device(f1):
        return geo_pair_grads_plain(f1, f2, c1a, c2a, c1b, c2b, rowmean, gm, coeff, shift,
                                    max_depth)
    out = _grads("geo_pair_grads", f1, f2, (c1a, c2a, c1b, c2b), rowmean, gm, coeff, (shift,),
                 max_depth)
    geo_pair_grads.launches += 1
    return out


def geo_quad_means(f1, f2, c1a, c2a, c1b, c2b, rowmean, gm, shift_lo: float, shift_hi: float,
                   max_depth: float) -> torch.Tensor:
    """K7f; see :func:`geo_quad_means_plain`."""
    if _device(f1):
        return geo_quad_means_plain(f1, f2, c1a, c2a, c1b, c2b, rowmean, gm, shift_lo,
                                    shift_hi, max_depth)
    out = _means("geo_quad_means", f1, f2, (c1a, c2a, c1b, c2b), rowmean, gm,
                 (shift_lo, shift_hi), max_depth)
    geo_quad_means.launches += 1
    return out


def geo_quad_grads(f1, f2, c1a, c2a, c1b, c2b, rowmean, gm, coeff, shift_lo: float,
                   shift_hi: float, max_depth: float):
    """K7g; see :func:`geo_quad_grads_plain`."""
    if _device(f1):
        return geo_quad_grads_plain(f1, f2, c1a, c2a, c1b, c2b, rowmean, gm, coeff, shift_lo,
                                    shift_hi, max_depth)
    out = _grads("geo_quad_grads", f1, f2, (c1a, c2a, c1b, c2b), rowmean, gm, coeff,
                 (shift_lo, shift_hi), max_depth)
    geo_quad_grads.launches += 1
    return out


def rcp_mismatches(device: torch.device) -> int:
    """The floats in [0.05, 2^95] whose reciprocal on the pair sweeps' fast
    path (taken where a tile's inputs are all within 2^90, so that every
    ``1 / (L1 + 0.05)`` lies there) differs from IEEE ``1 / x`` in any bit:
    0 on a correct build. Runs on the card only."""
    count = torch.empty(1, device=device, dtype=torch.int64)
    with torch.cuda.device(device):
        code = _build.library().geo_rcp_mismatches(count.data_ptr(), _build.stream(device))
    _build.check(code, "geo_rcp_mismatches")
    return int(count.item())


for _fn in (geo_row_stats, geo_single_means, geo_single_grads, geo_pair_means, geo_pair_grads,
            geo_quad_means, geo_quad_grads):
    _fn.launches = 0


class _GeoMeans(torch.autograd.Function):
    """K7a and a loss sweep forward (``fns[0]``: single, pair or quad means),
    the matching gradient sweeps backward (``fns[1]``); one half a shift.
    The points get no gradient."""

    @staticmethod
    def forward(ctx, fns, shifts, max_depth, f1, f2, *codes):
        rowmean, gm = geo_row_stats(f1, f2, max_depth, len(shifts))
        out = fns[0](f1, f2, *codes, rowmean, gm, *shifts, max_depth)
        ctx.save_for_backward(f1, f2, *codes, rowmean, gm)
        ctx.grads, ctx.args = fns[1], (*shifts, max_depth)
        return out

    @staticmethod
    def backward(ctx, g):
        f1, f2, *codes, rowmean, gm = ctx.saved_tensors
        B2, N, _ = f1.shape
        coeff = (g / float(B2 // gm.shape[0] * N * N)).to(torch.float32).contiguous()
        return (None,) * 5 + tuple(ctx.grads(f1, f2, *codes, rowmean, gm, coeff, *ctx.args))


def _rows(x: torch.Tensor) -> torch.Tensor:
    """``[B, C, H, W]`` -> ``[B, H W, C]``, contiguous."""
    B, C = x.shape[:2]
    return x.reshape(B, C, -1).transpose(1, 2).contiguous()


def geo_helper_mean(f1: torch.Tensor, f2: torch.Tensor, c1n: torch.Tensor, c2n: torch.Tensor,
                    shift: float, max_depth: float) -> torch.Tensor:
    """One geometry helper mean (replaces ``flash_geo_helper_mean``):
    ``f1``, ``f2 [B, 3, H, W]`` points (no gradient), the codes ``[B, S, H,
    W]`` channel-normalised; K7a + K7b forward, K7c backward."""
    return _GeoMeans.apply((geo_single_means, geo_single_grads), (float(shift),),
                           float(max_depth), _rows(f1.detach()), _rows(f2.detach()), _rows(c1n),
                           _rows(c2n))[0]


def geo_helper_mean_pair(f1: torch.Tensor, f2: torch.Tensor, c1n_a: torch.Tensor,
                         c2n_a: torch.Tensor, c1n_b: torch.Tensor, c2n_b: torch.Tensor,
                         shift: float, max_depth: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two helper means on one fd sweep (replaces
    ``flash_geo_helper_mean_pair``): K7a + K7d forward, K7e backward."""
    out = _GeoMeans.apply((geo_pair_means, geo_pair_grads), (float(shift),), float(max_depth),
                          _rows(f1.detach()), _rows(f2.detach()), _rows(c1n_a), _rows(c2n_a),
                          _rows(c1n_b), _rows(c2n_b))
    return out[0], out[1]


def flash_geo_pair_quad(feats: torch.Tensor, neg_feats: torch.Tensor, c0n: torch.Tensor,
                        c0n_neg: torch.Tensor, c1n: torch.Tensor, c1n_neg: torch.Tensor,
                        shift_neg: float, shift_self: float, max_depth: float
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The SOS step's four geometry helper means (neg coarse, neg fine, self
    coarse, self fine). ``feats``, ``neg_feats [B, 3, H, W]`` are points (no
    gradient), the codes ``[B, S, H, W]`` channel-normalised; K7a + K7f
    forward, K7g backward."""
    f, nf = _rows(feats.detach()), _rows(neg_feats.detach())
    a, na, b, nb = _rows(c0n), _rows(c0n_neg), _rows(c1n), _rows(c1n_neg)
    out = _GeoMeans.apply((geo_quad_means, geo_quad_grads),
                          (float(shift_neg), float(shift_self)), float(max_depth),
                          torch.cat([f, f]), torch.cat([nf, f]), torch.cat([a, a]),
                          torch.cat([na, a]), torch.cat([b, b]), torch.cat([nb, b]))
    return out[0], out[1], out[2], out[3]
