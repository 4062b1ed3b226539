"""The dataflow of K7's pair-tile kernels (``csrc/flash_corr.cu``), modelled
in torch on the CPU and held against the plain versions in
``nerfsos_torch/ops/flash_corr.py``.

The model follows the kernels: a CTA a tile of ``32 tile_rows`` rows x
``TILE_COLS`` columns of one batch row; lane ``l`` holds rows ``p0 + l +
32 i``; warp ``w`` walks columns ``[64 w, 64 (w + 1))`` of the tile; rows
past N get zeros and (gradients) a zero coefficient, columns past N are
never visited. The gradient sweep forms each pair's terms once: they add
into the lane's dc1 of its row and, summed over the lane's rows and then
over the warp by an xor-shuffle tree, into the tile's dc2 partial of the
column; the warps' dc1 are summed in warp order into the tile's dc1
partial; a finish sums the partial slices in block order. The loss sweep
sums each lane's valid rows, then the CTA in ``block_sum``'s tree, one
partial a tile; the finish sums each half's partials a thread a strided
run, then the same tree. K7a's sweep (the row stats) takes the same tiles
without codes (256 rows): each lane's running sums of fd over its warp's
columns, the warps' in warp order, one row-sum slice a column tile; a
second kernel sums a row's slices in tile order over N (rowmean) and its
128-row block's means in the tree, a third each half's block sums (gm).
Every scratch entry is written exactly once.
"""
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsos_torch.ops import flash_corr as fc
from nerfsos_tpu.ops.pallas import flash_corr as jfc


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for torch in this module's tests (the count found
    is restored after): the tier-1 run's pytest workers share the machine's
    cores, and torch's default of a thread a core in each worker
    oversubscribes them many times over."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


WARPS = 4


def _inputs(B2, N, S, heads, seed):
    """Points of rendered-depth scale and channel-normalised codes."""
    rng = np.random.default_rng(seed)
    pts = [rng.normal(size=(B2, N, 3)) * 0.7 for _ in range(2)]
    codes = []
    for _ in range(2 * heads):
        c = rng.normal(size=(B2, N, S))
        codes.append(c / np.linalg.norm(c, axis=2, keepdims=True))
    return [torch.from_numpy(np.ascontiguousarray(a, np.float32)) for a in (*pts, *codes)]


def _block_sum(v):
    """``block_sum`` over the last axis (128 threads): each warp's
    ``__shfl_down_sync`` tree (a lane past the warp adds its own value), then
    the warps' lane 0 in order from 0."""
    v = v.reshape(*v.shape[:-1], WARPS, 32)
    for o in (16, 8, 4, 2, 1):
        v = v + torch.cat([v[..., o:], v[..., 32 - o:]], -1)
    s = torch.zeros(v.shape[:-2])
    for w in range(WARPS):
        s = s + v[..., w, 0]
    return s


class _Tiles:
    """The tile walk of one call: its grid, each tile's lanes' rows and the
    warps' columns, with the pair terms of a warp."""

    def __init__(self, f1, f2, codes, rowmean, gm, shifts, max_depth):
        self.heads = len(codes) // 2
        self.B2, self.N, self.S = codes[0].shape
        self.R = fc.tile_rows(self.heads, self.S)
        self.tile_rows, self.wc = 32 * self.R, fc.TILE_COLS // WARPS
        self.ncb, self.nrb = fc.tile_grid(self.N, self.S, self.heads)
        self.halves = gm.shape[0]
        self.half = torch.arange(self.B2) // (self.B2 // self.halves)
        self.off = (gm - torch.tensor(shifts, dtype=torch.float32))[self.half]
        self.f1, self.f2, self.rowmean, self.maxd = f1, f2, rowmean, max_depth
        self.c1, self.c2 = codes[0::2], codes[1::2]

    def rows(self, rb):
        """The tile's rows ``[32, R]`` (lane, i), which are < N, and each
        lane row's points, codes of each head and rowmean (zeros past N)."""
        p = rb * self.tile_rows + torch.arange(32)[:, None] + 32 * torch.arange(self.R)
        ok = p < self.N
        pc = p.clamp(max=self.N - 1)

        def take(t):
            return torch.where(ok[..., None], t[:, pc], torch.zeros(()))

        return p, ok, take(self.f1), [take(c) for c in self.c1], \
            torch.where(ok, self.rowmean[:, pc], torch.zeros(()))

    def warp_cols(self, cb, w):
        q0 = cb * fc.TILE_COLS
        nc = min(fc.TILE_COLS, self.N - q0)
        lo, hi = w * self.wc, min(nc, (w + 1) * self.wc)
        return torch.arange(q0 + lo, q0 + max(lo, hi))

    def fd2(self, a, rm, j):
        """``fd - rowmean + off`` of the lanes' rows x the columns j:
        ``[B2, 32, R, J]``, with the plain version's operations."""
        x = self.f2[:, j]
        fd = torch.clamp(1.0 / (fc._l1(a[:, :, :, None], x[:, None, None], True) + 0.05),
                         max=self.maxd)
        return fd - rm[..., None] + self.off[:, None, None, None]

    def r(self, c1, h, j):
        """``1 / (L1(c1, c2) + 0.05)`` of head h: ``[B2, 32, R, J]``."""
        return 1.0 / (fc._l1(c1[h][:, :, :, None], self.c2[h][:, j][:, None, None], False)
                      + 0.05)


def _grads_model(f1, f2, codes, rowmean, gm, coeff, shifts, max_depth):
    t = _Tiles(f1, f2, codes, rowmean, gm, shifts, max_depth)
    B2, N, S, R, heads = t.B2, t.N, t.S, t.R, t.heads
    K = heads * S
    slice_ = B2 * N * K
    scratch = torch.full((fc.grads_scratch(B2, N, S, heads),), float("nan"))
    writes = torch.zeros(scratch.shape, dtype=torch.int64)
    assert scratch.numel() == (t.ncb + t.nrb) * slice_
    part1 = scratch[:t.ncb * slice_].view(t.ncb, B2, N, K)
    part2 = scratch[t.ncb * slice_:].view(t.nrb, B2, N, K)
    w1 = writes[:t.ncb * slice_].view(t.ncb, B2, N, K)
    w2 = writes[t.ncb * slice_:].view(t.nrb, B2, N, K)
    co = coeff.view(t.halves, heads)[t.half]  # [B2, heads]
    lanes = torch.arange(32)
    for rb in range(t.nrb):
        p, ok, a, c1, rm = t.rows(rb)
        co_r = torch.where(ok[..., None], co[:, None, None, :], torch.zeros(()))  # past N: 0
        for cb in range(t.ncb):
            red = []
            for w in range(WARPS):
                j = t.warp_cols(cb, w)
                g = torch.zeros(B2, 32, R, K)
                if len(j):
                    fd2 = t.fd2(a, rm, j)
                    terms = []
                    for h in range(heads):
                        r = t.r(c1, h, j)
                        dd = torch.where(r <= max_depth, co_r[..., h, None] * fd2 * r * r,
                                         torch.zeros(()))
                        sg = torch.sign(c1[h][:, :, :, None] - t.c2[h][:, j][:, None, None])
                        terms.append(dd[..., None] * sg)  # [B2, 32, R, J, S]
                    term = torch.cat(terms, -1)  # k = head S + channel
                    g = term.sum(3)  # the lane's dc1 of its rows, over the warp's columns
                    col = term[:, :, 0] * -1  # dc2: the lane's rows in order ...
                    for i in range(1, R):
                        col = col + term[:, :, i] * -1
                    for o in (16, 8, 4, 2, 1):  # ... then the warp's xor tree
                        col = col + col[:, lanes ^ o]
                    assert torch.equal(col, col[:, :1].expand_as(col))  # every lane holds it
                    part2[rb, :, j] = col[:, 0]
                    w2[rb, :, j] += 1
                red.append(g)
            s = red[0]
            for w in range(1, WARPS):  # the warps' dc1 in warp order
                s = s + red[w]
            s = s.transpose(1, 2).reshape(B2, t.tile_rows, K)  # tile row lane + 32 i
            p0 = rb * t.tile_rows
            nr = min(t.tile_rows, N - p0)
            part1[cb, :, p0:p0 + nr] = s[:, :nr]
            w1[cb, :, p0:p0 + nr] += 1
    assert not scratch.isnan().any() and bool((writes == 1).all())
    dc1, dc2 = part1[0], part2[0]
    for c in range(1, t.ncb):
        dc1 = dc1 + part1[c]
    for r in range(1, t.nrb):
        dc2 = dc2 + part2[r]
    out = []
    for h in range(heads):
        out += [dc1[..., h * S:(h + 1) * S], dc2[..., h * S:(h + 1) * S]]
    return tuple(out)


def _means_model(f1, f2, codes, rowmean, gm, shifts, max_depth):
    t = _Tiles(f1, f2, codes, rowmean, gm, shifts, max_depth)
    B2, N, S, R, heads = t.B2, t.N, t.S, t.R, t.heads
    n = fc.means_scratch(B2, N, S, heads)
    partial = torch.full((B2, t.nrb, t.ncb, heads), float("nan"))
    assert partial.numel() == n
    for rb in range(t.nrb):
        p, ok, a, c1, rm = t.rows(rb)
        for cb in range(t.ncb):
            v = torch.zeros(B2, WARPS, 32, R, heads)
            for w in range(WARPS):
                j = t.warp_cols(cb, w)
                if len(j):
                    fd2 = t.fd2(a, rm, j)
                    for h in range(heads):
                        cd = torch.clamp(t.r(c1, h, j), max=max_depth)
                        v[:, w, ..., h] = (-cd * fd2).sum(-1)
            lane = torch.zeros(B2, WARPS, 32, heads)
            for i in range(R):  # each lane's valid rows in order
                lane = lane + torch.where(ok[:, i, None], v[:, :, :, i], torch.zeros(()))
            partial[:, rb, cb] = _block_sum(lane.reshape(B2, 128, heads).transpose(1, 2))
    assert not partial.isnan().any()
    per_half = partial.reshape(t.halves, -1, heads)  # each half's partials, in CTA order
    m = -(-per_half.shape[1] // 128)
    x = torch.cat([per_half, torch.zeros(t.halves, m * 128 - per_half.shape[1], heads)], 1)
    x = x.reshape(t.halves, m, 128, heads)
    s = torch.zeros(t.halves, 128, heads)
    for i in range(m):  # thread k sums partials k, k + 128, ... in order
        s = s + x[:, i]
    out = _block_sum(s.transpose(1, 2)) / float(B2 // t.halves * N * N)
    return out.reshape(-1)


FORMS = {  # name: (heads, halves, means plain, grads plain)
    "quad": (2, 2, fc.geo_quad_means_plain, fc.geo_quad_grads_plain),
    "single": (1, 1, fc.geo_single_means_plain, fc.geo_single_grads_plain),
    "pair": (2, 1, fc.geo_pair_means_plain, fc.geo_pair_grads_plain),
}
# ragged N (no multiple of either tile side) and every rows-a-lane rule:
# heads S <= 4 (8 rows a lane), <= 8 (4), 16 (2: quad/pair at S = 8)
SHAPES = [(77, 1), (77, 8), (1000, 2), (1000, 3)]


def _case(form, N, S, maxd):
    heads, halves, means_plain, grads_plain = FORMS[form]
    B2 = 2 * halves
    f1, f2, *codes = _inputs(B2, N, S, heads, N + S + heads)
    shifts = (0.5, 3.0)[:halves]
    rm, gm = fc.geo_row_stats_plain(f1, f2, maxd, halves)
    return heads, halves, means_plain, grads_plain, (f1, f2, codes, rm, gm, shifts)


def _rel(a, ref):
    return float((a - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("N,S", SHAPES)
@pytest.mark.parametrize("maxd", [15.0, 1.5])
def test_k7_grad_tiles_match_plain(form, N, S, maxd):
    """The one-pass tiled gradient sweep's dc1/dc2 of each head to 1e-5 of
    the plain version's largest value."""
    heads, halves, _, grads_plain, (f1, f2, codes, rm, gm, shifts) = _case(form, N, S, maxd)
    B2 = f1.shape[0]
    coeff = torch.tensor([0.3, -1.0, 2.0, 0.7][:halves * heads]) / (B2 // halves * N * N)
    got = _grads_model(f1, f2, codes, rm, gm, coeff, shifts, maxd)
    want = grads_plain(f1, f2, *codes, rm, gm, coeff, *shifts, maxd)
    assert len(got) == len(want) == 2 * heads
    for a, ref in zip(got, want):
        assert a.shape == ref.shape and float(ref.abs().max()) > 0
        assert _rel(a, ref) <= 1e-5


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("N,S", SHAPES)
@pytest.mark.parametrize("maxd", [15.0, 1.5])
def test_k7_loss_tiles_match_plain(form, N, S, maxd):
    """The split-column loss sweep's means to 1e-5 of the plain version's
    largest."""
    heads, halves, means_plain, _, (f1, f2, codes, rm, gm, shifts) = _case(form, N, S, maxd)
    got = _means_model(f1, f2, codes, rm, gm, shifts, maxd)
    want = means_plain(f1, f2, *codes, rm, gm, *shifts, maxd)
    assert got.shape == want.shape == (halves * heads,)
    assert _rel(got, want) <= 1e-5


def test_k7_tile_grid_at_the_flagship_call():
    """16 x 4096 pixels, two heads of 2 channels: 8 rows a lane, 256-row x
    256-column tiles, 16 x 16 x 16 = 4096 CTAs; the gradient's partials are
    a 1-MiB slice a column tile and a row tile."""
    assert fc.tile_rows(2, 2) == 8 and fc.TILE_COLS == 256
    assert fc.tile_grid(4096, 2, 2) == (16, 16)
    assert fc.grads_scratch(16, 4096, 2, 2) == 32 * (16 * 4096 * 4)
    assert fc.means_scratch(16, 4096, 2, 2) == 16 * 16 * 16 * 2
    assert [fc.tile_rows(h, s) for h, s in ((1, 4), (1, 5), (2, 4), (2, 5), (2, 8))] == \
        [8, 4, 4, 2, 2]


def _row_stats_model(f1, f2, max_depth, halves):
    """K7a as its three kernels compute it: ``(rowmean [B2, N], gm
    [halves])``, with every scratch entry written once."""
    B2, N, _ = f1.shape
    ncb, nrb = fc.tile_grid(N, 0, 0)
    R, rows, wc = fc.tile_rows(0, 0), 32 * fc.tile_rows(0, 0), fc.TILE_COLS // WARPS
    nblk = -(-N // 128)
    scratch = torch.full((fc.row_stats_scratch(B2, N),), float("nan"))
    writes = torch.zeros(scratch.shape, dtype=torch.int64)
    part, w_part = (t[:ncb * B2 * N].view(ncb, B2, N) for t in (scratch, writes))
    blk, w_blk = (t[ncb * B2 * N:].view(B2, nblk) for t in (scratch, writes))
    for rb in range(nrb):
        p = rb * rows + torch.arange(32)[:, None] + 32 * torch.arange(R)  # [lane, i]
        ok = p < N
        a = torch.where(ok[..., None], f1[:, p.clamp(max=N - 1)], torch.zeros(()))
        for cb in range(ncb):
            q0 = cb * fc.TILE_COLS
            nc = min(fc.TILE_COLS, N - q0)
            red = []
            for w in range(WARPS):
                v = torch.zeros(B2, 32, R)
                for j in range(q0 + w * wc, q0 + min(nc, (w + 1) * wc)):  # in column order
                    x = f2[:, j][:, None, None]
                    v = v + torch.clamp(1.0 / (fc._l1(a, x, True) + 0.05), max=max_depth)
                red.append(v)
            s = red[0]
            for w in range(1, WARPS):
                s = s + red[w]
            s = s.transpose(1, 2).reshape(B2, rows)  # tile row lane + 32 i
            p0 = rb * rows
            nr = min(rows, N - p0)
            part[cb, :, p0:p0 + nr] = s[:, :nr]
            w_part[cb, :, p0:p0 + nr] += 1
    rowmean = part[0]
    for c in range(1, ncb):
        rowmean = rowmean + part[c]
    rowmean = rowmean / N
    padded = torch.cat([rowmean, torch.zeros(B2, nblk * 128 - N)], 1).view(B2, nblk, 128)
    blk[:] = _block_sum(padded)
    w_blk += 1
    assert not scratch.isnan().any() and bool((writes == 1).all())
    per_half = blk.reshape(halves, -1)  # each half's block sums in order
    n = per_half.shape[1]
    m = -(-n // 128)
    x = torch.cat([per_half, torch.zeros(halves, m * 128 - n)], 1).view(halves, m, 128)
    acc = torch.zeros(halves, 128)
    for i in range(m):  # thread k sums block sums k, k + 128, ... in order
        acc = acc + x[:, i]
    return rowmean, _block_sum(acc) / float(B2 // halves * N)


@pytest.mark.parametrize("B2,N,halves", [(4, 77, 2), (2, 300, 1), (4, 1000, 2)])
@pytest.mark.parametrize("maxd", [15.0, 1.5])
def test_k7a_row_tiles_match_plain(B2, N, halves, maxd):
    """K7a's tiles at ragged N (no multiple of the 256-row or 256-column
    tile): rowmean to 1e-5 of the plain version's largest, each half's gm
    to 1e-5 of its own."""
    f1, f2 = _inputs(B2, N, 1, 1, N + B2)[:2]
    got = _row_stats_model(f1, f2, maxd, halves)
    want = fc.geo_row_stats_plain(f1, f2, maxd, halves)
    assert got[0].shape == want[0].shape == (B2, N) and got[1].shape == want[1].shape == (halves,)
    assert _rel(got[0], want[0]) <= 1e-5
    assert float(((got[1] - want[1]).abs() / want[1].abs()).max()) <= 1e-5


def test_k7a_row_tiles_match_pallas():
    """At 384 pixels (a ragged second tile both ways; the Pallas kernel
    needs N a multiple of 128), the tile model against the JAX package's
    ``_row_stats`` (interpret mode): rowmean to 1e-5 of its largest, each
    half's gm to 1e-5 of the mean of the JAX rowmean over that half."""
    f1, f2 = _inputs(4, 384, 1, 1, 9)[:2]
    rm, gm = _row_stats_model(f1, f2, 15.0, 2)
    rm_j, _ = jfc._row_stats(jnp.asarray(f1.numpy()),
                             jnp.asarray(f2.numpy().transpose(0, 2, 1)), 15.0, True)
    rm_j = torch.from_numpy(np.array(rm_j)[..., 0])
    assert _rel(rm, rm_j) <= 1e-5
    gm_j = torch.stack([rm_j[:2].mean(), rm_j[2:].mean()])
    assert float(((gm - gm_j).abs() / gm_j.abs()).max()) <= 1e-5


def test_k7a_tile_grid_at_the_flagship_call():
    """16 x 4096 pixels: 256-row x 256-column tiles, 16 x 16 x 16 = 4096
    CTAs; a 256-KiB slice of row sums a column tile and a batch row's 32
    block sums."""
    assert fc.tile_rows(0, 0) == 8 and fc.tile_grid(4096, 0, 0) == (16, 16)
    assert fc.row_stats_scratch(16, 4096) == 16 * (16 * 4096 + 32)


def test_k7a_wrapper_launches_with_its_scratch(monkeypatch):
    """On the card geo_row_stats calls the library's ``geo_row_stats`` once
    with a scratch of ``row_stats_scratch`` floats (the tiles' row sums and
    the block sums) and counts the launch (here on a library that records
    the call); for a CPU tensor it is the plain version."""
    f1, f2 = _inputs(4, 300, 1, 1, 3)[:2]
    want = fc.geo_row_stats_plain(f1, f2, 15.0, 2)
    got = fc.geo_row_stats(f1, f2, 15.0, 2)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    calls = []

    class Lib:
        def geo_row_stats(self, *a):
            calls.append(a)
            return 0

    monkeypatch.setattr(fc, "_device", lambda t: False)
    monkeypatch.setattr(fc._build, "library", Lib)
    monkeypatch.setattr(fc._build, "stream", lambda device: None)
    monkeypatch.setattr(fc.torch.cuda, "device", lambda device: contextlib.nullcontext())
    before = fc.geo_row_stats.launches
    rm, gm = fc.geo_row_stats(f1, f2, 15.0, 2)
    (a,) = calls
    assert a[:4] == (f1.data_ptr(), f2.data_ptr(), rm.data_ptr(), gm.data_ptr())
    assert a[5:] == (fc.row_stats_scratch(4, 300), 4, 300, 2, 15.0, None)
    assert fc.row_stats_scratch(4, 300) == 4 * (2 * 300 + 3)
    assert fc.geo_row_stats.launches == before + 1
