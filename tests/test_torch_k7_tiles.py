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
run, then the same tree. Every scratch entry is written exactly once.
"""
import numpy as np
import pytest
import torch

from nerfsos_torch.ops import flash_corr as fc

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
