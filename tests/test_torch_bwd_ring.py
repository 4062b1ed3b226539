"""The reverse sweep's input-gradient products on wgmma
(``nerfsos_torch/csrc/train_sweep.cuh`` bwd_layer) modelled on the CPU: the
backward ring's host packing (``pack_bwd_ring``, and K8c's
``pack_input_ring``) unpacked against ``pack_train_bwd``'s and
``pack_input_bwd``'s matrices and TF32 parts in every mode (K3, K6 with and
without sem_0's coordinates, the mip field, the standalone field's input
gradients), its repacking after a weight update, and the kernel's dX
dataflow (chunks, rounds of four warpgroups over (sub, piece) units, k-slice
by k-slice 3xTF32 products with B from the ring's layout and A split
through ``_tf32``, the store mask, the accumulate and the gate) fed through
``test_torch_train_render._emulate_k3``'s reverse sweep, against the plain
versions and the Pallas kernel (K6: ``jax.vjp`` of
``fused_train_render_planar``, interpret mode) at tiny widths.

The CUDA kernel itself runs only on a card (tests/test_torch_cuda.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train_render import _emulate_k3

from nerfsos_torch.engines.checkpoint import state_dict_from_jax_params
from nerfsos_torch.models.fields import MipNeRFField, NeRFField
from nerfsos_torch.models.nerf import NeRFConfig as TorchConfig
from nerfsos_torch.models.nerf import NeRFNet as TorchNet
from nerfsos_torch.ops import fused_field as ff
from nerfsos_torch.ops import fused_render as fr
from nerfsos_tpu.models.nerf import NeRFConfig as JaxConfig
from nerfsos_tpu.models.nerf import NeRFNet as JaxNet
from nerfsos_tpu.ops.pallas import fused_render as jfr

R = 20  # rays: the last chunk is ragged
WG = 64  # points a sub (a consumer warpgroup's A rows)


@pytest.fixture(autouse=True)
def small_pallas_block(monkeypatch):
    """8 rays per Pallas grid step keeps interpret mode fast."""
    monkeypatch.setattr(jfr, "TRAIN_RAY_BLOCK", 8)


def _unpack(ring, rd, L, i):
    """Layer i's ring stages unpacked to the TF32 high and low parts of its
    matrix ``[k, N]`` (the inverse of the per-slice layout)."""
    n, k = rd.ncols[i], L.k
    blocks = ring[rd.off[i]:rd.off[i] + k * 2 * n].view(k // 8, 2, n // 8, 2, 8, 4)
    parts = blocks.permute(1, 0, 3, 5, 2, 4).reshape(2, k, n)  # [part, s h c, j r]
    return parts[0], parts[1]


def _check_ring(ring, rd, buf, layers, order):
    """Every layer of ``order`` in the ring, one after another, unpacks to
    the hi and lo parts of its matrix in ``buf`` (``pack_bwd_matrices``'
    ``[w, hi, lo, bias]``) with zero padding columns up to its wgmma width."""
    off = 0
    for i in order:
        L = layers[i]
        ldn, n = fr._pad8(L.n), rd.ncols[i]
        assert n == fr._ring_n(L.n) and rd.off[i] == off, i
        off += L.k * 2 * n
        hi, lo = _unpack(ring, rd, L, i)
        size = L.k * ldn
        assert torch.equal(hi[:, :ldn].reshape(-1), buf[L.w + size:L.w + 2 * size]), i
        assert torch.equal(lo[:, :ldn].reshape(-1), buf[L.w + 2 * size:L.w + 3 * size]), i
        assert not hi[:, ldn:].any() and not lo[:, ldn:].any(), i
        w = buf[L.w:L.w + size].view(L.k, ldn)
        assert float((hi[:, :ldn] + lo[:, :ldn] - w).abs().max()) <= 2.0**-20 * float(
            w.abs().max()), i
    assert off == ring.numel()
    assert rd.stage_floats == 16 * max(rd.ncols[i] for i in order)
    assert {i for i in range(len(layers)) if layers[i].k} == set(order)


def _field(mode, depth=4, width=32):
    torch.manual_seed(depth + len(mode))
    if mode == "mip":
        return MipNeRFField(net_depth=depth, net_width=width, multires=4, multires_views=2)
    sem, coord = {"k3": (False, False), "k6": (True, True), "k6_nocoord": (True, False)}[mode]
    return NeRFField(net_depth=depth, net_width=width, multires=4, multires_views=2,
                     use_semantics=sem, sem_with_coord=coord, sem_dim=2)


@pytest.mark.parametrize("mode", ["k3", "k6", "k6_nocoord", "mip"])
@pytest.mark.parametrize("depth,width", [(4, 32), (5, 16)])
def test_bwd_ring_unpacks_to_the_backward_matrices(mode, depth, width):
    """K3's, K6's (with and without coordinates) and the mip field's ring:
    ``pack_train_bwd``'s matrices in the kernel's order (rgb, views, alpha's
    slot, sem_1, sem_0, the trunk from the top)."""
    field = _field(mode, depth, width)
    buf, bwd = fr.pack_train_bwd(field)
    ring, rd = fr.pack_bwd_ring(field)
    order = fr.bwd_ring_layers(field)
    sem = field.mlp.use_semantics
    assert order == ([depth + 3, depth + 2, depth] + ([depth + 5, depth + 4] if sem else [])
                     + list(range(depth - 1, 0, -1)))
    _check_ring(ring, rd, buf, bwd, order)
    assert rd.ncols[depth] == fr._ring_n(width) and bwd[depth].k == fr._pad8(width) + 8


@pytest.mark.parametrize("depth,coord", [(4, True), (5, False), (5, True), (6, True)])
def test_input_ring_unpacks_to_the_input_matrices(depth, coord):
    """The standalone field's input-gradient ring (K8c): ``pack_input_bwd``'s
    matrices in the kernel's order (views, alpha's slot when the skip
    follows the last layer, sem_0, the layer after the skip, layer 0)."""
    torch.manual_seed(depth)
    field = NeRFField(net_depth=depth, net_width=32, multires=4, multires_views=2,
                      use_semantics=True, sem_with_coord=coord, sem_dim=2)
    buf, ibwd = ff.pack_input_bwd(field)
    ring, rd = ff.pack_input_ring(field)
    order = ff.input_ring_layers(field)
    skip_last = depth - 1 in field.mlp.skips
    assert order == ([depth + 2] + ([depth] if skip_last else [])
                     + ([depth + 4] if skip_last or coord else [])
                     + ([5] if depth > 5 else []) + [0])
    _check_ring(ring, rd, buf, ibwd, order)


@pytest.mark.parametrize("layer", ["semantic_linear.0", "pts_linears.2"])
def test_bwd_ring_repacks_a_changed_layer_only(layer):
    """The ring is a gather of ``pack_train_bwd``'s TF32 parts: an update of
    sem_0 alone (a --fix_backbone step) or of one trunk layer changes that
    matrix's stages and no other's, gives what a fresh field with the same
    weights gives, and the wrappers' cached ring (``_bwd_ring``, gathered
    from the cached ``pack_train_bwd`` buffer) follows the update."""
    field = _field("k6")
    cpu = torch.device("cpu")
    before, rd = fr.pack_bwd_ring(field)
    assert torch.equal(fr._bwd_ring(field, cpu)[0], before)
    with torch.no_grad():
        field.mlp.get_submodule(layer).weight.mul_(-0.5)
    after, rd2 = fr.pack_bwd_ring(field)
    assert torch.equal(fr._bwd_ring(field, cpu)[0], after)
    fresh = _field("k6")
    fresh.load_state_dict(field.state_dict())
    assert torch.equal(after, fr.pack_bwd_ring(fresh)[0])
    i = 4 + 4 if layer.startswith("semantic") else 2  # its backward matrix's index at depth 4
    L = fr.pack_train_bwd(field)[1][i]
    lo, hi = rd.off[i], rd.off[i] + 2 * L.k * rd.ncols[i]
    assert not torch.equal(before[lo:hi], after[lo:hi])
    assert torch.equal(before[:lo], after[:lo]) and torch.equal(before[hi:], after[hi:])
    assert list(rd.off) == list(rd2.off) and list(rd.ncols) == list(rd2.ncols)


def _ring_dx(field, S, max_piece=128):
    """``_emulate_k3``'s ``dx`` as bwd_layer computes it, from
    ``pack_bwd_ring``'s buffer alone: per chunk of the plan's rays (64-point
    subs, the last one zero past the chunk's points), rounds of four
    warpgroups over (sub, piece) units (pieces of ``min(N, max_piece)``
    outputs; the kernel's is 128, a smaller one exercises the pieces at tiny
    widths), each unit k-slice by k-slice ``lo x hi + hi x lo + hi x hi``
    with A split through ``_tf32``; the plane's rows ``n < pad8(n)`` are
    stored, after ``add`` and then the gate."""
    ring, rd = fr.pack_bwd_ring(field)
    bwd = fr.pack_train_bwd(field)[1]
    fdesc = fr.pack_field(field)[1]
    rpc = fr._wg_plan(fdesc, fr.pack_ring(field)[1], S)[0]

    def dx(i, segs, gate=None, add=None):
        L, N = bwd[i], rd.ncols[i]
        NP = min(N, max_piece)
        npc, ldn, nk = N // NP, fr._pad8(L.n), L.k // 8
        per = 4 // npc
        hi, lo = _unpack(ring, rd, L, i)
        y = torch.cat(segs)
        assert y.shape[0] == L.k
        out = torch.full((ldn, y.shape[1]), float("nan"))
        for c0 in range(0, y.shape[1], rpc * S):
            nq = min(rpc * S, y.shape[1] - c0)
            nsub = -(-nq // WG)
            yc = y.new_zeros(L.k, nsub * WG)
            yc[:, :nq] = y[:, c0:c0 + nq]
            units = []
            for r in range(-(-nsub // per)):
                for wg in range(4):
                    sub, n0 = r * per + wg // npc, (wg % npc) * NP
                    if sub >= nsub:
                        continue
                    units.append((sub, n0))
                    a = yc[:, WG * sub:WG * sub + WG]
                    acc = torch.zeros(WG, NP)
                    for s in range(nk):
                        ak = a[8 * s:8 * s + 8]
                        ahi = fr._tf32(ak)
                        alo = fr._tf32(ak - ahi)
                        bh, bl = hi[8 * s:8 * s + 8, n0:n0 + NP], lo[8 * s:8 * s + 8, n0:n0 + NP]
                        acc = acc + alo.t() @ bh + ahi.t() @ bl + ahi.t() @ bh
                    rows = max(0, min(NP, ldn - n0))
                    q = torch.arange(WG * sub, WG * sub + WG)
                    keep = q < nq
                    out[n0:n0 + rows, c0 + q[keep]] = acc.t()[:rows, keep]
            assert sorted(units) == [(s, n) for s in range(nsub) for n in range(0, N, NP)]
        assert not out.isnan().any()
        if add is not None:
            out = out + add
        return out if gate is None else torch.where(gate > 0, out, torch.zeros_like(out))

    return dx


def _inputs(seed, s):
    rng = np.random.default_rng(seed)
    odv = rng.normal(size=(R, 9)).astype(np.float32)
    odv[:, 6:9] = odv[:, 3:6] / np.linalg.norm(odv[:, 3:6], axis=1, keepdims=True)
    z = np.sort(rng.uniform(1, 4, size=(R, s)), 1).astype(np.float32)
    return odv, z


def _rel_errs(got, want):
    assert set(got) == set(want)
    out = {}
    for name, ref in want.items():
        ref = torch.as_tensor(ref)
        assert got[name].shape == ref.shape, name
        out[name] = float((got[name] - ref).abs().max()) / (float(ref.abs().max()) + 1e-9)
    return out


MODEL_CASES = [  # (K3 or K6, depth, semantic head, its coordinates, samples, noise, piece)
    ("k3", 4, True, True, 8, 0.6, 128), ("k3", 5, False, False, 16, 0.0, 16),
    ("k6", 4, True, True, 16, 0.0, 16), ("k6", 5, True, False, 8, 0.6, 128),
    ("k6", 4, False, False, 8, 0.6, 8)]


@pytest.mark.parametrize("mode,depth,sem,coord,s,noise,piece", MODEL_CASES)
def test_ring_dx_model_matches_plain(mode, depth, sem, coord, s, noise, piece):
    """The dX dataflow of the ring, fed through ``_emulate_k3``'s reverse
    sweep, gives ``rgb_train_grads_plain``'s (K3) and
    ``train_render_grads_plain``'s (K6) gradients, every leaf to 1e-5 of its
    largest value (the 3xTF32 products drop only lo x lo, ~2^-22 of a
    term); every case's field has density at its points, so the trunk's
    gradient is not zero."""
    torch.manual_seed(100 * depth + s)
    field = NeRFField(net_depth=depth, net_width=32, multires=4, multires_views=2,
                      use_semantics=sem, sem_with_coord=coord, sem_dim=2)
    odv, z = (torch.from_numpy(a) for a in _inputs(depth + s, s))
    rng = np.random.default_rng(s)
    dx = _ring_dx(field, s, piece)
    with torch.no_grad():
        if mode == "k6":
            dmaps = torch.from_numpy(rng.normal(size=(R, 7 if sem else 5)).astype(np.float32))
            dw = torch.from_numpy(rng.normal(size=(R, s)).astype(np.float32))
            got, _, _ = _emulate_k3(field, odv, z, None, False, noise, 99, dmaps, dw, dx=dx)
            want = fr.train_render_grads_plain(field, odv, z, dmaps, dw, noise_std=noise, seed=99)
        else:
            gt = torch.from_numpy(rng.uniform(0, 1, size=(R, 3)).astype(np.float32))
            got, _, _ = _emulate_k3(field, odv, z, gt, False, noise, 99, dx=dx)
            want = fr.rgb_train_grads_plain(field, odv, z, gt, white_bkgd=False, noise_std=noise,
                                            seed=99)[0]
    assert float(want["mlp.pts_linears.0.weight"].abs().max()) > 0  # not a field with no density
    for name, err in _rel_errs(got, want).items():
        assert err < 1e-5, (name, err)


def _jax_seed(key):
    return int(jax.random.randint(key, (1, 1), 0, 2**31 - 1).astype(jnp.float32)[0, 0])


@pytest.mark.parametrize("coord,noise,piece", [(True, 1.0, 16), (False, 0.0, 128)])
def test_ring_dx_model_matches_pallas_k6(coord, noise, piece):
    """K6 with the ring's dX dataflow against ``jax.vjp`` of
    ``fused_train_render_planar`` without ``frozen_backbone``
    (``_train_render_bwd``, interpret mode), depth 4, width 32, 16 samples,
    seeded map and weight cotangents: every leaf to 5e-5 of its largest
    value, the tolerance the plain version is held to against the same
    kernel (tests/test_torch_sos_kernels.py)."""
    kw = dict(netwidth=32, netwidth_fine=32, n_samples=8, n_importance=8, multires=4,
              multires_views=2, use_semantics=True, netdepth=4, netdepth_fine=4,
              sem_with_coord=coord)
    jcfg = JaxConfig(**kw, fused_field=True, frozen_backbone=False)
    params = JaxNet(jcfg).init(jax.random.PRNGKey(7))
    tnet = TorchNet(TorchConfig(**kw, fused_field=True))
    tnet.load_state_dict(state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, params)))
    s = 16
    odv, z = _inputs(31, s)
    key = jax.random.PRNGKey(s)
    rng = np.random.default_rng(s)
    dmaps = rng.normal(size=(R, 7)).astype(np.float32)
    dw = rng.normal(size=(R, s)).astype(np.float32)
    _, vjp = jax.vjp(
        lambda p: jfr.fused_train_render_planar(p, jnp.asarray(odv), jnp.asarray(z), jcfg,
                                                depth=4, noise_std=noise, noise_key=key),
        params["fine"])
    (g_j,) = vjp((jnp.asarray(dmaps), jnp.asarray(dw)))
    want = {k[len("nerf."):]: v for k, v in state_dict_from_jax_params(
        {"coarse": jax.tree_util.tree_map(np.asarray, g_j)}).items()}
    field = tnet.nerf_fine
    with torch.no_grad():
        got, _, _ = _emulate_k3(field, torch.from_numpy(odv), torch.from_numpy(z), None, False,
                                noise, _jax_seed(key), torch.from_numpy(dmaps),
                                torch.from_numpy(dw), dx=_ring_dx(field, s, piece))
    for name, err in _rel_errs(got, want).items():
        assert err <= 5e-5, (name, err)
