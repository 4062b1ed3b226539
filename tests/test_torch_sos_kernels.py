"""The SOS finetune's kernels on the CPU: the plain versions of K4 (train
forward with sem_in), K5 (the semantic-head backward), K6 (the full
train-render backward) and K7 (the geometry-correlation loss in its single,
pair and quad forms) against the JAX Pallas kernels in interpret mode, and
models of the K5 kernel's packed layout.

The CUDA kernels themselves run only on a card (tests/test_torch_cuda.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsos_torch.engines.checkpoint import state_dict_from_jax_params
from nerfsos_torch.models.nerf import NeRFConfig as TorchConfig
from nerfsos_torch.models.nerf import NeRFNet as TorchNet
from nerfsos_torch.ops import flash_corr as tfc
from nerfsos_torch.ops import fused_render as tfr
from nerfsos_tpu.models.nerf import NeRFConfig as JaxConfig
from nerfsos_tpu.models.nerf import NeRFNet as JaxNet
from nerfsos_tpu.ops.pallas import flash_corr as jfc
from nerfsos_tpu.ops.pallas import fused_render as jfr


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


TINY = dict(netwidth=16, netwidth_fine=16, n_samples=8, n_importance=8, multires=4,
            multires_views=2, use_semantics=True)
R = 20  # not a multiple of the 8-ray Pallas block


@pytest.fixture(autouse=True)
def small_pallas_block(monkeypatch):
    """8 rays per Pallas grid step keeps interpret mode fast."""
    monkeypatch.setattr(jfr, "TRAIN_RAY_BLOCK", 8)


def _nets(depth, coord, frozen=True):
    kw = {**TINY, "netdepth": depth, "netdepth_fine": depth, "sem_with_coord": coord}
    jcfg = JaxConfig(**kw, fused_field=True, frozen_backbone=frozen)
    params = JaxNet(jcfg).init(jax.random.PRNGKey(3))
    tnet = TorchNet(TorchConfig(**kw, fused_field=True))
    tnet.load_state_dict(state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, params)))
    return jcfg, params, tnet


def _inputs(seed, s):
    rng = np.random.default_rng(seed)
    odv = rng.normal(size=(R, 9)).astype(np.float32)
    odv[:, 6:9] = odv[:, 3:6] / np.linalg.norm(odv[:, 3:6], axis=1, keepdims=True)
    z = np.sort(rng.uniform(1, 4, size=(R, s)), 1).astype(np.float32)
    return odv, z


def _jax_seed(key):
    return int(jax.random.randint(key, (1, 1), 0, 2**31 - 1).astype(jnp.float32)[0, 0])


CASES = [(5, True, 0.6, 8), (6, True, 0.0, 16), (6, False, 0.6, 16), (5, False, 0.0, 8)]


@pytest.mark.parametrize("depth,coord,noise,s", CASES)
def test_train_render_plain_matches_pallas(depth, coord, noise, s):
    """K4: maps, weights and sem_in (the JAX stream_semin residual)."""
    jcfg, params, tnet = _nets(depth, coord)
    odv, z = _inputs(s, s)
    ws, bs = jfr._flatten_mlp_params(params["fine"]["mlp"], depth, True)
    seed = 1234567
    maps_j, w_j, semin_j = jfr._train_render_fwd_impl(
        tuple(ws), tuple(bs), jnp.asarray(odv), jnp.asarray(z),
        jnp.full((1, 1), seed, jnp.float32), depth, (4,), jcfg.multires, jcfg.multires_views,
        True, coord, "float32", noise, interpret=True, save_semin=True, frozen_blk=True)
    C = tnet.nerf_fine.mlp.semantic_linear[0].in_features
    semin_j = np.asarray(semin_j).transpose(0, 2, 1).reshape(-1, C)[:R * s]
    maps_t, w_t, semin_t = tfr.train_render_plain(
        tnet.nerf_fine, torch.from_numpy(odv), torch.from_numpy(z), noise_std=noise, seed=seed,
        save_semin=True)
    assert maps_t.shape == (R, 7) and w_t.shape == (R, s) and semin_t.shape == (R * s, C)
    np.testing.assert_allclose(maps_t.numpy(), np.asarray(maps_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(semin_t.numpy(), semin_j, atol=1e-5, rtol=0)


@pytest.mark.parametrize("depth,coord,noise,s", CASES)
def test_frozen_backward_matches_pallas(depth, coord, noise, s):
    """K5 through the autograd function: the semantic head's grads against
    jax.vjp of fused_train_render_planar with frozen_backbone; every other
    leaf gets none."""
    jcfg, params, tnet = _nets(depth, coord)
    odv, z = _inputs(s + 1, s)
    key = jax.random.PRNGKey(5)
    dmaps = np.random.default_rng(s).normal(size=(R, 7)).astype(np.float32)
    (maps_j, w_j), vjp = jax.vjp(
        lambda p: jfr.fused_train_render_planar(p, jnp.asarray(odv), jnp.asarray(z), jcfg,
                                                depth=depth, noise_std=noise, noise_key=key),
        params["fine"])
    (g_j,) = vjp((jnp.asarray(dmaps), jnp.zeros_like(w_j)))
    want = {k[len("nerf."):]: v for k, v in state_dict_from_jax_params(
        {"coarse": jax.tree_util.tree_map(np.asarray, g_j)}).items()}

    field = tnet.nerf_fine
    maps_t, w_t = tfr.fused_train_render(field, torch.from_numpy(odv), torch.from_numpy(z),
                                         noise_std=noise, seed=_jax_seed(key), frozen=True)
    np.testing.assert_allclose(maps_t.detach().numpy(), np.asarray(maps_j), atol=1e-5, rtol=0)
    torch.sum(maps_t * torch.from_numpy(dmaps)).backward()
    for name, p in field.named_parameters():
        if name in tfr._SEM_NAMES:
            ref = want[name].numpy()
            scale = np.abs(ref).max() + 1e-12
            assert np.abs(p.grad.numpy() - ref).max() <= 1e-5 * scale, name
        else:
            assert p.grad is None, name
            assert not want[name].any(), name


K6_CASES = [  # (depth, sem_with_coord, noise, samples, seeded dweights)
    (5, True, 1.0, 8, True),
    (6, True, 0.0, 16, False),
    (6, False, 1.0, 16, True),
    (5, False, 0.0, 8, False),
]


@pytest.mark.parametrize("depth,coord,noise,s,dweights", K6_CASES)
def test_full_backward_plain_matches_pallas(depth, coord, noise, s, dweights):
    """K6's plain version against jax.vjp of fused_train_render_planar
    without frozen_backbone (_train_render_bwd, interpret mode): every leaf
    to 5e-5 of its max at fixed z, with seeded dmaps and zero or seeded
    dweights."""
    jcfg, params, tnet = _nets(depth, coord, frozen=False)
    odv, z = _inputs(s + 3, s)
    key = jax.random.PRNGKey(s)
    rng = np.random.default_rng(depth + s)
    dmaps = rng.normal(size=(R, 7)).astype(np.float32)
    dw = rng.normal(size=(R, s)).astype(np.float32) if dweights else np.zeros((R, s), np.float32)
    (maps_j, _), vjp = jax.vjp(
        lambda p: jfr.fused_train_render_planar(p, jnp.asarray(odv), jnp.asarray(z), jcfg,
                                                depth=depth, noise_std=noise, noise_key=key),
        params["fine"])
    (g_j,) = vjp((jnp.asarray(dmaps), jnp.asarray(dw)))
    want = {k[len("nerf."):]: v for k, v in state_dict_from_jax_params(
        {"coarse": jax.tree_util.tree_map(np.asarray, g_j)}).items()}
    got = tfr.train_render_grads_plain(tnet.nerf_fine, torch.from_numpy(odv), torch.from_numpy(z),
                                       torch.from_numpy(dmaps),
                                       torch.from_numpy(dw) if dweights else None,
                                       noise_std=noise, seed=_jax_seed(key))
    assert set(got) == set(want)
    for name, g in got.items():
        ref = want[name].numpy()
        scale = np.abs(ref).max()
        assert scale > 0 and np.abs(g.numpy() - ref).max() <= 5e-5 * scale, name


def test_unfrozen_backward_names_k6():
    """Without ``frozen`` the autograd function's backward is K6 (its plain
    version on CPU tensors, no launch): every leaf gets the gradient of
    train_render_grads_plain, the weights' cotangent included."""
    _, _, tnet = _nets(6, True)
    odv, z = (torch.from_numpy(a) for a in _inputs(0, 8))
    field = tnet.nerf
    before = tfr.train_render_grads.launches
    maps, w = tfr.fused_train_render(field, odv, z, noise_std=0.5, seed=4, frozen=False)
    dmaps, dw = torch.randn(maps.shape), torch.randn(w.shape)
    (torch.sum(maps * dmaps) + torch.sum(w * dw)).backward()
    want = tfr.train_render_grads_plain(field, odv, z, dmaps, dw, noise_std=0.5, seed=4)
    for name, p in field.named_parameters():
        assert torch.equal(p.grad, want[name]), name
    assert tfr.train_render_grads.launches == before
    for p in field.parameters():  # an unused weights output: a zero cotangent
        p.grad = None
    maps, _ = tfr.fused_train_render(field, odv, z, noise_std=0.5, seed=4, frozen=False)
    torch.sum(maps * dmaps).backward()
    want = tfr.train_render_grads(field, odv, z, dmaps, None, noise_std=0.5, seed=4)
    assert all(torch.equal(p.grad, want[n]) for n, p in field.named_parameters())


def test_forward_without_grad_stores_no_sem_in():
    _, _, tnet = _nets(6, True)
    odv, z = (torch.from_numpy(a) for a in _inputs(1, 8))
    with torch.no_grad():
        maps, w = tfr.fused_train_render(tnet.nerf, odv, z, noise_std=0.0, seed=0, frozen=True)
    want = tfr.train_render_plain(tnet.nerf, odv, z, noise_std=0.0, seed=0, save_semin=False)
    assert torch.equal(maps, want[0]) and torch.equal(w, want[1])


def _k5_ring(buf, d, rank):
    """Cluster rank ``rank``'s W0^T [8 kslices, 32] TF32 high and low parts
    unpacked from pack_frozen's ring (the inverse of its per-slice layout)."""
    n = d.kslices * 16 * tfr._SEM_COLS
    blocks = buf[rank * n:(rank + 1) * n].view(d.kslices, 2, tfr._SEM_COLS // 8, 2, 8, 4)
    parts = blocks.permute(1, 0, 3, 5, 2, 4).reshape(2, 8 * d.kslices, tfr._SEM_COLS)
    return parts[0], parts[1]


def _b_offset(k, n):
    """csrc/wgmma.cuh b_offset: element (k, n) of a k-slice of a wgmma B operand."""
    return (n // 8) * 64 + (k // 4) * 32 + (n % 8) * 4 + k % 4


def _emulate_k5(field, sem_in, w, dmaps):
    """What K5 computes, from pack_frozen's buffer alone, in its dataflow: per
    cluster rank (32 of sem_0's outputs) and 64-point tile of sem_in (rows
    past the points zeroed, columns past C read 0), F's product with the
    ring's W0 k-slices and the rows in its point order (3xTF32 through
    _tf32), ds written into dW0's B buffer at (k-slice p % 8, position
    p // 8) as TF32 parts, D's product reading it back per k-slice against
    sem_in's rows in its point order, the small sums; then the gradient
    buffer and unpack_frozen."""
    buf, d = tfr.pack_frozen(field)
    P, C = sem_in.shape
    S, sem, hidden, cols = w.shape[1], d.sem_dim, d.hidden, tfr._SEM_COLS
    tf = tfr._tf32
    b0 = buf[d.b0:d.b0 + hidden]
    w1 = buf[d.w1:d.w1 + sem * hidden].view(sem, hidden)
    m = torch.arange(64)
    pi = 4 * (m % 8) + m // 16 + 32 * ((m % 16) // 8)  # F: accumulator row m -> point
    sigma = m // 8 + 8 * (m % 8)                         # D: k position m -> point
    assert sorted(pi.tolist()) == sorted(sigma.tolist()) == list(range(64))
    n = torch.arange(cols)
    flat = torch.zeros(d.grad_size)
    dw0 = flat[d.gw0:d.gb0].view(C, hidden)
    dw1 = flat[d.gw1:d.gb1].view(hidden, sem)
    for rank in range(tfr._SEM_RANKS):
        n0 = cols * rank
        nb = min(cols, hidden - n0)
        if nb <= 0:
            continue
        whi, wlo = _k5_ring(buf, d, rank)
        acc0 = torch.zeros(8 * d.kslices, cols)
        for q0 in range(0, P, 64):
            np_ = min(64, P - q0)
            x = torch.zeros(64, 8 * d.kslices)
            x[:np_, :C] = sem_in[q0:q0 + np_]
            xr = x[pi]
            xh = tf(xr)
            xl = tf(xr - xh)
            s_pre = xl @ whi + xh @ wlo + xh @ whi
            s_pre[:, :nb] += b0[n0:n0 + nb]
            pts, valid = q0 + pi, pi < np_
            q = pts.clamp(max=P - 1)
            dsem = torch.where(valid[:, None], dmaps[q // S, 5:] * w.reshape(-1)[q, None], 0.0)
            w1b = torch.zeros(sem, cols)
            w1b[:, :nb] = w1[:, n0:n0 + nb]
            ds = torch.where(s_pre > 0, dsem @ w1b, 0.0)  # [row, output]
            dsbuf = torch.zeros(8, 2, 8 * cols)
            off = _b_offset((pi // 8)[:, None], n[None, :])
            dsbuf[(pi % 8)[:, None], 0, off] = tf(ds)
            dsbuf[(pi % 8)[:, None], 1, off] = tf(ds - tf(ds))
            for kk in range(8):
                k = torch.arange(8)
                bhi = dsbuf[kk, 0][_b_offset(k[:, None], n[None, :])]  # [k, output]
                blo = dsbuf[kk, 1][_b_offset(k[:, None], n[None, :])]
                at = x[sigma[8 * kk:8 * kk + 8]].t()  # [features, k]
                ah = tf(at)
                acc0 += tf(at - ah) @ bhi + ah @ blo + ah @ bhi
            dw1[n0:n0 + nb] += (torch.relu(s_pre).t() @ dsem)[:nb]
            flat[d.gb0 + n0:d.gb0 + n0 + nb] += ds.sum(0)[:nb]
            if rank == 0:
                flat[d.gb1:d.grad_size] += dsem.sum(0)
        dw0[:, n0:n0 + nb] = acc0[:C, :nb]
    return tfr.unpack_frozen(field, flat, d)


@pytest.mark.parametrize("depth,coord,width", [(5, True, 16), (6, False, 16), (8, True, 256),
                                               (5, True, 256), (6, True, 64)])
def test_k5_layout_matches_plain(depth, coord, width):
    """The W0 ring of each cluster rank (four of 32 outputs at width 256,
    the last ones empty at narrow widths), the tiles' point orders, ds in the B layout and
    the gradient layout reproduce the plain version's grads; (5, True, 256)
    is the 384-row head (C = 382: the skip after the last trunk layer, with
    coordinates)."""
    torch.manual_seed(0)
    from nerfsos_torch.models.fields import NeRFField
    field = NeRFField(net_depth=depth, net_width=width, multires=10 if width == 256 else 4,
                      multires_views=2, use_semantics=True, sem_with_coord=coord, sem_dim=3)
    odv, z = (torch.from_numpy(a) for a in _inputs(2, 8))
    _, w, sem_in = tfr.train_render_plain(field, odv, z, noise_std=0.0, seed=0, save_semin=True)
    dmaps = torch.randn(R, 8)
    got = _emulate_k5(field, sem_in, w, dmaps)
    want = tfr.frozen_sem_grads_plain(field, sem_in, w, dmaps)
    for k in want:
        assert got[k].shape == want[k].shape, k
        scale = float(want[k].abs().max()) + 1e-12
        assert float((got[k] - want[k]).abs().max()) <= 1e-5 * scale, k


def test_k5_ring_unpacks_to_the_weights():
    """pack_frozen's rings are W0^T's TF32 parts, columns 32 r .. of rank r,
    rows past C and columns past the head zero; its bias and W1 follow."""
    torch.manual_seed(1)
    from nerfsos_torch.models.fields import NeRFField
    field = NeRFField(net_depth=5, net_width=256, multires=10, multires_views=2,
                      use_semantics=True, sem_with_coord=True, sem_dim=3)
    buf, d = tfr.pack_frozen(field)
    lin0, lin2 = field.mlp.semantic_linear[0], field.mlp.semantic_linear[2]
    wt = lin0.weight.detach().t()
    assert (d.C, d.hidden, d.kslices) == (382, 128, 48)
    for rank in range(tfr._SEM_RANKS):
        hi, lo = _k5_ring(buf, d, rank)
        part = wt[:, 32 * rank:32 * rank + 32]
        assert torch.equal(hi[:d.C], tfr._tf32(part))
        assert torch.equal(lo[:d.C], tfr._tf32(part - tfr._tf32(part)))
        assert not hi[d.C:].any() and not lo[d.C:].any()
    assert torch.equal(buf[d.b0:d.b0 + 128], lin0.bias.detach())
    assert torch.equal(buf[d.w1:], lin2.weight.detach().reshape(-1))


@pytest.mark.parametrize("depth,width,stages", [(8, 256, (2, 6)), (5, 256, (2, 2)),
                                                (5, 16, (2, 6))])
def test_k5_plan_fits_shared_memory(depth, width, stages):
    """Two sem_in stages beside six W0 stages at the flagship head
    (C = 319), beside two at the 384-row head (C = 382), within the
    232,448 B a block can use; a head of more than 128 outputs is
    refused."""
    from nerfsos_torch.models.fields import NeRFField
    field = NeRFField(net_depth=depth, net_width=width, multires=10 if width == 256 else 4,
                      multires_views=4, use_semantics=True, sem_with_coord=True, sem_dim=2)
    plan = tfr._frozen_plan(tfr.pack_frozen(field)[1])
    assert (plan.xstages, plan.wstages) == stages
    assert tfr._frozen_smem(plan) <= tfr._MAX_SMEM
    if width == 256 and depth == 8:
        assert tfr._frozen_smem(plan) == 229120
    big = tfr.pack_frozen(field)[1]
    big.hidden = 192
    with pytest.raises(NotImplementedError):
        tfr._frozen_plan(big)


def test_cpu_wrappers_take_the_plain_path():
    _, _, tnet = _nets(6, True)
    odv, z = (torch.from_numpy(a) for a in _inputs(3, 8))
    before = (tfr.train_render.launches, tfr.frozen_sem_grads.launches)
    maps, w, sem_in = tfr.train_render(tnet.nerf, odv, z, noise_std=0.3, seed=9, save_semin=True)
    want = tfr.train_render_plain(tnet.nerf, odv, z, noise_std=0.3, seed=9, save_semin=True)
    assert all(torch.equal(a, b) for a, b in zip((maps, w, sem_in), want))
    dmaps = torch.randn(R, 7)
    g = tfr.frozen_sem_grads(tnet.nerf, sem_in, w, dmaps)
    g_p = tfr.frozen_sem_grads_plain(tnet.nerf, sem_in, w, dmaps)
    assert set(g) == set(tfr._SEM_NAMES) and all(torch.equal(g[k], g_p[k]) for k in g)
    assert (tfr.train_render.launches, tfr.frozen_sem_grads.launches) == before


# ----------------------------------------------------------------- K7


def _geo_inputs(seed, B=2, P=16, S=2):
    """Points from depths along rays, and channel-normalised codes, with
    P * P = 256 (a multiple of 128: the JAX side runs its flash kernels)."""
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(B, 3, P, P)) * 2.0).astype(np.float32)
    codes = [rng.normal(size=(B, S, P, P)).astype(np.float32) for _ in range(2)]
    codes = [c / np.linalg.norm(c, axis=1, keepdims=True) for c in codes]
    neg = np.array([1, 0][:B]) if B == 2 else rng.permutation(B)
    return pts, pts[neg], codes[0], codes[0][neg], codes[1], codes[1][neg]


@pytest.mark.parametrize("seed,shifts,maxd", [(0, (3.0, 0.5), 15.0), (1, (10.0, 3.0), 2.0)])
def test_geo_quad_plain_matches_pallas(seed, shifts, maxd):
    """K7a + K7f: the four means; K7g: the codes' gradients of a weighted
    sum of them (every code of the neg and the self sweep)."""
    pts, npts, c0, c0n, c1, c1n = _geo_inputs(seed)
    wts = np.array([0.7, -1.3, 0.4, 2.0], np.float32)

    def jloss(c0, c0n, c1, c1n):
        out = jfc.flash_geo_pair_quad(jnp.asarray(pts), jnp.asarray(npts), c0, c0n, c1, c1n,
                                      shifts[0], shifts[1], maxd, interpret=True)
        return jnp.sum(jnp.stack(out) * wts), jnp.stack(out)

    (_, want), g_want = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(a) for a in (c0, c0n, c1, c1n)))
    tc = [torch.from_numpy(a).requires_grad_() for a in (c0, c0n, c1, c1n)]
    out = tfc.flash_geo_pair_quad(torch.from_numpy(pts), torch.from_numpy(npts), *tc,
                                  shifts[0], shifts[1], maxd)
    got = torch.stack(out)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=0)
    torch.sum(got * torch.from_numpy(wts)).backward()
    for t, g in zip(tc, g_want):
        g = np.asarray(g)
        assert np.abs(t.grad.numpy() - g).max() <= 1e-5 * np.abs(g).max()


def test_geo_row_stats_plain_matches_pallas():
    pts, npts, *_ = _geo_inputs(2)
    f1 = np.concatenate([pts, pts]).reshape(4, 3, 256).transpose(0, 2, 1)
    f2 = np.concatenate([npts, pts]).reshape(4, 3, 256)
    rm_j, _ = jfc._row_stats(jnp.asarray(f1), jnp.asarray(f2), 15.0, True)
    rm, gm = tfc.geo_row_stats(torch.from_numpy(np.ascontiguousarray(f1)),
                               torch.from_numpy(np.ascontiguousarray(f2.transpose(0, 2, 1))),
                               15.0)
    np.testing.assert_allclose(rm.numpy(), np.asarray(rm_j)[..., 0], rtol=1e-5, atol=0)
    np.testing.assert_allclose(gm.numpy(), [np.asarray(rm_j)[:2].mean(),
                                            np.asarray(rm_j)[2:].mean()], rtol=1e-5)


def test_geo_quad_cpu_wrappers_count_nothing():
    pts, npts, c0, c0n, c1, c1n = _geo_inputs(3)
    before = (tfc.geo_row_stats.launches, tfc.geo_quad_means.launches,
              tfc.geo_quad_grads.launches)
    tc = [torch.from_numpy(a).requires_grad_() for a in (c0, c0n, c1, c1n)]
    out = tfc.flash_geo_pair_quad(torch.from_numpy(pts), torch.from_numpy(npts), *tc,
                                  3.0, 0.5, 15.0)
    sum(out).backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in tc)
    assert (tfc.geo_row_stats.launches, tfc.geo_quad_means.launches,
            tfc.geo_quad_grads.launches) == before


@pytest.mark.parametrize("seed,shift,maxd", [(5, 3.0, 15.0), (6, 10.0, 2.0)])
def test_geo_single_plain_matches_pallas(seed, shift, maxd):
    """K7a + K7b: one helper mean (one half: gm the mean of every row); K7c:
    both codes' gradients."""
    pts, npts, c0, c0n, _, _ = _geo_inputs(seed)

    def jloss(a, b):
        return jfc.flash_geo_helper_mean(jnp.asarray(pts), jnp.asarray(npts), a, b, shift, maxd,
                                         interpret=True)

    want, g_want = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(c0), jnp.asarray(c0n))
    tc = [torch.from_numpy(a).requires_grad_() for a in (c0, c0n)]
    got = tfc.geo_helper_mean(torch.from_numpy(pts), torch.from_numpy(npts), *tc, shift, maxd)
    assert got.shape == ()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    (2.5 * got).backward()
    for t, g in zip(tc, g_want):
        g = 2.5 * np.asarray(g)
        assert np.abs(t.grad.numpy() - g).max() <= 1e-5 * np.abs(g).max()


@pytest.mark.parametrize("seed,shift,maxd", [(7, 0.5, 15.0), (8, 3.0, 1.5)])
def test_geo_pair_plain_matches_pallas(seed, shift, maxd):
    """K7a + K7d: two heads' means on one sweep; K7e: the four codes'
    gradients of a weighted sum of them."""
    pts, npts, c0, c0n, c1, c1n = _geo_inputs(seed)
    wts = np.array([1.7, -0.6], np.float32)

    def jloss(*c):
        out = jfc.flash_geo_helper_mean_pair(jnp.asarray(pts), jnp.asarray(npts), *c, shift, maxd,
                                             interpret=True)
        return jnp.sum(jnp.stack(out) * wts), jnp.stack(out)

    (_, want), g_want = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(a) for a in (c0, c0n, c1, c1n)))
    tc = [torch.from_numpy(a).requires_grad_() for a in (c0, c0n, c1, c1n)]
    got = torch.stack(tfc.geo_helper_mean_pair(torch.from_numpy(pts), torch.from_numpy(npts),
                                               *tc, shift, maxd))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=0)
    torch.sum(got * torch.from_numpy(wts)).backward()
    for t, g in zip(tc, g_want):
        g = np.asarray(g)
        assert np.abs(t.grad.numpy() - g).max() <= 1e-5 * np.abs(g).max()


def test_geo_single_and_pair_cpu_wrappers_count_nothing():
    """On CPU tensors the K7b-K7e wrappers are their plain versions: the
    same values, no launch; the pair's means are the two single means."""
    pts, npts, c0, c0n, c1, c1n = (torch.from_numpy(a) for a in _geo_inputs(9))
    names = ("geo_row_stats", "geo_single_means", "geo_single_grads", "geo_pair_means",
             "geo_pair_grads")
    before = [getattr(tfc, n).launches for n in names]
    a = tfc.geo_helper_mean(pts, npts, c0, c0n, 3.0, 15.0)
    b = tfc.geo_helper_mean(pts, npts, c1, c1n, 3.0, 15.0)
    pair = tfc.geo_helper_mean_pair(pts, npts, c0, c0n, c1, c1n, 3.0, 15.0)
    torch.testing.assert_close(torch.stack(pair), torch.stack([a, b]), rtol=1e-6, atol=0)
    assert [getattr(tfc, n).launches for n in names] == before
