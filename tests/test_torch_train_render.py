"""K3 (the fused RGB train pass) on the CPU: its noise hash and plain version
against the JAX Pallas kernel in interpret mode, and a model of the CUDA
kernel's dataflow (the packed layers, the workspace planes, the gradient
layout) against the plain version, in K3's loss mode and in K6's cotangent
mode (the full train-render backward, with the semantic head's planes).

The CUDA kernel itself runs only on a card (tests/test_torch_cuda.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsos_torch.engines.checkpoint import state_dict_from_jax_params
from nerfsos_torch.models.nerf import NeRFConfig as TorchConfig
from nerfsos_torch.models.nerf import NeRFNet as TorchNet
from nerfsos_torch.ops import fused_render as tfr
from nerfsos_tpu.models.nerf import NeRFConfig as JaxConfig
from nerfsos_tpu.models.nerf import NeRFNet as JaxNet
from nerfsos_tpu.ops.pallas import fused_render as jfr

TINY = dict(netwidth=16, netdepth=5, netwidth_fine=16, netdepth_fine=5, n_samples=8,
            n_importance=8, multires=4, multires_views=2)
R = 20  # not a multiple of the 8-ray Pallas block: the last block is ragged


@pytest.fixture(autouse=True)
def small_pallas_block(monkeypatch):
    """8 rays per Pallas grid step keeps interpret mode fast (the TPU block
    would pad 20 rays to 128)."""
    monkeypatch.setattr(jfr, "TRAIN_RAY_BLOCK", 8)


def _nets(**over):
    kw = {**TINY, **over}
    jcfg = JaxConfig(**kw, fused_field=True)
    params = JaxNet(jcfg).init(jax.random.PRNGKey(3))
    tnet = TorchNet(TorchConfig(**kw, fused_field=True))
    tnet.load_state_dict(state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, params)))
    return jcfg, params, tnet


def _inputs(seed, s):
    rng = np.random.default_rng(seed)
    odv = rng.normal(size=(R, 9)).astype(np.float32)
    odv[:, 6:9] = odv[:, 3:6] / np.linalg.norm(odv[:, 3:6], axis=1, keepdims=True)
    z = np.sort(rng.uniform(1, 4, size=(R, s)), 1).astype(np.float32)
    gt = rng.uniform(0, 1, size=(R, 3)).astype(np.float32)
    return odv, z, gt


def _jax_seed(key):
    """The seed fused_rgb_train_grads draws from its noise key."""
    return int(jax.random.randint(key, (1, 1), 0, 2**31 - 1).astype(jnp.float32)[0, 0])


@pytest.mark.parametrize("seed", [0, 7, 123456789, 2**31 - 200])
def test_noise_hash_and_draws_match_pallas(seed):
    n = 3 * 64
    idx = jnp.arange(n, dtype=jnp.int32)[None]
    base = jnp.asarray(np.float32(seed)).astype(jnp.int32)
    h1_j = jfr._mix32((idx + base) * jnp.int32(-1640531527))
    h2_j = jfr._mix32(h1_j + jnp.int32(0x7E3779B9))
    h1_t, h2_t = tfr.noise_hash(seed, n)
    np.testing.assert_array_equal(h1_t.numpy(), np.asarray(h1_j)[0].view(np.uint32))
    np.testing.assert_array_equal(h2_t.numpy(), np.asarray(h2_j)[0].view(np.uint32))
    want = jfr._noise_lanes(jnp.asarray(np.float32(seed)), 0, n, 0.7)
    got = tfr.noise_plain(seed, 3, 64, 0.7)
    np.testing.assert_allclose(got.numpy().reshape(-1), np.asarray(want)[0], atol=1e-6, rtol=0)


def _jax_grads_as_torch(grads):
    """JAX ``{'mlp': {name: {kernel, bias}}}`` -> torch names of one field."""
    sd = state_dict_from_jax_params(
        {"coarse": jax.tree_util.tree_map(np.asarray, grads)})
    return {k[len("nerf."):]: v for k, v in sd.items()}


CASES = [  # (use_semantics, sem_with_coord, white_bkgd, noise_std, samples)
    (True, True, False, 0.6, 8),
    (True, True, True, 0.0, 16),
    (True, False, False, 0.0, 8),
    (True, False, True, 0.6, 16),
    (False, False, False, 0.6, 16),
    (False, False, True, 0.0, 8),
]


@pytest.mark.parametrize("sem,coord,white,noise,s", CASES)
def test_rgb_train_grads_plain_matches_pallas(sem, coord, white, noise, s):
    jcfg, params, tnet = _nets(use_semantics=sem, sem_with_coord=coord, white_bkgd=white)
    odv, z, gt = _inputs(s, s)
    key = jax.random.PRNGKey(11)
    g_j, maps_j, w_j = jfr.fused_rgb_train_grads(
        params["fine"], jnp.asarray(odv), jnp.asarray(z), jnp.asarray(gt), jcfg,
        noise_std=noise, noise_key=key, interpret=True)
    g_t, maps_t, w_t = tfr.rgb_train_grads_plain(
        tnet.nerf_fine, torch.from_numpy(odv), torch.from_numpy(z), torch.from_numpy(gt),
        white_bkgd=white, noise_std=noise, seed=_jax_seed(key))
    assert maps_t.shape == maps_j.shape == (R, 5 + (2 if sem else 0))
    np.testing.assert_allclose(maps_t.numpy(), np.asarray(maps_j), atol=2e-5, rtol=0)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), atol=2e-5, rtol=0)
    want = _jax_grads_as_torch(g_j)
    assert set(g_t) == set(want)
    for name, g in g_t.items():
        ref = want[name].numpy()
        scale = np.abs(ref).max() + 1e-9
        assert np.abs(g.numpy() - ref).max() / scale < 5e-5, name
        if "semantic_linear" in name:
            assert not g.any(), name


# ---------------------------------------------------------------- the kernel's dataflow


def _layer(buf, L):
    npad = (L.n + 7) // 8 * 8
    return buf[L.w:L.w + L.k * npad].view(L.k, npad), buf[L.b:L.b + npad]


def _pad_rows(x, rows):
    return torch.cat([x, x.new_zeros(rows - x.shape[0], x.shape[1])])


def _mm(b, L, segs, relu=False):
    w, bias = _layer(b, L)
    x = torch.cat(segs)
    assert x.shape[0] == w.shape[0]
    y = w.t() @ x + bias[:, None]
    return torch.relu(y) if relu else y


def _emulate_forward(field, odv, z):
    """The forward of every point through ``pack_field``'s buffer, feature
    major: the activations the reverse sweep reads (the workspace planes'
    rows: emb, demb, each trunk layer's, feature, views' hidden and the
    semantic head's hidden ``s_act``) and the heads' outputs (sigma without
    noise, the rgb logits, the semantics)."""
    buf, fd = tfr.pack_field(field)
    depth, skip, sem = fd.depth, fd.skip, fd.sem_dim
    Rn, S = z.shape
    pts = (odv[:, None, 0:3] + odv[:, None, 3:6] * z[..., None]).reshape(-1, 3)
    dirs = odv[:, None, 6:9].expand(Rn, S, 3).reshape(-1, 3)
    emb = _pad_rows(field.embed(pts).t(), (fd.emb_dim + 7) // 8 * 8)
    demb = _pad_rows(field.embed_views(dirs).t(), (fd.demb_dim + 7) // 8 * 8)
    acts, h = [], [emb]
    for i in range(depth):
        acts.append(_mm(buf, fd.layer[i], h, relu=True))
        h = [emb, acts[-1]] if i == skip else [acts[-1]]
    out = dict(emb=emb, demb=demb, acts=acts, s_act=None, semv=None)
    out["sigma"] = _mm(buf, fd.layer[depth], h)[0].view(Rn, S)
    out["feat"] = _mm(buf, fd.layer[depth + 1], h)
    out["hv"] = _mm(buf, fd.layer[depth + 2], [out["feat"], demb], relu=True)
    out["logits"] = _mm(buf, fd.layer[depth + 3], [out["hv"]])[:3].view(3, Rn, S)
    if sem:
        out["s_act"] = _mm(buf, fd.layer[depth + 4], h + ([emb] if fd.sem_with_coord else []),
                           relu=True)
        out["semv"] = _mm(buf, fd.layer[depth + 5], [out["s_act"]])[:sem].view(sem, Rn, S)
    return out


def _emulate_k3(field, odv, z, gt, white, noise_std, seed, dmaps=None, dweights=None, fwd=None,
                dx=None, dwb=None, mip=False, cot=None, dys=None):
    """What csrc/train_render.cu computes, step for step, in feature-major
    torch matrices built only from the packed buffers: the forward
    (``fwd``, by default ``_emulate_forward``'s), the composite and its
    reverse per ray, the input gradients through ``pack_train_bwd`` with the
    relu gates, dW = X dY^T into ``grad_layout``'s buffer, then
    ``unpack_grads``. With ``dmaps`` (K6) the maps' cotangent is ``dmaps``
    (and ``dweights``) instead of the img2mse one, and the semantic head is
    swept between alpha and the trunk, its input gradient on h added into
    the last trunk layer's cotangent. ``dx(i, segs, gate, add)``: layer
    i's input-gradient product of the dY rows ``segs``, ``add`` added and
    then gated by ``gate > 0`` (each when not None); by default
    ``pack_train_bwd``'s matrix in one product. ``dwb(layer, segs, dy)``:
    layer's (dW ``[rows of segs, dy rows]``, db) from its input rows
    ``segs`` and its cotangent rows ``dy``; by default one product and one
    sum. ``mip`` (K10b, with ``fwd`` given): ``z`` holds fenceposts
    ``[R, S + 1]``, an interval's distance is its length (no far pad) and
    its depth the midpoint. ``cot`` (the field backward, K8c/K8f, with
    ``fwd`` given): the cotangent planes' rows ``(drgb [8, P], dsig [8, P],
    dsem [8, P] or None)`` in place of the composite's (no composite: odv,
    z and the maps are unused, maps and weights come back None).
    ``dys``: a dict that gets each layer's cotangent rows by layer index."""
    fd = tfr.pack_field(field)[1]
    bbuf, bwd = tfr.pack_train_bwd(field)
    if dx is None:
        def dx(i, segs, gate=None, add=None):
            y = _mm(bbuf, bwd[i], segs) + (0 if add is None else add)
            return y if gate is None else y * (gate > 0)
    depth, skip, sem = fd.depth, fd.skip, fd.sem_dim
    fwd = _emulate_forward(field, odv, z) if fwd is None else fwd
    emb, demb, acts, feat, hv, s_act = (fwd[k] for k in ("emb", "demb", "acts", "feat", "hv",
                                                          "s_act"))
    h = [emb, acts[-1]] if depth - 1 == skip else [acts[-1]]
    ins = [[emb]] + [[emb, acts[i - 1]] if i - 1 == skip else [acts[i - 1]]
                     for i in range(1, depth)]
    if cot is not None:
        drgb, dsig, dsem = cot
        k6_sem, maps, w = dsem is not None, None, None
    else:
        drgb, dsig, dsem, maps, w = _composite_cotangents(
            fwd, odv, z, gt, white, noise_std, seed, dmaps, dweights, mip, sem)
        k6_sem = dsem is not None

    offs, size = tfr.grad_layout(field, k6_sem)
    flat = torch.zeros(size)

    def wgrad(layer, segs, dy):
        if dys is not None:
            dys[layer] = dy
        gw, gb = offs[layer]
        if dwb is None:
            flat[gw:gb] = (torch.cat(segs) @ dy.t()).reshape(-1)
            flat[gb:gb + dy.shape[0]] = dy.sum(1)
        else:
            w_, b_ = dwb(layer, segs, dy)
            flat[gw:gb] = w_.reshape(-1)
            flat[gb:gb + dy.shape[0]] = b_

    k_alpha, k_feat, k_views, k_rgb = depth, depth + 1, depth + 2, depth + 3
    wgrad(k_rgb, [hv], drgb)
    dpv = dx(k_rgb, [drgb], hv)
    wgrad(k_views, [feat, demb], dpv)
    dfeat = dx(k_views, [dpv])
    wgrad(k_feat, h, dfeat)
    wgrad(k_alpha, h, dsig)
    cur = dx(k_alpha, [dfeat, dsig], acts[-1])
    if k6_sem:
        wgrad(depth + 5, [s_act], dsem)
        ds = dx(depth + 5, [dsem], s_act)
        wgrad(depth + 4, h + ([emb] if fd.sem_with_coord else []), ds)
        cur = dx(depth + 4, [ds], acts[-1], cur)
    for i in range(depth - 1, -1, -1):
        wgrad(i, ins[i], cur)
        if i > 0:
            cur = dx(i, [cur], acts[i - 1])
    return tfr.unpack_grads(field, flat, k6_sem), maps, w


def _composite_cotangents(fwd, odv, z, gt, white, noise_std, seed, dmaps, dweights, mip, sem):
    """K3's, K6's and K10b's composite and its reverse per ray (see
    ``_emulate_k3``): the cotangent planes' rows (drgb, dsig; dsem with
    ``dmaps`` and the semantic head, else None), the maps and the weights."""
    sigma, logits, semv = fwd["sigma"], fwd["logits"], fwd["semv"]
    Rn, S = z.shape[0], z.shape[1] - int(mip)
    if noise_std > 0:
        sigma = sigma + tfr.noise_plain(seed, Rn, S, noise_std)

    nd = torch.sqrt(odv[:, 3] ** 2 + odv[:, 4] ** 2 + odv[:, 5] ** 2)
    if mip:
        D = (z[:, 1:] - z[:, :-1]) * nd[:, None]
        z = (z[:, :-1] + z[:, 1:]) * 0.5  # the depth of an interval
    else:
        D = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 1e10)], 1) * nd[:, None]
    e = torch.exp(-torch.clamp(sigma, min=0) * D)
    alpha, y = 1 - e, e + 1e-10
    T = torch.ones_like(e)
    for s in range(1, S):
        T[:, s] = T[:, s - 1] * y[:, s - 1]
    w = alpha * T
    rgb = torch.sigmoid(logits)
    cols = [(w * rgb).sum(-1).t(), (w * z).sum(1, keepdim=True), w.sum(1, keepdim=True)]
    if sem:
        cols.append((w * semv).sum(-1).t())
    maps = torch.cat(cols, 1)
    if dmaps is None:
        diff = 2 * (maps[:, :3] + ((1 - maps[:, 4:5]) if white else 0) - gt)
        dacc = -diff.sum(1, keepdim=True) if white else 0
        dw = (diff.t()[..., None] * rgb).sum(0) + dacc
    else:
        diff = dmaps[:, :3]
        dw = (diff.t()[..., None] * rgb).sum(0) + dmaps[:, 3:4] * z + dmaps[:, 4:5]
        if sem:
            dw = dw + (dmaps[:, 5:].t()[..., None] * semv).sum(0)
        if dweights is not None:
            dw = dw + dweights
    suffix = torch.zeros(Rn)
    dalpha = torch.zeros_like(w)
    for s in range(S - 1, -1, -1):
        dalpha[:, s] = dw[:, s] * T[:, s] - suffix / y[:, s]
        suffix = suffix + dw[:, s] * alpha[:, s] * T[:, s]
    dsig = torch.where(sigma > 0, dalpha * e * D, torch.zeros_like(D)).reshape(1, -1)
    drgb = ((diff.t()[..., None] * w) * (rgb * (1 - rgb))).reshape(3, -1)
    dsig, drgb = _pad_rows(dsig, 8), _pad_rows(drgb, 8)
    dsem = None
    if dmaps is not None and sem > 0:
        dsem = _pad_rows((dmaps[:, 5:].t()[..., None] * w).reshape(sem, -1), 8)
    return drgb, dsig, dsem, maps, w


@pytest.mark.parametrize("sem,coord,white,noise,s", CASES)
def test_kernel_dataflow_matches_plain(sem, coord, white, noise, s):
    _, _, tnet = _nets(use_semantics=sem, sem_with_coord=coord, white_bkgd=white)
    odv, z, gt = (torch.from_numpy(a) for a in _inputs(s + 1, s))
    with torch.no_grad():
        g_e, maps_e, w_e = _emulate_k3(tnet.nerf_fine, odv, z, gt, white, noise, 99)
    g_p, maps_p, w_p = tfr.rgb_train_grads_plain(tnet.nerf_fine, odv, z, gt, white_bkgd=white,
                                                 noise_std=noise, seed=99)
    torch.testing.assert_close(maps_e, maps_p, atol=1e-5, rtol=0)
    torch.testing.assert_close(w_e, w_p, atol=1e-5, rtol=0)
    assert set(g_e) == set(g_p)
    for name, g in g_p.items():
        assert g_e[name].shape == g.shape, name
        err = float((g_e[name] - g).abs().max()) / (float(g.abs().max()) + 1e-9)
        assert err < 1e-5, (name, err)


K6_CASES = [  # (use_semantics, sem_with_coord, noise_std, samples, dweights)
    (True, True, 0.6, 8, True),
    (True, False, 0.0, 16, False),
    (True, True, 0.0, 16, False),
    (False, False, 0.6, 8, True),
]


@pytest.mark.parametrize("sem,coord,noise,s,dweights", K6_CASES)
def test_k6_dataflow_matches_plain(sem, coord, noise, s, dweights):
    """K6's cotangent mode: the layout K6 reads (the semantic head's packed
    input-gradient matrices, its planes and its gradient slots) reproduces
    train_render_grads_plain."""
    _, _, tnet = _nets(use_semantics=sem, sem_with_coord=coord)
    odv, z, _ = (torch.from_numpy(a) for a in _inputs(s + 2, s))
    rng = np.random.default_rng(s)
    dmaps = torch.from_numpy(rng.normal(size=(R, 7 if sem else 5)).astype(np.float32))
    dw = torch.from_numpy(rng.normal(size=(R, s)).astype(np.float32)) if dweights else None
    field = tnet.nerf_fine
    with torch.no_grad():
        g_e, _, _ = _emulate_k3(field, odv, z, None, False, noise, 99, dmaps, dw)
    g_p = tfr.train_render_grads_plain(field, odv, z, dmaps, dw, noise_std=noise, seed=99)
    assert set(g_e) == set(g_p) == {n for n, _ in field.named_parameters()}
    for name, g in g_p.items():
        assert g_e[name].shape == g.shape, name
        scale = float(g.abs().max())
        assert scale > 0, name
        assert float((g_e[name] - g).abs().max()) / scale < 1e-5, name


def test_train_desc_planes_and_layout():
    """The workspace planes hold exactly the padded rows the kernel's layers
    read, one 64-point tile per rays_per_chunk * S / 64, and the gradient
    buffer covers every layer but the semantic head (K3); K6 adds the
    semantic head's three planes (s_act, d_sem, ds) after the trunk's and
    its two layers' gradients, and the head's two input-gradient matrices
    come after K3's in the packed buffer."""
    _, _, tnet = _nets(use_semantics=True, sem_with_coord=True)
    field = tnet.nerf_fine
    buf, fd = tfr._packed(field, torch.device("cpu"))
    _, bwd = tfr.pack_train_bwd(field)
    for S, rpc, nsub in [(8, 64, 8), (16, 32, 8), (192, 2, 6), (130, 3, 7), (1000, 1, 16)]:
        d = tfr.train_desc(field, fd, bwd, S)
        assert d.rays_per_chunk == rpc
        rows = [d.rows[p] for p in range(10 + fd.depth)]
        assert rows == [32, 16, 16, 8, 8, 8, 8, 16, 16, 16] + [16] * fd.depth
        assert d.plane[1] == 32 * 72 * nsub and d.ws_size == sum(rows) * 72 * nsub
    offs, size = tfr.grad_layout(field)
    assert len(offs) == fd.depth + 4 and d.grad_size == size
    layers = tfr._field_layers(field)
    assert [bwd[i].k for i in range(1, fd.depth)] == [16] * (fd.depth - 1)
    assert (bwd[fd.depth].k, bwd[fd.depth].n) == (24, 16)  # [W_feature; W_alpha] on h
    assert (bwd[fd.depth + 2].k, bwd[fd.depth + 2].n) == (8, 16)
    assert (bwd[fd.depth + 3].k, bwd[fd.depth + 3].n) == (8, 8)
    assert layers[fd.depth][1] == [27, 16]  # the skip follows the last trunk layer here
    d6 = tfr.train_desc(field, fd, bwd, 192, sem=True)
    rows6 = [d6.rows[p] for p in range(13 + fd.depth)]
    assert rows6 == rows + [8, 8, 8]  # hidden 16 / 2, d_sem padded to 8, ds
    assert d6.ws_size == sum(rows6) * 72 * 6 and d6.rays_per_chunk == 2
    offs6, size6 = tfr.grad_layout(field, sem=True)
    assert offs6[:fd.depth + 4] == offs and len(offs6) == fd.depth + 6 and d6.grad_size == size6
    assert offs6[fd.depth + 4][0] == size  # sem_0's dW right after K3's buffer
    assert (bwd[fd.depth + 4].k, bwd[fd.depth + 4].n) == (8, 16)  # W_sem0 on h
    assert (bwd[fd.depth + 5].k, bwd[fd.depth + 5].n) == (8, 8)  # W_sem1
    assert min(bwd[fd.depth + 4].w, bwd[fd.depth + 5].w) > max(
        bwd[i].b for i in range(1, fd.depth + 4) if i != fd.depth + 1)


def test_cpu_wrapper_takes_the_plain_path():
    _, _, tnet = _nets(use_semantics=True, sem_with_coord=True)
    odv, z, gt = (torch.from_numpy(a) for a in _inputs(5, 8))
    before = tfr.fused_rgb_train_grads.launches
    got = tfr.fused_rgb_train_grads(tnet.nerf, odv, z, gt, white_bkgd=False, noise_std=0.5,
                                    seed=3)
    want = tfr.rgb_train_grads_plain(tnet.nerf, odv, z, gt, white_bkgd=False, noise_std=0.5,
                                     seed=3)
    for k in want[0]:
        assert torch.equal(got[0][k], want[0][k]), k
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert tfr.fused_rgb_train_grads.launches == before
