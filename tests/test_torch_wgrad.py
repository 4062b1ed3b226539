"""The reverse sweep's weight-gradient products on wgmma
(``nerfsos_torch/csrc/train_sweep.cuh`` wgrad) modelled on the CPU: the
reverse sweeps of a call (``group`` forward chunks a sweep, a CTA's
chunks ``(wave group + j) grid + b``, the last one ragged), each sub's X
and dY rows staged from the workspace planes (``[rows][kLd]`` tiles of 64
points, chunk j's subs after chunk j - 1's) in blocks of 64 rows with
stale rows past a block's end, rounds of four warpgroups over (64-row
block of X, piece of at most 128 outputs), dY converted into TF32 high
and low parts stored as the kernel stores them and read back through the
wgmma descriptor's core-matrix layout, the A fragments (a float2 of points
2 t and 2 t + 1 at k positions t and t + 4) split through ``_tf32``,
three products a k step, db from the sums of each k-slice, the partial dW
read and written once a round of a sweep and the partials summed in CTA
order. Fed through ``test_torch_train_render._emulate_k3``'s reverse sweep
(K3, K6 with and without sem_0's coordinates) and applied to every layer
of the mip field's and the standalone field's backward, against the plain
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

R = 20  # rays
WG = 64  # points a sub; X rows a warpgroup's block
KLD = fr._KLD
NAN = float("nan")
# wgmma's K-major no-swizzle B operand (csrc/wgmma.cuh b_desc): element
# (k, n) of a k-slice at byte (n // 8) SBO + (k // 4) LBO + (n % 8) 16 + (k % 4) 4
LBO, SBO = 128, 256


@pytest.fixture(autouse=True)
def small_pallas_block(monkeypatch):
    """8 rays per Pallas grid step keeps interpret mode fast."""
    monkeypatch.setattr(jfr, "TRAIN_RAY_BLOCK", 8)


def _sweeps(P, chunk_points, grid, group):
    """The reverse sweeps of a call over P points: (CTA, [(first point,
    points) of each chunk of the sweep]) in launch order; a sweep's chunks
    stop at the first one past the points (train_reverse_kernel)."""
    nchunks = -(-P // chunk_points)
    out = []
    for wave in range(-(-nchunks // (grid * group))):
        for b in range(grid):
            spans = []
            for j in range(group):
                c = (wave * group + j) * grid + b
                if c >= nchunks:
                    break
                spans.append((c * chunk_points, min(chunk_points, P - c * chunk_points)))
            if spans:
                out.append((b, spans))
    return out


def _tiles(m, spans, nsf, pad):
    """Plane rows ``m [rows, P]`` as the sweep's workspace holds them:
    ``[sub][rows][kLd]`` tiles, chunk j's subs from ``j nsf`` on, its last
    sub's points past the chunk ``pad`` (the forward's values there; the
    cotangents are 0), the row's 8 pad floats NaN (never read)."""
    nsub = (len(spans) - 1) * nsf + -(-spans[-1][1] // WG)
    t = torch.full((nsub, m.shape[0], KLD), NAN)
    for j, (p0, nq) in enumerate(spans):
        for s in range(-(-nq // WG)):
            t[j * nsf + s, :, :WG] = pad
            q = min(WG, nq - WG * s)
            t[j * nsf + s, :, :q] = m[:, p0 + WG * s:p0 + WG * s + q]
    return t


def _stage(tiles, sub, r0, r1, block):
    """A ring stage: rows [r0, r1) of the concatenated planes of sub, one
    copy a plane; rows past r1 - r0 hold what the stage held before (NaN)."""
    st = torch.full((block, KLD), NAN)
    off = 0
    for t in tiles:
        lo, hi = max(r0, off), min(r1, off + t.shape[1])
        if lo < hi:
            st[lo - r0:hi - r0] = t[sub, lo - off:hi - off]
        off += t.shape[1]
    return st


def _seq_sum(v, dim):
    """v summed along dim one term after another, in order (fp32)."""
    out = v.select(dim, 0).clone()
    for i in range(1, v.shape[dim]):
        out = out + v.select(dim, i)
    return out


def _b_read(buf, NP):
    """A k-slice's B operand [8, NP] (TF32 parts) as wgmma reads it at buf."""
    k = torch.arange(8)[:, None]
    n = torch.arange(NP)[None, :]
    return buf[((n // 8) * SBO + (k // 4) * LBO + (n % 8) * 16 + (k % 4) * 4) // 4]


def _wgrad_sweep(xs, dy, spans, nsf, gw, gb, block=WG, max_piece=128):
    """One sweep's dW and db of a layer, added into a CTA's partial ``gw
    [kpad, ldn]`` and ``gb [ldn]`` as wgrad_rounds does: X rows ``xs`` (the
    planes' rows, each padded to 8) and dY rows ``dy [ldn, P]``. ``block``
    (the kernel's 64) and ``max_piece`` (its 128) smaller exercise several
    m-groups and pieces at tiny widths."""
    kpad, ldn = sum(x.shape[0] for x in xs), dy.shape[0]
    xt = [_tiles(x, spans, nsf, 7.0) for x in xs]
    yt = [_tiles(dy, spans, nsf, 0.0)]
    nsub = xt[0].shape[0]
    NP = 8
    while NP < ldn and NP < max_piece:
        NP *= 2
    nm = -(-kpad // block)
    ngr = -(-nm // 4)
    for r in range(-(-ldn // NP) * ngr):
        pc, mb0 = r // ngr, 4 * (r % ngr)
        cnt, nrow = min(4, nm - mb0), min(NP, ldn - pc * NP)
        sums = mb0 == 0
        acc = torch.zeros(cnt, block, NP)
        dbacc = torch.zeros(nrow)
        for sub in range(nsub):
            d = [_stage(yt, sub, pc * NP + r0, min(pc * NP + r0 + block, pc * NP + nrow), block)
                 for r0 in range(0, nrow, block)]
            # the conversion: row n, points 8 kk .. 8 kk + 7 of its stage to k-slice kk
            B = torch.full((8 * 16 * NP,), NAN)
            dbp = torch.full((8, nrow), NAN)
            for n in range(nrow):
                v = d[n // block][n % block, :WG].view(8, 8)  # [kk, point]
                hi = fr._tf32(v)
                lo = fr._tf32(v - hi)
                for h in range(2):  # k half h, position c: point 2 c + h
                    at = torch.arange(8)[:, None] * 16 * NP + (n >> 3) * 64 + h * 32 + (n & 7) * 4 \
                        + torch.arange(4)[None, :]
                    B[at] = hi[:, h::2]
                    B[at + 8 * NP] = lo[:, h::2]
                if sums:
                    dbp[:, n] = _seq_sum(v, 1)
            if sums:
                dbacc = dbacc + _seq_sum(dbp, 0)
            for w in range(cnt):
                x = _stage(xt, sub, block * (mb0 + w), min(block * (mb0 + w + 1), kpad), block)
                for kk in range(8):
                    # the float2 of points 8 kk + 2 t, + 1 at k positions t, t + 4
                    pts = 8 * kk + torch.tensor([0, 2, 4, 6, 1, 3, 5, 7])
                    a = x[:, pts]
                    ahi = fr._tf32(a)
                    alo = fr._tf32(a - ahi)
                    bh = _b_read(B[kk * 16 * NP:], NP)
                    bl = _b_read(B[kk * 16 * NP + 8 * NP:], NP)
                    acc[w] = ((acc[w] + alo @ bh) + ahi @ bl) + ahi @ bh
        for w in range(cnt):
            m0 = block * (mb0 + w)
            rows = min(block, kpad - m0)
            gw[m0:m0 + rows, pc * NP:pc * NP + nrow] += acc[w, :rows, :nrow]
        if sums:
            gb[pc * NP:pc * NP + nrow] += dbacc


def _wgrad_call(xs, dy, chunk_points, grid, group, **kw):
    """A call's dW and db of a layer: each CTA's partial over its sweeps,
    then the partials summed in CTA order (reduce_partials)."""
    kpad, ldn = sum(x.shape[0] for x in xs), dy.shape[0]
    nsf = -(-chunk_points // WG)
    gw, gb = torch.zeros(grid, kpad, ldn), torch.zeros(grid, ldn)
    for b, spans in _sweeps(dy.shape[1], chunk_points, grid, group):
        _wgrad_sweep(xs, dy, spans, nsf, gw[b], gb[b], **kw)
    return _seq_sum(gw, 0), _seq_sum(gb, 0)


def _rel_errs(got, want):
    assert set(got) == set(want)
    out = {}
    for name, ref in want.items():
        ref = torch.as_tensor(ref)
        assert got[name].shape == ref.shape, name
        assert torch.isfinite(got[name]).all(), name
        out[name] = float((got[name] - ref).abs().max()) / (float(ref.abs().max()) + 1e-9)
    return out


def _inputs(seed, s):
    rng = np.random.default_rng(seed)
    odv = rng.normal(size=(R, 9)).astype(np.float32)
    odv[:, 6:9] = odv[:, 3:6] / np.linalg.norm(odv[:, 3:6], axis=1, keepdims=True)
    z = np.sort(rng.uniform(1, 4, size=(R, s)), 1).astype(np.float32)
    return odv, z


# (K3 or K6, depth, semantic head, its coordinates, samples, noise, rays a
# chunk, CTAs, chunks a sweep, X rows a block, outputs a piece)
MODEL_CASES = [
    ("k3", 4, True, True, 8, 0.6, 6, 2, 2, 64, 128),   # 48-point chunks, one sub each
    ("k3", 5, False, False, 16, 0.0, 7, 1, 2, 8, 16),  # several m-groups and pieces
    ("k6", 4, True, True, 16, 0.0, 6, 2, 2, 64, 128),  # 96-point chunks, ragged last chunk
    ("k6", 5, True, False, 8, 0.6, 9, 1, 3, 16, 8),
    ("k6", 4, False, False, 8, 0.6, 20, 1, 1, 64, 128),  # one chunk, one sweep
]


@pytest.mark.parametrize("mode,depth,sem,coord,s,noise,rpc,grid,group,block,piece",
                         MODEL_CASES)
def test_wgrad_model_matches_plain(mode, depth, sem, coord, s, noise, rpc, grid, group, block,
                                   piece):
    """The dW dataflow, fed through ``_emulate_k3``'s reverse sweep, gives
    ``rgb_train_grads_plain``'s (K3) and ``train_render_grads_plain``'s
    (K6) gradients, every leaf finite and to 1e-5 of its largest value
    (the 3xTF32 products drop only lo x lo, ~2^-22 of a term; the sums'
    order differs by the chunks and the CTAs)."""
    torch.manual_seed(100 * depth + s)
    field = NeRFField(net_depth=depth, net_width=32, multires=4, multires_views=2,
                      use_semantics=sem, sem_with_coord=coord, sem_dim=2)
    odv, z = (torch.from_numpy(a) for a in _inputs(depth + s, s))
    rng = np.random.default_rng(s)

    def dwb(layer, segs, dy):
        return _wgrad_call(segs, dy, rpc * s, grid, group, block=block, max_piece=piece)

    with torch.no_grad():
        if mode == "k6":
            dmaps = torch.from_numpy(rng.normal(size=(R, 7 if sem else 5)).astype(np.float32))
            dwt = torch.from_numpy(rng.normal(size=(R, s)).astype(np.float32))
            got, _, _ = _emulate_k3(field, odv, z, None, False, noise, 99, dmaps, dwt, dwb=dwb)
            want = fr.train_render_grads_plain(field, odv, z, dmaps, dwt, noise_std=noise,
                                               seed=99)
        else:
            gt = torch.from_numpy(rng.uniform(0, 1, size=(R, 3)).astype(np.float32))
            got, _, _ = _emulate_k3(field, odv, z, gt, False, noise, 99, dwb=dwb)
            want = fr.rgb_train_grads_plain(field, odv, z, gt, white_bkgd=False, noise_std=noise,
                                            seed=99)[0]
    assert float(want["mlp.pts_linears.0.weight"].abs().max()) > 0  # not a field with no density
    for name, err in _rel_errs(got, want).items():
        assert err < 1e-5, (name, err)


def _jax_seed(key):
    return int(jax.random.randint(key, (1, 1), 0, 2**31 - 1).astype(jnp.float32)[0, 0])


def test_wgrad_model_matches_pallas_k6():
    """K6 with the dW dataflow (chunks of 3 rays, 2 CTAs, 2 chunks a sweep)
    against ``jax.vjp`` of ``fused_train_render_planar`` without
    ``frozen_backbone`` (interpret mode), depth 4, width 32, 16 samples,
    sem_0's coordinates, noise 1, seeded map and weight cotangents: every
    leaf to 5e-5 of its largest value, the tolerance the plain version is
    held to against the same kernel (tests/test_torch_sos_kernels.py)."""
    kw = dict(netwidth=32, netwidth_fine=32, n_samples=8, n_importance=8, multires=4,
              multires_views=2, use_semantics=True, netdepth=4, netdepth_fine=4,
              sem_with_coord=True)
    jcfg = JaxConfig(**kw, fused_field=True, frozen_backbone=False)
    params = JaxNet(jcfg).init(jax.random.PRNGKey(7))
    tnet = TorchNet(TorchConfig(**kw, fused_field=True))
    tnet.load_state_dict(state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, params)))
    s = 16
    odv, z = _inputs(31, s)
    key = jax.random.PRNGKey(s)
    rng = np.random.default_rng(s)
    dmaps = rng.normal(size=(R, 7)).astype(np.float32)
    dwt = rng.normal(size=(R, s)).astype(np.float32)
    _, vjp = jax.vjp(
        lambda p: jfr.fused_train_render_planar(p, jnp.asarray(odv), jnp.asarray(z), jcfg,
                                                depth=4, noise_std=1.0, noise_key=key),
        params["fine"])
    (g_j,) = vjp((jnp.asarray(dmaps), jnp.asarray(dwt)))
    want = {k[len("nerf."):]: v for k, v in state_dict_from_jax_params(
        {"coarse": jax.tree_util.tree_map(np.asarray, g_j)}).items()}
    with torch.no_grad():
        got, _, _ = _emulate_k3(tnet.nerf_fine, torch.from_numpy(odv), torch.from_numpy(z), None,
                                False, 1.0, _jax_seed(key), torch.from_numpy(dmaps),
                                torch.from_numpy(dwt),
                                dwb=lambda layer, segs, dy: _wgrad_call(segs, dy, 3 * s, 2, 2))
    for name, err in _rel_errs(got, want).items():
        assert err <= 5e-5, (name, err)


def _layer_io(field, run):
    """Each dense layer's input ``[P, in]`` and output cotangent ``[P, out]``
    as ``run()`` (a plain backward of field) forms them."""
    io, handles = {}, []

    def hook(mod, inp, out):
        io[mod] = [inp[0].detach().reshape(-1, inp[0].shape[-1]), None]
        out.register_hook(lambda g: io[mod].__setitem__(1, g.detach().reshape(-1, g.shape[-1])))

    for lin, _ in fr._field_layers(field):
        handles.append(lin.register_forward_hook(hook))
    try:
        grads = run()
    finally:
        for h in handles:
            h.remove()
    return io, grads


def _pad_rows(x, rows):
    return torch.cat([x, x.new_zeros(rows - x.shape[0], x.shape[1])])


def _check_layers(field, io, grads, chunk_points, grid, group):
    """The model's dW/db of every layer from its plain input and cotangent
    against the plain gradients: finite, to 1e-5 of each leaf's largest
    value."""
    names = {id(p): n for n, p in field.named_parameters()}
    for lin, segs in fr._field_layers(field):
        x, dy = io[lin]
        xs, c0 = [], 0
        for k in segs:
            xs.append(_pad_rows(x[:, c0:c0 + k].t(), fr._pad8(k)))
            c0 += k
        n = lin.out_features
        gw, gb = _wgrad_call(xs, _pad_rows(dy.t(), fr._pad8(n)), chunk_points, grid, group)
        rows, r = [], 0
        for k in segs:
            rows.append(gw[r:r + k, :n])
            r += fr._pad8(k)
        got = {names[id(lin.weight)]: torch.cat(rows).t(), names[id(lin.bias)]: gb[:n]}
        want = {k: grads[k] for k in got}
        for name, err in _rel_errs(got, want).items():
            assert err < 1e-5, (name, err)


@pytest.mark.parametrize("s,rpc,grid,group", [(9, 5, 2, 2), (17, 4, 1, 3)])
def test_wgrad_model_on_the_mip_field(s, rpc, grid, group):
    """K10b's layers (the mip field: 60-wide integrated PE, no semantic
    head): the model's dW/db from each layer's input and cotangent in
    ``mip_train_render_grads_plain``'s backward match its gradients."""
    torch.manual_seed(s)
    field = MipNeRFField(net_depth=4, net_width=32, multires=4, multires_views=2)
    rng = np.random.default_rng(s)
    odvr = rng.normal(size=(R, 10)).astype(np.float32)
    odvr[:, 6:9] = odvr[:, 3:6] / np.linalg.norm(odvr[:, 3:6], axis=1, keepdims=True)
    odvr[:, 9] = rng.uniform(0.002, 0.01, size=R)
    z = np.sort(rng.uniform(1, 4, size=(R, s + 1)), 1).astype(np.float32)
    dmaps = torch.from_numpy(rng.normal(size=(R, 5)).astype(np.float32))
    dwt = torch.from_numpy(rng.normal(size=(R, s)).astype(np.float32))
    io, grads = _layer_io(field, lambda: fr.mip_train_render_grads_plain(
        field, torch.from_numpy(odvr), torch.from_numpy(z), dmaps, dwt, noise_std=0.5, seed=3))
    _check_layers(field, io, grads, rpc * s, grid, group)


@pytest.mark.parametrize("sem,coord", [(True, True), (False, False)])
def test_wgrad_model_on_the_field_backward(sem, coord):
    """K8c/K8f's layers (the standalone field's backward from a per-point
    cotangent, 70-point chunks, 2 CTAs, 2 chunks a sweep): the model's dW/db
    from each layer's input and cotangent in ``field_grads_plain`` match
    its gradients."""
    torch.manual_seed(5)
    field = NeRFField(net_depth=4, net_width=32, multires=4, multires_views=2,
                      use_semantics=sem, sem_with_coord=coord, sem_dim=2)
    rng = np.random.default_rng(6)
    N = 300
    pts = torch.from_numpy(rng.normal(size=(N, 3)).astype(np.float32))
    dirs = torch.nn.functional.normalize(torch.from_numpy(rng.normal(size=(N, 3)).astype(
        np.float32)), dim=1)
    g = torch.from_numpy(rng.normal(size=(N, 4 + (2 if sem else 0))).astype(np.float32))
    io, grads = _layer_io(field, lambda: ff.field_grads_plain(field, pts, dirs, g,
                                                              input_grads=False)[0])
    _check_layers(field, io, grads, 70, 2, 2)


def test_reverse_groups_and_their_workspace():
    """``_rev_group``: about ``_REV_POINTS`` points a sweep, no more chunks
    than the waves, the workspace within ``_REV_BYTES``; ``train_desc``'s
    planes hold ``group`` chunks' subs (each chunk's after the last one's)."""
    assert fr._rev_group(16384, 132, 384, 1000) == 5  # the SOS step's fine pass
    assert fr._rev_group(4096, 132, 512, 1000) == 4   # its coarse pass
    assert fr._rev_group(512, 132, 384, 1000) == 4    # 1024 rays: four waves
    assert fr._rev_group(100, 132, 384, 1000) == 1    # one wave
    assert fr._rev_group(16384, 132, 384, 3 << 20) == 2  # 12 MiB a chunk: 4 GiB cap
    assert fr._rev_group(50, 1, 2048, 1000) == 1
    field = NeRFField(net_depth=4, net_width=32, multires=4, multires_views=2,
                      use_semantics=True, sem_with_coord=True, sem_dim=2)
    _, fd = fr.pack_field(field)
    _, bwd = fr.pack_train_bwd(field)
    for S, rpc in [(192, 2), (136, 3), (1, 512)]:
        one = fr.train_desc(field, fd, bwd, S, True, rays_per_chunk=rpc)
        three = fr.train_desc(field, fd, bwd, S, True, rays_per_chunk=rpc, group=3)
        nsf = -(-rpc * S // WG)
        assert three.ws_size == 3 * one.ws_size
        for p in range(13 + fd.depth):
            assert three.rows[p] == one.rows[p]
            assert three.plane[p] == 3 * one.plane[p]
            if p:
                assert three.plane[p] - three.plane[p - 1] == 3 * nsf * one.rows[p - 1] * KLD
