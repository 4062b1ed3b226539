"""K4's 128-point tile (``nerfsos_torch/csrc/wg_tile.cuh``) modelled on the
CPU: the ring's host packing (``pack_ring``) unpacked against the field's
weights and ``pack_field``'s TF32 parts, and the tile's dataflow (ring
order, k-slice by k-slice 3xTF32 products with A split through ``_tf32``,
in-place write-back into each warpgroup's h, the heads from the
accumulators, the composite strip) held against ``train_render_plain`` and
the JAX package's ``_train_render_fwd_impl`` (Pallas, interpret mode) at
tiny widths, with ragged last tiles (R * S not a multiple of 128); and its
routes: K2 (noise 0), K1 (sigma-only), K3's and K6's storing forward, and
K9/K10a's mip mode (the Gaussians and the integrated PE in the prologue,
the mip composite) against their plain versions and the JAX package's
kernels.
"""
import contextlib
import itertools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsos_torch import _build
from nerfsos_torch.engines.checkpoint import state_dict_from_jax_params
from nerfsos_torch.models import mip as tmip
from nerfsos_torch.models.fields import MipNeRFField, NeRFField
from nerfsos_torch.models.mip import cast_rays
from nerfsos_torch.models.mlp import round_bf16
from nerfsos_torch.models.nerf import NeRFConfig as TorchConfig
from nerfsos_torch.models.nerf import NeRFNet as TorchNet
from nerfsos_torch.ops import fused_field as ff
from nerfsos_torch.ops import fused_render as fr
from nerfsos_tpu.models import mip as jmip
from nerfsos_tpu.models.nerf import NeRFConfig as JaxConfig
from nerfsos_tpu.models.nerf import NeRFNet as JaxNet
from nerfsos_tpu.ops.pallas import fused_field as jff
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


R = 20  # 160 or 320 points: the last 128-point tile is ragged
WG = 64  # points a consumer warpgroup


@pytest.fixture(autouse=True)
def small_pallas_block(monkeypatch):
    """8 rays per Pallas grid step keeps interpret mode fast."""
    monkeypatch.setattr(jfr, "TRAIN_RAY_BLOCK", 8)


def _nets(depth, sem, coord):
    kw = dict(netwidth=32, netwidth_fine=32, n_samples=8, n_importance=8, multires=4,
              multires_views=2, use_semantics=sem, netdepth=depth, netdepth_fine=depth,
              sem_with_coord=coord)
    jcfg = JaxConfig(**kw, fused_field=True, frozen_backbone=sem)
    params = JaxNet(jcfg).init(jax.random.PRNGKey(5))
    tnet = TorchNet(TorchConfig(**kw, fused_field=True))
    tnet.load_state_dict(state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, params)))
    return jcfg, params, tnet


def _inputs(seed, s):
    rng = np.random.default_rng(seed)
    odv = rng.normal(size=(R, 9)).astype(np.float32)
    odv[:, 6:9] = odv[:, 3:6] / np.linalg.norm(odv[:, 3:6], axis=1, keepdims=True)
    z = np.sort(rng.uniform(1, 4, size=(R, s)), 1).astype(np.float32)
    return odv, z


def _ring_layer(ring, rd, fdesc, i):
    """Layer i's ring stages unpacked to its TF32 high and low parts of
    ``W^T [k, N]`` (the inverse of ``pack_ring``'s per-slice layout)."""
    n, k = rd.ncols[i], fdesc.layer[i].k
    blocks = ring[rd.off[i]:rd.off[i] + k * 2 * n].view(k // 8, 2, n // 8, 2, 8, 4)
    parts = blocks.permute(1, 0, 3, 5, 2, 4).reshape(2, k, n)  # [part, s h c, j r]
    return parts[0], parts[1]


@pytest.mark.parametrize("depth,sem,coord,width", [(4, True, True, 32), (5, True, False, 16),
                                                   (6, False, False, 256)])
def test_ring_packing_unpacks_to_the_weights(depth, sem, coord, width):
    torch.manual_seed(depth)
    field = NeRFField(net_depth=depth, net_width=width, multires=4, multires_views=2,
                      use_semantics=sem, sem_with_coord=coord, sem_dim=3)
    _check_ring(field, (8, 64, 192))


@pytest.mark.parametrize("depth,width,multires", [(5, 32, 4), (8, 64, 10)])
def test_ring_packing_unpacks_a_mip_field(depth, width, multires):
    """pack_ring of a ``MipNeRFField`` (the integrated PE's 6 multires
    input rows, no semantic head, the skip after layer 4): the trunk,
    feature and views in ring order, each unpacking to its weights, and
    ``_wg_plan`` fitting at K9's and K10a's interval counts."""
    torch.manual_seed(depth)
    field = MipNeRFField(net_depth=depth, net_width=width, multires=multires,
                         multires_views=multires // 2)
    assert fr.pack_field(field)[1].emb_dim == 6 * multires
    _check_ring(field, (7, 63, 190))


def _check_ring(field, samples):
    """pack_ring's buffer of ``field`` unpacked against its weights and
    ``pack_field``'s TF32 parts; the plan at each of ``samples`` fits."""
    depth, sem = field.mlp.depth, field.mlp.use_semantics
    buf, fdesc = fr.pack_field(field)
    ring, rd = fr.pack_ring(field)
    layers = fr._field_layers(field)
    order = fr.ring_layers(field)
    assert order == list(range(depth)) + ([depth + 4] if sem else []) + [depth + 1, depth + 2]
    off = 0
    for i in order:
        lin, segs = layers[i]
        L = fdesc.layer[i]
        ldn, n = fr._pad8(L.n), rd.ncols[i]
        assert n in fr._RING_WIDTHS and ldn <= n < 2 * ldn and rd.off[i] == off
        off += L.k * 2 * n
        hi, lo = _ring_layer(ring, rd, fdesc, i)
        size = L.k * ldn
        assert torch.equal(hi[:, :ldn].reshape(-1), buf[L.w + size:L.w + 2 * size])
        assert torch.equal(lo[:, :ldn].reshape(-1), buf[L.w + 2 * size:L.w + 3 * size])
        assert not hi[:, ldn:].any() and not lo[:, ldn:].any()
        assert torch.equal(hi, fr._tf32(hi)) and torch.equal(lo, fr._tf32(lo))
        # the segments' rows, padding rows dropped, are the layer's W^T to TF32 x 2
        rows, r = [], 0
        for k in segs:
            rows.append((hi + lo)[r:r + k, :lin.out_features])
            assert not (hi[r + k:r + fr._pad8(k)]).any()
            r += fr._pad8(k)
        wt = lin.weight.detach().t()
        assert float((torch.cat(rows) - wt).abs().max()) <= 2.0**-20 * float(wt.abs().max())
    assert off == ring.numel()
    assert rd.hrows == max(rd.ncols[i] for i in list(range(depth)) + [depth + 1])
    assert rd.stage_floats == 16 * max(rd.ncols[i] for i in order)
    assert rd.stages == 0  # set per call by the wrapper
    for S in samples:
        rpc, rds = fr._wg_plan(fdesc, rd, S)
        assert 2 <= rds.stages <= 4 and fr._wg_smem(fdesc, rds, rpc, S) <= fr._MAX_SMEM


def _swz(k, p):
    """Row k, point p of a warpgroup tile (``csrc/wg_tile.cuh`` swz)."""
    return k * WG + (p ^ ((k & 3) << 3))


def _mip_prologue(gauss, E, Ep, hrows):
    """wg_forward_tile's kInMip prologue for one warpgroup on flat swizzled
    tiles: the 64 points' Gaussians ``gauss [64, 6]`` (means, variances;
    zero past the chunk's points) into rows 0-5 of h, then ipe_rows_wg's E
    rows (row f: k = f mod E/2, channel k mod 3, frequency 2^(k // 3); the
    second half's phase + pi/2) from them into emb. emb's pad rows E ..
    Ep - 1 hold wg_cta's zeros, every other float of both tiles starts NaN:
    the prologue writes every emb row and reads no h row past 5. Returns emb
    unswizzled ``[Ep, 64]``."""
    p = torch.arange(WG)
    h = torch.full((hrows * WG,), float("nan"))
    emb = torch.full((Ep * WG,), float("nan"))
    for k in range(E, Ep):
        emb[_swz(k, p)] = 0.0
    for r in range(6):
        h[_swz(r, p)] = gauss[:, r]
    half = E // 2
    for f in range(E):
        k = f % half
        c, freq = k % 3, 2.0 ** (k // 3)
        y = freq * h[_swz(c, p)]
        yv = (freq * freq) * h[_swz(3 + c, p)]
        s = torch.sin(y + 0.5 * np.pi if f >= half else y)
        emb[_swz(f, p)] = torch.exp(-0.5 * yv) * s
    assert h[_swz(6, 0):].isnan().all()  # rows 6.. are the trunk's
    out = emb[_swz(torch.arange(Ep)[:, None], p)]
    assert not out.isnan().any() and not out[E:].any()
    return out


def _k4_model(field, odv, z, noise_std, seed, save_semin, desc=None, sem_act=False,
              sigma_only=False, mip=False, points=None, per=1, g=None, in_grad=False):
    """K4 as the kernel computes it, from pack_field's and pack_ring's
    buffers alone: chunks of rays, 128-point tiles of two 64-point
    warpgroups, each layer k-slice by k-slice in the ring's order.
    ``sigma_only`` (K1's mode): the tile reads the rays' first 6 columns,
    streams the trunk's layers alone, then the alpha head; only the weights
    come out right. ``mip`` (K9's and K10a's mode): ``odv`` is odvr
    ``[R, 10]`` and ``z`` fenceposts ``[R, S + 1]``; each warpgroup's
    prologue is :func:`_mip_prologue` on its intervals' Gaussians, and the
    chunk's composite is the mip one (maps ``[R, 5]``). With
    ``desc`` (``train_desc`` at the plan's chunk), K3's, K6's and (``mip``)
    K10b's storing forward (``wg_forward_tile``'s kStore): each warpgroup
    with a point before the chunk's nq also writes emb, demb, every trunk
    layer's output, feature, views' hidden activation and (``sem_act``, K6)
    the semantic head's into sub 2 t + w of its chunk's workspace slice;
    the slices come back with each float's count of writes and the chunk's
    nq, and so do the heads' outputs of every point (the composite strip:
    sigma without noise at column 0, the rgb logits at 2.., the semantics
    at 5..). With ``points`` (the field kernels' point-list modes; odv and
    z unused): ``(pts, dirs)`` (K8b/K8d), ``(pts,)`` with ``sigma_only``
    (K8a/K8e) or ``(mean, cov, dirs)`` with ``mip`` (K11); a CTA takes
    ``per`` consecutive tiles of the rows, the alpha thread writes sigma to
    its output column, the rgb logits and semantics go to the tile's strip
    (3 + sem floats a point) and each warpgroup copies its rows out after
    its last head. Returns the output rows (sigma ``[N]`` or raw
    ``[N, 4 + sem]``), each float of which is checked to be written once.
    With ``points=(pts, dirs)``, ``desc`` (``train_desc`` at S = 1) and the
    cotangent ``g [N, 4 + sem]``: the field backward's forward (K8c/K8f,
    the store mode with the point-list input), a CTA a chunk of
    ``desc.rays_per_chunk`` points (``per`` = its tiles); no alpha head and
    no output rows; after the tiles, g's columns into the cotangent planes
    (P_DRGB rows 0-2, P_DSIG row 0, with the semantic head d_sem's rows <
    sem; every other row and every point past the chunk's zero) of each
    sub, and with ``in_grad`` (K8c) the point-PE cotangent plane's subs
    zeroed whole. Returns the chunks' slices as the storing forward's."""
    buf, fdesc = fr.pack_field(field)
    ring, rd = fr.pack_ring(field)
    listed = points is not None
    bwd_fwd = listed and desc is not None  # the field backward's forward
    depth, sem = fdesc.depth, fdesc.sem_dim
    if bwd_fwd:
        assert per * 128 == desc.rays_per_chunk and g.shape == (points[0].shape[0], 4 + sem)
    if listed:
        N = points[0].shape[0]
        C = 1 if sigma_only else 4 + sem
        rows = torch.full((N, C), float("nan"))
        written = torch.zeros((N, C), dtype=torch.int32)
        spans = [(b, min(per * 128, N - b)) for b in range(0, N, per * 128)]
    else:
        R_, S = z.shape[0], z.shape[1] - int(mip)
        rpc, _ = fr._wg_plan(fdesc, rd, S)
        spans = [(r0, min(rpc, R_ - r0) * S) for r0 in range(0, R_, rpc)]
    E, Ed = fdesc.emb_dim, fdesc.demb_dim
    Ep, Edp = fr._pad8(E), fr._pad8(Ed)
    L = fdesc.layer
    head = [L[depth + j] for j in range(6)]  # alpha, feature, views, rgb, sem_0, sem_1
    cs = 6 + sem
    hn = L[depth - 1].n
    hoff = E if fdesc.skip == depth - 1 else 0
    C_in = hoff + hn + (E if fdesc.sem_with_coord else 0)
    stages = {"n": 0}

    def bias(Li, n):
        b = buf[Li.b:Li.b + fr._pad8(Li.n)]
        return torch.cat([b, b.new_zeros(n - b.numel())])

    def wt_fp32(Li):
        ldo = fr._pad8(Li.n)
        return buf[Li.w:Li.w + Li.k * ldo].view(Li.k, ldo)

    def product(i, segs):
        """acc [64, N]: one k-slice of 8 rows a step, lo x hi + hi x lo + hi x hi."""
        a = torch.cat([s for s in segs if s is not None])  # [k, 64]
        hi, lo = _ring_layer(ring, rd, fdesc, i)
        acc = torch.zeros(WG, rd.ncols[i])
        for s in range(a.shape[0] // 8):
            ak = a[8 * s:8 * s + 8]
            ahi = fr._tf32(ak)
            alo = fr._tf32(ak - ahi)
            bh, bl = hi[8 * s:8 * s + 8], lo[8 * s:8 * s + 8]
            acc = acc + alo.t() @ bh + ahi.t() @ bl + ahi.t() @ bh
            stages["n"] += 1
        return acc

    def pe(x, rows):
        out = [x]
        for band in range((rows - 3) // 6):
            for phase in (0.0, float(np.float32(np.pi / 2))):
                out.append(torch.sin(x * (2.0 ** band) + phase))
        return torch.cat(out)

    def put_row(q, c, v):  # a point-list mode's write of out row q, column c
        rows[q, c] = v
        written[q, c] += 1

    maps, weights, sem_in, slices, strips = [], [], [], [], []
    for r0, nq in spans:
        if listed:
            sl = slice(r0, r0 + nq)
            if mip:
                gauss = torch.cat([points[0][sl], points[1][sl]], 1)
            else:
                pts = points[0][sl]
            dirs = None if sigma_only else points[-1][sl]
            tstrip = torch.full((128, 3 + sem), float("nan"))  # the tile's heads
        else:
            o, zc = odv[r0:r0 + rpc], z[r0:r0 + rpc]
            if mip:
                gauss = torch.cat(cast_rays(zc, o[:, 0:3], o[:, 3:6], o[:, 9:10]),
                                  -1).reshape(-1, 6)
            else:
                pts = (o[:, None, 0:3] + o[:, None, 3:6] * zc[..., None]).reshape(-1, 3)
            dirs = None if sigma_only else o[:, None, 6:9].expand(-1, S, 3).reshape(-1, 3)
        strip = torch.zeros(nq, cs)
        semin = torch.zeros(nq, C_in)
        if desc is not None:
            ws = torch.zeros(desc.ws_size)
            writes = torch.zeros(desc.ws_size, dtype=torch.int32)
            slices.append((ws, writes, nq))

        def put(p, sub, x):
            rows_ = desc.rows[p]
            at = desc.plane[p] + sub * rows_ * fr._KLD
            ws[at:at + rows_ * fr._KLD].view(rows_, fr._KLD)[:, :WG] = x[:rows_]
            writes[at:at + rows_ * fr._KLD].view(rows_, fr._KLD)[:, :WG] += 1

        for t in range(-(-nq // 128)):
            for wg in range(2):
                qw = 128 * t + WG * wg
                q = torch.arange(qw, qw + WG)
                live = q < nq
                qc = q.clamp(max=nq - 1)
                ql = qc[live]
                emb = torch.zeros(Ep, WG)
                demb = torch.zeros(Edp, WG)
                if mip:
                    emb = _mip_prologue(torch.where(live[:, None], gauss[qc], 0.0), E, Ep,
                                        rd.hrows)
                else:
                    emb[:E] = pe(torch.where(live, pts[qc].t(), 0.0), E)
                if not sigma_only:
                    demb[:Ed] = pe(torch.where(live, dirs[qc].t(), 0.0), Ed)
                store, sub = desc is not None and qw < nq, qw // WG
                if store:
                    put(fr._P_EMB, sub, emb)
                    put(fr._P_DEMB, sub, demb)
                h = torch.full((rd.hrows, WG), float("nan"))  # rows are written before read
                in0, in1 = emb, None
                for i in range(depth):
                    v = torch.relu(product(i, [in0, in1]) + bias(L[i], rd.ncols[i]))
                    h[:rd.ncols[i]] = v.t()  # over the layer's own input rows
                    if store:
                        put(fr._P_ACT0 + i, sub, v.t())
                    if i == depth - 1:
                        semin[ql, hoff:hoff + hn] = v[live, :hn]
                    hs = h[:fr._pad8(L[i].n)]
                    in0, in1 = (emb, hs) if i == fdesc.skip else (hs, None)
                if hoff:
                    semin[ql, :E] = emb[:E].t()[live]
                if fdesc.sem_with_coord:
                    semin[ql, hoff + hn:] = emb[:E].t()[live]
                xa = torch.cat([s for s in (in0, in1) if s is not None])
                alpha = xa.t() @ wt_fp32(head[0])[:, 0] + buf[head[0].b]
                strip[ql, 0] = alpha[live]
                if listed and not bwd_fwd:
                    put_row(r0 + ql, 0 if sigma_only else 3, alpha[live])
                if sigma_only:
                    continue
                if sem:
                    i = depth + 4
                    v = torch.relu(product(i, [in0, in1, emb if fdesc.sem_with_coord else None])
                                   + bias(head[4], rd.ncols[i]))
                    if store and sem_act:
                        put(fr._P_ACT0 + depth, sub, v.t())
                    s_out = v[:, :head[5].k] @ wt_fp32(head[5])[:, :sem] + buf[head[5].b:
                                                                             head[5].b + sem]
                    strip[ql, 5:5 + sem] = s_out[live]
                    if listed:
                        tstrip[ql - 128 * t, 3:3 + sem] = s_out[live]
                i = depth + 1
                h[:rd.ncols[i]] = (product(i, [in0, in1]) + bias(head[1], rd.ncols[i])).t()
                if store:
                    put(fr._P_FEAT, sub, h)
                i = depth + 2
                v = torch.relu(product(i, [h[:fr._pad8(head[1].n)], demb])
                               + bias(head[2], rd.ncols[i]))
                if store:
                    put(fr._P_HV, sub, v.t())
                rgb = v[:, :head[3].k] @ wt_fp32(head[3])[:, :3] + buf[head[3].b:head[3].b + 3]
                strip[ql, 2:5] = rgb[live]
                if listed and not bwd_fwd:  # the warpgroup's rows but sigma from the strip
                    tstrip[ql - 128 * t, 0:3] = rgb[live]
                    part = tstrip[ql - 128 * t]
                    for c in range(C):
                        if c != 3:
                            put_row(r0 + ql, c, part[:, c if c < 3 else c - 1])
        if bwd_fwd:  # the consumers' copy of g into the cotangent planes
            nsub = -(-nq // WG)
            q = torch.arange(nsub * WG)
            gq = torch.where((q < nq)[:, None], g[r0 + q.clamp(max=nq - 1)], 0.0).t()
            p_dsem, p_gemb = fr._P_ACT0 + depth + 1, fr._P_ACT0 + depth + 3
            cots = [(fr._P_DRGB, gq[0:3]), (fr._P_DSIG, gq[3:4])]
            cots += [(p_dsem, gq[4:4 + sem])] if sem else []
            for p, rows_g in cots:
                full = torch.cat([rows_g, rows_g.new_zeros(8 - rows_g.shape[0], rows_g.shape[1])])
                for sub in range(nsub):
                    put(p, sub, full[:, WG * sub:WG * (sub + 1)])
            if in_grad:
                at, n = desc.plane[p_gemb], nsub * desc.rows[p_gemb] * fr._KLD
                ws[at:at + n] = 0.0
                writes[at:at + n] += 1
        if listed:
            continue
        strips.append(strip)
        raw = torch.cat([strip[:, 2:5], strip[:, 0:1], strip[:, 5:5 + sem]], 1)
        raw = raw.view(zc.shape[0], S, -1)
        sigma = raw[..., 3]
        if noise_std > 0:
            sigma = sigma + fr.noise_plain(seed, R_, S, noise_std)[r0:r0 + rpc]
        m, w = (fr._mip_maps if mip else fr._maps)(raw, sigma, zc, o[:, 3:6])
        maps.append(m)
        weights.append(w)
        sem_in.append(semin)
    layers = range(depth) if sigma_only else fr.ring_layers(field)
    per_tile = sum(L[i].k // 8 for i in layers)
    assert stages["n"] == 2 * per_tile * sum(-(-nq // 128) for _, nq in spans)
    if bwd_fwd:
        assert not written.any()
        return slices
    if listed:
        assert (written == 1).all() and not rows.isnan().any()
        return rows[:, 0] if sigma_only else rows
    out = torch.cat(maps), torch.cat(weights), torch.cat(sem_in) if save_semin else None
    return out if desc is None else (*out, slices, torch.cat(strips))


CASES = [(4, True, True, 0.6, 8), (5, True, False, 0.0, 16), (6, True, True, 0.0, 8),
         (4, False, False, 0.6, 16)]


@pytest.mark.parametrize("depth,sem,coord,noise,s", CASES)
def test_k4_tile_model_matches_plain_and_pallas(depth, sem, coord, noise, s):
    """The tile's dataflow against the plain version and the Pallas kernel:
    maps, weights and (with the semantic head) sem_in."""
    jcfg, params, tnet = _nets(depth, sem, coord)
    odv, z = _inputs(s + depth, s)
    seed = 2345678
    field = tnet.nerf_fine
    odv_t, z_t = torch.from_numpy(odv), torch.from_numpy(z)
    with torch.no_grad():
        got = _k4_model(field, odv_t, z_t, noise, seed, sem)
    want = fr.train_render_plain(field, odv_t, z_t, noise_std=noise, seed=seed, save_semin=sem)
    for a, b in zip(got, want):
        if b is not None:
            assert a.shape == b.shape
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=0)
    ws, bs = jfr._flatten_mlp_params(params["fine"]["mlp"], depth, sem)
    outs = jfr._train_render_fwd_impl(
        tuple(ws), tuple(bs), jnp.asarray(odv), jnp.asarray(z),
        jnp.full((1, 1), seed, jnp.float32), depth, (4,), jcfg.multires, jcfg.multires_views,
        sem, coord, "float32", noise, interpret=True, save_semin=sem, frozen_blk=True)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(outs[0]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(outs[1]), atol=1e-5, rtol=0)
    if sem:
        C = field.mlp.semantic_linear[0].in_features
        semin_j = np.asarray(outs[2]).transpose(0, 2, 1).reshape(-1, C)[:R * s]
        np.testing.assert_allclose(got[2].numpy(), semin_j, atol=1e-5, rtol=0)


K2_CASES = [(4, True, True, 8), (5, True, False, 16), (6, False, False, 16), (5, False, False, 8)]


@pytest.mark.parametrize("depth,sem,coord,s", K2_CASES)
def test_k2_route_is_the_tile_without_noise(monkeypatch, depth, sem, coord, s):
    """K2 runs K4's kernel with noise 0 and no sem_in: the tile's dataflow
    at noise 0 and train_render_plain(noise_std=0, save_semin=False) against
    K2's plain version and the JAX package's eval kernel
    (``fused_render_planar``, Pallas in interpret mode), ragged last tile."""
    monkeypatch.setattr(jfr, "RAY_BLOCK", 8)
    jcfg, params, tnet = _nets(depth, sem, coord)
    odv, z = _inputs(3 * s + depth, s)
    field = tnet.nerf_fine
    odv_t, z_t = torch.from_numpy(odv), torch.from_numpy(z)
    with torch.no_grad():
        model = _k4_model(field, odv_t, z_t, 0.0, 0, False)
        route = fr.train_render_plain(field, odv_t, z_t, noise_std=0.0, seed=0, save_semin=False)
        want = fr.render_plain(field, odv_t, z_t)
    assert route[2] is None and model[2] is None
    for got in (model[:2], route[:2]):
        for a, b in zip(got, want):
            assert a.shape == b.shape
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=0)
    maps_j, w_j = jfr.fused_render_planar(params["fine"], jnp.asarray(odv), jnp.asarray(z), jcfg,
                                          depth=depth, interpret=True)
    np.testing.assert_allclose(model[0].numpy(), np.asarray(maps_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(model[1].numpy(), np.asarray(w_j), atol=1e-5, rtol=0)


K1_CASES = [(4, True, True, 8), (5, False, False, 16), (6, True, False, 16)]


@pytest.mark.parametrize("depth,sem,coord,s", K1_CASES)
def test_k1_route_is_the_tile_sigma_only(monkeypatch, depth, sem, coord, s):
    """K1 runs K4's kernel in its sigma-only mode: the tile's dataflow on
    ``od [R, 6]`` (the trunk's ring stages, the alpha head, the composite at
    noise 0) against K1's plain version and the JAX package's coarse pass
    (``fused_coarse_weights_planar``, Pallas in interpret mode), the
    coarse field's weights bridged from JAX, fixed z, ragged last tile:
    the weights to 1e-5."""
    monkeypatch.setattr(jfr, "RAY_BLOCK", 8)
    jcfg, params, tnet = _nets(depth, sem, coord)
    odv, z = _inputs(5 * s + depth, s)
    od = np.ascontiguousarray(odv[:, :6])
    field = tnet.nerf
    od_t, z_t = torch.from_numpy(od), torch.from_numpy(z)
    with torch.no_grad():
        model = _k4_model(field, od_t, z_t, 0.0, 0, False, sigma_only=True)[1]
        want = fr.coarse_weights_plain(field, od_t, z_t)
    assert model.shape == want.shape == (R, s)
    np.testing.assert_allclose(model.numpy(), want.numpy(), atol=1e-5, rtol=0)
    w_j = jfr.fused_coarse_weights_planar(params["coarse"], jnp.asarray(od), jnp.asarray(z), jcfg,
                                          depth=depth, interpret=True)
    np.testing.assert_allclose(model.numpy(), np.asarray(w_j), atol=1e-5, rtol=0)


def _mip_nets(depth):
    """A JAX MipNeRFNet with seeded params and the port's twin holding them,
    at a tiny width (32, multires 4: a 24-row integrated PE)."""
    kw = dict(netwidth=32, netdepth=depth, n_samples=8, n_importance=8, multires=4,
              multires_views=2, use_semantics=False)
    jcfg = JaxConfig(**kw, fused_field=True)
    params = jmip.MipNeRFNet(jcfg).init(jax.random.PRNGKey(7))
    tnet = tmip.MipNeRFNet(TorchConfig(**kw, fused_field=True))
    tnet.load_state_dict(state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, params)))
    return jcfg, params, tnet


def _mip_inputs(seed, s):
    """odvr [R, 10] (origins, directions, unit viewdirs, a 504-pixel view's
    base radius) and sorted fenceposts [R, s + 1] in [1, 4]."""
    rng = np.random.default_rng(seed)
    odvr = rng.normal(size=(R, 10)).astype(np.float32)
    odvr[:, 0:3] *= 0.3
    odvr[:, 6:9] = odvr[:, 3:6] / np.linalg.norm(odvr[:, 3:6], axis=1, keepdims=True)
    odvr[:, 9] = 2.0 / 504 * 2 / np.sqrt(12)
    z = np.sort(rng.uniform(1, 4, size=(R, s + 1)), 1).astype(np.float32)
    return odvr, z


MIP_CASES = [(4, 0.0, 8), (5, 0.0, 16), (5, 0.6, 7)]  # depth, noise, intervals


@pytest.mark.parametrize("depth,noise,s", MIP_CASES)
def test_k9_k10a_route_is_the_tile_in_mip_mode(monkeypatch, depth, noise, s):
    """K9 (noise 0) and K10a run K4's kernel in its mip mode: the tile's
    dataflow with the mip prologue (the Gaussians in h's scratch rows, the
    swizzled IPE rows, zero pad rows) and the mip composite against the
    plain versions and the JAX package's kernels (``fused_mip_render_planar``
    and ``_mip_train_fwd_impl``, Pallas in interpret mode), the mip field's
    weights bridged from JAX, the noise at a fixed seed, 20 rays in one
    chunk (160, 320 or 140 intervals: the last 128-point tile is ragged, at
    16 intervals its second warpgroup lies wholly past them): maps and
    weights to 1e-5."""
    monkeypatch.setattr(jfr, "RAY_BLOCK", 8)
    jcfg, params, tnet = _mip_nets(depth)
    odvr, z = _mip_inputs(7 * s + depth, s)
    seed = 1234567
    field = tnet.mip
    odvr_t, z_t = torch.from_numpy(odvr), torch.from_numpy(z)
    with torch.no_grad():
        model = _k4_model(field, odvr_t, z_t, noise, seed, False, mip=True)
        if noise == 0.0:
            want = fr.mip_render_plain(field, odvr_t, z_t)
        else:
            want = fr.mip_train_render_plain(field, odvr_t, z_t, noise_std=noise, seed=seed)
    assert model[2] is None and model[0].shape == (R, 5) and model[1].shape == (R, s)
    for a, b in zip(model[:2], want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=0)
    if noise == 0.0:
        outs = jfr.fused_mip_render_planar(params["mip"], jnp.asarray(odvr), jnp.asarray(z), jcfg,
                                           interpret=True)
    else:
        ws, bs = jfr._flatten_mlp_params(params["mip"]["mlp"], depth, False)
        outs = jfr._mip_train_fwd_impl(
            tuple(ws), tuple(bs), jnp.asarray(odvr), jnp.asarray(z),
            jnp.full((1, 1), seed, jnp.float32), depth, (4,), jcfg.multires,
            jcfg.multires_views, "float32", "cone", noise, interpret=True)
    for a, b in zip(model[:2], outs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b)[:R], atol=1e-5, rtol=0)


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card: the wrappers take their
    CUDA branch on it."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_mip_wrappers_launch_the_tile_with_a_ring(monkeypatch):
    """On CUDA tensors fused_mip_render and mip_train_render launch K4's
    kernel in its mip mode through ``_mip_forward`` (no plain fallback,
    noise 0 for K9) and count the launch; ``_mip_forward`` calls the
    library's ``nerf_mip_render`` once with ``_wg_plan``'s chunk and ring
    stages and ``pack_ring``'s buffer (here on a library that records the
    call)."""
    torch.manual_seed(3)
    field = MipNeRFField(net_depth=5, net_width=32, multires=4, multires_views=2)
    odvr, z = (torch.from_numpy(a) for a in _mip_inputs(3, 63))
    seen = []

    def forward(f, o, zz, noise_std, seed, bf16):
        seen.append((f, o, zz, noise_std, seed, bf16))
        return "maps", "weights"

    monkeypatch.setattr(fr, "_mip_forward", forward)
    card = odvr.as_subclass(_OnCard), z.as_subclass(_OnCard)
    counts = fr.fused_mip_render.launches, fr.mip_train_render.launches
    assert fr.fused_mip_render(field, *card) == ("maps", "weights")
    assert fr.mip_train_render(field, *card, noise_std=1.0, seed=5) == ("maps", "weights")
    assert (fr.fused_mip_render.launches, fr.mip_train_render.launches) == (
        counts[0] + 1, counts[1] + 1)
    assert [s[3:] for s in seen] == [(0.0, 0, False), (1.0, 5, False)]
    assert all(s[0] is field and s[1] is card[0] and s[2] is card[1] for s in seen)
    monkeypatch.undo()

    calls = []

    class Lib:
        def nerf_mip_render(self, *a):
            calls.append(a)
            return 0

    monkeypatch.setattr(fr._build, "library", Lib)
    monkeypatch.setattr(fr._build, "stream", lambda device: None)
    monkeypatch.setattr(fr.torch.cuda, "device", lambda device: contextlib.nullcontext())
    maps, weights = fr._mip_forward(field, odvr, z, 1.0, 5)
    assert maps.shape == (R, 5) and weights.shape == (R, 63)
    (a,) = calls
    buf, fdesc = fr._packed(field, odvr.device)
    rbuf, ring = fr._ring(field, odvr.device)
    rpc, rd = fr._wg_plan(fdesc, ring, 63)
    assert rpc == 8 and torch.equal(rbuf, fr.pack_ring(field)[0])
    assert a[:4] == (odvr.data_ptr(), z.data_ptr(), buf.data_ptr(), rbuf.data_ptr())
    desc, rdesc = a[4]._obj, a[5]._obj
    assert desc.rays_per_chunk == rpc and desc.f.emb_dim == 24
    assert bytes(rdesc) == bytes(rd) and rdesc.stages >= 2
    assert a[6:] == (maps.data_ptr(), weights.data_ptr(), R, 63, fr.noise_seed(5), 1.0, None)
    with pytest.raises(NotImplementedError):  # no kernel and no plain fallback off the card
        fr.fused_mip_render(field, odvr.to("meta"), z.to("meta"))


def test_ring_repacks_a_changed_layer_only():
    """pack_ring is a gather of pack_field's TF32 parts: an update of sem_0
    alone (a --fix_backbone step) changes sem_0's stages and no other
    layer's, gives what a fresh field with the same weights gives, and the
    wrappers' cached ring (``_ring``, gathered from the cached ``_packed``
    buffer) follows the update."""
    torch.manual_seed(1)
    kw = dict(net_depth=4, net_width=32, multires=4, multires_views=2, use_semantics=True,
              sem_with_coord=True, sem_dim=2)
    field = NeRFField(**kw)
    cpu = torch.device("cpu")
    before, rd = fr.pack_ring(field)
    assert torch.equal(fr._ring(field, cpu)[0], before)
    with torch.no_grad():
        field.mlp.semantic_linear[0].weight.mul_(-0.5)
    after, rd2 = fr.pack_ring(field)
    assert torch.equal(fr._ring(field, cpu)[0], after)
    fresh = NeRFField(**kw)
    fresh.load_state_dict(field.state_dict())
    assert torch.equal(after, fr.pack_ring(fresh)[0])
    i = 4 + 4  # sem_0's kernel layer index at depth 4
    k, n = fr.pack_field(field)[1].layer[i].k, rd.ncols[i]
    lo, hi = rd.off[i], rd.off[i] + 2 * k * n
    assert not torch.equal(before[lo:hi], after[lo:hi])
    assert torch.equal(before[:lo], after[:lo]) and torch.equal(before[hi:], after[hi:])
    assert list(rd.off) == list(rd2.off) and list(rd.ncols) == list(rd2.ncols)


STORE_CASES = [  # (K3, K6 or K10b, depth, semantic head, its coordinates, noise)
    ("k3", 4, True, True, 0.6), ("k3", 5, False, False, 0.0), ("k6", 4, True, True, 0.0),
    ("k6", 5, True, False, 0.6), ("k6", 4, False, False, 0.0), ("k10b", 5, False, False, 0.6),
    ("k10b", 4, False, False, 0.0)]


@pytest.mark.parametrize("mode,depth,sem,coord,noise", STORE_CASES)
def test_storing_forward_model_feeds_the_reverse_sweep(mode, depth, sem, coord, noise):
    """K3's, K6's and K10b's storing forward on the 128-point tile (K10b's
    in its mip mode: fenceposts, the Gaussians and the integrated PE, the
    mip field), at S = 136: chunks of 3 rays (the plan's, which sizes
    train_desc's planes), 408 points, 7 subs, so the last tile's second
    warpgroup lies wholly past the points; the last chunk of 20 rays has 2
    rays (272 points, 5 subs). Every float of each stored plane's subs of
    the chunk's points is written once and nothing else is written; the
    planes, fed through the reverse sweep of ``_emulate_k3`` (with the
    tile's heads as the composite's input; K10b's composite the mip one),
    give ``rgb_train_grads_plain``'s, ``train_render_grads_plain``'s and
    ``mip_train_render_grads_plain``'s gradients."""
    from test_torch_train_render import _emulate_k3

    torch.manual_seed(depth)
    S, k6, mip = 136, mode != "k3", mode == "k10b"
    if mip:
        field = MipNeRFField(net_depth=depth, net_width=32, multires=4, multires_views=2)
        odv, z = (torch.from_numpy(a) for a in _mip_inputs(depth, S))
    else:
        field = NeRFField(net_depth=depth, net_width=32, multires=4, multires_views=2,
                          use_semantics=sem, sem_with_coord=coord, sem_dim=2)
        odv, z = (torch.from_numpy(a) for a in _inputs(depth, S))
    fdesc = fr.pack_field(field)[1]
    rpc, _ = fr._wg_plan(fdesc, fr.pack_ring(field)[1], S)
    desc = fr.train_desc(field, fdesc, fr.pack_train_bwd(field)[1], S, sem=k6 and sem,
                         rays_per_chunk=rpc)
    assert desc.rays_per_chunk == rpc == 3
    with torch.no_grad():
        *_, slices, strip = _k4_model(field, odv, z, noise, 5, False, desc, sem_act=k6 and sem,
                                      mip=mip)
    nsub = -(-rpc * S // WG)
    stored = ([fr._P_EMB, fr._P_DEMB, fr._P_FEAT, fr._P_HV]
              + [fr._P_ACT0 + i for i in range(depth + (k6 and sem))])
    acts = {p: [] for p in stored}
    for ws, writes, nq in slices:
        want = torch.zeros_like(writes)
        for p in stored:
            rows, at = desc.rows[p], desc.plane[p]
            want[at:at + nsub * rows * fr._KLD].view(nsub, rows, fr._KLD)[:-(-nq // WG), :, :WG] = 1
            tiles = ws[at:at + nsub * rows * fr._KLD].view(nsub, rows, fr._KLD)[:, :, :WG]
            acts[p].append(tiles.permute(1, 0, 2).reshape(rows, -1)[:, :nq])
        assert torch.equal(writes, want)
    acts = {p: torch.cat(a, 1) for p, a in acts.items()}
    sems = fdesc.sem_dim
    fwd = dict(emb=acts[fr._P_EMB], demb=acts[fr._P_DEMB], feat=acts[fr._P_FEAT],
               hv=acts[fr._P_HV], acts=[acts[fr._P_ACT0 + i] for i in range(depth)],
               s_act=acts.get(fr._P_ACT0 + depth), sigma=strip[:, 0].view(R, S),
               logits=strip[:, 2:5].t().reshape(3, R, S),
               semv=strip[:, 5:5 + sems].t().reshape(sems, R, S) if sem else None)
    rng = np.random.default_rng(depth)
    kw = dict(noise_std=noise, seed=99)
    with torch.no_grad():
        if k6:
            dmaps = torch.from_numpy(rng.normal(size=(R, 5 + sems)).astype(np.float32))
            dw = torch.from_numpy(rng.normal(size=(R, S)).astype(np.float32))
            got, _, _ = _emulate_k3(field, odv, z, None, False, noise, 99, dmaps, dw, fwd=fwd,
                                    mip=mip)
    if mip:
        want = fr.mip_train_render_grads_plain(field, odv, z, dmaps, dw, **kw)
    elif k6:
        want = fr.train_render_grads_plain(field, odv, z, dmaps, dw, **kw)
    else:
        gt = torch.from_numpy(rng.uniform(0, 1, size=(R, 3)).astype(np.float32))
        with torch.no_grad():
            got, maps, w = _emulate_k3(field, odv, z, gt, False, noise, 99, fwd=fwd)
        want, maps_p, w_p = fr.rgb_train_grads_plain(field, odv, z, gt, white_bkgd=False, **kw)
        torch.testing.assert_close(maps, maps_p, atol=1e-5, rtol=0)
        torch.testing.assert_close(w, w_p, atol=1e-5, rtol=0)
    assert set(got) == set(want)
    for name, g in want.items():
        assert got[name].shape == g.shape, name
        err = float((got[name] - g).abs().max()) / (float(g.abs().max()) + 1e-9)
        assert err < 1e-5, (name, err)


def _jax_field_grads(depth, sem, dws, dbs):
    """The JAX field backward's (dW, db) in ``_flatten_mlp_params`` order ->
    the port's parameter names of one field."""
    names = [f"pts_linears_{i}" for i in range(depth)]
    names += ["alpha_linear", "feature_linear", "views_linears_0", "rgb_linear"]
    names += ["sem_0", "sem_1"] if sem else []
    tree = {"coarse": {"mlp": {n: {"kernel": np.asarray(w), "bias": np.asarray(b)}
                               for n, w, b in zip(names, dws, dbs)}}}
    return {k[len("nerf."):]: v for k, v in state_dict_from_jax_params(tree).items()}


def _pe_grads(x, gx):
    """``train_sweep.cuh`` pe_grads on feature-major rows: the stored x
    ``[3, P]`` and the PE's cotangent ``[rows, P]`` -> ``[P, 3]``, each
    phase rounded once an operation as the forward's PE rounds it."""
    out = gx[:3].clone()
    for b in range((gx.shape[0] - 3) // 6):
        for h in range(2):
            phase = x * 2.0 ** b + (float(np.float32(np.pi / 2)) if h else 0.0)
            out = out + (gx[3 + 6 * b + 3 * h:6 + 6 * b + 3 * h] * torch.cos(phase)) * 2.0 ** b
    return out.t()


N_BWD = 555  # two 512-point chunks: the second's one tile ragged, its second warpgroup past N
BWD_CASES = [  # (mode, depth, semantic head, its coordinates)
    ("k8c", 5, True, True), ("k8c", 4, True, False), ("k8f", 4, True, True),
    ("k8f", 3, False, False)]


@pytest.mark.parametrize("mode,depth,sem,coord", BWD_CASES)
def test_field_backward_forward_model_feeds_the_reverse_sweep(mode, depth, sem, coord):
    """K8c's and K8f's forward (``field_bwd_forward_kernel``) is the tile's
    store mode with the point-list input: the tile model on rows of points
    in 512-point chunks (555 points: the last chunk one ragged tile whose
    second warpgroup lies past N) writes every stored plane's float of its
    subs once, g's columns into the cotangent planes (zero past N and in
    the padding rows) and, for K8c, zeroes the point-PE cotangent plane;
    no output row. The planes, fed through ``_emulate_k3``'s reverse sweep
    with those cotangents (and for K8c the input-gradient matrices of
    ``pack_input_bwd`` and the PE's chain rule from the stored x), give
    ``field_grads_plain``'s gradients and the JAX package's
    ``_fused_backward`` (K8c, with dpts/ddirs) or ``_fused_backward_pl``
    (K8f), Pallas in interpret mode, each leaf to 1e-5 of its max."""
    from test_torch_train_render import _emulate_k3

    in_grad = mode == "k8c"
    jcfg, params, tnet = _nets(depth, sem, coord)
    field = tnet.nerf
    pts, dirs, _ = _field_rows(N_BWD, 7 * depth + sem)
    fdesc = fr.pack_field(field)[1]
    C = 4 + fdesc.sem_dim
    g = np.random.default_rng(depth).normal(size=(N_BWD, C)).astype(np.float32)
    tp, td, tg = (torch.from_numpy(a) for a in (pts, dirs, g))
    desc = fr.train_desc(field, fdesc, fr.pack_train_bwd(field)[1], 1, sem, input_grads=in_grad)
    assert desc.rays_per_chunk == 512
    with torch.no_grad():
        slices = _k4_model(field, None, None, 0.0, 0, False, desc, sem_act=sem,
                           points=(tp, td), per=4, g=tg, in_grad=in_grad)
    stored = ([fr._P_EMB, fr._P_DEMB, fr._P_FEAT, fr._P_HV]
              + [fr._P_ACT0 + i for i in range(depth + sem)])
    cots = [fr._P_DRGB, fr._P_DSIG] + ([fr._P_ACT0 + depth + 1] if sem else [])
    p_gemb = fr._P_ACT0 + depth + 3
    planes = {p: [] for p in stored + cots}
    assert [nq for *_, nq in slices] == [512, N_BWD - 512]
    for ws, writes, nq in slices:
        nsub = -(-nq // WG)
        want = torch.zeros_like(writes)
        for p in stored + cots:
            rows, at = desc.rows[p], desc.plane[p]
            want[at:at + nsub * rows * fr._KLD].view(nsub, rows, fr._KLD)[:, :, :WG] = 1
            tiles = ws[at:at + nsub * rows * fr._KLD].view(nsub, rows, fr._KLD)[:, :, :WG]
            planes[p].append(tiles.permute(1, 0, 2).reshape(rows, -1))
        if in_grad:
            want[desc.plane[p_gemb]:desc.plane[p_gemb] + nsub * desc.rows[p_gemb] * fr._KLD] = 1
            assert not ws[desc.plane[p_gemb]:desc.plane[p_gemb + 1]].any()
        assert torch.equal(writes, want)
        assert not torch.stack([planes[p][-1][:, nq:].abs().sum() for p in cots]).any()
    planes = {p: torch.cat([t[:, :512] for t in ts], 1)[:, :N_BWD] for p, ts in planes.items()}
    drgb, dsig = planes[fr._P_DRGB], planes[fr._P_DSIG]
    dsem = planes[fr._P_ACT0 + depth + 1] if sem else None
    assert torch.equal(drgb[:3], tg[:, :3].t()) and not drgb[3:].any()
    assert torch.equal(dsig[0], tg[:, 3]) and not dsig[1:].any()
    if sem:
        assert torch.equal(dsem[:2], tg[:, 4:].t()) and not dsem[2:].any()
    fwd = dict(emb=planes[fr._P_EMB], demb=planes[fr._P_DEMB], feat=planes[fr._P_FEAT],
               hv=planes[fr._P_HV], acts=[planes[fr._P_ACT0 + i] for i in range(depth)],
               s_act=planes.get(fr._P_ACT0 + depth))
    dys = {}
    with torch.no_grad():
        got, maps, w = _emulate_k3(field, None, None, None, False, 0.0, 0, fwd=fwd,
                                   cot=(drgb, dsig, dsem), dys=dys)
    assert maps is None and w is None
    want, dp, dd = ff.field_grads_plain(field, tp, td, tg, input_grads=in_grad)
    if in_grad:  # the reverse sweep's input-gradient products, then the PE's chain rule
        ibuf, ibwd = ff.pack_input_bwd(field)

        def product(i, dy):
            L = ibwd[i]
            m = ibuf[L.w:L.w + L.k * fr._pad8(L.n)].view(L.k, fr._pad8(L.n))
            assert dy.shape[0] == L.k
            return m[:, :L.n].t() @ dy

        gemb = 0
        for i in ff.input_ring_layers(field):
            if i == depth + 2:
                continue
            dy = torch.cat([dys[depth + 1], dys[depth]]) if i == depth else dys[i]
            gemb = gemb + product(i, dy)
        gdemb = product(depth + 2, dys[depth + 2])
        got["dpts"] = _pe_grads(fwd["emb"][:3], gemb)
        got["ddirs"] = _pe_grads(fwd["demb"][:3], gdemb)
        want = {**want, "dpts": dp, "ddirs": dd}
    ws_j, bs_j = jff._flatten_mlp_params(params["coarse"]["mlp"], depth, sem)
    args = (depth, (4,), jcfg.multires, jcfg.multires_views, sem, coord, "float32")
    if in_grad:
        dws, dbs, (jdp, jdd) = jff._fused_backward(tuple(ws_j), tuple(bs_j),
                                                   (jnp.asarray(pts), jnp.asarray(dirs)),
                                                   jnp.asarray(g), *args, block=128,
                                                   interpret=True)
        jax_want = {**_jax_field_grads(depth, sem, dws, dbs),
                    "dpts": torch.from_numpy(np.array(jdp)),
                    "ddirs": torch.from_numpy(np.array(jdd))}
    else:
        pd = jnp.asarray(np.concatenate([pts.T, dirs.T], 0))
        dws, dbs = jff._fused_backward_pl(tuple(ws_j), tuple(bs_j), pd, jnp.asarray(g.T), *args,
                                          block=128, interpret=True)
        jax_want = _jax_field_grads(depth, sem, dws, dbs)
    assert set(got) == set(want) == set(jax_want)
    for ref in (want, jax_want):
        for name, r in ref.items():
            assert got[name].shape == r.shape, name
            err = float((got[name] - r).abs().max()) / (float(r.abs().max()) + 1e-12)
            assert err <= 1e-5, (name, err)


def _field_rows(n, seed):
    """``n`` points in [-2, 2]^3, unit directions and small diagonal
    covariances ``[n, 3]`` (float32 numpy)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-2, 2, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    dirs = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    cov = rng.uniform(0, 0.02, size=(n, 3)).astype(np.float32)
    return pts, dirs, cov


N_LIST = 300  # 2 tiles and 44 points: the last tile's second warpgroup lies past N
LIST_CASES = [  # (kernel, depth, semantic head, its coordinates, tiles a CTA)
    ("k8b", 5, True, True, 2), ("k8b", 4, True, False, 1), ("k8b", 5, False, False, 1),
    ("k8a", 5, True, True, 2), ("k11", 5, False, False, 2), ("k11", 4, False, False, 1)]


@pytest.mark.parametrize("kernel,depth,sem,coord,per", LIST_CASES)
def test_field_forwards_are_the_tile_in_point_list_mode(kernel, depth, sem, coord, per):
    """The field forwards (K8b/K8d, K8a/K8e, K11) run K4's tile in its
    point-list modes: the tile model on rows of points (a CTA ``per``
    tiles, 300 points: the last tile's second warpgroup wholly past N;
    sigma straight to its column, the other heads through the tile's strip
    and the warpgroups' copy-out, each output float written once) against
    the plain versions and the JAX package's field kernels (Pallas,
    interpret mode), the fields' weights bridged from JAX, at 1e-5."""
    pts, dirs, cov = _field_rows(N_LIST, 11 * depth + per)
    tp, td, tc = (torch.from_numpy(a) for a in (pts, dirs, cov))
    if kernel == "k11":
        jcfg, params, tnet = _mip_nets(depth)
        field = tnet.mip
        with torch.no_grad():
            got = _k4_model(field, None, None, 0.0, 0, False, mip=True, points=(tp, tc, td),
                            per=per)
            want = ff.mip_field_plain(field, tp, tc, td)
        pd = jnp.asarray(np.concatenate([pts.T, cov.T, dirs.T], 0))
        jax_out = np.asarray(jff.fused_mip_apply_planar(params["mip"], pd, jcfg)).T
    else:
        jcfg, params, tnet = _nets(depth, sem, coord)
        field = tnet.nerf
        with torch.no_grad():
            if kernel == "k8a":
                got = _k4_model(field, None, None, 0.0, 0, False, sigma_only=True, points=(tp,),
                                per=per)
                want = ff.sigma_plain(field, tp)
            else:
                got = _k4_model(field, None, None, 0.0, 0, False, points=(tp, td), per=per)
                want = ff.field_plain(field, tp, td)
        if kernel == "k8a":
            jax_out = np.asarray(jff.fused_sigma_apply(params["coarse"], jnp.asarray(pts),
                                                       jcfg, depth=depth))[:, 0]
        else:
            jax_out = np.asarray(jff.fused_field_apply(params["coarse"], jnp.asarray(pts)[:, None],
                                                       jnp.asarray(dirs), jcfg,
                                                       depth=depth))[:, 0]
    assert got.shape == want.shape == jax_out.shape
    assert got.shape == ((N_LIST,) if kernel == "k8a" else (N_LIST, 4 + 2 * sem))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), jax_out, atol=1e-5, rtol=0)


def test_field_grads_launches_with_the_forward_ring(monkeypatch):
    """On the card field_grads (K8f, and K8c with ``input_grads``) calls the
    library's ``nerf_field_grads`` once a call with ``pack_ring``'s buffer
    and ``_field_ring``'s stages for its forward (K4's tile in its storing
    point-list mode) beside the reverse sweep's rings, and counts the
    launch (here on a library that records the calls)."""
    torch.manual_seed(6)
    field = NeRFField(net_depth=4, net_width=32, multires=4, multires_views=2,
                      use_semantics=True, sem_with_coord=True, sem_dim=2)
    pts, dirs, _ = (torch.from_numpy(a) for a in _field_rows(N_LIST, 5))
    g = torch.ones(N_LIST, 6)
    calls = []

    class Lib:
        def __getattr__(self, name):
            return lambda *a: calls.append((name, a)) or 0

    props = type("Props", (), {"multi_processor_count": 132})()
    monkeypatch.setattr(ff, "_on_card", lambda t: True)
    monkeypatch.setattr(fr._build, "library", Lib)
    monkeypatch.setattr(fr._build, "stream", lambda device: None)
    monkeypatch.setattr(fr.torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(fr.torch.cuda, "get_device_properties", lambda device: props)
    cpu = torch.device("cpu")
    buf, fdesc = fr._packed(field, cpu)
    rbuf, ring = fr._ring(field, cpu)
    bring, brd = fr._bwd_ring(field, cpu)
    counts = ff.field_grads.launches, ff.field_grads.input_grad_launches
    for input_grads in (False, True):
        grads, dp, dd = ff.field_grads(field, pts, dirs, g, input_grads=input_grads)
        (name, a), = calls[-1:]
        assert name == "nerf_field_grads" and set(grads) == {n for n, _ in
                                                           field.named_parameters()}
        assert a[:6] == (pts.data_ptr(), dirs.data_ptr(), g.data_ptr(), buf.data_ptr(),
                         rbuf.data_ptr(), bring.data_ptr())
        assert torch.equal(rbuf, fr.pack_ring(field)[0])
        rd = ff._field_ring(fdesc, ring, True)
        assert bytes(a[8]._obj) == bytes(rd) and rd.stages == 4 and ring.stages == 0
        assert bytes(a[9]._obj) == bytes(brd) and a[7]._obj.rays_per_chunk == 512
        assert (a[6] is not None, a[14] is not None) == (input_grads, input_grads)
        assert (dp is not None) == input_grads and a[14] == (dp.data_ptr() if input_grads
                                                             else None)
        assert a[16:] == (N_LIST, 1, 1, None)
    assert (ff.field_grads.launches, ff.field_grads.input_grad_launches) == (
        counts[0] + 2, counts[1] + 1)


@pytest.mark.parametrize("sem,mip", [(True, False), (False, False), (False, True)])
def test_field_plan_takes_three_ring_stages_at_the_flagship(sem, mip):
    """``_field_plan`` at the flagship widths (8 x 256, multires 10/4; the
    semantic head with coordinates, sem_dim 2; the mip field): three ring
    stages beside the tiles and the compact strip (3 + sem floats a point)
    within the shared memory, for the field forward and the sigma forward,
    and one wave of runs of consecutive tiles (2^18 points on 132 SMs: 16
    tiles a CTA, 128 CTAs; 1024 x 64: 4; 32768 x 64: 125)."""
    torch.manual_seed(0)
    if mip:
        field = MipNeRFField(net_depth=8, net_width=256, multires=10, multires_views=4)
    else:
        field = NeRFField(net_depth=8, net_width=256, multires=10, multires_views=4,
                          use_semantics=sem, sem_with_coord=sem, sem_dim=2)
    fdesc = fr.pack_field(field)[1]
    ring = fr.pack_ring(field)[1]
    for heads in (True, False):
        for n, want in ((1 << 18, 16), (1024 * 64, 4), (32768 * 64, 125), (300, 1), (1, 1)):
            per, rd = ff._field_plan(fdesc, ring, n, 132, heads)
            assert per == want and rd.stages == 3, (n, heads, per, rd.stages)
            assert ff._field_smem(fdesc, rd, heads) <= fr._MAX_SMEM
            assert -(-n // (128 * per)) <= 132
    assert ring.stages == 0  # the cached descriptor is not touched


def test_field_and_k10b_wrappers_launch_the_tile_with_a_ring(monkeypatch):
    """On CUDA tensors fused_sigma_apply, field_forward and
    fused_mip_field_apply launch K4's tile in its point-list modes through
    ``_field_launch`` (no plain fallback) and count the launch, and
    mip_train_render_grads launches K10b through ``_mip_grads_launch``;
    those call the library's ``nerf_field_sigma``, ``nerf_field``,
    ``nerf_mip_field`` and ``nerf_mip_train_render_grads`` once each with
    ``pack_ring``'s buffer, ``_field_plan``'s tiles a CTA and ring stages
    (``_wg_plan``'s chunk and stages for K10b) and their inputs (here on
    a library that records the calls)."""
    torch.manual_seed(4)
    field = NeRFField(net_depth=4, net_width=32, multires=4, multires_views=2,
                      use_semantics=True, sem_with_coord=True, sem_dim=2)
    mfield = MipNeRFField(net_depth=5, net_width=32, multires=4, multires_views=2)
    pts, dirs, cov = (torch.from_numpy(a) for a in _field_rows(N_LIST, 3))
    odvr, z = (torch.from_numpy(a) for a in _mip_inputs(3, 63))
    dmaps, dw = torch.ones(R, 5), torch.ones(R, 63)
    seen = []
    monkeypatch.setattr(ff, "_check_points", lambda *a, **k: None)
    monkeypatch.setattr(fr, "_check_inputs", lambda *a, **k: None)
    monkeypatch.setattr(ff, "_field_launch", lambda f, name, out, heads, *ins, bf16=False,
                        f32_heads=None: seen.append((f, name, tuple(out.shape), heads, ins, bf16,
                                                     f32_heads)))
    monkeypatch.setattr(fr, "_mip_grads_launch", lambda *a: seen.append(a) or (torch.zeros(
        fr.grad_layout(mfield)[1]), None))
    card = [t.as_subclass(_OnCard) for t in (pts, dirs, cov, odvr, z, dmaps, dw)]
    counts = (ff.fused_sigma_apply.launches, ff.field_forward.launches,
              ff.fused_mip_field_apply.launches, fr.mip_train_render_grads.launches)
    monkeypatch.setattr(torch, "empty", lambda shape, **kw: torch.zeros(shape))
    ff.fused_sigma_apply(field, card[0])
    ff.field_forward(field, card[0], card[1])
    ff.fused_mip_field_apply(mfield, card[0], card[2], card[1])
    fr.mip_train_render_grads(mfield, *card[3:], noise_std=1.0, seed=5)
    assert (ff.fused_sigma_apply.launches, ff.field_forward.launches,
            ff.fused_mip_field_apply.launches, fr.mip_train_render_grads.launches) == tuple(
                c + 1 for c in counts)
    assert [s[1:4] for s in seen[:3]] == [("nerf_field_sigma", (N_LIST,), False),
                                          ("nerf_field", (N_LIST, 6), True),
                                          ("nerf_mip_field", (N_LIST, 4), True)]
    assert [len(s[4]) for s in seen[:3]] == [1, 2, 3] and seen[3][0] is mfield
    assert seen[2][5] is False  # fp32: K11's tile in its fp32 mode
    assert seen[0][5:] == (False, None) and seen[1][5:] == (False, False)  # K8a, K8b/K8d fp32
    assert seen[3][1] is card[3] and seen[3][2] is card[4] and seen[3][5:] == (1.0, 5, False)
    monkeypatch.undo()

    calls = []

    class Lib:
        def __getattr__(self, name):
            return lambda *a: calls.append((name, a)) or 0

    props = type("Props", (), {"multi_processor_count": 132})()
    monkeypatch.setattr(fr._build, "library", Lib)
    monkeypatch.setattr(fr._build, "stream", lambda device: None)
    monkeypatch.setattr(fr.torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(fr.torch.cuda, "get_device_properties", lambda device: props)
    for f, name, C, heads, ins in ((field, "nerf_field_sigma", 1, False, (pts,)),
                                   (field, "nerf_field", 6, True, (pts, dirs)),
                                   (mfield, "nerf_mip_field", 4, True, (pts, cov, dirs))):
        out = torch.empty((N_LIST, C) if C > 1 else (N_LIST,))
        ff._field_launch(f, name, out, heads, *ins)
        (got, a), = calls[-1:]
        buf, fdesc = fr._packed(f, pts.device)
        rbuf, ring = fr._ring(f, pts.device)
        per, rd = ff._field_plan(fdesc, ring, N_LIST, 132, heads)
        assert got == name and torch.equal(rbuf, fr.pack_ring(f)[0]) and per == 1
        k = len(ins)
        assert a[:k] == tuple(t.data_ptr() for t in ins)
        assert a[k:k + 2] == (buf.data_ptr(), rbuf.data_ptr())
        assert a[k + 2]._obj.f.emb_dim == fdesc.emb_dim and bytes(a[k + 3]._obj) == bytes(rd)
        assert rd.stages == 4 and a[k + 4:] == (out.data_ptr(), N_LIST, per, None)
    flat, _ = fr._mip_grads_launch(mfield, odvr, z, dmaps, dw, 1.0, 5)
    (got, a), = calls[-1:]
    buf, fdesc = fr._packed(mfield, odvr.device)
    rbuf, ring = fr._ring(mfield, odvr.device)
    rpc, rd = fr._wg_plan(fdesc, ring, 63)
    bring, brd = fr._bwd_ring(mfield, odvr.device)
    assert got == "nerf_mip_train_render_grads" and rpc == 8
    assert a[:7] == (odvr.data_ptr(), z.data_ptr(), dmaps.data_ptr(), dw.data_ptr(),
                     buf.data_ptr(), rbuf.data_ptr(), bring.data_ptr())
    desc = a[7]._obj
    assert desc.rays_per_chunk == rpc and bytes(a[8]._obj) == bytes(rd) and rd.stages >= 2
    assert bytes(a[9]._obj) == bytes(brd) and a[12] == flat.data_ptr()
    assert a[13:15] == (R, 63) and a[17:] == (fr.noise_seed(5), 1.0, None)
    with pytest.raises(NotImplementedError):  # no kernel and no plain fallback off the card
        ff.field_forward(field, pts.to("meta"), dirs.to("meta"))
    with pytest.raises(NotImplementedError):
        fr.mip_train_render_grads(mfield, odvr.to("meta"), z.to("meta"), dmaps, dw,
                                  noise_std=1.0, seed=5)


def test_field_forward_counts_each_bf16_head_rule_apart(monkeypatch):
    """On CUDA tensors at bf16 the field forward launches its bf16 mode
    with the head rule it is given, and counts K8b's rule (f32_heads) in
    ``launches_bf16_f32_heads`` and K8d's in ``launches_bf16``, each alone;
    the sigma forward's bf16 launch goes to its own ``launches_bf16``."""
    field = NeRFField(net_depth=4, net_width=32, multires=4, multires_views=2,
                      use_semantics=True, sem_with_coord=True, sem_dim=2)
    pts, dirs = (torch.from_numpy(a).as_subclass(_OnCard) for a in _field_rows(N_LIST, 3)[:2])
    seen = []
    monkeypatch.setattr(ff, "_check_points", lambda *a, **k: None)
    monkeypatch.setattr(ff, "_field_launch", lambda f, name, out, heads, *ins, bf16=False,
                        f32_heads=None: seen.append((name, bf16, f32_heads)))
    monkeypatch.setattr(torch, "empty", lambda shape, **kw: torch.zeros(shape))
    fwd, sig = ff.field_forward, ff.fused_sigma_apply

    def counts():
        return (fwd.launches, fwd.launches_bf16, fwd.launches_bf16_f32_heads, sig.launches,
                sig.launches_bf16)

    before = counts()
    ff.field_forward(field, pts, dirs, torch.bfloat16, f32_heads=True)
    assert [a - b for a, b in zip(counts(), before)] == [0, 0, 1, 0, 0]
    ff.field_forward(field, pts, dirs, torch.bfloat16)
    ff.field_forward(field, pts, dirs, torch.float32, f32_heads=True)  # fp32: one rule
    ff.fused_sigma_apply(field, pts, torch.bfloat16)
    assert [a - b for a, b in zip(counts(), before)] == [1, 1, 1, 0, 1]
    assert seen == [("nerf_field", True, True), ("nerf_field", True, False),
                    ("nerf_field", False, False), ("nerf_field_sigma", True, None)]


# ----------------------------------------------------------------- the bf16 mode


def _desc_lbo_sbo():
    """The LBO and SBO (bytes) that ``csrc/wgmma.cuh`` b_desc encodes for every
    B operand: the two k halves' and the 8-output groups' distances."""
    src = open(os.path.join(_build.CSRC_DIR, "wgmma.cuh")).read()
    body = src[src.index("uint64_t b_desc("):]
    lbo, sbo = map(int, re.findall(r"\((\d+) >> 4\)", body[:body.index("}")]))
    return lbo, sbo


def _bf16_slices(words, n):
    """The bf16 k16 slices in ``words`` (float32 words, two bf16 each) read
    through the K-major no-swizzle addressing of a wgmma B operand at the
    descriptor's LBO and SBO (core matrices of 8 outputs x 16 B):
    ``[slices, 16 k positions, n]`` in float32."""
    lbo, sbo = _desc_lbo_sbo()
    b16 = words.view(torch.bfloat16).to(torch.float32).view(-1, 16 * n)
    q, col = torch.meshgrid(torch.arange(16), torch.arange(n), indexing="ij")
    return b16[:, ((col // 8) * sbo + (q // 8) * lbo + (col % 8) * 16 + (q % 8) * 2) // 2]


def _ring_bf16_wt(wt):
    """One layer's padded ``W^T [kpad, N]`` (N the wgmma width) in
    pack_ring's bf16 layout, cut slice by slice: its k16 slices as float32
    words (the reference the ring's gather is held to)."""
    k16, n = -(-wt.shape[0] // 16) * 16, wt.shape[1]
    w = wt.new_zeros((k16, n))
    w[:wt.shape[0]] = wt
    blk = (w.view(k16 // 16, 16, n)[:, fr.bf16_k_rows(), :].view(k16 // 16, 2, 8, n // 8, 8)
           .permute(0, 3, 1, 4, 2))  # [s, j, h, r, c]
    return blk.reshape(-1).to(torch.bfloat16).view(torch.float32)


def _bf16_ring_layer(ring, rd, fdesc, i):
    n, k16 = rd.ncols[i], -(-fdesc.layer[i].k // 16)
    return _bf16_slices(ring[rd.off[i]:rd.off[i] + k16 * 8 * n], n)


@pytest.mark.parametrize("depth,sem,coord,width", [(4, True, True, 32), (5, True, False, 16),
                                                   (8, True, True, 256), (6, False, False, 64)])
def test_bf16_ring_reads_back_through_the_descriptor(depth, sem, coord, width):
    """pack_ring's bf16 layout (K1, K2 and K4 at bf16): each layer's k16
    slices, read through the B operand's core matrices at b_desc's LBO/SBO
    with k position q holding row bf16_k_rows()[q] of its 16, are the
    layer's W^T rounded to bf16, its padding rows and columns zero; the
    descriptor's offsets and stage size count float32 words (a slice is
    16 x N bf16, 8 N words: ring_producer's 32 N bytes), and the plan fits."""
    torch.manual_seed(depth + width)
    field = NeRFField(net_depth=depth, net_width=width, multires=10 if width == 256 else 4,
                      multires_views=4 if width == 256 else 2, use_semantics=sem,
                      sem_with_coord=coord, sem_dim=2)
    _, fdesc = fr.pack_field(field)
    ring, rd = fr.pack_ring(field, bf16=True)
    assert ring.dtype == torch.float32
    rows = fr.bf16_k_rows()
    assert sorted(rows.tolist()) == list(range(16))
    off = 0
    for i in fr.ring_layers(field):
        lin, segs = fr._field_layers(field)[i]
        n = rd.ncols[i]
        assert rd.off[i] == off and n == fr._ring_n(lin.out_features)
        k16 = -(-fdesc.layer[i].k // 16)
        off += k16 * 8 * n
        b = _bf16_ring_layer(ring, rd, fdesc, i)  # [s, q, n]
        wt = torch.zeros(16 * k16, n)
        wt[rows[None, :] + 16 * torch.arange(k16)[:, None]] = b
        want, r, rp = torch.zeros(16 * k16, n), 0, 0
        for k in segs:
            want[rp:rp + k, :lin.out_features] = lin.weight.detach().t()[r:r + k]
            r, rp = r + k, rp + fr._pad8(k)
        assert torch.equal(wt, want.to(torch.bfloat16).to(torch.float32)), i
        padded = torch.zeros(fdesc.layer[i].k, n)
        padded[:, :fr._pad8(lin.out_features)] = fr._padded_wt(lin, segs)[0]
        assert torch.equal(ring[rd.off[i]:off], _ring_bf16_wt(padded)), i  # the gather's cut
    assert off == ring.numel()
    assert rd.stage_floats == 8 * max(rd.ncols[i] for i in fr.ring_layers(field))
    for S in (64, 192):
        rpc, rds = fr._wg_plan(fdesc, rd, S)
        assert 2 <= rds.stages <= 4 and fr._wg_smem(fdesc, rds, rpc, S) <= fr._MAX_SMEM


@pytest.mark.parametrize("width,segs", [(32, [32, 32]), (16, [27, 16]), (64, [40])])
def test_bf16_k_step_model_is_the_bf16_product(width, segs):
    """wg_layer's bf16 k step modelled per thread: for 8-row steps 2 ks + h
    a thread loads rows t and t + 4 of points m0 and m0 + 8 as in fp32 mode,
    and bf16x2 puts row t in the lower half (k position 2 t + 8 h) and row
    t + 4 in the upper (2 t + 1 + 8 h); with B read from the bf16 ring
    through the descriptor, the summed wgmma products are the product of the
    bf16-rounded inputs and W^T in float32 (models/mlp.bf16_operands_dense
    without the bias), a k16 step past the segments' last 8 rows reading
    zeros."""
    torch.manual_seed(width)
    K = sum(segs)
    lin = torch.nn.Linear(K, width)
    x = torch.randn(64, K) * 3.0
    # the segments' rows, each padded to 8 (the tile's emb/h rows), then to 16
    kpad = sum(fr._pad8(k) for k in segs)
    xs = torch.zeros(64, -(-kpad // 16) * 16)
    wt, r, rp = torch.zeros(xs.shape[1], width), 0, 0
    for k in segs:
        xs[:, rp:rp + k] = x[:, r:r + k]
        wt[rp:rp + k] = lin.weight.detach().t()[r:r + k]
        r, rp = r + k, rp + fr._pad8(k)
    b16 = _bf16_slices(_ring_bf16_wt(wt), fr._ring_n(width))[:, :, :width]
    acc = torch.zeros(64, width)
    for ks in range(xs.shape[1] // 16):
        a = torch.zeros(64, 16)
        for h, t, e in itertools.product(range(2), range(4), range(2)):
            row = 8 * (2 * ks + h) + t + 4 * e  # the fp32 load of 8-row step 2 ks + h
            a[:, 2 * t + e + 8 * h] = xs[:, row] if row < kpad else 0.0
        acc += round_bf16(a) @ b16[ks]
    want = round_bf16(x) @ round_bf16(lin.weight.detach()).t()
    assert float((acc - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_pack_frozen_bf16_reads_back_w0():
    """pack_frozen's bf16 ring: each rank's k16 slices read through the B
    operand's core matrices at b_desc's LBO/SBO (wgmma.cuh b_offset_bf16)
    are W0^T rounded to bf16 (k position q: row 16 s + q), zero-padded; the
    descriptor counts k16 slices (C padded to 64) and sets bf16; the plan
    fits in less shared memory than fp32's (half-size tiles and stages)."""
    torch.manual_seed(2)
    field = NeRFField(net_depth=8, net_width=256, multires=10, multires_views=4,
                      use_semantics=True, sem_with_coord=True, sem_dim=2)
    lin0 = field.mlp.semantic_linear[0]
    C, hidden, cols = lin0.in_features, lin0.out_features, fr._SEM_COLS
    buf, d = fr.pack_frozen(field, bf16=True)
    assert (d.bf16, d.C, d.kslices) == (1, 319, 20)
    want = torch.zeros(16 * d.kslices, fr._SEM_RANKS * cols)
    want[:C, :hidden] = round_bf16(lin0.weight.detach().t())
    per = d.kslices * 8 * cols  # words a rank
    for rank in range(fr._SEM_RANKS):
        b = _bf16_slices(buf[rank * per:(rank + 1) * per], cols)  # [s, q, n]
        assert torch.equal(b.reshape(-1, cols), want[:, cols * rank:cols * (rank + 1)]), rank
    assert d.b0 == fr._SEM_RANKS * per and torch.equal(buf[d.b0:d.w1], lin0.bias.detach())
    plan = fr._frozen_plan(d)
    f32 = fr._frozen_plan(fr.pack_frozen(field)[1])
    assert fr._frozen_smem(plan) <= fr._MAX_SMEM and fr._frozen_smem(plan) < fr._frozen_smem(f32)


def _emulate_k5_bf16(field, sem_in, w, dmaps):
    """K5's bf16 mode in its dataflow, from pack_frozen's bf16 buffer alone:
    per cluster rank and 64-point tile, F's product with A = the tile's bf16
    rows in its point order (k position q of k16 slice s: column 16 s + q)
    and B = the ring's slices through the descriptor; s_act, d_sem_c and ds
    rounded to bf16 as frozen_sem_kernel's epilogue does, ds written into
    dW0's B buffer (point p at k position p % 16 of slice p // 16,
    b_offset_bf16) and read back through the descriptor by D against
    xt_fragment_bf16's X^T (points 16 kk + q); the small sums."""
    buf, d = fr.pack_frozen(field, bf16=True)
    P, C = sem_in.shape
    S, sem, hidden, cols = w.shape[1], d.sem_dim, d.hidden, fr._SEM_COLS
    b0 = buf[d.b0:d.b0 + hidden]
    w1 = round_bf16(buf[d.w1:d.w1 + sem * hidden].view(sem, hidden))
    m = torch.arange(64)
    pi = 4 * (m % 8) + m // 16 + 32 * ((m % 16) // 8)  # F: accumulator row m -> point
    k, n = torch.meshgrid(torch.arange(16), torch.arange(cols), indexing="ij")
    boff = (n // 8) * 128 + (k // 8) * 64 + (n % 8) * 8 + k % 8  # b_offset_bf16
    flat = torch.zeros(d.grad_size)
    dw0 = flat[d.gw0:d.gb0].view(C, hidden)
    dw1 = flat[d.gw1:d.gb1].view(hidden, sem)
    per = d.kslices * 8 * cols
    for rank in range(fr._SEM_RANKS):
        n0 = cols * rank
        nb = min(cols, hidden - n0)
        if nb <= 0:
            continue
        wring = _bf16_slices(buf[rank * per:(rank + 1) * per], cols)  # [s, q, n]
        acc0 = torch.zeros(16 * d.kslices, cols)
        for q0 in range(0, P, 64):
            np_ = min(64, P - q0)
            x = torch.zeros(64, 16 * d.kslices)
            x[:np_, :C] = sem_in[q0:q0 + np_].to(torch.float32)
            s_pre = sum(x[pi][:, 16 * s:16 * s + 16] @ wring[s] for s in range(d.kslices))
            s_pre[:, :nb] += b0[n0:n0 + nb]
            s_act = round_bf16(torch.relu(s_pre))
            q = (q0 + pi).clamp(max=P - 1)
            dsem = torch.where((pi < np_)[:, None], dmaps[q // S, 5:] * w.reshape(-1)[q, None],
                               0.0)
            dc = round_bf16(dsem)
            w1b = torch.zeros(sem, cols)
            w1b[:, :nb] = w1[:, n0:n0 + nb]
            ds = round_bf16(torch.where(s_act > 0, dc @ w1b, 0.0))  # [row, output]
            dsbuf = torch.zeros(4, 512)
            dsbuf[(pi // 16)[:, None], ((n[0] // 8) * 128 + ((pi % 16) // 8)[:, None] * 64
                                        + (n[0] % 8) * 8 + (pi % 8)[:, None])] = ds
            for kk in range(4):
                acc0 += x[16 * kk:16 * kk + 16].t() @ dsbuf[kk][boff]
            dw1[n0:n0 + nb] += (s_act.t() @ dc)[:nb]
            flat[d.gb0 + n0:d.gb0 + n0 + nb] += ds.sum(0)[:nb]
            if rank == 0:
                flat[d.gb1:d.grad_size] += dsem.sum(0)
        dw0[:, n0:n0 + nb] = acc0[:C, :nb]
    return fr.unpack_frozen(field, flat, d)


@pytest.mark.parametrize("depth,coord,width", [(5, True, 16), (8, True, 64), (6, False, 32)])
def test_k5_bf16_dataflow_matches_plain(depth, coord, width):
    """_emulate_k5_bf16 (the bf16 ring, the tiles' point orders, ds in the
    bf16 B layout, the gradient layout) reproduces frozen_sem_grads_plain at
    bf16 to float32 summation order (1e-5 of each leaf's max)."""
    torch.manual_seed(depth)
    field = NeRFField(net_depth=depth, net_width=width, multires=4, multires_views=2,
                      use_semantics=True, sem_with_coord=coord, sem_dim=3)
    odv, z = (torch.from_numpy(a) for a in _inputs(2, 8))
    _, w, sem_in = fr.train_render_plain(field, odv, z, noise_std=0.0, seed=0, save_semin=True,
                                         compute_dtype=torch.bfloat16)
    dmaps = torch.randn(R, 8)
    got = _emulate_k5_bf16(field, sem_in, w, dmaps)
    want = fr.frozen_sem_grads_plain(field, sem_in, w, dmaps, torch.bfloat16)
    for k in want:
        assert got[k].shape == want[k].shape, k
        scale = float(want[k].abs().max()) + 1e-12
        assert float((got[k] - want[k]).abs().max()) <= 1e-5 * scale, k
