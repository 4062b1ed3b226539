"""``--compute_dtype bfloat16`` for the RGB pretrain (K3) and the full SOS
finetune (K6) on the CPU: the bf16 plain versions of K3 and K6 against the
JAX Pallas kernel ``_train_render_bwd_kernel`` at bf16 (interpret mode), a
model of the bf16 CUDA kernels' dataflow (``pack_bwd_ring``'s bf16 layout
read through the B descriptor, the storing forward's bf16 planes, the
reverse sweep's k16 steps, roundings and gradient layout) against the plain
versions, one fused bf16 RGB step and one full bf16 SOS step against the JAX
steps, and ``run_nerf.main`` at bf16 through an RGB pretrain and a full
finetune from its checkpoint.

The plain versions and the Pallas kernel round the same operands to bf16 and
sum in float32 in other orders, so they differ by float32 summation order
(measured <= 3.7e-7 of a leaf's max here), but for a ray where an
activation lay within that rounding of a bf16 rounding boundary and rounded
the other way (a flip). A flip shows in the ray's maps and weights and moves
the leaves by up to 2% of their max at these sizes (20 rays: a ray is 5% of
the sum), so each call may have one flipped row (maps or weights beyond
KERNEL_TOL, test_torch_bf16.py's bound, within FLIP_ROW_TOL), and its leaves
are held on the call's other rays: rays are independent in every gradient
sum, so both sides are called again without the flipped ray. The float32
plain version misses each bound (its leaves lie 6e-4 to 0.3 of their max
from the bf16 kernel's here). The CUDA kernels' bf16 modes run on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from nerfsos_torch import run_nerf
from nerfsos_torch.data.synthetic import write_sphere_scene
from nerfsos_torch.engines import checkpoint as tckpt
from nerfsos_torch.engines import sos as tsos
from nerfsos_torch.engines import state as tstate
from nerfsos_torch.engines import trainer as ttrainer
from nerfsos_torch.losses import correlation as tcorr
from nerfsos_torch.models.mlp import round_bf16
from nerfsos_torch.models.nerf import NeRFConfig as TorchConfig
from nerfsos_torch.models.nerf import NeRFNet as TorchNet
from nerfsos_torch.ops import fused_render as tfr
from nerfsos_tpu.engines import sos as jsos
from nerfsos_tpu.engines import state as jstate
from nerfsos_tpu.engines import trainer as jtrainer
from nerfsos_tpu.losses import correlation as jcorr
from nerfsos_tpu.models.nerf import NeRFConfig as JaxConfig
from nerfsos_tpu.models.nerf import NeRFNet as JaxNet
from nerfsos_tpu.ops.pallas import fused_render as jfr
from test_torch_bf16 import (KERNEL_TOL, R, TINY, _inputs, _jax_params, _jax_seed, _np, _vits,
                             patch_scene)  # noqa: F401 (patch_scene: a fixture)
from test_torch_k4_tile import _bf16_slices
from test_torch_train_render import _emulate_k3, _layer, _pad_rows

BF16 = torch.bfloat16
# The one flipped row a call may have: within FLIP_ROW_TOL of the other side
# (the largest flip measured here moved a white-background ray's maps by
# 1.4e-3; test_torch_bf16.py's FLIP_TOL, 1e-3, was set on K1/K2/K4's maps)
FLIP_ROW_TOL = 5e-3
# A leaf's largest |plain - Pallas| over its largest |Pallas|, on a call's
# rays without a flip: float32 summation order alone (measured <= 3.7e-7)
LEAF_TOL = 1e-5


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


@pytest.fixture(autouse=True)
def small_pallas_block(monkeypatch):
    """8 rays a Pallas grid step keeps interpret mode fast."""
    monkeypatch.setattr(jfr, "TRAIN_RAY_BLOCK", 8)


def _nets(**over):
    kw = {**TINY, **over}
    jcfg = JaxConfig(**kw, fused_field=True, compute_dtype="bfloat16")
    params = _jax_params(JaxNet(jcfg), 2)
    tnet = TorchNet(TorchConfig(**kw, fused_field=True, compute_dtype="bfloat16"))
    tnet.load_state_dict(tckpt.state_dict_from_jax_params(_np(params)))
    return jcfg, params, tnet


def _jax_grads(g):
    """JAX's ``{'mlp': ...}`` gradients -> torch names of one field."""
    return {k[len("nerf."):]: v for k, v in tckpt.state_dict_from_jax_params(
        {"coarse": _np(g)}).items()}


def _flipped(got, want):
    """Rows of ``got`` beyond KERNEL_TOL of ``want``: at most one, within
    FLIP_ROW_TOL (a bf16 rounding flip)."""
    err = np.abs(np.asarray(got, np.float32).reshape(len(want), -1)
                 - np.asarray(want, np.float32).reshape(len(want), -1)).max(1)
    rows = np.flatnonzero(err > KERNEL_TOL)
    assert len(rows) <= 1 and err.max() <= FLIP_ROW_TOL, err
    return rows


def _leaf_reading(got, want):
    """The worst leaf's largest |got - want| over LEAF_TOL of its max |want|."""
    worst = 0.0
    for name, ref in want.items():
        ref = np.asarray(ref)
        scale = np.abs(ref).max()
        if scale == 0:  # a leaf no cotangent reaches (K3's semantic head): exactly 0
            assert not np.asarray(got[name]).any(), name
            continue
        worst = max(worst, float(np.abs(np.asarray(got[name]) - ref).max() / scale) / LEAF_TOL)
    return worst


# ----------------------------------------------------------------- K3 and K6 against Pallas

K3_CASES = [  # (use_semantics, sem_with_coord, white_bkgd, noise_std, samples); the RGB
    (True, False, True, 0.0, 16),  # step below holds K3 with coordinates, no white
    (False, False, True, 0.6, 8),  # background and noise 0.6 at 8 and 16 samples
]


@pytest.mark.parametrize("sem,coord,white,noise,s", K3_CASES)
def test_k3_bf16_plain_matches_pallas(sem, coord, white, noise, s):
    """K3's bf16 plain version against fused_rgb_train_grads at bf16: maps
    and weights to KERNEL_TOL but for a flipped row, every leaf to LEAF_TOL
    of its max on the rays without it (the semantic head's leaves 0); the
    float32 plain version misses the leaves' bound."""
    jcfg, params, tnet = _nets(use_semantics=sem, sem_with_coord=coord, white_bkgd=white)
    odv, z = _inputs(s, s)
    gt = np.random.default_rng(s).uniform(0, 1, (R, 3)).astype(np.float32)
    key = jax.random.PRNGKey(11)

    def both(rows):
        g_j, maps_j, w_j = jfr.fused_rgb_train_grads(
            params["fine"], jnp.asarray(odv[rows]), jnp.asarray(z[rows]), jnp.asarray(gt[rows]),
            jcfg, noise_std=noise, noise_key=key, interpret=True)
        args = (tnet.nerf_fine, *(torch.from_numpy(a[rows]) for a in (odv, z, gt)))
        kw = dict(white_bkgd=white, noise_std=noise, seed=_jax_seed(key))
        return (_jax_grads(g_j), maps_j, w_j, tfr.rgb_train_grads_plain(*args, **kw,
                                                                       compute_dtype=BF16),
                tfr.rgb_train_grads_plain(*args, **kw))

    want, maps_j, w_j, (g, maps, w), (g32, maps32, _) = both(np.arange(R))
    assert maps.shape == maps_j.shape == (R, 5 + (2 if sem else 0))
    flipped = np.union1d(_flipped(maps, maps_j), _flipped(w, w_j))
    assert float((maps - maps32).abs().max()) > 100 * KERNEL_TOL  # the two modes differ
    if len(flipped):  # the leaves on the other rays (both sides' noise: the call's ray index)
        want, _, _, (g, _, _), (g32, _, _) = both(np.setdiff1d(np.arange(R), flipped))
    assert _leaf_reading(g, want) <= 1.0
    assert _leaf_reading(g32, want) > 1.0


K6_CASES = [  # (depth, sem_with_coord, noise, samples, seeded dweights); the full SOS
    (5, True, 1.0, 8, True),    # step below holds K6 at depth 5 with coordinates,
    (6, False, 0.0, 16, False),  # noise 0, 4 + 4 samples
]


@pytest.mark.parametrize("depth,coord,noise,s,dweights", K6_CASES)
def test_k6_bf16_plain_matches_pallas_vjp(depth, coord, noise, s, dweights):
    """K6's bf16 plain version against jax.vjp of fused_train_render_planar
    at bf16 without frozen_backbone (_train_render_bwd, interpret mode):
    every leaf to LEAF_TOL of its max, on the rays without a flipped one
    (the forward's maps, K4's bf16 plain version, against JAX's); the
    float32 plain version misses the bound."""
    jcfg, params, tnet = _nets(netdepth=depth, netdepth_fine=depth, sem_with_coord=coord)
    odv, z = _inputs(s + 3, s)
    key = jax.random.PRNGKey(s)
    rng = np.random.default_rng(depth + s)
    dmaps = rng.normal(size=(R, 7)).astype(np.float32)
    dw = rng.normal(size=(R, s)).astype(np.float32) if dweights else np.zeros((R, s), np.float32)
    field, seed = tnet.nerf_fine, _jax_seed(key)

    def both(rows):
        (maps_j, _), vjp = jax.vjp(
            lambda p: jfr.fused_train_render_planar(p, jnp.asarray(odv[rows]),
                                                    jnp.asarray(z[rows]), jcfg, depth=depth,
                                                    noise_std=noise, noise_key=key),
            params["fine"])
        (g_j,) = vjp((jnp.asarray(dmaps[rows]), jnp.asarray(dw[rows])))
        o, zz, dm = (torch.from_numpy(a[rows]) for a in (odv, z, dmaps))
        dwt = torch.from_numpy(dw[rows]) if dweights else None
        kw = dict(noise_std=noise, seed=seed)
        maps = tfr.train_render_plain(field, o, zz, save_semin=False, compute_dtype=BF16, **kw)[0]
        return (_jax_grads(g_j), maps_j, maps,
                tfr.train_render_grads_plain(field, o, zz, dm, dwt, compute_dtype=BF16, **kw),
                tfr.train_render_grads_plain(field, o, zz, dm, dwt, **kw))

    want, maps_j, maps, g, g32 = both(np.arange(R))
    flipped = _flipped(maps, maps_j)
    if len(flipped):
        want, _, _, g, g32 = both(np.setdiff1d(np.arange(R), flipped))
    assert set(g) == set(want) == {n for n, _ in field.named_parameters()}
    assert all(np.abs(np.asarray(v)).max() > 0 for v in want.values())
    assert _leaf_reading(g, want) <= 1.0
    assert _leaf_reading(g32, want) > 1.0


# ----------------------------------------------------------------- the kernels' dataflow


def _bwd_slices(field, L, i):
    """Layer i's input-gradient matrix ``Wb [k, n]`` as the bf16 kernels read
    it: ``pack_bwd_ring``'s bf16 k16 slices through the B descriptor, k
    position q of slice s holding row 16 s + bf16_k_rows()[q]; checked to
    be Wb rounded to bf16 with zero padding."""
    ring, rd = tfr.pack_bwd_ring(field, bf16=True)
    n, k16 = rd.ncols[i], -(-L.k // 16)
    b = _bf16_slices(ring[rd.off[i]:rd.off[i] + k16 * 8 * n], n)  # [s, q, n]
    rows = (16 * torch.arange(k16)[:, None] + tfr.bf16_k_rows()[None, :]).reshape(-1)
    wt = torch.zeros(16 * k16, n)
    wt[rows] = b.reshape(-1, n)
    return wt


def test_bf16_bwd_ring_reads_back_through_the_descriptor():
    """pack_bwd_ring's bf16 layout (K3, K6 at bf16): every input-gradient
    matrix of pack_train_bwd, in bwd_ring_layers' order, read through the B
    descriptor in bf16_k_rows' k order, is the matrix rounded to bf16 with
    its rows padded to 16 and its columns to the wgmma width by zeros; the
    offsets count float32 words (8 N a k16 slice)."""
    for depth, coord, width in ((5, True, 32), (6, False, 16), (8, True, 256)):
        torch.manual_seed(depth)
        field = TorchNet(TorchConfig(**{**TINY, "netdepth_fine": depth, "netwidth_fine": width,
                                        "sem_with_coord": coord, "multires": 10,
                                        "multires_views": 4}, fused_field=True)).nerf_fine
        buf, bwd = tfr.pack_train_bwd(field)
        ring, rd = tfr.pack_bwd_ring(field, bf16=True)
        off = 0
        for i in tfr.bwd_ring_layers(field):
            L = bwd[i]
            ldn, n = tfr._pad8(L.n), tfr._ring_n(L.n)
            assert rd.off[i] == off and rd.ncols[i] == n
            off += -(-L.k // 16) * 8 * n
            want = torch.zeros(-(-L.k // 16) * 16, n)
            want[:L.k, :ldn] = round_bf16(buf[L.w:L.w + L.k * ldn].view(L.k, ldn))
            assert torch.equal(_bwd_slices(field, L, i), want), i
        assert off == ring.numel()


def _bf16_forward(field, odv, z):
    """``_emulate_forward`` as the bf16 storing forward computes it from
    pack_field's buffer: each product on its inputs and W^T rounded to bf16
    with the float32 bias, and every plane it stores (emb, the view PE, the
    trunk's outputs, feat, hv, s_act) rounded to bf16; the heads (sigma,
    the rgb logits, the semantics) float32."""
    buf, fd = tfr.pack_field(field)
    depth, skip, sem = fd.depth, fd.skip, fd.sem_dim
    Rn, S = z.shape
    pts = (odv[:, None, 0:3] + odv[:, None, 3:6] * z[..., None]).reshape(-1, 3)
    dirs = odv[:, None, 6:9].expand(Rn, S, 3).reshape(-1, 3)
    emb = round_bf16(_pad_rows(field.embed(pts).t(), tfr._pad8(fd.emb_dim)))
    demb = round_bf16(_pad_rows(field.embed_views(dirs).t(), tfr._pad8(fd.demb_dim)))

    def mm(L, segs, relu=False):
        w, bias = _layer(buf, L)
        y = round_bf16(w).t() @ round_bf16(torch.cat(segs)) + bias[:, None]
        return torch.relu(y) if relu else y

    acts, h = [], [emb]
    for i in range(depth):
        acts.append(round_bf16(mm(fd.layer[i], h, relu=True)))
        h = [emb, acts[-1]] if i == skip else [acts[-1]]
    out = dict(emb=emb, demb=demb, acts=acts, s_act=None, semv=None)
    out["sigma"] = mm(fd.layer[depth], h)[0].view(Rn, S)
    out["feat"] = round_bf16(mm(fd.layer[depth + 1], h))
    out["hv"] = round_bf16(mm(fd.layer[depth + 2], [out["feat"], demb], relu=True))
    out["logits"] = mm(fd.layer[depth + 3], [out["hv"]])[:3].view(3, Rn, S)
    if sem:
        out["s_act"] = round_bf16(mm(fd.layer[depth + 4],
                                     h + ([emb] if fd.sem_with_coord else []), relu=True))
        out["semv"] = mm(fd.layer[depth + 5], [out["s_act"]])[:sem].view(sem, Rn, S)
    return out


def _dx_bf16(field, k6_sem):
    """bwd_layer's bf16 mode: per k16 step the A operand of dY rows
    16 s + bf16_k_rows()[q] (rows past the matrix read 0) rounded to bf16,
    against pack_bwd_ring's bf16 slices, summed in float32; the product
    added to ``add``, gated, and rounded to bf16 but for alpha's slot when
    the semantic head's product is still to be added (sweep_steps' rnd)."""
    _, bwd = tfr.pack_train_bwd(field)
    depth = field.mlp.depth

    def dx(i, segs, gate=None, add=None):
        L = bwd[i]
        wt = _bwd_slices(field, L, i)[:, :L.n]
        dy = torch.cat(segs)
        assert dy.shape[0] == L.k
        a = torch.zeros(wt.shape[0], dy.shape[1])
        a[:L.k] = round_bf16(dy)
        y = torch.zeros(L.n, dy.shape[1])
        for s in range(wt.shape[0] // 16):
            y += wt[16 * s:16 * s + 16].t() @ a[16 * s:16 * s + 16]
        y = torch.cat([y, y.new_zeros(tfr._pad8(L.n) - L.n, y.shape[1])])
        if add is not None:
            y = y + add
        if gate is not None:
            y = y * (gate > 0)
        return y if (k6_sem and i == depth) else round_bf16(y)

    return dx


def _dwb_bf16(layer, segs, dy):
    """wgrad's bf16 mode per 64-point sub and piece of NP outputs: the
    sub's dY rows written into the B operand as store_b8_bf16 writes them
    (point 16 kk + k at k position k of slice kk, rounded to bf16, at
    b_offset_bf16) and read back through the descriptor, A the X rows'
    points in order rounded to bf16, summed in float32; db the plane's
    values summed as they are."""
    x = torch.cat(segs)
    n, P = dy.shape
    NP = 8
    while NP < n and NP < 128:
        NP *= 2
    k, col = torch.meshgrid(torch.arange(16), torch.arange(NP), indexing="ij")
    at = ((col // 8) * 128 + (k // 8) * 64 + (col % 8) * 8 + k % 8).reshape(-1)  # b_offset_bf16
    dW = torch.zeros(x.shape[0], n)
    for p0 in range(0, P, 64):
        xs = torch.zeros(x.shape[0], 64)
        xs[:, :min(64, P - p0)] = x[:, p0:p0 + 64]
        for pc in range(0, n, NP):
            sub = torch.zeros(NP, 64)
            sub[:min(NP, n - pc), :min(64, P - p0)] = dy[pc:pc + NP, p0:p0 + 64]
            words = torch.zeros(4, 16 * NP, dtype=torch.bfloat16)  # the sub's 4 k16 slices
            for kk in range(4):
                words[kk, at] = sub[col, 16 * kk + k].reshape(-1).to(torch.bfloat16)
            b = _bf16_slices(words.view(torch.float32).reshape(-1), NP)  # [kk, k, NP]
            for kk in range(4):
                dW[:, pc:pc + NP] += (round_bf16(xs[:, 16 * kk:16 * kk + 16])
                                      @ b[kk, :, :min(NP, n - pc)])
    return dW, dy.sum(1)


DATAFLOW_CASES = [  # (mode, use_semantics, sem_with_coord, depth, samples)
    ("k3", True, True, 5, 8),
    ("k3", False, False, 6, 16),
    ("k6", True, True, 5, 16),
    ("k6", True, False, 6, 8),
]


@pytest.mark.parametrize("mode,sem,coord,depth,s", DATAFLOW_CASES)
def test_k3_k6_bf16_dataflow_matches_plain(mode, sem, coord, depth, s):
    """The bf16 kernels' dataflow from the packed buffers alone: the storing
    forward's bf16 planes, K3's or K6's composite and cotangent planes
    (float32), bwd_layer's k16 steps on pack_bwd_ring's bf16 slices with the
    epilogue's gate and rounding, wgrad's B operand written and read back
    through the descriptor, into grad_layout's buffer, reproduce the bf16
    plain version's gradients (and K3's maps and weights) to float32
    summation order: 1e-5 of each leaf's max but for a ray with a bf16
    rounding flip, whose terms both sides then go without."""
    torch.manual_seed(depth + s)
    field = TorchNet(TorchConfig(**{**TINY, "use_semantics": sem, "sem_with_coord": coord,
                                    "netdepth_fine": depth}, fused_field=True)).nerf_fine
    odv, z = (torch.from_numpy(a) for a in _inputs(depth + s, s))
    rng = np.random.default_rng(s)
    gt = torch.from_numpy(rng.uniform(0, 1, (R, 3)).astype(np.float32))
    dmaps = torch.from_numpy(rng.normal(size=(R, 5 + (2 if sem else 0))).astype(np.float32))
    dweights = torch.from_numpy(rng.normal(size=(R, s)).astype(np.float32))
    noise, k6 = 0.6, mode == "k6"

    def both(rows):
        o, zz = odv[rows].contiguous(), z[rows].contiguous()
        with torch.no_grad():
            got = _emulate_k3(field, o, zz, None if k6 else gt[rows], False, noise, 77,
                              dmaps[rows] if k6 else None, dweights[rows] if k6 else None,
                              fwd=_bf16_forward(field, o, zz), dx=_dx_bf16(field, k6 and sem),
                              dwb=_dwb_bf16)
        kw = dict(noise_std=noise, seed=77, compute_dtype=BF16)
        if k6:
            want = (tfr.train_render_grads_plain(field, o, zz, dmaps[rows], dweights[rows], **kw),
                    *tfr.train_render_plain(field, o, zz, save_semin=False, **kw)[:2])
        else:
            want = tfr.rgb_train_grads_plain(field, o, zz, gt[rows], white_bkgd=False, **kw)
        return got, want

    (g, maps, w), (gp, maps_p, w_p) = both(np.arange(R))
    flipped = np.union1d(_flipped(maps, maps_p), _flipped(w, w_p))
    if len(flipped):
        (g, _, _), (gp, _, _) = both(np.setdiff1d(np.arange(R), flipped))
    assert set(g) == set(gp)
    for name, ref in gp.items():
        assert g[name].shape == ref.shape, name
        scale = float(ref.abs().max())
        assert float((g[name] - ref).abs().max()) <= 1e-5 * max(scale, 1e-30), name


# ----------------------------------------------------------------- the steps against JAX's

STEP = dict(TINY, perturb=0.0, raw_noise_std=0.6)
LR = 5e-4
# A step's gradient leaf against JAX's, over the leaf's max. A bf16 rounding
# flip in the fine pass (whose z follow the coarse weights) moves the fine
# field's leaves: measured 6.5e-5 (the RGB step, 20 rays) and 6.1e-4 (the
# full SOS step, 128 rays, whose losses couple the rays, so no ray can be set
# apart); the coarse field's agree to 2e-7. The float32 steps lie 3e-2 to 0.2
# of a leaf's max from JAX's bf16 steps, 15x the bound and more.
STEP_TOL = 2e-3


def _rgb_batch(seed, n=20):
    rng = np.random.default_rng(seed)
    rays = rng.normal(size=(2, n, 3)).astype(np.float32)
    rays[0] *= 0.3
    return {"rays": rays, "target": rng.uniform(0, 1, (n, 3)).astype(np.float32)}


@pytest.fixture(scope="module")
def rgb_step_pair():
    """JAX's bf16 fused RGB step on one batch (K3 at bf16 in interpret mode,
    TRAIN_RAY_BLOCK 8): its params, gradients, metrics, post-Adam params and
    noise seeds."""
    old = jfr.TRAIN_RAY_BLOCK
    jfr.TRAIN_RAY_BLOCK = 8
    try:
        jnet = JaxNet(JaxConfig(**STEP, fused_field=True, compute_dtype="bfloat16"))
        params = _jax_params(jnet, 4)
        batch, key = _rgb_batch(5), jax.random.PRNGKey(8)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        grads, metrics = jtrainer._fused_rgb_value_and_grads(jnet, params, jbatch, key, 1.0, 4.0,
                                                             1.0)
        state = jstate.TrainState.create(params, jstate.make_optimizer(LR, 0.1, 250_000))
    finally:
        jfr.TRAIN_RAY_BLOCK = old
    _, k_c, _, k_f = jax.random.split(key, 4)  # the coarse and fine noise keys (trainer.py:74)
    return {"params": _np(params), "batch": batch, "grads": _np(grads),
            "stepped": _np(state.apply_gradients(grads).params),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "seeds": tuple(_jax_seed(k) for k in (k_c, k_f))}


def _step_leaves(got, want):
    """The worst leaf of a step's gradients over STEP_TOL of its max."""
    return max(float((got[n] - ref).abs().max()) / (STEP_TOL * float(ref.abs().max()))
               for n, ref in want.items() if float(ref.abs().max()) > 0)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_rgb_step_bf16_matches_jax(rgb_step_pair, monkeypatch, dtype):
    """One make_rgb_train_step step of the bf16 fused net (K3's bf16 plain
    version on the CPU), JAX's noise seeds injected: every gradient leaf to
    STEP_TOL of its max and the loss to 1e-5 relative of JAX's bf16 step;
    the post-Adam params to 1e-6 where the gradient entry lies beyond
    1e-3 of its leaf's max (Adam's first update is lr g / (|g| + eps): for
    an entry within its summation-order noise of 0 its sign is free, and
    it moved one entry by 3.1e-5 here). The float32 net's step (the
    control) misses the gradients' bound."""
    pair = rgb_step_pair
    tnet = TorchNet(TorchConfig(**STEP, fused_field=True, compute_dtype=dtype))
    tnet.load_state_dict(tckpt.state_dict_from_jax_params(pair["params"]))
    monkeypatch.setattr(ttrainer, "step_randomness", lambda *a: (None, pair["seeds"]))
    opt = tstate.make_optimizer(tnet.parameters(), LR)
    step = ttrainer.make_rgb_train_step(tnet, opt, tstate.exp_decay_schedule(LR, 0.1, 250_000),
                                        1.0, 4.0)
    m = step({k: torch.from_numpy(v) for k, v in pair["batch"].items()}, 0)
    want = tckpt.state_dict_from_jax_params(pair["grads"])
    over = _step_leaves({n: p.grad for n, p in tnet.named_parameters()}, want)
    if dtype == "float32":
        assert over > 1.0
        return
    assert over <= 1.0
    np.testing.assert_allclose(float(m["loss"]), pair["metrics"]["loss"], rtol=1e-5)
    stepped = tckpt.state_dict_from_jax_params(pair["stepped"])
    for name, p in tnet.named_parameters():
        g = want[name].abs()
        moved = (p.detach() - stepped[name])[g > 1e-3 * float(g.max())]
        assert not moved.numel() or float(moved.abs().max()) <= 1e-6, name


@pytest.fixture(scope="module")
def sos_full_pair():
    """JAX's full SOS step at bf16 (no fix_backbone: K4 and K6 at bf16 in
    interpret mode, TRAIN_RAY_BLOCK 128) on test_torch_sos.py's batch, under
    jit as its train step runs, with a float32 ViT on both sides (the
    render's bf16 is what this holds; test_torch_bf16.py holds the bf16
    ViT): its params, loss terms and gradients, and the appearance loss's
    coordinates from its key."""
    from test_torch_bf16 import APP, GEO, NET
    from test_torch_sos import B, P, STRIDE, _app_coords, _batch

    old = jfr.TRAIN_RAY_BLOCK
    jfr.TRAIN_RAY_BLOCK = 128
    try:
        jnet = JaxNet(JaxConfig(**NET, fused_field=True, compute_dtype="bfloat16"))
        params = _jax_params(jnet, 0)
        je, dino_params, te = _vits(torch.float32)
        cfg = jsos.SOSConfig(batch_size=B, patch_size=P, patch_stride=STRIDE,
                             fix_backbone=False)
        app = jcorr.CorrelationLoss.from_params(APP, use_sim_matrix=True)
        geo = jcorr.GeoCorrelationLoss.from_params(GEO, use_sim_matrix=True)
        batch, key = _batch(0), jax.random.PRNGKey(7)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        (_, metrics), grads = jax.jit(jax.value_and_grad(
            lambda p: jsos.sos_loss_fn(jnet, je, app, geo, cfg, p, dino_params, jbatch, key,
                                       2.0, 6.0), has_aux=True))(params)
    finally:
        jfr.TRAIN_RAY_BLOCK = old
    return {"params": _np(params), "te": te, "batch": batch, "grads": _np(grads),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "coords": torch.from_numpy(_app_coords(key)), "shape": (B, P, STRIDE)}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_full_sos_step_bf16_matches_jax(sos_full_pair, monkeypatch, dtype):
    """One make_sos_train_step step of the full finetune (every leaf
    trained; the fused render's backward K6's bf16 plain version) on the
    bf16 fused net, JAX's coordinates injected: every loss term to 1e-5
    relative and every gradient leaf to STEP_TOL of its max of JAX's bf16
    step; the float32 net's step (the control) misses the gradients'
    bound."""
    from test_torch_bf16 import APP, GEO, NET

    pair = sos_full_pair
    B, P, stride = pair["shape"]
    tnet = TorchNet(TorchConfig(**NET, fused_field=True, compute_dtype=dtype))
    tnet.load_state_dict(tckpt.state_dict_from_jax_params(pair["params"]))
    cfg = tsos.SOSConfig(batch_size=B, patch_size=P, patch_stride=stride, fix_backbone=False)
    monkeypatch.setattr(tsos, "draw_pair_coords", lambda *a: pair["coords"])
    opt = tstate.make_optimizer(tnet, LR, fix_backbone=False)
    step = tsos.make_sos_train_step(
        tnet, pair["te"], tcorr.CorrelationLoss.from_params(APP, use_sim_matrix=True),
        tcorr.GeoCorrelationLoss.from_params(GEO, use_sim_matrix=True), cfg, opt,
        tstate.exp_decay_schedule(LR, 0.1, 250_000), 2.0, 6.0)
    m = step({k: torch.from_numpy(pair["batch"][k]) for k in ("rays", "target")}, 0)
    want = tckpt.state_dict_from_jax_params(pair["grads"])
    over = _step_leaves({n: p.grad for n, p in tnet.named_parameters()}, want)
    if dtype == "float32":
        assert over > 1.0
        return
    assert over <= 1.0
    for k in ("loss", "img0", "img1", "corr0", "corr1", "geo_corr0", "geo_corr1"):
        np.testing.assert_allclose(float(m[k]), pair["metrics"][k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    assert abs(float(m["corr0"])) > 0 and abs(float(m["geo_corr1"])) > 0


# ----------------------------------------------------------------- the entry point


def test_run_nerf_bf16_pretrain_then_full_finetune(patch_scene, tmp_path, monkeypatch):
    """run_nerf.main at bf16 on the fused route: an RGB pretrain (K3's bf16
    plain version, twice a step), then from its last.ckpt a full SOS
    finetune (no --fix_backbone: K4 and K6 at bf16), each writing its
    checkpoint; every leaf moves in the finetune, the trunk included."""
    from test_torch_bf16 import FROZEN, _main

    seen = []
    for name in ("rgb_train_grads_plain", "train_render_grads_plain"):
        orig = getattr(tfr, name)

        def spy(*a, _orig=orig, _name=name, **kw):
            seen.append((_name, kw.get("compute_dtype")))
            return _orig(*a, **kw)
        monkeypatch.setattr(tfr, name, spy)
    logs = tmp_path / "logs"
    rgb = _main(patch_scene, logs, "rgb", "--N_rand", "32", "--max_steps", "2")
    assert seen and set(seen) == {("rgb_train_grads_plain", BF16)}
    ckpt = rgb / "checkpoints" / "last.ckpt"
    start, gstep, _ = tckpt.load_checkpoint(str(ckpt))
    assert gstep == 2
    seen.clear()
    run = _main(patch_scene, logs, "full", *[f for f in FROZEN if f != "--fix_backbone"],
                "--ckpt_path", str(ckpt), "--max_steps", "4")
    assert {n for n, _ in seen} == {"train_render_grads_plain"}
    assert all(d == BF16 for _, d in seen)
    end, gstep, opt_state = tckpt.load_checkpoint(str(run / "checkpoints" / "last.ckpt"))
    assert gstep == 4 and len(opt_state["state"]) == len(end)
    for k, v in end.items():
        assert torch.isfinite(v).all() and (k not in start or not torch.equal(v, start[k])), k
