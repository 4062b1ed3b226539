"""``--compute_dtype bfloat16`` on the CPU: the bf16 modes' plain versions of
K1, K2, K4 and K5 against the JAX Pallas kernels at bf16 (interpret mode),
the eager bf16 field and the bf16 ViT against JAX's bf16 XLA modules, one
frozen SOS step at bf16 against JAX, ``run_nerf.main`` at bf16 (``--eval``,
the ``--fix_backbone`` finetune and its resume), and the RGB pretrain's,
the full finetune's, ``--mipnerf``'s, ``--N_importance 0``'s and the
classic ``--eval_vol``'s routes passing the entry (their kernels' bf16
modes: tests/test_torch_bf16_train.py, tests/test_torch_mip_bf16.py,
tests/test_torch_field_bf16.py).

Two bf16 semantics are held here (``models/mlp.py``): the fused kernels'
(each product's operands rounded to bf16, the product and the bias in
float32), whose plain versions match the Pallas kernels to float32
rounding, and flax's ``nn.Dense(dtype=bf16)`` (bf16 products, bf16 bias
adds, bf16 activations) of the eager route, which matches JAX's XLA net to
bf16 rounding. The CUDA kernels' bf16 modes run on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsos_torch import run_nerf
from nerfsos_torch.data.synthetic import write_sphere_scene
from nerfsos_torch.engines import checkpoint as tckpt
from nerfsos_torch.engines import sos as tsos
from nerfsos_torch.engines import state as tstate
from nerfsos_torch.engines import trainer as ttrainer
from nerfsos_torch.losses import correlation as tcorr
from nerfsos_torch.models import extractor as text
from nerfsos_torch.models.nerf import NeRFConfig as TorchConfig
from nerfsos_torch.models.nerf import NeRFNet as TorchNet
from nerfsos_torch.models.vit import VisionTransformer as TorchViT
from nerfsos_torch.ops import fused_render as tfr
from nerfsos_tpu.engines import sos as jsos
from nerfsos_tpu.losses import correlation as jcorr
from nerfsos_tpu.models import extractor as jext
from nerfsos_tpu.models import vit as jvit
from nerfsos_tpu.models.nerf import NeRFConfig as JaxConfig
from nerfsos_tpu.models.nerf import NeRFNet as JaxNet
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


BF16 = torch.bfloat16
TINY = dict(netwidth=32, netdepth=5, netwidth_fine=32, netdepth_fine=5, n_samples=8,
            n_importance=8, multires=4, multires_views=2, use_semantics=True,
            sem_with_coord=True)
R = 20  # not a multiple of the 8-ray Pallas block
# The bf16 plain versions against the Pallas kernels at bf16: both round the
# same operands to bf16 and accumulate in float32, so they differ by float32
# summation order alone (measured <= 6.4e-6 on the maps and weights here),
# but for a ray where an activation lay within that float32 rounding of a
# bf16 rounding boundary and rounded the other way on the two sides (one
# bf16 ulp, 0.02-0.05% of sem_in's entries). Such a flip moved one ray of a
# call here, by 1.2e-5 and 2.1e-5 (and by 4.6e-4 on the same shapes with
# flax's init's weights), and none in five other draws of the weights. So
# one ray of a call may lie beyond KERNEL_TOL, within FLIP_TOL (twice the
# largest flip seen); a bf16 rounding in the wrong place moves every ray by
# ~1e-3 (the bf16 and float32 versions differ by 1e-3 to 2e-2).
KERNEL_TOL = 1e-5
FLIP_TOL = 1e-3
FLIP_ROWS = 0.1  # the eager route's share of points a rounding flip may move


def _assert_bf16_close(got, want, got32):
    """got (the bf16 plain version) vs want (the Pallas kernel at bf16) row
    by row: KERNEL_TOL, but for one row, which must lie within FLIP_TOL;
    and far from the float32 version got32."""
    got, want, got32 = (np.asarray(x, np.float32).reshape(len(got), -1)
                        for x in (got, want, got32))
    err = np.abs(got - want).max(1)
    assert float(np.abs(got - got32).max()) > 100 * KERNEL_TOL  # the two modes differ
    assert (err > KERNEL_TOL).sum() <= 1 and err.max() <= FLIP_TOL, err


@pytest.fixture(autouse=True)
def small_pallas_block(monkeypatch):
    """8 rays per Pallas grid step keeps interpret mode fast."""
    monkeypatch.setattr(jfr, "RAY_BLOCK", 8)
    monkeypatch.setattr(jfr, "TRAIN_RAY_BLOCK", 8)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_params(jnet, seed, *args):
    """Params for ``jnet`` (a JAX NeRFNet, or a flax module and ``args`` to
    init it with) in the tree its init makes, drawn
    from a seeded numpy generator at the scale of flax's default init
    (kernels N(0, 1/fan_in)) with biases N(0, 0.1^2); the tree from
    jax.eval_shape, since JAX's init op by op costs seconds."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        if path[-1].key == "kernel":
            x = rng.normal(size=leaf.shape) / np.sqrt(leaf.shape[0])
        else:
            x = 0.1 * rng.normal(size=leaf.shape)
        return jnp.asarray(x, leaf.dtype)

    return jax.tree_util.tree_map_with_path(draw, jax.eval_shape(jnet.init,
                                                                 jax.random.PRNGKey(0), *args))


def _nets(fused=True, frozen=False, **over):
    kw = {**TINY, **over}
    jcfg = JaxConfig(**kw, fused_field=fused, compute_dtype="bfloat16", frozen_backbone=frozen)
    params = _jax_params(JaxNet(jcfg), 2)
    tnet = TorchNet(TorchConfig(**kw, fused_field=fused, compute_dtype="bfloat16",
                                frozen_backbone=frozen))
    tnet.load_state_dict(tckpt.state_dict_from_jax_params(_np(params)))
    return jcfg, params, tnet


def _inputs(seed, s):
    rng = np.random.default_rng(seed)
    odv = rng.normal(size=(R, 9)).astype(np.float32)
    odv[:, 6:9] = odv[:, 3:6] / np.linalg.norm(odv[:, 3:6], axis=1, keepdims=True)
    z = np.sort(rng.uniform(1, 4, size=(R, s)), 1).astype(np.float32)
    return odv, z


def _jax_seed(key):
    return int(jax.random.randint(key, (1, 1), 0, 2**31 - 1).astype(jnp.float32)[0, 0])


@pytest.mark.parametrize("use_semantics", [True, False])
def test_k1_k2_bf16_plain_match_pallas(use_semantics):
    """K1's weights and K2's maps and weights at bf16 against
    fused_coarse_weights_planar / fused_render_planar at bf16 to KERNEL_TOL,
    and far from the float32 kernels'."""
    jcfg, params, tnet = _nets(use_semantics=use_semantics)
    odv, z = _inputs(1, 16)
    w1_j = jfr.fused_coarse_weights_planar(params["coarse"], jnp.asarray(odv[:, :6]),
                                           jnp.asarray(z[:, :8]), jcfg, interpret=True)
    maps_j, w_j = jfr.fused_render_planar(params["fine"], jnp.asarray(odv), jnp.asarray(z),
                                          jcfg, interpret=True)
    od, zc = torch.from_numpy(odv[:, :6].copy()), torch.from_numpy(z[:, :8].copy())
    with torch.no_grad():
        w1 = tfr.coarse_weights_plain(tnet.nerf, od, zc, BF16)
        maps, w = tfr.render_plain(tnet.nerf_fine, torch.from_numpy(odv), torch.from_numpy(z),
                                   BF16)
        w1_32 = tfr.coarse_weights_plain(tnet.nerf, od, zc)
        maps32, w32 = tfr.render_plain(tnet.nerf_fine, torch.from_numpy(odv),
                                       torch.from_numpy(z))
    assert maps.shape == maps_j.shape == (R, 5 + (2 if use_semantics else 0))
    for got, want, got32 in ((w1, w1_j, w1_32), (maps, maps_j, maps32), (w, w_j, w32)):
        _assert_bf16_close(got, want, got32)


@pytest.mark.parametrize("depth,coord,noise,s", [(6, True, 0.6, 8)])
def test_k4_bf16_plain_matches_pallas(depth, coord, noise, s):
    """K4 at bf16: maps and weights to KERNEL_TOL, and sem_in, stored in bf16
    on both sides, equal but for a bf16 rounding of an input that float32
    summation order moved across a rounding boundary (one bf16 ulp)."""
    jcfg, params, tnet = _nets(frozen=True, netdepth=depth, netdepth_fine=depth,
                               sem_with_coord=coord)
    odv, z = _inputs(s, s)
    ws, bs = jfr._flatten_mlp_params(params["fine"]["mlp"], depth, True)
    seed = 1234567
    maps_j, w_j, semin_j = jfr._train_render_fwd_impl(
        tuple(ws), tuple(bs), jnp.asarray(odv), jnp.asarray(z),
        jnp.full((1, 1), seed, jnp.float32), depth, (4,), jcfg.multires, jcfg.multires_views,
        True, coord, "bfloat16", noise, interpret=True, save_semin=True, frozen_blk=True)
    assert semin_j.dtype == jnp.bfloat16
    C = tnet.nerf_fine.mlp.semantic_linear[0].in_features
    semin_j = np.asarray(semin_j.astype(jnp.float32)).transpose(0, 2, 1).reshape(-1, C)[:R * s]
    kw = dict(noise_std=noise, seed=seed, save_semin=True)
    maps, w, semin = tfr.train_render_plain(tnet.nerf_fine, torch.from_numpy(odv),
                                            torch.from_numpy(z), compute_dtype=BF16, **kw)
    maps32, w32, _ = tfr.train_render_plain(tnet.nerf_fine, torch.from_numpy(odv),
                                            torch.from_numpy(z), **kw)
    assert semin.dtype == BF16 and semin.shape == (R * s, C)
    _assert_bf16_close(maps, maps_j, maps32)
    _assert_bf16_close(w, w_j, w32)
    got = semin.to(torch.float32).numpy()
    off = got != semin_j
    assert off.mean() < 1e-3
    np.testing.assert_allclose(got[off], semin_j[off], rtol=2.0**-7, atol=0)


@pytest.mark.parametrize("depth,coord,noise,s", [(6, True, 0.6, 8)])
def test_k5_bf16_matches_pallas(depth, coord, noise, s):
    """K5 at bf16 through the autograd function (its plain version on CPU
    tensors): the semantic head's grads against jax.vjp of
    fused_train_render_planar at bf16 with frozen_backbone (K4 and K5 in
    interpret mode) to 1e-5 of each leaf's max; every other leaf gets none."""
    jcfg, params, tnet = _nets(frozen=True, netdepth=depth, netdepth_fine=depth,
                               sem_with_coord=coord)
    odv, z = _inputs(s + 1, s)
    key = jax.random.PRNGKey(5)
    dmaps = np.random.default_rng(s).normal(size=(R, 7)).astype(np.float32)
    (maps_j, w_j), vjp = jax.vjp(
        lambda p: jfr.fused_train_render_planar(p, jnp.asarray(odv), jnp.asarray(z), jcfg,
                                                depth=depth, noise_std=noise, noise_key=key),
        params["fine"])
    (g_j,) = vjp((jnp.asarray(dmaps), jnp.zeros_like(w_j)))
    want = {k[len("nerf."):]: v for k, v in tckpt.state_dict_from_jax_params(
        {"coarse": _np(g_j)}).items()}
    field = tnet.nerf_fine
    maps, _ = tfr.fused_train_render(field, torch.from_numpy(odv), torch.from_numpy(z),
                                     noise_std=noise, seed=_jax_seed(key), frozen=True,
                                     compute_dtype=BF16)
    with torch.no_grad():
        maps32 = tfr.train_render_plain(field, torch.from_numpy(odv), torch.from_numpy(z),
                                        noise_std=noise, seed=_jax_seed(key),
                                        save_semin=False)[0]
    _assert_bf16_close(maps.detach(), maps_j, maps32)
    torch.sum(maps * torch.from_numpy(dmaps)).backward()
    for name, p in field.named_parameters():
        if name in tfr._SEM_NAMES:
            ref = want[name].numpy()
            scale = np.abs(ref).max() + 1e-12
            assert np.abs(p.grad.numpy() - ref).max() <= 1e-5 * scale, name
        else:
            assert p.grad is None, name


def test_bf16_wrappers_on_the_cpu_take_the_plain_path():
    """On CPU tensors the bf16 wrappers are their plain versions and count no
    launch; K5's wrapper takes the bf16 sem_in K4's stores."""
    _, _, tnet = _nets(frozen=True)
    odv, z = (torch.from_numpy(a) for a in _inputs(4, 8))
    counts = [(f.launches, f.launches_bf16) for f in (
        tfr.fused_coarse_weights, tfr.fused_render, tfr.train_render, tfr.frozen_sem_grads)]
    with torch.no_grad():
        w1 = tfr.fused_coarse_weights(tnet.nerf, odv[:, :6].contiguous(), z, BF16)
        maps, w = tfr.fused_render(tnet.nerf_fine, odv, z, BF16)
        assert torch.equal(w1, tfr.coarse_weights_plain(tnet.nerf, odv[:, :6].contiguous(), z,
                                                        BF16))
        assert torch.equal(maps, tfr.render_plain(tnet.nerf_fine, odv, z, BF16)[0])
        m4, w4, semin = tfr.train_render(tnet.nerf_fine, odv, z, noise_std=0.0, seed=0,
                                         save_semin=True, compute_dtype=BF16)
    assert semin.dtype == BF16
    dmaps = torch.randn(m4.shape)
    g = tfr.frozen_sem_grads(tnet.nerf_fine, semin, w4, dmaps, BF16)
    assert all(torch.equal(g[k], v) for k, v in tfr.frozen_sem_grads_plain(
        tnet.nerf_fine, semin, w4, dmaps, BF16).items())
    assert counts == [(f.launches, f.launches_bf16) for f in (
        tfr.fused_coarse_weights, tfr.fused_render, tfr.train_render, tfr.frozen_sem_grads)]


# ----------------------------------------------------------------- the eager route


def test_eager_bf16_field_matches_jax_xla():
    """--no_fused_field at bf16: the coarse and fine NeRFField (the float32
    PE, flax's bf16 Dense layers, float32 outputs) against JAX's XLA
    NeRFField at compute_dtype bfloat16, run op by op as the JAX entry
    point's eval does outside jit: the same bf16 roundings on both sides, so
    the raw outputs (bf16 values) are equal (measured: on every point here)
    but on points where a rounding flipped (at most FLIP_ROWS of them), each
    within four bf16 steps of its scale (2^-6). Under jit XLA
    fuses elementwise chains and skips some bf16 roundings, which moves its
    outputs by about the bf16-vs-float32 distance."""
    from nerfsos_tpu.models.fields import NeRFField as FlaxField

    jcfg, params, tnet = _nets(fused=False)
    assert not tnet.fused
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(R, 8, 3)).astype(np.float32)
    dirs = rng.normal(size=(R, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    ff = FlaxField(net_depth=5, net_width=32, multires=4, multires_views=2,
                   use_semantics=True, sem_with_coord=True, compute_dtype=jnp.bfloat16)
    f32 = TorchNet(TorchConfig(**TINY))
    f32.load_state_dict(tnet.state_dict())
    for part, field, field32 in (("coarse", tnet.nerf, f32.nerf),
                                 ("fine", tnet.nerf_fine, f32.nerf_fine)):
        want = ff.apply({"params": params[part]}, jnp.asarray(pts), jnp.asarray(dirs))
        with torch.no_grad():
            got = field(torch.from_numpy(pts), torch.from_numpy(dirs))
            ref32 = field32(torch.from_numpy(pts), torch.from_numpy(dirs))
        assert got.dtype == torch.float32 and got.shape == want.shape == (R, 8, 6)
        err = np.abs(got.numpy() - np.asarray(want)).reshape(R * 8, -1).max(1)
        scale = float(np.abs(np.asarray(want)).max())
        assert (err > 0).mean() <= FLIP_ROWS and err.max() <= 2.0**-6 * scale, part
        assert float((got - ref32).abs().max()) > 1e-3  # bf16, not float32 (9.2e-3 here)


def test_eager_bf16_mlp_is_flax_dense():
    """The MLP at bf16 against flax's NeRFMLP at bf16 on random embeddings:
    the raw outputs to one bf16 rounding of their scale."""
    from nerfsos_tpu.models.mlp import NeRFMLP as FlaxMLP
    from nerfsos_torch.models.mlp import NeRFMLP as TorchMLP

    rng = np.random.default_rng(7)  # the field test's R x 8 points: its compiled ops serve
    pe = rng.normal(size=(R * 8, 27)).astype(np.float32)
    ve = rng.normal(size=(R * 8, 15)).astype(np.float32)
    fm = FlaxMLP(depth=5, width=32, use_semantics=True, sem_with_coord=True,
                 compute_dtype=jnp.bfloat16)
    p = _jax_params(fm, 1, jnp.asarray(pe), jnp.asarray(ve))["params"]
    tm = TorchMLP(27, 15, depth=5, width=32, use_semantics=True, sem_with_coord=True,
                  compute_dtype=BF16)
    sd = tckpt.state_dict_from_jax_params({"coarse": {"mlp": _np(p)}})
    tm.load_state_dict({k[len("nerf.mlp."):]: v for k, v in sd.items()})
    want = np.asarray(fm.apply({"params": p}, jnp.asarray(pe), jnp.asarray(ve)))
    with torch.no_grad():
        got = tm(torch.from_numpy(pe), torch.from_numpy(ve)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=2.0**-7 * np.abs(want).max(), rtol=0)


@functools.lru_cache(maxsize=None)
def _vits(dtype):
    """JAX's bf16 (or float32) extractor with a small ViT, its params, and
    the port's with the same weights: seeded numpy draws at the scale of
    flax's default init (Dense kernels N(0, 1/fan_in), LayerNorm scales near
    1), bridged to flax by the JAX package's torch_vit_state_to_flax (no JAX
    init, which op by op costs seconds); built once per dtype (the tests
    only read them)."""
    te = text.VitExtractor(vit=TorchViT(patch_size=16, embed_dim=32, depth=2, num_heads=2,
                                        dtype=dtype))
    rng = np.random.default_rng(1)
    sd = {}
    for k, v in te.vit.state_dict().items():
        if "norm" in k and k.endswith("weight"):
            x = 1.0 + 0.1 * rng.normal(size=v.shape)
        elif k.endswith("weight"):
            x = rng.normal(size=v.shape) / np.sqrt(np.prod(v.shape[1:]))
        else:
            x = 0.02 * rng.normal(size=v.shape)
        sd[k] = torch.from_numpy(x.astype(np.float32))
    te.vit.load_state_dict(sd)
    je = jext.VitExtractor("dino_vits16", dtype=jnp.bfloat16 if dtype == BF16 else jnp.float32)
    je.vit = jvit.VisionTransformer(patch_size=16, embed_dim=32, depth=2, num_heads=2,
                                    pos_embed_size=224, dtype=je.dtype)
    dino_params = je.params = jvit.torch_vit_state_to_flax(
        {k: v.numpy() for k, v in sd.items()}, depth=2)
    return je, dino_params, te


def test_bf16_vit_matches_jax():
    """The ViT at bf16 against JAX's at bf16 (op by op, as the extractor
    runs it): float32 outputs, a median relative error of the patch tokens
    below 1e-3 (JAX's own bf16-vs-f32 check allows 0.05; JAX's bf16 and
    float32 ViTs differ by a median 5.8e-3 here) and at most 2^-6 of each
    output's scale anywhere: the same ops round to bf16 on both sides, so
    most tokens are equal (measured median 0, 1.1e-3 of the scale at most,
    where a rounding flipped)."""
    je, dino_params, te = _vits(BF16)
    x = np.random.default_rng(2).uniform(size=(2, 32, 32, 3)).astype(np.float32)
    want = je.get_vit_attn_feat(jnp.asarray(x), params=dino_params)
    with torch.no_grad():
        got = te.get_vit_attn_feat(torch.from_numpy(x))
    for k in ("feat", "cls_", "attn"):
        g, w = got[k].numpy(), np.asarray(want[k], np.float32)
        assert got[k].dtype == torch.float32 and g.shape == w.shape, k
        assert np.abs(g - w).max() <= 2.0**-6 * np.abs(w).max(), k
    rel = np.abs(got["feat"].numpy() - np.asarray(want["feat"])) / np.maximum(
        np.abs(np.asarray(want["feat"])), 1e-3)
    assert np.median(rel) < 1e-3


def test_synthetic_extractor_bf16_matches_jax():
    x = np.random.default_rng(5).uniform(size=(2, 32, 32, 3)).astype(np.float32)
    je = jext.SyntheticExtractor(dtype=jnp.bfloat16)
    te = text.SyntheticExtractor(proj=torch.from_numpy(np.array(je.params["proj"])),
                                 dtype=BF16)
    want = je.get_vit_attn_feat(jnp.asarray(x))
    got = te.get_vit_attn_feat(torch.from_numpy(x))
    for k in ("feat", "cls_", "attn"):
        assert got[k].dtype == BF16, k
        g, w = got[k].to(torch.float32).numpy(), np.asarray(want[k], np.float32)
        np.testing.assert_allclose(g, w, atol=2.0**-7 * np.abs(w).max(), rtol=0, err_msg=k)


# ----------------------------------------------------------------- the frozen SOS step

B, P, STRIDE = 2, 8, 2
NEAR, FAR = 2.0, 6.0
NET = dict(netwidth=16, netdepth=5, netwidth_fine=16, netdepth_fine=5, n_samples=4,
           n_importance=4, multires=4, multires_views=2, use_semantics=True,
           sem_with_coord=True, perturb=0.0, raw_noise_std=0.0, ray_block=B * P * P)
APP, GEO = [0.18, 1, 0.46, 1], [0.5, 1, 3, 1]


def test_frozen_sos_step_bf16_matches_jax(monkeypatch):
    """sos_loss_fn at bf16 with the fused render (K4/K5's bf16 plain
    versions) and a bf16 ViT against JAX's with K4/K5 at bf16 in interpret
    mode, under jit as its train step runs: every term to 5e-4 relative, the
    semantic head's grads to 3e-3 of each leaf's max, the trunk none. The
    render's terms agree to ~1e-6; the correlation terms read the bf16 ViT's
    features, and under jit XLA fuses the ViT's elementwise chains and skips
    some of their bf16 roundings (op by op the ViTs agree,
    test_bf16_vit_matches_jax), which moves them by up to 2.9e-5 (the loss
    2.0e-5, the grads 5.8e-4 of a leaf's max, measured). JAX's params are
    drawn (_jax_params), not run through its init."""
    from tests.test_torch_sos import _app_coords, _batch

    monkeypatch.setattr(jfr, "TRAIN_RAY_BLOCK", 128)
    jnet = JaxNet(JaxConfig(**NET, fused_field=True, compute_dtype="bfloat16"))
    params = _jax_params(jnet, 0)
    je, dino_params, te = _vits(BF16)
    jcfg = jsos.SOSConfig(batch_size=B, patch_size=P, patch_stride=STRIDE, fix_backbone=True)
    app = jcorr.CorrelationLoss.from_params(APP, use_sim_matrix=True)
    geo = jcorr.GeoCorrelationLoss.from_params(GEO, use_sim_matrix=True)
    batch, key = _batch(0), jax.random.PRNGKey(7)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (_, want_m), grads = jax.jit(jax.value_and_grad(
        lambda p: jsos.sos_loss_fn(jnet, je, app, geo, jcfg, p, dino_params, jbatch, key,
                                   NEAR, FAR), has_aux=True))(params)

    tnet = TorchNet(TorchConfig(**NET, fused_field=True, frozen_backbone=True,
                                compute_dtype="bfloat16"))
    tnet.load_state_dict(tckpt.state_dict_from_jax_params(_np(params)))
    tstate.make_optimizer(tnet, 5e-4, fix_backbone=True)
    cfg = tsos.SOSConfig(batch_size=B, patch_size=P, patch_stride=STRIDE, fix_backbone=True)
    loss, m = tsos.sos_loss_fn(
        tnet, te, tcorr.CorrelationLoss.from_params(APP, use_sim_matrix=True),
        tcorr.GeoCorrelationLoss.from_params(GEO, use_sim_matrix=True), cfg,
        {k: torch.from_numpy(batch[k]) for k in ("rays", "target")}, NEAR, FAR,
        coords=torch.from_numpy(_app_coords(key)))
    for k in ("loss", "img0", "img1", "corr0", "corr1", "geo_corr0", "geo_corr1"):
        np.testing.assert_allclose(float(m[k].detach()), float(want_m[k]), rtol=5e-4, atol=1e-7,
                                   err_msg=k)
    assert abs(float(m["corr0"].detach())) > 0 and abs(float(m["geo_corr1"].detach())) > 0
    loss.backward()
    want = tckpt.state_dict_from_jax_params(_np(grads))
    for name, p in tnet.named_parameters():
        if "semantic_linear" in name:
            scale = float(want[name].abs().max())
            assert scale > 0 and float((p.grad - want[name]).abs().max()) <= 3e-3 * scale, name
        else:
            assert p.grad is None, name


# ----------------------------------------------------------------- the entry point

SOS_FLAGS = ["--data_type", "llff", "--N_samples", "4", "--N_importance", "4",
             "--netdepth", "5", "--netwidth", "16", "--netdepth_fine", "5",
             "--netwidth_fine", "16", "--multires", "4", "--multires_views", "2",
             "--raw_noise_std", "1.0", "--fast_mode", "--ray_chunk", "256",
             "--compute_dtype", "bfloat16"]
FROZEN = ["--patch_tune", "--batch_size", "2", "--patch_size", "8", "--patch_stride", "2",
          "--load_nostrict", "--use_dino", "--use_correlation", "--use_geoCorr",
          "--fix_backbone", "--sem_with_coord", "--use_sim_matrix", "--app_corr_params", "0.18",
          "1", "0.46", "1", "--geo_corr_params", "0.5", "1", "3", "1", "--i_print", "2",
          "--i_weights", "2", "--i_testset", "2", "--use_masks"]


@pytest.fixture
def patch_scene(tmp_path):
    """A 1-view 6x8 test split and 3 train views of 24x32."""
    data = tmp_path / "data"
    write_sphere_scene(str(data), 6, 8, n_views=1, split="test")
    write_sphere_scene(str(data), 24, 32, n_views=3, split="train")
    return data


def _main(data, logs, expname, *extra):
    args, _ = run_nerf.create_arg_parser().parse_known_args(
        ["--expname", expname, "--basedir", str(logs), "--data_path", str(data), *SOS_FLAGS,
         *extra])
    run_nerf.main(args, device="cpu")
    return logs / expname


def test_run_nerf_bf16_eval_and_frozen_finetune(patch_scene, tmp_path, monkeypatch):
    """main at bf16: a frozen finetune from a float32 RGB checkpoint (its
    --i_testset view and final eval on K1/K2's bf16 plain versions, a bf16
    DINO), a resume of it, then --eval of its checkpoint; the kernels' bf16
    routes are the ones taken (their wrappers are called at bf16), the
    trunk stays bit-equal and the semantic head moves."""
    logs = tmp_path / "logs"
    args, _ = run_nerf.create_arg_parser().parse_known_args(
        ["--expname", "rgb", "--basedir", str(logs), "--data_path", str(patch_scene),
         *SOS_FLAGS[:-2], "--N_rand", "32", "--max_steps", "1"])
    run_nerf.main(args, device="cpu")  # the float32 RGB pretrain
    rgb_state = tckpt.load_checkpoint(str(logs / "rgb" / "checkpoints" / "last.ckpt"))[0]

    seen = []
    for name in ("fused_coarse_weights", "fused_render", "train_render", "frozen_sem_grads"):
        orig = getattr(tfr, name)

        def spy(*a, _orig=orig, _name=name, **kw):
            dtype = kw.get("compute_dtype", a[-1] if isinstance(a[-1], torch.dtype) else None)
            seen.append((_name, dtype))
            return _orig(*a, **kw)
        monkeypatch.setattr(tfr, name, spy)
    dinos = []
    orig_dino = run_nerf.build_dino
    monkeypatch.setattr(run_nerf, "build_dino",
                        lambda *a: dinos.append(orig_dino(*a)) or dinos[-1])

    ckpt = str(logs / "rgb" / "checkpoints" / "last.ckpt")
    run = _main(patch_scene, logs, "sos", *FROZEN, "--ckpt_path", ckpt, "--max_steps", "2")
    assert dinos[0].vit.dtype == BF16
    assert {n for n, d in seen} == {"fused_coarse_weights", "fused_render", "train_render",
                                    "frozen_sem_grads"}
    assert all(d == BF16 for _, d in seen)
    state, gstep, opt_state = tckpt.load_checkpoint(str(run / "checkpoints" / "last.ckpt"))
    assert gstep == 2 and len(opt_state["state"]) == 8
    for k, v in state.items():
        if "semantic_linear" in k:
            assert not torch.equal(v, rgb_state[k]) if k in rgb_state else True
        else:
            assert torch.equal(v, rgb_state[k]), k
    assert (run / "testset_00000002").exists() and (run / "eval").exists()

    run = _main(patch_scene, logs, "sos", *FROZEN, "--max_steps", "3")  # resume at step 2
    _, gstep, opt_state = tckpt.load_checkpoint(str(run / "checkpoints" / "last.ckpt"))
    assert gstep == 3 and len(opt_state["state"]) == 8

    seen.clear()
    _main(patch_scene, logs, "sos", "--eval", "--sem_with_coord")
    assert {n for n, _ in seen} == {"fused_coarse_weights", "fused_render"}
    assert all(d == BF16 for _, d in seen)


@pytest.mark.parametrize("flags", [
    [],  # the RGB pretrain (K3)
    ["--patch_tune", "--batch_size", "2", "--patch_size", "8", "--patch_stride", "2",
     "--use_dino", "--use_geoCorr"],  # the full SOS finetune (K6)
    ["--mipnerf", "--eval_vol"],  # mip-NeRF (K9, K10a, K10b; K11 for the export)
    ["--N_importance", "0", "--eval"],  # a net with no fine pass (K8d)
    ["--N_importance", "0"],  # its training (K8d, K8f)
    ["--eval_vol"],  # the classic export (K8b)
])
def test_bf16_runs_the_rgb_and_full_sos_routes(tmp_path, flags):
    """The RGB pretrain, the full SOS finetune, --mipnerf, a net with no fine
    pass and the classic --eval_vol, each refused at bf16 until its kernels
    had their bf16 modes, pass the entry now: main goes on to load the
    (missing) data (the run directory exists: --eval reads a trained one)."""
    args, _ = run_nerf.create_arg_parser().parse_known_args(
        ["--expname", "x", "--basedir", str(tmp_path / "logs"), "--data_path",
         str(tmp_path / "missing"), *SOS_FLAGS, *flags])
    (tmp_path / "logs" / "x").mkdir(parents=True)
    with pytest.raises(FileNotFoundError, match="missing"):
        run_nerf.main(args, device="cpu")


def test_bf16_rgb_step_runs_on_the_eager_field(patch_scene, tmp_path):
    """--no_fused_field at bf16: the RGB train step on flax-semantics bf16
    layers (autograd through bf16), a finite loss and moved weights."""
    run = _main(patch_scene, tmp_path / "logs", "eager", "--no_fused_field", "--N_rand", "32",
                "--max_steps", "1")
    state, gstep, _ = tckpt.load_checkpoint(str(run / "checkpoints" / "last.ckpt"))
    assert gstep == 1 and all(torch.isfinite(v).all() for v in state.values())


def test_k10b_bf16_wrapper_runs_on_the_cpu():
    """K10b (the mip backward), refused at bf16 until it had its bf16 mode,
    runs at bf16 now: on CPU tensors its wrapper is its bf16 plain version
    (K6's bf16 sweep on the mip forward) and counts no launch, and it lies
    far from the float32 version (tests/test_torch_mip_bf16.py holds it
    against JAX)."""
    from nerfsos_torch.models.fields import MipNeRFField

    rng = np.random.default_rng(0)
    torch.manual_seed(0)
    field = MipNeRFField(net_depth=5, net_width=16, multires=4, multires_views=2)
    odvr = torch.from_numpy(rng.normal(size=(4, 10)).astype(np.float32))
    z = torch.from_numpy(np.sort(rng.uniform(1, 4, (4, 9)), 1).astype(np.float32))
    dmaps = torch.from_numpy(rng.normal(size=(4, 5)).astype(np.float32))
    kw = dict(noise_std=1.0, seed=3)
    counts = (tfr.mip_train_render_grads.launches, tfr.mip_train_render_grads.launches_bf16)
    got = tfr.mip_train_render_grads(field, odvr, z, dmaps, None, compute_dtype=BF16, **kw)
    want = tfr.mip_train_render_grads_plain(field, odvr, z, dmaps, None, compute_dtype=BF16,
                                            **kw)
    got32 = tfr.mip_train_render_grads(field, odvr, z, dmaps, None, **kw)
    assert counts == (tfr.mip_train_render_grads.launches,
                      tfr.mip_train_render_grads.launches_bf16)
    assert set(got) == {n for n, _ in field.named_parameters()}
    assert all(torch.equal(got[k], want[k]) for k in got)
    assert max(float((got[k] - got32[k]).abs().max()) for k in got) > 1e-3
