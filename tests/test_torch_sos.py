"""The port's SOS finetune vs nerfsos_tpu's, on tiny inputs (CPU): the ViT
(its position-embedding resize too) and the photometric stand-in with
carried weights, the correlation losses (single, pair and quad forms, the
negatives), the whole ``sos_loss_fn`` and one train step with a frozen
backbone, with the whole network trained, with random negatives and
without the similarity-matrix flag, the patch sampler, the train-time ARI,
and ``run_nerf.main`` in every ``--patch_tune`` mode from an RGB checkpoint.

The JAX side's Pallas kernels run in interpret mode (the fused train render
K4/K5 of the frozen step, and K7 at 16 x 16 = 256 pixels a patch, a multiple
of 128; at the whole-loss tests' 8 x 8 patches its geometry loss takes its
XLA path). The other steps' JAX side renders without its fused kernels (the
port's fused path, the kernels' plain versions, is held to it); K6's plain
version is held to its Pallas kernel in tests/test_torch_sos_kernels.py.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsos_torch import run_nerf
from nerfsos_torch.data.datasets import PatchDataset
from nerfsos_torch.data.synthetic import write_sphere_scene
from nerfsos_torch.engines import checkpoint as tckpt
from nerfsos_torch.engines import sos as tsos
from nerfsos_torch.engines import state as tstate
from nerfsos_torch.losses import correlation as tcorr
from nerfsos_torch.models import extractor as text
from nerfsos_torch.models.nerf import NeRFConfig as TorchConfig
from nerfsos_torch.models.nerf import NeRFNet as TorchNet
from nerfsos_torch.models.vit import VisionTransformer as TorchViT
from nerfsos_tpu.data.datasets import PatchDataset as JaxPatchDataset
from nerfsos_tpu.engines import sos as jsos
from nerfsos_tpu.engines import state as jstate
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


B, P, STRIDE = 2, 8, 2
NEAR, FAR = 2.0, 6.0
NET = dict(netwidth=16, netdepth=5, netwidth_fine=16, netdepth_fine=5, n_samples=4,
           n_importance=4, multires=4, multires_views=2, use_semantics=True,
           sem_with_coord=True, perturb=0.0, raw_noise_std=0.0, ray_block=B * P * P)
APP, GEO = [0.18, 1, 0.46, 1], [0.5, 1, 3, 1]
LR = 5e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _vits():
    """The small ViT of tests/test_sos.py in both packages, same weights."""
    je = jext.VitExtractor("dino_vits16")
    je.vit = jvit.VisionTransformer(patch_size=16, embed_dim=32, depth=2, num_heads=2,
                                    pos_embed_size=224)
    dino_params = je.init(jax.random.PRNGKey(1))
    te = text.VitExtractor(vit=TorchViT(patch_size=16, embed_dim=32, depth=2, num_heads=2))
    te.vit.load_state_dict(tckpt.vit_state_dict_from_jax_params(_np(dino_params)))
    return je, dino_params, te


def _batch(seed):
    """Rays from a sphere of radius 4 towards the origin, RGB targets, masks."""
    rng = np.random.default_rng(seed)
    n = B * P * P
    o = rng.normal(size=(n, 3))
    o = 4.0 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = -o / 4.0 + 0.15 * rng.normal(size=(n, 3))
    return {"rays": np.stack([o, d]).astype(np.float32),
            "target": rng.uniform(0, 1, (n, 3)).astype(np.float32),
            "masks": (rng.uniform(size=(n, 1)) > 0.5).astype(np.int32)}


def _app_coords(key, feature_samples=11):
    """The coordinates JAX's sos_loss_fn draws for the appearance loss
    (engines/sos.py:163, :244-251), in the order of draw_pair_coords."""
    _, k_app0, k_app1, _, _ = jax.random.split(key, 5)
    k1a, k2a, _ = jax.random.split(k_app0, 3)
    k1b, k2b, _ = jax.random.split(k_app1, 3)
    shape = (B, feature_samples, feature_samples, 2)
    return np.concatenate([np.asarray(jax.random.uniform(k, shape) * 2.0 - 1.0)
                           for k in (k1a, k1b, k2a, k2b)])


@pytest.fixture(scope="module")
def sos_pair():
    """Both packages' SOS setups, JAX's loss, metrics and gradients, and its
    post-Adam params (make_optimizer(fix_backbone=True)), on one batch."""
    old = jfr.TRAIN_RAY_BLOCK
    jfr.TRAIN_RAY_BLOCK = 128  # few interpret-mode grid steps
    try:
        jnet = JaxNet(JaxConfig(**NET, fused_field=True))
        params = jnet.init(jax.random.PRNGKey(0))
        je, dino_params, te = _vits()
        cfg = jsos.SOSConfig(batch_size=B, patch_size=P, patch_stride=STRIDE, fix_backbone=True)
        app = jcorr.CorrelationLoss.from_params(APP, use_sim_matrix=True)
        geo = jcorr.GeoCorrelationLoss.from_params(GEO, use_sim_matrix=True)
        batch, key = _batch(0), jax.random.PRNGKey(7)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        (_, metrics), grads = jax.value_and_grad(
            lambda p: jsos.sos_loss_fn(jnet, je, app, geo, cfg, p, dino_params, jbatch, key,
                                       NEAR, FAR), has_aux=True)(params)
        tx = jstate.make_optimizer(LR, 0.1, 250_000, fix_backbone=True, params=params)
        state = jstate.TrainState.create(params, tx).apply_gradients(grads)
    finally:
        jfr.TRAIN_RAY_BLOCK = old
    return {"params": _np(params), "te": te, "batch": batch, "key": key,
            "metrics": {k: float(v) for k, v in metrics.items()}, "grads": _np(grads),
            "stepped": _np(state.params)}


def _torch_setup(pair, fused=True):
    tnet = TorchNet(TorchConfig(**NET, fused_field=fused, frozen_backbone=fused))
    tnet.load_state_dict(tckpt.state_dict_from_jax_params(pair["params"]))
    cfg = tsos.SOSConfig(batch_size=B, patch_size=P, patch_stride=STRIDE, fix_backbone=True)
    app = tcorr.CorrelationLoss.from_params(APP, use_sim_matrix=True)
    geo = tcorr.GeoCorrelationLoss.from_params(GEO, use_sim_matrix=True)
    batch = {k: torch.from_numpy(pair["batch"][k]) for k in ("rays", "target")}
    return tnet, cfg, app, geo, batch


TERMS = ("loss", "img0", "img1", "psnr", "psnr0", "corr0", "corr1", "geo_corr0", "geo_corr1",
         "contrast", "sem0", "sem1")


@pytest.mark.parametrize("fused", [True, False])
def test_sos_loss_matches_jax(sos_pair, fused):
    """Every term to 1e-5 relative; the semantic head's grads to 1e-4 of each
    leaf's max; with the fused render (K4/K5's plain versions) the trunk gets
    no gradient at all."""
    tnet, cfg, app, geo, batch = _torch_setup(sos_pair, fused)
    opt = tstate.make_optimizer(tnet, LR, fix_backbone=True)
    assert len(opt.param_groups[0]["params"]) == 8  # sem_0, sem_1 of both fields
    coords = torch.from_numpy(_app_coords(sos_pair["key"]))
    loss, m = tsos.sos_loss_fn(tnet, sos_pair["te"], app, geo, cfg, batch, NEAR, FAR,
                               coords=coords)
    for k in TERMS:
        np.testing.assert_allclose(float(m[k]), sos_pair["metrics"][k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    assert abs(float(m["corr0"])) > 0 and abs(float(m["geo_corr1"])) > 0
    loss.backward()
    want = tckpt.state_dict_from_jax_params(sos_pair["grads"])
    for name, p in tnet.named_parameters():
        if "semantic_linear" in name:
            scale = float(want[name].abs().max())
            assert scale > 0 and float((p.grad - want[name]).abs().max()) <= 1e-4 * scale, name
        else:
            assert p.grad is None, name


def test_sos_step_matches_jax(sos_pair, monkeypatch):
    """One make_sos_train_step step: the semantic head after Adam within 1e-6
    of the JAX step's; every trunk leaf bit-equal to its start."""
    tnet, cfg, app, geo, batch = _torch_setup(sos_pair)
    coords = torch.from_numpy(_app_coords(sos_pair["key"]))
    monkeypatch.setattr(tsos, "draw_pair_coords", lambda *a: coords)
    before = {n: p.detach().clone() for n, p in tnet.named_parameters()}
    opt = tstate.make_optimizer(tnet, LR, fix_backbone=True)
    step = tsos.make_sos_train_step(tnet, sos_pair["te"], app, geo, cfg, opt,
                                    tstate.exp_decay_schedule(LR, 0.1, 250_000), NEAR, FAR)
    m = step(batch, 0)
    np.testing.assert_allclose(float(m["loss"]), sos_pair["metrics"]["loss"], rtol=1e-5)
    want = tckpt.state_dict_from_jax_params(sos_pair["stepped"])
    for name, p in tnet.named_parameters():
        if "semantic_linear" in name:
            assert not torch.equal(p.detach(), before[name]), name
            assert float((p.detach() - want[name]).abs().max()) <= 1e-6, name
        else:
            assert torch.equal(p.detach(), before[name]), name


# the other --patch_tune modes: (fix_backbone, use_sim_matrix, rand_neg)
MODES = {"full": (False, True, False), "rand_neg": (True, True, True),
         "no_sim_matrix": (True, False, False)}


def _jax_negatives(key):
    """The negatives JAX's rand_neg step draws (engines/sos.py:163, :204-229),
    in draw_negatives' order: the appearance loss's coarse and fine heads'
    (the third of each key's three splits), then the geometry loss's."""
    _, k_app0, k_app1, k_geo0, k_geo1 = jax.random.split(key, 5)
    return np.stack([np.asarray(jax.random.permutation(jax.random.split(k, 3)[2], B))
                     for k in (k_app0, k_app1)]
                    + [np.asarray(jax.random.permutation(k, B)) for k in (k_geo0, k_geo1)])


@pytest.fixture(scope="module", params=list(MODES))
def mode_pair(request):
    """JAX's loss, metrics, gradients and post-Adam params for one more
    mode on the batch of ``sos_pair`` (its render without the fused
    kernels; noise 0 and perturb 0, so the step is deterministic)."""
    fix, sim, rand = MODES[request.param]
    jnet = JaxNet(JaxConfig(**NET))
    params = jnet.init(jax.random.PRNGKey(0))
    je, dino_params, te = _vits()
    cfg = jsos.SOSConfig(batch_size=B, patch_size=P, patch_stride=STRIDE, fix_backbone=fix)
    app = jcorr.CorrelationLoss.from_params(APP, use_sim_matrix=sim, rand_neg=rand)
    geo = jcorr.GeoCorrelationLoss.from_params(GEO, use_sim_matrix=sim, rand_neg=rand)
    batch, key = _batch(0), jax.random.PRNGKey(7)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (_, metrics), grads = jax.value_and_grad(
        lambda p: jsos.sos_loss_fn(jnet, je, app, geo, cfg, p, dino_params, jbatch, key,
                                   NEAR, FAR), has_aux=True)(params)
    tx = jstate.make_optimizer(LR, 0.1, 250_000, fix_backbone=fix, params=params)
    state = jstate.TrainState.create(params, tx).apply_gradients(grads)
    return {"mode": request.param, "params": _np(params), "te": te, "batch": batch, "key": key,
            "metrics": {k: float(v) for k, v in metrics.items()}, "grads": _np(grads),
            "stepped": _np(state.params),
            "negatives": torch.from_numpy(_jax_negatives(key)) if rand else None}


def _mode_setup(pair):
    fix, sim, rand = MODES[pair["mode"]]
    tnet = TorchNet(TorchConfig(**NET, fused_field=True, frozen_backbone=fix))
    tnet.load_state_dict(tckpt.state_dict_from_jax_params(pair["params"]))
    cfg = tsos.SOSConfig(batch_size=B, patch_size=P, patch_stride=STRIDE, fix_backbone=fix)
    app = tcorr.CorrelationLoss.from_params(APP, use_sim_matrix=sim, rand_neg=rand)
    geo = tcorr.GeoCorrelationLoss.from_params(GEO, use_sim_matrix=sim, rand_neg=rand)
    batch = {k: torch.from_numpy(pair["batch"][k]) for k in ("rays", "target")}
    return tnet, cfg, app, geo, batch


def test_sos_mode_loss_matches_jax(mode_pair):
    """The whole network trained (the fused render's backward K6's plain
    version), random negatives, and no --use_sim_matrix: every term to 1e-5
    relative and every trained leaf's gradient to 1e-4 of its max, with
    JAX's coordinates and negatives injected; frozen leaves get none."""
    tnet, cfg, app, geo, batch = _mode_setup(mode_pair)
    coords = torch.from_numpy(_app_coords(mode_pair["key"]))
    loss, m = tsos.sos_loss_fn(tnet, mode_pair["te"], app, geo, cfg, batch, NEAR, FAR,
                               coords=coords, negatives=mode_pair["negatives"])
    for k in TERMS:
        np.testing.assert_allclose(float(m[k]), mode_pair["metrics"][k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    assert abs(float(m["corr0"])) > 0 and abs(float(m["geo_corr0"])) > 0
    loss.backward()
    want = tckpt.state_dict_from_jax_params(mode_pair["grads"])
    for name, p in tnet.named_parameters():
        if cfg.fix_backbone and "semantic_linear" not in name:
            assert p.grad is None, name
            continue
        scale = float(want[name].abs().max())
        assert scale > 0 and float((p.grad - want[name]).abs().max()) <= 1e-4 * scale, name


def test_sos_mode_step_matches_jax(mode_pair, monkeypatch):
    """One make_sos_train_step step of each mode, the draws JAX made
    injected: every trained leaf after Adam within 1e-6 of the JAX step's
    and moved; every frozen leaf bit-equal to its start."""
    tnet, cfg, app, geo, batch = _mode_setup(mode_pair)
    coords = torch.from_numpy(_app_coords(mode_pair["key"]))
    monkeypatch.setattr(tsos, "draw_pair_coords", lambda *a: coords)
    monkeypatch.setattr(tsos, "draw_negatives", lambda *a: mode_pair["negatives"])
    before = {n: p.detach().clone() for n, p in tnet.named_parameters()}
    opt = tstate.make_optimizer(tnet, LR, fix_backbone=cfg.fix_backbone)
    step = tsos.make_sos_train_step(tnet, mode_pair["te"], app, geo, cfg, opt,
                                    tstate.exp_decay_schedule(LR, 0.1, 250_000), NEAR, FAR)
    m = step(batch, 0)
    np.testing.assert_allclose(float(m["loss"]), mode_pair["metrics"]["loss"], rtol=1e-5)
    want = tckpt.state_dict_from_jax_params(mode_pair["stepped"])
    for name, p in tnet.named_parameters():
        if cfg.fix_backbone and "semantic_linear" not in name:
            assert torch.equal(p.detach(), before[name]), name
        else:
            assert not torch.equal(p.detach(), before[name]), name
            assert float((p.detach() - want[name]).abs().max()) <= 1e-6, name


def test_sos_loss_needs_a_matching_frozen_flag(sos_pair):
    tnet, cfg, app, geo, batch = _torch_setup(sos_pair)
    unfrozen = TorchNet(TorchConfig(**NET, fused_field=True))
    with pytest.raises(ValueError, match="frozen_backbone"):
        tsos.sos_loss_fn(unfrozen, sos_pair["te"], app, geo, cfg, batch, NEAR, FAR)


def test_vit_extractor_matches_jax():
    je, dino_params, te = _vits()
    x = np.random.default_rng(0).uniform(size=(2, 40, 48, 3)).astype(np.float32)
    want = je.get_vit_attn_feat(jnp.asarray(x), params=dino_params)
    got = te.get_vit_attn_feat(torch.from_numpy(x))
    for k in ("attn", "cls_", "feat"):
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("w,h", [(10, 10), (20, 20), (12, 18)])
def test_vit_pos_embed_resize_matches_jax(w, h):
    """The 14 x 14 position embedding resized for another input side as
    jax.image.resize(method="bicubic") does (antialiased when it shrinks)."""
    vit = TorchViT(patch_size=16, embed_dim=32, depth=1, num_heads=2)
    pe = vit.pos_embed.detach().numpy()
    got = vit.interpolate_pos_encoding(w * h, 16 * w, 16 * h).detach().numpy()
    want = jax.image.resize(jnp.asarray(pe[:, 1:]).reshape(1, 14, 14, 32), (1, w, h, 32),
                            method="bicubic")
    assert got.shape == (1, 1 + w * h, 32)
    np.testing.assert_allclose(got[:, 1:], np.asarray(want).reshape(1, -1, 32), rtol=0,
                               atol=1e-5 * np.abs(pe).max())
    np.testing.assert_array_equal(got[:, :1], pe[:, :1])


def test_vit_state_dict_round_trips_the_reference_names():
    _, dino_params, te = _vits()
    sd = te.vit.state_dict()
    back = jvit.torch_vit_state_to_flax({k: v.numpy() for k, v in sd.items()}, depth=2)
    for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(back)[0],
                                 jax.tree_util.tree_flatten_with_path(_np(dino_params))[0]):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))


def test_seeded_vit_draws_as_the_jax_vit():
    """A fresh ViT draws its weights by the JAX package's law, JAX's drawn
    beside: flax's default (lecun normal: a normal cut at 2 sigma, variance
    1 / fan_in, a zero bias) for every Dense and the patch convolution
    (fan_in 3 x 16 x 16), truncated_normal(0.02) for the two embeddings,
    LayerNorms at one and zero."""
    import math

    je = jext.VitExtractor("dino_vits16")
    je.vit = jvit.VisionTransformer(patch_size=16, embed_dim=64, depth=2, num_heads=2,
                                    pos_embed_size=224)
    want = tckpt.vit_state_dict_from_jax_params(_np(je.init(jax.random.PRNGKey(3))))
    torch.manual_seed(3)
    got = TorchViT(patch_size=16, embed_dim=64, depth=2, num_heads=2).state_dict()
    assert got.keys() == want.keys()
    for k, v in got.items():
        w = want[k]
        assert v.shape == w.shape, k
        if "norm" in k:
            fill = 1.0 if k.endswith("weight") else 0.0
            assert bool((v == fill).all()) and bool((w == fill).all()), k
            continue
        if k.endswith("bias"):
            assert not v.any() and not w.any(), k
            continue
        # scale: the multiplier of a standard normal cut at +-2, whose std is 0.8796...
        trunc_std = 0.87962566103423978
        embed = k in ("cls_token", "pos_embed")
        scale = 0.02 if embed else math.sqrt(1.0 / v[0].numel()) / trunc_std
        n = v.numel()
        for x in (v, w):
            assert float(x.abs().max()) <= 2 * scale * (1 + 1e-6), k
            # the std of n draws: within 6 of its standard errors of the law's
            assert abs(float(x.std()) / (scale * trunc_std) - 1) < 6 / math.sqrt(n) + 0.02, k


def test_synthetic_extractor_matches_jax():
    je = jext.SyntheticExtractor(embed_dim=24)
    te = text.SyntheticExtractor(embed_dim=24,
                                 proj=tckpt.synthetic_params_from_jax(_np(je.params)))
    x = np.random.default_rng(2).uniform(size=(3, 24, 40, 3)).astype(np.float32)
    want, got = je.get_vit_attn_feat(jnp.asarray(x)), te.get_vit_attn_feat(torch.from_numpy(x))
    for k in ("attn", "cls_", "feat"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    assert text.synthetic_projection(24).shape == (6, 24)


def _codes(rng, n, s=2, p=16):
    return [rng.normal(size=(n, s, p, p)).astype(np.float32) for _ in range(2)]


def test_appearance_pair_heads_matches_jax():
    """Both heads' appearance losses from the same coordinates and features;
    the codes' gradients of their sum."""
    rng = np.random.default_rng(3)
    feats = rng.normal(size=(3, 8, 5, 5)).astype(np.float32)
    c0, c1 = _codes(rng, 3)
    sim = np.asarray(jcorr.get_similarity_matrix(jnp.asarray(rng.normal(size=(3, 8)))))
    key0, key1 = jax.random.PRNGKey(11), jax.random.PRNGKey(12)
    japp = jcorr.CorrelationLoss.from_params(APP, use_sim_matrix=True)
    (want, (g0, g1)) = jax.value_and_grad(
        lambda a, b: sum(japp.pair_heads(key0, key1, jnp.asarray(feats), a, b, jnp.asarray(sim))),
        argnums=(0, 1))(jnp.asarray(c0), jnp.asarray(c1))
    shape = (3, 11, 11, 2)
    keys = [k for kk in (key0, key1) for k in jax.random.split(kk, 3)[:2]]
    coords = np.concatenate([np.asarray(jax.random.uniform(k, shape) * 2.0 - 1.0)
                             for k in (keys[0], keys[2], keys[1], keys[3])])
    tapp = tcorr.CorrelationLoss.from_params(APP, use_sim_matrix=True)
    t0, t1 = (torch.from_numpy(c).requires_grad_() for c in (c0, c1))
    got = sum(tapp.pair_heads(torch.from_numpy(coords), torch.from_numpy(feats), t0, t1,
                              torch.from_numpy(sim)))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    got.backward()
    for t, g in ((t0, g0), (t1, g1)):
        g = np.asarray(g)
        assert np.abs(t.grad.numpy() - g).max() <= 1e-5 * np.abs(g).max()


def test_geometry_quad_matches_jax():
    """The four geometry means (through K7's plain versions) and the codes'
    gradients, against the JAX loss (its flash kernels in interpret mode)."""
    rng = np.random.default_rng(4)
    pts = (2.0 * rng.normal(size=(2, 3, 16, 16))).astype(np.float32)  # 256 pixels a patch
    c0, c1 = _codes(rng, 2)
    neg = np.array([1, 0])
    jgeo = jcorr.GeoCorrelationLoss.from_params(GEO, use_sim_matrix=True)
    wts = np.array([1.0, -0.5, 2.0, 0.25], np.float32)

    def jloss(a, b):
        out = jnp.stack(jgeo.quad(jnp.asarray(pts), jnp.asarray(pts[neg]), a, a[neg], b, b[neg]))
        return jnp.sum(out * wts), out

    (_, want), (g0, g1) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(c0), jnp.asarray(c1))
    tgeo = tcorr.GeoCorrelationLoss.from_params(GEO, use_sim_matrix=True)
    t0, t1 = (torch.from_numpy(c).requires_grad_() for c in (c0, c1))
    tn = torch.from_numpy(neg)
    got = torch.stack(tgeo.quad(torch.from_numpy(pts), torch.from_numpy(pts[neg]), t0, t0[tn],
                                t1, t1[tn]))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5)
    torch.sum(got * torch.from_numpy(wts)).backward()
    for t, g in ((t0, g0), (t1, g1)):
        g = np.asarray(g)
        assert np.abs(t.grad.numpy() - g).max() <= 1e-5 * np.abs(g).max()


def test_appearance_single_matches_jax():
    """One head's appearance loss with random negatives (JAX's __call__ with
    rand_neg), its coordinates and negatives from JAX's key splits, and the
    code's gradient; __call__ draws the coordinates, then the negatives."""
    rng = np.random.default_rng(13)
    feats = rng.normal(size=(3, 8, 5, 5)).astype(np.float32)
    code = _codes(rng, 3)[0]
    key = jax.random.PRNGKey(21)
    japp = jcorr.CorrelationLoss.from_params(APP, rand_neg=True)
    want, g = jax.value_and_grad(lambda c: japp(key, jnp.asarray(feats), c, None))(
        jnp.asarray(code))
    k_c1, k_c2, k_neg = jax.random.split(key, 3)
    coords = np.concatenate([np.asarray(jax.random.uniform(k, (3, 11, 11, 2)) * 2.0 - 1.0)
                             for k in (k_c1, k_c2)])
    neg = torch.from_numpy(np.asarray(jax.random.permutation(k_neg, 3)))
    tapp = tcorr.CorrelationLoss.from_params(APP, rand_neg=True)
    t = torch.from_numpy(code).requires_grad_()
    got = tapp.single(torch.from_numpy(coords), neg, torch.from_numpy(feats), t)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    got.backward()
    assert np.abs(t.grad.numpy() - np.asarray(g)).max() <= 1e-5 * np.abs(np.asarray(g)).max()
    drawn = tapp(torch.Generator().manual_seed(5), torch.from_numpy(feats), t, None)
    gen = torch.Generator().manual_seed(5)
    replay = torch.rand((6, 11, 11, 2), generator=gen) * 2.0 - 1.0
    assert torch.equal(drawn, tapp.single(replay, torch.randperm(3, generator=gen),
                                          torch.from_numpy(feats), t))


def test_geometry_single_and_pair_match_jax():
    """GeoCorrelationLoss.__call__ with random negatives (the single-head
    means, K7b/K7c's plain versions), .pair with the similarity matrix (the
    quad means) and .helper_mean_pair (K7d/K7e's) against the JAX loss, its
    flash kernels in interpret mode at 16 x 16 pixels; the codes' gradients."""
    rng = np.random.default_rng(14)
    depth = rng.uniform(2.0, 20.0, size=(2, 1, 16, 16)).astype(np.float32)  # some over max_depth
    o = rng.normal(size=(2, 3, 16, 16)).astype(np.float32)
    d = rng.normal(size=(2, 3, 16, 16)).astype(np.float32)
    c0, c1 = _codes(rng, 2)
    sim = np.asarray(jcorr.get_similarity_matrix(jnp.asarray(rng.normal(size=(2, 8)))))
    key = jax.random.PRNGKey(31)
    jrand = jcorr.GeoCorrelationLoss.from_params(GEO, rand_neg=True)
    jsim = jcorr.GeoCorrelationLoss.from_params(GEO, use_sim_matrix=True)
    rays = (jnp.asarray(o), jnp.asarray(d))
    pts = np.asarray(jsim._filtered_points(jnp.asarray(depth), rays))
    flip = np.array([1, 0])

    def jloss(a, b):
        single = jrand(key, jnp.asarray(depth), a, rays, None)
        pair = jsim.pair(key, key, jnp.asarray(depth), a, b, rays, jnp.asarray(sim))
        hpair = jsim.helper_mean_pair(jnp.asarray(pts), jnp.asarray(pts[flip]), a, a[flip], b,
                                      b[flip], 3.0)
        out = jnp.stack([single, *pair, *hpair])
        return jnp.sum(out * jnp.arange(1.0, 6.0)), out

    (_, want), grads = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(c0), jnp.asarray(c1))
    trand = tcorr.GeoCorrelationLoss.from_params(GEO, rand_neg=True)
    tsim = tcorr.GeoCorrelationLoss.from_params(GEO, use_sim_matrix=True)
    t0, t1 = (torch.from_numpy(c).requires_grad_() for c in (c0, c1))
    tpts, tf = tsim._filtered_points(*(torch.from_numpy(a) for a in (depth, o, d))), flip
    np.testing.assert_allclose(tpts.numpy(), pts, rtol=1e-6, atol=1e-6)
    neg = torch.from_numpy(np.asarray(jax.random.permutation(key, 2)))
    got = torch.stack([trand.single(tpts, t0, neg),
                       *tsim.pair(None, *(torch.from_numpy(depth),), t0, t1,
                                  torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(sim)),
                       *tsim.helper_mean_pair(tpts, tpts[tf], t0, t0[tf], t1, t1[tf], 3.0)])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5)
    torch.sum(got * torch.arange(1.0, 6.0)).backward()
    for t, g in zip((t0, t1), grads):
        g = np.asarray(g)
        assert np.abs(t.grad.numpy() - g).max() <= 1e-5 * np.abs(g).max()


def test_filtered_points_take_the_batch_max_under():
    depth = torch.tensor([[[[1.0, 20.0]]], [[[7.0, 16.0]]]])  # [2, 1, 1, 2]
    o, d = torch.zeros(2, 3, 1, 2), torch.ones(2, 3, 1, 2)
    pts = tcorr.GeoCorrelationLoss(max_depth=15.0)._filtered_points(depth, o, d)
    assert pts[:, 0].flatten().tolist() == [1.0, 7.0, 7.0, 7.0]


def test_nerf_contrastive_and_similarity_match_jax():
    e = np.random.default_rng(5).normal(size=(4, 16)).astype(np.float32)
    np.testing.assert_allclose(float(tcorr.nerf_contrastive(torch.from_numpy(e))),
                               float(jcorr.nerf_contrastive(jnp.asarray(e))), rtol=1e-5)
    np.testing.assert_allclose(tcorr.get_similarity_matrix(torch.from_numpy(e)).numpy(),
                               np.asarray(jcorr.get_similarity_matrix(jnp.asarray(e))),
                               rtol=1e-5, atol=1e-6)
    perm = tcorr.super_perm(torch.Generator().manual_seed(0), 7)  # the reference's rule
    assert not (perm == torch.arange(7)).any() and ((0 <= perm) & (perm < 7)).all()


def test_random_negatives_are_not_ported():
    """The negatives: rand_neg a permutation from the generator, no
    similarity matrix a permutation without fixed points, else the argmin
    (whatever use_sim_matrix says, as in the JAX step)."""
    sim = torch.tensor([[1.0, 0.2, 0.5], [0.2, 1.0, -0.3], [0.5, -0.3, 1.0]])
    for loss in (tcorr.CorrelationLoss(rand_neg=True), tcorr.GeoCorrelationLoss(rand_neg=True)):
        draws = [loss.negative_index(torch.Generator().manual_seed(k), 9, sim[:1, :1])
                 for k in range(8)]
        assert all(sorted(d.tolist()) == list(range(9)) for d in draws)
        assert len({tuple(d.tolist()) for d in draws}) > 1
        again = loss.negative_index(torch.Generator().manual_seed(3), 9, None)
        assert torch.equal(again, draws[3])
    for loss in (tcorr.CorrelationLoss(), tcorr.GeoCorrelationLoss(use_sim_matrix=False)):
        perm = loss.negative_index(torch.Generator().manual_seed(1), 9, None)
        assert sorted(perm.tolist()) == list(range(9)) and not (perm == torch.arange(9)).any()
        assert loss.negative_index(None, 3, sim).tolist() == [1, 2, 1]


def test_dino_input_chain_matches_jax():
    x = np.random.default_rng(6).uniform(size=(2, 16, 16, 3)).astype(np.float32)
    j = jext.normalize_imagenet(jext.resize_nearest_torch(jnp.asarray(x), 96, 96))
    t = text.normalize_imagenet(text.resize_nearest_torch(torch.from_numpy(x), 96, 96))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-6)


@pytest.fixture
def patch_scene(tmp_path):
    """A 1-view 6x8 test split and 3 train views of 24x32 (crop 8 x 2 = 16)."""
    data = tmp_path / "data"
    write_sphere_scene(str(data), 6, 8, n_views=1, split="test")
    write_sphere_scene(str(data), 24, 32, n_views=3, split="train")
    return data


def test_patch_dataset_matches_jax(patch_scene):
    """Three batches of two (one crossing an epoch of the 3-view shuffle)
    from the same numpy rng: bit-equal rays, targets, masks, poses, starts."""
    tds = PatchDataset(str(patch_scene), patch_size=8, patch_stride=2, ret_k=True)
    jds = JaxPatchDataset(str(patch_scene), patch_size=8, patch_stride=2, ret_k=True)
    rt, rj = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(3):
        a, b = tds.sample_batch(rt, 2), jds.sample_batch(rj, 2)
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert a["rays"].shape == (2, 128, 3) and a["poses"].shape == (2, 3, 4)
    assert np.abs(a["poses"]).sum() > 0  # the scene's poses_train.npy
    with pytest.raises(ValueError, match="exceeds"):
        PatchDataset(str(patch_scene), patch_size=8, patch_stride=4)


@pytest.mark.parametrize("clus_no_sfm", [True, False])
def test_online_seg_metrics_matches_jax(clus_no_sfm):
    rng = np.random.default_rng(8)
    sem = rng.normal(size=(2 * 64, 2)).astype(np.float32)
    sem[: 64 // 2] += 3.0
    masks = (rng.uniform(size=(2 * 64, 1)) > 0.5).astype(np.int64)
    want = jsos.online_seg_metrics(jnp.asarray(sem), masks, 2, 8, clus_no_sfm=clus_no_sfm)
    firsts = [int(jax.random.randint(k, (), 0, 64)) for k in
              jax.random.split(jax.random.PRNGKey(0), 2)]
    got = tsos.online_seg_metrics(torch.from_numpy(sem), masks, 2, 8, clus_no_sfm=clus_no_sfm,
                                  firsts=np.array(firsts))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-9, err_msg=k)


def test_make_optimizer_fix_backbone_holds_the_head_alone():
    net = TorchNet(TorchConfig(**NET))
    opt = tstate.make_optimizer(net, 1e-3, fix_backbone=True)
    held = {id(p) for p in opt.param_groups[0]["params"]}
    for name, p in net.named_parameters():
        assert (id(p) in held) == ("semantic_linear" in name) == p.requires_grad, name
    assert len(tstate.make_optimizer(net, 1e-3).param_groups[0]["params"]) == len(
        list(net.parameters()))


SOS_FLAGS = ["--data_type", "llff", "--N_samples", "4", "--N_importance", "4",
             "--netdepth", "5", "--netwidth", "16", "--netdepth_fine", "5",
             "--netwidth_fine", "16", "--multires", "4", "--multires_views", "2",
             "--raw_noise_std", "1.0", "--fast_mode", "--ray_chunk", "256"]
PATCH_FLAGS = ["--patch_tune", "--batch_size", "2", "--patch_size", "8", "--patch_stride", "2",
               "--load_nostrict", "--sem_w", "0", "--use_dino", "--contrast_w", "0",
               "--use_correlation", "--use_geoCorr", "--fix_backbone", "--ret_cluster",
               "--clus_no_sfm", "--sem_with_coord", "--sem_dim", "2", "--use_sim_matrix",
               "--correlation_w", "1", "--Gcorrelation_w", "0.01", "--app_corr_params", "0.18",
               "1", "0.46", "1", "--geo_corr_params", "0.5", "1", "3", "1", "--i_print", "2",
               "--i_weights", "2", "--use_masks"]


def _main(data, logs, expname, *extra):
    args, _ = run_nerf.create_arg_parser().parse_known_args(
        ["--expname", expname, "--basedir", str(logs), "--data_path", str(data), *SOS_FLAGS,
         *extra])
    run_nerf.main(args, device="cpu")
    return logs / expname


def test_run_nerf_patch_tune_from_an_rgb_checkpoint(patch_scene, tmp_path, monkeypatch,
                                                    capsys):
    """The flagship finetune flags from an RGB checkpoint trained without
    --sem_with_coord: the SOS terms are finite and the correlation terms
    nonzero, the trunk stays bit-equal to the checkpoint's, the semantic
    head moves, the run logs the ARI, writes checkpoints and its final eval,
    and a second run resumes with the Adam state."""
    logs = tmp_path / "logs"
    rgb = _main(patch_scene, logs, "rgb", "--N_rand", "32", "--max_steps", "1")
    rgb_ckpt = str(rgb / "checkpoints" / "last.ckpt")
    rgb_state = tckpt.load_checkpoint(rgb_ckpt)[0]

    recorded = {"metrics": [], "start": None}
    orig = tsos.make_sos_train_step

    def recording(net, *a, **kw):
        step = orig(net, *a, **kw)
        recorded["start"] = recorded["start"] or {n: p.detach().clone()
                                                  for n, p in net.named_parameters()}

        def wrapped(batch, global_step):
            m = step(batch, global_step)
            recorded["metrics"].append((global_step, {k: float(v) for k, v in m.items()}))
            return m
        return wrapped

    monkeypatch.setattr(tsos, "make_sos_train_step", recording)
    run = _main(patch_scene, logs, "sos", *PATCH_FLAGS, "--ckpt_path", rgb_ckpt,
                "--max_steps", "3")
    out = capsys.readouterr().out
    assert "clus_ari:" in out and "L_geo_corr1:" in out and "No --dino_ckpt" in out
    assert [s for s, _ in recorded["metrics"]] == [1, 2]  # from the RGB run's step 1
    for _, m in recorded["metrics"]:
        assert all(np.isfinite(v) for v in m.values())
        assert m["corr0"] != 0 and m["corr1"] != 0 and m["geo_corr0"] != 0 and m["geo_corr1"] != 0
    assert {"00000002.ckpt", "latest.ckpt", "last.ckpt"} <= set(os.listdir(run / "checkpoints"))
    assert os.path.exists(run / "eval" / "log.json")
    state, gstep, opt_state = tckpt.load_checkpoint(str(run / "checkpoints" / "last.ckpt"))
    assert gstep == 3 and {int(s["step"]) for s in opt_state["state"].values()} == {2}
    assert len(opt_state["state"]) == 8
    for k, v in state.items():
        if "semantic_linear" in k:
            assert not torch.equal(v, recorded["start"][k]), k
        else:
            assert torch.equal(v, rgb_state[k]), k
    key = "nerf.mlp.semantic_linear.0.weight"  # [h; emb] here, h alone in the RGB run
    assert state[key].shape[1] > rgb_state[key].shape[1]

    resumed = _main(patch_scene, logs, "sos", *PATCH_FLAGS, "--max_steps", "4")
    assert [s for s, _ in recorded["metrics"]][2:] == [2, 3]  # from latest.ckpt (step 2)
    _, gstep, opt_state = tckpt.load_checkpoint(str(resumed / "checkpoints" / "last.ckpt"))
    assert gstep == 4 and {int(s["step"]) for s in opt_state["state"].values()} == {3}


def _rgb_checkpoint(scene, logs):
    """One RGB step without --sem_with_coord: its last.ckpt and state."""
    rgb = _main(scene, logs, "rgb", "--N_rand", "32", "--max_steps", "1")
    path = str(rgb / "checkpoints" / "last.ckpt")
    return path, tckpt.load_checkpoint(path)[0]


FULL_FLAGS = [f for f in PATCH_FLAGS if f != "--fix_backbone"]


def test_run_nerf_full_finetune_from_an_rgb_checkpoint(patch_scene, tmp_path):
    """The flagship finetune flags without --fix_backbone: every leaf trains
    (the trunk moves off the checkpoint's), Adam's state of every leaf is
    saved, and a second run resumes with it."""
    logs = tmp_path / "logs"
    rgb_ckpt, rgb_state = _rgb_checkpoint(patch_scene, logs)
    run = _main(patch_scene, logs, "full", *FULL_FLAGS, "--ckpt_path", rgb_ckpt,
                "--max_steps", "3")
    state, gstep, opt_state = tckpt.load_checkpoint(str(run / "checkpoints" / "last.ckpt"))
    assert gstep == 3 and len(opt_state["state"]) == len(state) == 44  # 22 leaves a field
    assert {int(s["step"]) for s in opt_state["state"].values()} == {2}
    for k, v in rgb_state.items():
        if "semantic_linear.0" not in k:  # sem_0 is fresh: its input width differs
            assert not torch.equal(state[k], v), k
    resumed = _main(patch_scene, logs, "full", *FULL_FLAGS, "--max_steps", "4")
    end, gstep, opt_state = tckpt.load_checkpoint(str(resumed / "checkpoints" / "last.ckpt"))
    assert gstep == 4 and len(opt_state["state"]) == 44
    assert {int(s["step"]) for s in opt_state["state"].values()} == {3}
    assert not torch.equal(end["nerf.mlp.pts_linears.0.weight"],
                           state["nerf.mlp.pts_linears.0.weight"])


def test_run_nerf_random_negatives(patch_scene, tmp_path, monkeypatch):
    """--rand_neg: each head of each loss takes its own draw of negatives
    and its single-head losses (the geometry loss's on K7b/K7c); every term
    is finite and the correlation terms nonzero."""
    logs = tmp_path / "logs"
    rgb_ckpt, _ = _rgb_checkpoint(patch_scene, logs)
    calls, metrics = [], []
    for cls in (tcorr.CorrelationLoss, tcorr.GeoCorrelationLoss):
        orig = cls.__dict__["single"]

        def single(self, *a, _orig=orig, _cls=cls):
            calls.append(_cls.__name__)
            return _orig(self, *a)
        monkeypatch.setattr(cls, "single", single)
    orig_step = tsos.make_sos_train_step

    def recording(*a, **kw):
        step = orig_step(*a, **kw)
        return lambda batch, k: metrics.append(step(batch, k)) or metrics[-1]
    monkeypatch.setattr(tsos, "make_sos_train_step", recording)
    _main(patch_scene, logs, "rand", *PATCH_FLAGS, "--rand_neg", "--ckpt_path", rgb_ckpt,
          "--max_steps", "3")
    assert len(metrics) == 2
    assert calls == ["CorrelationLoss", "CorrelationLoss", "GeoCorrelationLoss",
                     "GeoCorrelationLoss"] * 2
    for m in metrics:
        assert all(np.isfinite(float(v)) for v in m.values())
        assert all(float(m[k]) != 0 for k in ("corr0", "corr1", "geo_corr0", "geo_corr1"))


def test_run_nerf_patch_tune_without_the_sos_losses(patch_scene, tmp_path, monkeypatch,
                                                    capsys):
    """--patch_tune without the SOS losses: the RGB train step on patch
    batches (B P P rays), no DINO; without --fix_backbone the trunk moves."""
    logs = tmp_path / "logs"
    rgb_ckpt, rgb_state = _rgb_checkpoint(patch_scene, logs)
    from nerfsos_torch.engines import trainer

    rays = []
    orig = trainer.make_rgb_train_step

    def recording(*a, **kw):
        step = orig(*a, **kw)
        return lambda batch, k: rays.append(batch["rays"].shape) or step(batch, k)
    monkeypatch.setattr(trainer, "make_rgb_train_step", recording)
    run = _main(patch_scene, logs, "rgbpatch", "--patch_tune", "--batch_size", "2",
                "--patch_size", "8", "--patch_stride", "2", "--i_print", "2", "--i_weights", "2",
                "--ckpt_path", rgb_ckpt, "--max_steps", "3")
    assert rays == [(2, 2 * 8 * 8, 3)] * 2
    assert "dino" not in capsys.readouterr().out.lower()
    state, gstep, opt_state = tckpt.load_checkpoint(str(run / "checkpoints" / "last.ckpt"))
    assert gstep == 3 and len(opt_state["state"]) == len(state)
    assert not torch.equal(state["nerf.mlp.pts_linears.0.weight"],
                           rgb_state["nerf.mlp.pts_linears.0.weight"])


@pytest.mark.parametrize("flags,leaves", [
    (["--patch_tune", "--use_dino", "--use_correlation", "--use_sim_matrix"], 44),
    (["--patch_tune", "--fix_backbone", "--use_dino", "--use_geoCorr"], 8),
    (["--patch_tune", "--fix_backbone", "--use_dino", "--use_geoCorr", "--use_sim_matrix",
      "--rand_neg"], 8),
    (["--patch_tune", "--fix_backbone"], 8),
    (["--patch_tune", "--fix_backbone", "--use_correlation"], None),
])
def test_unported_patch_tune_modes_exit(patch_scene, tmp_path, flags, leaves):
    """Every --patch_tune mode runs a step from a fresh model (the whole
    network without --fix_backbone, a geometry loss without the similarity
    matrix flag, random negatives, no SOS losses), Adam holding ``leaves``
    leaves; the SOS losses without --use_dino still stop."""
    argv = ["--expname", "x", "--basedir", str(tmp_path / "logs"), "--data_path",
            str(patch_scene), *SOS_FLAGS, *flags, "--batch_size", "2", "--patch_size", "8",
            "--patch_stride", "2", "--sem_with_coord", "--max_steps", "1", "--i_weights", "1"]
    args, _ = run_nerf.create_arg_parser().parse_known_args(argv)
    if leaves is None:
        with pytest.raises(SystemExit, match="require --use_dino"):
            run_nerf.main(args, device="cpu")
        return
    run_nerf.main(args, device="cpu")
    _, gstep, opt_state = tckpt.load_checkpoint(str(tmp_path / "logs" / "x" / "checkpoints" /
                                                    "last.ckpt"))
    assert gstep == 1 and len(opt_state["state"]) == leaves


def test_make_optimizer_full_finetune_unfreezes():
    """A module a --fix_backbone optimizer froze trains whole again under an
    optimizer without it."""
    net = TorchNet(TorchConfig(**NET))
    tstate.make_optimizer(net, 1e-3, fix_backbone=True)
    assert not net.nerf.mlp.pts_linears[0].weight.requires_grad
    opt = tstate.make_optimizer(net, 1e-3)
    assert len(opt.param_groups[0]["params"]) == len(list(net.parameters()))
    assert all(p.requires_grad for p in net.parameters())
