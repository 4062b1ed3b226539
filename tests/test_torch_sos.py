"""The port's frozen SOS finetune vs nerfsos_tpu's, on tiny inputs (CPU):
the ViT and the photometric stand-in with carried weights, the correlation
losses, the whole ``sos_loss_fn`` and one train step with a frozen
backbone, the patch sampler, the train-time ARI, and ``run_nerf.main`` with
``--patch_tune --fix_backbone`` from an RGB checkpoint.

The JAX side's Pallas kernels run in interpret mode (the fused train render
K4/K5, and K7 at 16 x 16 = 256 pixels a patch, a multiple of 128; at the
whole-loss tests' 8 x 8 patches its geometry loss takes its XLA path).
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


def test_vit_state_dict_round_trips_the_reference_names():
    _, dino_params, te = _vits()
    sd = te.vit.state_dict()
    back = jvit.torch_vit_state_to_flax({k: v.numpy() for k, v in sd.items()}, depth=2)
    for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(back)[0],
                                 jax.tree_util.tree_flatten_with_path(_np(dino_params))[0]):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))


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
    with pytest.raises(NotImplementedError, match="K7b"):
        tcorr.CorrelationLoss(rand_neg=True).negative_index(torch.eye(2))
    with pytest.raises(NotImplementedError, match="K7b"):
        tcorr.GeoCorrelationLoss(use_sim_matrix=False).negative_index(torch.eye(2))


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


@pytest.mark.parametrize("flags,match", [
    (["--patch_tune", "--use_dino", "--use_correlation", "--use_sim_matrix"], "K6"),
    (["--patch_tune", "--fix_backbone", "--use_dino", "--use_geoCorr"], "K7b"),
    (["--patch_tune", "--fix_backbone", "--use_dino", "--use_geoCorr", "--use_sim_matrix",
      "--rand_neg"], "K7b"),
    (["--patch_tune", "--fix_backbone"], "without the SOS losses"),
    (["--patch_tune", "--fix_backbone", "--use_correlation"], "require --use_dino"),
])
def test_unported_patch_tune_modes_exit(patch_scene, tmp_path, flags, match):
    args, _ = run_nerf.create_arg_parser().parse_known_args(
        ["--expname", "x", "--basedir", str(tmp_path / "logs"), "--data_path",
         str(patch_scene), "--data_type", "llff", *flags])
    with pytest.raises(SystemExit, match=match):
        run_nerf.main(args, device="cpu")
