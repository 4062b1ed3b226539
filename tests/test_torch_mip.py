"""The port's mip-NeRF path vs nerfsos_tpu's, on tiny inputs (CPU): the
Gaussians, blurpool, the integrated PE, the mip composite, K9/K10a/K10b's
plain versions against the Pallas kernels (interpret mode,
``RAY_BLOCK`` 8), the whole ``MipNeRFNet`` forward, one Adam step, and
``run_nerf.main --mipnerf`` in train, resume and ``--eval``.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsos_torch import run_nerf
from nerfsos_torch.core import encoding as tenc
from nerfsos_torch.core import render as trender
from nerfsos_torch.data.datasets import RayDataset
from nerfsos_torch.data.synthetic import write_sphere_scene
from nerfsos_torch.engines import checkpoint as tckpt
from nerfsos_torch.engines import state as tstate
from nerfsos_torch.engines import trainer as ttrainer
from nerfsos_torch.models import mip as tmip
from nerfsos_torch.models.nerf import NeRFConfig as TorchConfig
from nerfsos_torch.ops import fused_render as tfr
from nerfsos_tpu.core import encoding as jenc
from nerfsos_tpu.core import render as jrender
from nerfsos_tpu.data.datasets import RayDataset as JaxRayDataset
from nerfsos_tpu.engines import state as jstate
from nerfsos_tpu.engines import trainer as jtrainer
from nerfsos_tpu.models import mip as jmip
from nerfsos_tpu.models.nerf import NeRFConfig as JaxConfig
from nerfsos_tpu.ops.pallas import fused_render as jfr

# depth 5: the skip's [emb, h] input follows layer 4
TINY = dict(netwidth=32, netdepth=5, n_samples=8, n_importance=8, multires=4,
            multires_views=2, use_semantics=False)
RADII = 0.01


def _pair(fused: bool = True, **over):
    """A JAX MipNeRFNet with seeded params and the port's twin holding them."""
    kw = {**TINY, **over}
    jnet = jmip.MipNeRFNet(JaxConfig(**kw, fused_field=fused))
    params = jnet.init(jax.random.PRNGKey(3))
    tnet = tmip.MipNeRFNet(TorchConfig(**kw, fused_field=fused))
    tnet.load_state_dict(tckpt.state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, params)))
    return jnet, params, tnet


def _odvr_z(R: int, S: int, seed: int):
    """Rays (origins, directions, unit viewdirs, radii) and sorted fenceposts
    ``[R, S + 1]`` in [1, 4]."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(R, 3)) * 0.3
    d = rng.normal(size=(R, 3))
    v = d / np.linalg.norm(d, axis=1, keepdims=True)
    odvr = np.concatenate([o, d, v, np.full((R, 1), RADII)], 1).astype(np.float32)
    z = np.sort(rng.uniform(1.0, 4.0, (R, S + 1)), 1).astype(np.float32)
    return odvr, z


def _jax_seed(key) -> int:
    """The noise seed ``fused_mip_train_render_planar`` draws from its key."""
    return int(jax.random.randint(key, (1, 1), 0, 2**31 - 1).astype(jnp.float32)[0, 0])


@pytest.mark.parametrize("shape", ["cone", "cylinder"])
def test_cast_rays_and_blurpool_match_jax(rng, shape):
    R, S = 13, 6
    z = np.sort(rng.uniform(1.0, 5.0, (R, S + 1)), 1).astype(np.float32)
    o, d = (rng.normal(size=(R, 3)).astype(np.float32) for _ in range(2))
    radii = rng.uniform(0.001, 0.05, (R, 1)).astype(np.float32)
    want = jmip.cast_rays(jnp.asarray(z), jnp.asarray(o), jnp.asarray(d), jnp.asarray(radii), shape)
    got = tmip.cast_rays(*(torch.from_numpy(a) for a in (z, o, d, radii)), shape)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-10)
    w = rng.random((R, S)).astype(np.float32)
    np.testing.assert_allclose(tmip.blurpool_weights(torch.from_numpy(w)).numpy(),
                               np.asarray(jmip.blurpool_weights(jnp.asarray(w))), rtol=1e-6)


@pytest.mark.parametrize("stable", [True, False])
def test_conical_frustum_forms_match_jax(rng, stable):
    """Both closed forms of the frustum's moments. The unstable one
    subtracts t0^k from t1^k, so its intervals are wide (1/3 to 1 of t0)
    to keep the cancellation inside the tolerance."""
    t0 = rng.uniform(1.0, 3.0, (11, 5)).astype(np.float32)
    t1 = (t0 * rng.uniform(1.33, 2.0, t0.shape)).astype(np.float32)
    d = rng.normal(size=(11, 3)).astype(np.float32)
    r = rng.uniform(0.001, 0.05, (11, 5)).astype(np.float32)
    want = jmip.conical_frustum_to_gaussian(*(jnp.asarray(a) for a in (d, t0, t1, r)), stable)
    got = tmip.conical_frustum_to_gaussian(*(torch.from_numpy(a) for a in (d, t0, t1, r)), stable)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5 if stable else 1e-4,
                                   atol=1e-10)


def test_ipe_matches_jax(rng):
    x = rng.normal(size=(5, 7, 3)).astype(np.float32) * 2
    cov = rng.uniform(0, 0.01, (5, 7, 3)).astype(np.float32)
    want = jenc.integrated_positional_encoding(jnp.asarray(x), jnp.asarray(cov), 10, 9.0)
    got = tenc.integrated_positional_encoding(torch.from_numpy(x), torch.from_numpy(cov), 10, 9.0)
    assert got.shape == (5, 7, tenc.ipe_dim(3, 10)) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("white", [False, True])
def test_mip_volumetric_render_matches_jax(rng, white):
    raw = rng.normal(size=(9, 6, 4)).astype(np.float32)
    z = np.sort(rng.uniform(1.0, 4.0, (9, 7)), 1).astype(np.float32)
    d = rng.normal(size=(9, 3)).astype(np.float32)
    want = jrender.mip_volumetric_render(jnp.asarray(raw), jnp.asarray(z), jnp.asarray(d),
                                         white_bkgd=white)
    got = trender.mip_volumetric_render(torch.from_numpy(raw), torch.from_numpy(z),
                                        torch.from_numpy(d), white_bkgd=white)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5, rtol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("noise", [0.0, 1.0])
def test_mip_render_plain_matches_pallas(monkeypatch, noise):
    """K9's plain version vs ``fused_mip_render_planar`` (no noise), K10a's
    vs ``fused_mip_train_render_planar`` with its key's seed injected, at
    fixed fenceposts, to 3e-5."""
    monkeypatch.setattr(jfr, "RAY_BLOCK", 8)
    jnet, params, tnet = _pair()
    odvr, z = _odvr_z(20, 7, 1)
    key = jax.random.PRNGKey(11)
    if noise == 0.0:
        want = jfr.fused_mip_render_planar(params["mip"], jnp.asarray(odvr), jnp.asarray(z),
                                           jnet.cfg)
        got = tfr.fused_mip_render(tnet.mip, torch.from_numpy(odvr), torch.from_numpy(z))
    else:
        want = jfr.fused_mip_train_render_planar(params["mip"], jnp.asarray(odvr),
                                                 jnp.asarray(z), jnet.cfg, noise_std=noise,
                                                 noise_key=key)
        got = tfr.mip_train_render(tnet.mip, torch.from_numpy(odvr), torch.from_numpy(z),
                                   noise_std=noise, seed=_jax_seed(key))
    for g, w, name in zip(got, want, ("maps", "weights")):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=3e-5, err_msg=name)


def test_mip_train_render_grads_plain_matches_pallas_vjp(monkeypatch):
    """K10b's plain version vs ``jax.vjp`` of ``fused_mip_train_render_planar``
    (noise 1 from the key's seed) with seeded map and weight cotangents:
    every leaf to 5e-5 of its max."""
    monkeypatch.setattr(jfr, "RAY_BLOCK", 8)
    jnet, params, tnet = _pair()
    R, S = 20, 7
    odvr, z = _odvr_z(R, S, 2)
    rng = np.random.default_rng(3)
    dmaps = rng.normal(size=(R, 5)).astype(np.float32)
    dw = rng.normal(size=(R, S)).astype(np.float32)
    key = jax.random.PRNGKey(12)
    _, vjp = jax.vjp(lambda p: jfr.fused_mip_train_render_planar(
        p, jnp.asarray(odvr), jnp.asarray(z), jnet.cfg, noise_std=1.0, noise_key=key),
        params["mip"])
    (jgrads,) = vjp((jnp.asarray(dmaps), jnp.asarray(dw)))
    want = tckpt.state_dict_from_jax_params({"mip": jax.tree_util.tree_map(np.asarray, jgrads)})
    got = tfr.mip_train_render_grads(tnet.mip, torch.from_numpy(odvr), torch.from_numpy(z),
                                     torch.from_numpy(dmaps), torch.from_numpy(dw),
                                     noise_std=1.0, seed=_jax_seed(key))
    assert {f"mip.{k}" for k in got} == set(want)
    for name, g in got.items():
        ref = want[f"mip.{name}"]
        scale = float(ref.abs().max()) + 1e-12
        assert float((g - ref).abs().max()) / scale <= 5e-5, name


@pytest.mark.parametrize("jax_fused", [False, True])
def test_mip_net_forward_matches_jax(monkeypatch, jax_fused):
    """The whole eval forward at perturb 0 (Gaussians, IPE, field, blurpool,
    det importance sampling, mip composite, coarse outputs) of the port's
    kernel route (K9's plain version on the CPU) and plain route against the
    JAX net's XLA route or fused route: maps to 3e-5, z_std to 5e-3."""
    monkeypatch.setattr(jfr, "RAY_BLOCK", 8)
    jnet, params, tnet = _pair(fused=jax_fused)
    rng = np.random.default_rng(4)
    rays = rng.normal(size=(2, 33, 3)).astype(np.float32)
    rays[0] *= 0.3
    want = jax.jit(lambda p, r: jnet(p, r, (1.0, 4.0), radii=RADII, train=False))(
        params, jnp.asarray(rays))
    for fused in (True, False):
        net = tmip.MipNeRFNet(TorchConfig(**TINY, fused_field=fused)).eval()
        net.load_state_dict(tnet.state_dict())
        assert net.fused == fused
        with torch.no_grad():
            got = net(torch.from_numpy(rays), (1.0, 4.0), radii=RADII, train=False)
        assert set(got) == set(want)
        for k in want:
            tol = 5e-3 if k == "z_std" else 3e-5
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=tol,
                                       rtol=1e-5, err_msg=f"{fused}:{k}")


def test_mip_train_step_matches_jax(monkeypatch):
    """One mip Adam step (perturb 0, noise 0.6 from the JAX key's seeds)
    against ``make_rgb_train_step(..., net_kwargs={"radii": r})``: the
    post-Adam params per leaf to 1e-5 of the leaf's scale, the metrics to
    1e-6. The batch's fine samples agree (no importance-sample bin flip)."""
    monkeypatch.setattr(jfr, "RAY_BLOCK", 8)
    jnet, params, tnet = _pair(perturb=0.0, raw_noise_std=0.6, netdepth=2)
    rng = np.random.default_rng(5)
    rays = rng.normal(size=(2, 20, 3)).astype(np.float32)
    rays[0] *= 0.3
    batch = {"rays": rays, "target": rng.uniform(0, 1, (20, 3)).astype(np.float32)}
    key, lr = jax.random.PRNGKey(8), 5e-4
    _, k_c, _, k_f = jax.random.split(key, 4)
    seeds = (_jax_seed(k_c), _jax_seed(k_f))

    tx = jstate.make_optimizer(lr, 0.1, 250_000)
    state = jstate.TrainState.create(params, tx)
    step = jtrainer.make_rgb_train_step(jnet, 1.0, 4.0, donate=False,
                                        net_kwargs={"radii": RADII})
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    state, jmetrics = step(state, {**jbatch, "masks": jnp.zeros((20, 1))}, key)

    assert not ttrainer.supports_fused_rgb_loss(tnet)
    opt = tstate.make_optimizer(tnet, lr)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, tmetrics = ttrainer.rgb_loss_fn(tnet, tbatch, 1.0, 4.0, 1.0, None, seeds,
                                          {"radii": RADII})
    loss.backward()
    tstate.set_lr(opt, tstate.exp_decay_schedule(lr, 0.1, 250_000)(0))
    opt.step()
    ref = tckpt.state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, state.params))
    for name, p in tnet.named_parameters():
        scale = float(ref[name].abs().max())
        assert float((p.detach() - ref[name]).abs().max()) <= 1e-5 * scale, name
    for k in ("loss", "psnr", "img0", "img1", "psnr0"):
        np.testing.assert_allclose(float(tmetrics[k]), float(jmetrics[k]), rtol=1e-6, err_msg=k)


def test_mip_net_contract():
    """No semantic head; one field ``mip`` with ``mip.mlp.*`` keys whose
    first layer takes the 60-wide IPE at multires 10."""
    with pytest.raises(ValueError, match="semantics"):
        tmip.MipNeRFNet(TorchConfig(use_semantics=True))
    net = tmip.MipNeRFNet(TorchConfig(use_semantics=False, fused_field=True))
    assert net.fused and all(k.startswith("mip.mlp.") for k in net.state_dict())
    assert net.mip.mlp.pts_linears[0].in_features == 60
    assert net.mip.mlp.pts_linears[5].in_features == 60 + 256


def test_radii_matches_jax(tmp_path):
    write_sphere_scene(str(tmp_path), height=6, width=9, n_views=1)
    assert RayDataset(str(tmp_path)).radii() == JaxRayDataset(str(tmp_path),
                                                              split="test").radii()


def _mip_argv(data, logs, *extra):
    return ["--expname", "m", "--basedir", str(logs), "--data_path", str(data),
            "--data_type", "llff", "--mipnerf", "--N_samples", "6", "--N_importance", "6",
            "--netdepth", "5", "--netwidth", "16", "--multires", "3", "--multires_views", "2",
            "--N_rand", "24", "--raw_noise_std", "0.5", "--i_print", "1", "--i_weights", "2",
            "--i_testset", "1000", "--ray_chunk", "40", *extra]


def test_run_nerf_mipnerf_trains_resumes_and_evals(tmp_path):
    """``main --mipnerf`` on the CPU (the kernel route's plain versions):
    trains 3 steps with checkpoints holding every leaf's Adam state, resumes
    to 4 from step 2, and ``--eval --mipnerf`` renders the test views into
    images and finite metrics (no semantic images)."""
    data, logs = tmp_path / "data", tmp_path / "logs"
    write_sphere_scene(str(data), height=6, width=8, n_views=2)
    write_sphere_scene(str(data), height=6, width=8, n_views=2, split="train")
    for steps in ("3", "4"):
        args, _ = run_nerf.create_arg_parser().parse_known_args(
            _mip_argv(data, logs, "--max_steps", steps))
        run_nerf.main(args, device="cpu")
    state, step, opt = tckpt.load_checkpoint(str(logs / "m" / "checkpoints" / "last.ckpt"))
    assert step == 4 and all(k.startswith("mip.mlp.") for k in state)
    assert len(opt["state"]) == len(state)
    lines = [json.loads(x) for x in open(logs / "m" / "tensorboard" / "scalars.jsonl")]
    steps_logged = [x["step"] for x in lines if x["tag"] == "train/loss"]
    assert steps_logged == [1, 2, 3, 3, 4]  # resumed from latest.ckpt at step 2
    out = logs / "m" / "eval"
    (out / "log.json").unlink()  # the last train step's eval wrote one
    args, _ = run_nerf.create_arg_parser().parse_known_args(_mip_argv(data, logs, "--eval"))
    run_nerf.main(args, device="cpu")
    log = json.load(open(out / "log.json"))
    assert len(log["mse"]) == 2 and np.isfinite(log["total_psnr"])
    assert log["total_sem_ari"] == 0.0
    names = set(os.listdir(out))
    assert {"rgb_000.png", "depth_001.png", "alpha_001.png"} <= names
    assert not any(n.startswith(("sem_", "clus_")) for n in names)


def test_mipnerf_with_sos_losses_exits(tmp_path):
    data, logs = tmp_path / "data", tmp_path / "logs"
    write_sphere_scene(str(data), height=6, width=8, n_views=1)
    args, _ = run_nerf.create_arg_parser().parse_known_args(
        _mip_argv(data, logs, "--patch_tune", "--use_dino", "--use_correlation"))
    with pytest.raises(SystemExit, match="semantic head"):
        run_nerf.main(args, device="cpu")
