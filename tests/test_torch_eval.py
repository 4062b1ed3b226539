"""The port's eval engine and entry point vs nerfsos_tpu's, on tiny inputs (CPU)."""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import run_nerf as jax_run_nerf
from nerfsos_torch import run_nerf
from nerfsos_torch.data.datasets import RayDataset
from nerfsos_torch.data.synthetic import write_sphere_scene
from nerfsos_torch.engines import checkpoint as tckpt
from nerfsos_torch.engines import eval as teval
from nerfsos_torch.losses.photometric import img2mse, mse2psnr
from nerfsos_torch.models.mip import MipNeRFNet
from nerfsos_torch.models.nerf import NeRFConfig as TorchConfig
from nerfsos_torch.models.nerf import NeRFNet as TorchNet
from nerfsos_torch.ops.kmeans import kmeans, segmap_cluster
from nerfsos_torch.ops.ssim import ssim as tssim
from nerfsos_torch.utils import io as tio
from nerfsos_tpu.engines import eval as jeval
from nerfsos_tpu.losses import photometric as jphoto
from nerfsos_tpu.models.nerf import NeRFConfig as JaxConfig
from nerfsos_tpu.models.nerf import NeRFNet as JaxNet
from nerfsos_tpu.ops import kmeans as jkmeans
from nerfsos_tpu.ops.ssim import ssim as jssim
from tests.test_eval import _TinyEvalDataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# test_eval.py's eval_net configuration
EVAL_CFG = dict(netwidth=16, netdepth=2, netwidth_fine=16, netdepth_fine=2, n_samples=4,
                n_importance=4, multires=2, multires_views=2, use_semantics=True,
                ray_block=256)


def _jax_first(n):
    """The k-means start index nerfsos_tpu draws (ops/kmeans.py)."""
    return int(jax.random.randint(jax.random.PRNGKey(0), (), 0, n))


@pytest.fixture(scope="module")
def eval_pair():
    jnet = JaxNet(JaxConfig(**EVAL_CFG))
    params = jnet.init(jax.random.PRNGKey(0))
    tnet = TorchNet(TorchConfig(**EVAL_CFG, fused_field=True)).eval()
    tnet.load_state_dict(tckpt.state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, params)))
    return jnet, params, tnet


def test_evaluate_matches_jax(eval_pair, tmp_path, rng):
    jnet, params, tnet = eval_pair
    ds = _TinyEvalDataset(rng)
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    want = jeval.evaluate(jnet, params, ds, save_dir=str(jdir), ret_cluster=True, find_fg=False)
    got = teval.evaluate(tnet, ds, save_dir=str(tdir), ret_cluster=True,
                         kmeans_first=_jax_first(ds.H * ds.W))
    for k in ("mse", "psnr", "ssim"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    for k in ("sem_ari", "sem_ari_fg", "clus_ari", "clus_ari_fg"):
        assert got[k] == want[k], k
    assert np.isnan(got["lpips"]) and np.isnan(want["lpips"])
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    jlog, tlog = (json.load(open(d / "log.json")) for d in (jdir, tdir))
    assert tlog.keys() == jlog.keys()
    assert tlog["lpips"] == [None, None] and tlog["total_lpips"] is None
    np.testing.assert_allclose(tlog["mse"], jlog["mse"], rtol=1e-5)


def test_eval_one_view_maps_match_jax(eval_pair, rng):
    jnet, params, tnet = eval_pair
    batch = _TinyEvalDataset(rng).get_view(1)
    jret, _ = jeval.eval_one_view(jeval.make_render_fn(jnet, 1.0, 4.0), params, batch)
    tret, _ = teval.eval_one_view(teval.make_render_fn(tnet, 1.0, 4.0), batch,
                                  kmeans_first=_jax_first(144))
    for k in ("rgb", "depth", "acc", "disp", "semantics", "weights"):
        np.testing.assert_allclose(tret[k], jret[k], atol=2e-5, rtol=1e-5, err_msg=k)
    np.testing.assert_array_equal(tret["sem"], jret["sem"])
    np.testing.assert_array_equal(tret["clustering"], jret["clustering"])


@pytest.mark.parametrize("k", [2, 3])
def test_kmeans_matches_jax_labels(rng, k):
    x = np.concatenate([rng.normal(loc=c, scale=0.3, size=(40, 2)) for c in range(k)])
    x = x.astype(np.float32)
    first = _jax_first(x.shape[0])
    want, cents = jkmeans.kmeans(jax.random.PRNGKey(0), jnp.asarray(x), k)
    got, tcents = kmeans(torch.from_numpy(x), k, first)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(tcents.numpy(), np.asarray(cents), atol=1e-6)
    seg = segmap_cluster(torch.from_numpy(x).reshape(8, -1, 2), k, first=first)
    np.testing.assert_array_equal(seg.reshape(-1).numpy(), np.asarray(want))


def test_ssim_matches_jax(rng):
    a = rng.random((13, 17, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(scale=0.1, size=a.shape), 0, 1).astype(np.float32)
    want = float(jssim(jnp.asarray(a), jnp.asarray(b), data_format="HWC"))
    got = float(tssim(torch.from_numpy(a), torch.from_numpy(b), data_format="HWC"))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    nchw = float(tssim(torch.from_numpy(a).permute(2, 0, 1)[None],
                       torch.from_numpy(b).permute(2, 0, 1)[None]))
    np.testing.assert_allclose(nchw, got, rtol=1e-6)


def test_photometric_matches_jax(rng):
    a, b = rng.random((2, 10, 3)).astype(np.float32)
    for red in ("mean", "sum", "none"):
        np.testing.assert_allclose(img2mse(torch.from_numpy(a), torch.from_numpy(b), red).numpy(),
                                   np.asarray(jphoto.img2mse(jnp.asarray(a), jnp.asarray(b), red)),
                                   rtol=1e-6)
    np.testing.assert_allclose(float(mse2psnr(torch.tensor(0.01))),
                               float(jphoto.mse2psnr(jnp.asarray(0.01))), rtol=1e-6)


def test_flag_surface_matches_jax_entry_point():
    """Same names, aliases, types, defaults, choices and nargs as run_nerf.py."""
    def surface(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.type, a.nargs,
                         tuple(a.choices) if a.choices else None, a.required, type(a).__name__)
                for a in parser._actions}

    assert surface(run_nerf.create_arg_parser()) == surface(jax_run_nerf.create_arg_parser())


def test_config_file_parses_like_jax():
    argv = ["--config", os.path.join(REPO, "configs", "flower_full.txt"), "--eval",
            "--N_importance", "96"]
    mine, _ = run_nerf.create_arg_parser().parse_known_args(argv)
    ref, _ = jax_run_nerf.create_arg_parser().parse_known_args(argv)
    assert vars(mine) == vars(ref)


def _scene(tmp_path, net_cfg, **scene):
    data, logs = tmp_path / "data", tmp_path / "logs"
    write_sphere_scene(str(data), **scene)
    os.makedirs(logs / "t")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        net = TorchNet(TorchConfig(**net_cfg))
    ckpt = str(tmp_path / "w.ckpt")
    tckpt.save_checkpoint(ckpt, 3, net)
    return data, logs, ckpt


def _argv(data, logs, ckpt, *extra):
    return ["--expname", "t", "--basedir", str(logs), "--data_path", str(data),
            "--data_type", "llff", "--ckpt_path", ckpt, "--N_samples", "4",
            "--N_importance", "4", "--netdepth", "2", "--netwidth", "16",
            "--netdepth_fine", "2", "--netwidth_fine", "16", "--multires", "2",
            "--multires_views", "2", "--ray_chunk", "50", *extra]


def test_run_nerf_eval_end_to_end(tmp_path):
    """The entry point on the CPU: the fused branch (plain K1/K2) renders a
    two-view analytic scene and writes the eval artifacts."""
    data, logs, ckpt = _scene(tmp_path, dict(EVAL_CFG, ray_block=50), height=10, width=12,
                              n_views=2)
    args, _ = run_nerf.create_arg_parser().parse_known_args(
        _argv(data, logs, ckpt, "--eval", "--ret_cluster", "--use_masks"))
    run_nerf.main(args, device="cpu")
    out = logs / "t" / "eval"
    names = set(os.listdir(out))
    for i in range(2):
        assert {f"{p}_{i:03d}.png" for p in ("rgb", "depth", "alpha", "sem", "clus")} <= names
        assert f"depth_{i:03d}_.png" in names
    log = json.load(open(out / "log.json"))
    assert set(log) == set(teval.METRIC_KEYS) | {f"total_{k}" for k in teval.METRIC_KEYS}
    assert len(log["mse"]) == 2 and np.isfinite(log["total_psnr"])
    ds = RayDataset(str(data), use_masks=True)
    assert ds.get_view(1)["masks"].sum() > 0  # the sphere is in view


@pytest.mark.parametrize("mode", [["--patch_tune"], ["--no_batching"], ["--eval_video"],
                                  ["--eval_vol"], ["--eval", "--mipnerf"]])
def test_unported_modes_exit(tmp_path, mode):
    """Each of these modes once stopped with "not yet ported"; each runs now:
    ``--patch_tune`` alone the RGB finetune on patches and ``--no_batching``
    the RGB step on one image a step (four steps here, two in the centre
    crop), ``--eval_video`` the exhibit path's videos (the test view's rays
    as ``rays_exhibit.npy``), ``--eval --mipnerf`` the test view from a mip
    checkpoint, and ``--eval_vol`` the checkpoint's density on the
    ``--vol_extents 0.2 --vol_size 0.02`` grid."""
    data, logs, ckpt = _scene(tmp_path, EVAL_CFG, height=4, width=4)
    if mode == ["--eval_vol"]:
        args, _ = run_nerf.create_arg_parser().parse_known_args(
            _argv(data, logs, ckpt, *mode, "--vol_extents", "0.2", "--vol_size", "0.02"))
        run_nerf.main(args, device="cpu")
        vol = tio.read_mrc(str(logs / "t" / "eval" / "density.mrc"))
        assert vol.shape == (10, 10, 10) and np.isfinite(vol).all() and (vol >= 0).all()
        assert os.path.exists(logs / "t" / "eval" / "density.ply")
        return
    if "--mipnerf" in mode:
        cfg = {k: v for k, v in EVAL_CFG.items() if k != "use_semantics"}
        tckpt.save_checkpoint(ckpt, 3, MipNeRFNet(TorchConfig(**cfg, use_semantics=False)))
        args, _ = run_nerf.create_arg_parser().parse_known_args(_argv(data, logs, ckpt, *mode))
        run_nerf.main(args, device="cpu")
        log = json.load(open(logs / "t" / "eval" / "log.json"))
        assert len(log["mse"]) == 1 and np.isfinite(log["total_psnr"])
        return
    if mode == ["--eval_video"]:
        np.save(data / "rays_exhibit.npy", np.load(data / "rays_test.npy"))
        args, _ = run_nerf.create_arg_parser().parse_known_args(
            _argv(data, logs, ckpt, *mode, "--ret_cluster"))
        run_nerf.main(args, device="cpu")
        assert {f"{k}_t.mp4" for k in ("rgb", "disp", "sem", "clus")} <= set(
            os.listdir(logs / "t"))
        assert not os.path.exists(logs / "t" / "checkpoints" / "last.ckpt")  # no training
        return
    write_sphere_scene(str(data), height=4, width=4, n_views=2, split="train")
    mode = [*mode, "--batch_size", "2", "--max_steps", "4"]
    mode += ["--patch_size", "2"] if "--patch_tune" in mode else ["--precrop_iters", "3"]
    args, _ = run_nerf.create_arg_parser().parse_known_args(_argv(data, logs, ckpt, *mode))
    run_nerf.main(args, device="cpu")
    state, step, opt = tckpt.load_checkpoint(str(logs / "t" / "checkpoints" / "last.ckpt"))
    assert step == 4 and len(opt["state"]) == len(state)  # Adam holds every leaf


def test_main_without_a_card_raises(tmp_path):
    """With no device given the entry point runs on cuda:{gpuid}; it does not
    fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    data, logs, ckpt = _scene(tmp_path, EVAL_CFG, height=4, width=4)
    args, _ = run_nerf.create_arg_parser().parse_known_args(_argv(data, logs, ckpt, "--eval"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_nerf.main(args)


_HYGIENE = r"""
import sys
for m in ("jax", "jaxlib", "flax", "optax", "orbax", "sklearn", "imageio", "matplotlib",
          "cv2", "PIL", "nerfsos_tpu"):
    sys.modules[m] = None
import os
import torch
import nerfsos_torch.run_nerf
import nerfsos_torch.data.datasets as ds_mod
import nerfsos_torch.data.gen_dataset as gen
import nerfsos_torch.data.image_io
import nerfsos_torch.data.load_blender
import nerfsos_torch.data.load_deepvoxels
import nerfsos_torch.data.load_linemod
import nerfsos_torch.data.load_llff
import nerfsos_torch.data.load_tankstemple
import nerfsos_torch.data.load_toydesk
import nerfsos_torch.data.poses
import nerfsos_torch.data.ray_utils
from nerfsos_torch.data.synthetic import write_blender_scene
import nerfsos_torch.engines.eval as ev
import nerfsos_torch.engines.checkpoint
import nerfsos_torch.engines.state as st
import nerfsos_torch.engines.trainer as tr
import nerfsos_torch.utils.summary
from nerfsos_torch.models.nerf import NeRFConfig, NeRFNet
import numpy as np

class DS:
    def __len__(self): return 1
    def near_far(self): return 1.0, 4.0
    def get_view(self, i):
        r = np.random.default_rng(0)
        return {"rays": r.normal(size=(2, 6, 5, 3)).astype(np.float32),
                "masks": r.integers(0, 2, (6, 5, 1)),
                "target": r.random((6, 5, 3)).astype(np.float32)}

net = NeRFNet(NeRFConfig(netdepth=2, netwidth=8, netdepth_fine=2, netwidth_fine=8,
                         n_samples=4, n_importance=4, multires=2, multires_views=2,
                         use_semantics=True, fused_field=True))
out = ev.evaluate(net, DS(), save_dir=sys.argv[1], ret_cluster=True)
assert np.isfinite(out["psnr"])
opt = st.make_optimizer(net.parameters(), 1e-3)
step = tr.make_rgb_train_step(net, opt, st.exp_decay_schedule(1e-3, 0.1, 1e5), 1.0, 4.0)
r = np.random.default_rng(1)
m = step({"rays": torch.from_numpy(r.normal(size=(2, 16, 3)).astype(np.float32)),
          "target": torch.from_numpy(r.random((16, 3)).astype(np.float32))}, 0)
assert tr.supports_fused_rgb_loss(net) and np.isfinite(float(m["loss"]))
scene = os.path.join(sys.argv[1], "scene")
write_blender_scene(scene, 8, (2, 1, 1))  # PNGs of the port's own writer: numpy decodes them
args, _ = gen.create_arg_parser().parse_known_args(
    ["--data_type", "blender", "--data_path", scene, "--half_res", "--white_bkgd"])
gen.generate_dataset(args, scene)
view = ds_mod.ViewDataset(scene, precrop_iters=2).sample_batch(np.random.default_rng(0), 4, 1)
assert view["rays"].shape == (2, 4, 3) and np.isfinite(view["target"]).all()
print("OK")
"""


def test_port_imports_no_jax_sklearn_imageio_matplotlib_cv2(tmp_path):
    proc = subprocess.run([sys.executable, "-c", _HYGIENE, str(tmp_path)], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")
    assert os.path.exists(tmp_path / "log.json")
