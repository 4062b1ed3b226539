"""The port's exhibit videos, test-image summaries and ``--no_batching`` runs
(CPU): ``render_video`` vs nerfsos_tpu's on bridged weights, the mp4
writer's routes, and ``run_nerf.main`` from a raw scene to trained views and
videos."""
import os
import sys

import jax
import numpy as np
import pytest
import torch

from nerfsos_torch import run_nerf
from nerfsos_torch.data import datasets as tdatasets
from nerfsos_torch.data import gen_dataset as tgen
from nerfsos_torch.data import synthetic
from nerfsos_torch.engines import checkpoint as tckpt
from nerfsos_torch.engines import eval as teval
from nerfsos_torch.models.nerf import NeRFConfig as TorchConfig
from nerfsos_torch.models.nerf import NeRFNet as TorchNet
from nerfsos_torch.utils import io as tio
from nerfsos_torch.utils import summary as tsummary
from nerfsos_tpu.data import datasets as jdatasets
from nerfsos_tpu.engines import eval as jeval
from nerfsos_tpu.models.nerf import NeRFConfig as JaxConfig
from nerfsos_tpu.models.nerf import NeRFNet as JaxNet

FRAMES = 3
VIDEO_CFG = dict(netwidth=16, netdepth=2, netwidth_fine=16, netdepth_fine=2, n_samples=8,
                 n_importance=8, multires=4, multires_views=2, use_semantics=True,
                 ray_block=256)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for torch in this module's tests (the tier-1
    run's pytest workers share the machine's cores)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _truncate_exhibit(root: str, n: int = FRAMES) -> None:
    path = os.path.join(root, "rays_exhibit.npy")
    np.save(path, np.load(path)[:n])


@pytest.fixture(scope="module")
def exhibit_root(tmp_path_factory):
    """A 10 x 12 LLFF scene prepared by the port, its spiral path cut to
    ``FRAMES`` views."""
    root = str(tmp_path_factory.mktemp("llff"))
    synthetic.write_llff_scene(root, 10, 12, n_views=6, factor=8)
    args, _ = tgen.create_arg_parser().parse_known_args(
        ["--data_type", "llff", "--data_path", root, "--llffhold", "3"])
    tgen.generate_dataset(args, root)
    _truncate_exhibit(root)
    return root


def test_render_video_matches_jax(exhibit_root, tmp_path, monkeypatch):
    """Each frame's rgb and disparity to 1e-5 of the JAX package's on the
    same (bridged) weights; the semantic argmax equal, the k-means labels
    equal up to the flip; the same mp4 names."""
    jnet = JaxNet(JaxConfig(**VIDEO_CFG))
    params = jnet.init(jax.random.PRNGKey(0))
    tnet = TorchNet(TorchConfig(**VIDEO_CFG, fused_field=True)).eval()
    tnet.load_state_dict(tckpt.state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, params)))

    jrets, jvideos = [], {}
    one_view = jeval.eval_one_view

    def record(*a, **kw):
        ret, m = one_view(*a, **kw)
        jrets.append(ret)
        return ret, m

    monkeypatch.setattr(jeval, "eval_one_view", record)
    monkeypatch.setattr(jeval.io_utils, "write_video",
                        lambda path, frames, **kw: jvideos.setdefault(os.path.basename(path),
                                                                      frames))
    jeval.render_video(jnet, params, jdatasets.ExhibitDataset(exhibit_root),
                       save_dir=str(tmp_path / "jax"), suffix="7", find_fg=False)
    ds = tdatasets.ExhibitDataset(exhibit_root)
    H, W = ds.height, ds.width
    first = int(jax.random.randint(jax.random.PRNGKey(0), (), 0, H * W))
    got = teval.render_video(tnet, ds, save_dir=str(tmp_path / "torch"), suffix="7",
                             kmeans_first=first)
    assert sorted(os.listdir(tmp_path / "torch")) == sorted(jvideos) == [
        "clus_7.mp4", "disp_7.mp4", "rgb_7.mp4", "sem_7.mp4"]
    assert len(jrets) == FRAMES and got["rgb"].shape == (FRAMES, H, W, 3)
    for i, want in enumerate(jrets):
        np.testing.assert_allclose(got["rgb"][i], want["rgb"], rtol=0, atol=1e-5)
        np.testing.assert_allclose(got["disp"][i], want["disp"], rtol=0, atol=1e-5)
        np.testing.assert_array_equal(got["sem"][i], want["sem"])
        clus = got["clus"][i]
        assert (clus == want["clustering"]).all() or (clus == 1 - want["clustering"]).all()
    np.testing.assert_array_equal(jvideos["clus_7.mp4"], (got["clus"] * 255).astype(np.uint8))


def test_write_video_names_both_writers_when_neither_imports(tmp_path, monkeypatch):
    frames = np.zeros((2, 4, 6, 3), np.uint8)
    tio.write_video(str(tmp_path / "a.mp4"), frames)
    assert tio.video_writer() == "cv2" and os.path.getsize(tmp_path / "a.mp4") > 0
    monkeypatch.setitem(sys.modules, "cv2", None)
    assert tio.video_writer() == "imageio"
    monkeypatch.setitem(sys.modules, "imageio", None)
    assert tio.video_writer() == "none"
    with pytest.raises(RuntimeError, match=r"b\.mp4.*cv2.*imageio"):
        tio.write_video(str(tmp_path / "b.mp4"), frames)


def _argv(data, logs, *extra):
    return ["--expname", "v", "--basedir", str(logs), "--data_path", str(data),
            "--config", os.path.join(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))), "configs", "lego.txt"),
            "--test_skip", "1", "--N_samples", "4", "--N_importance", "4",
            "--netdepth", "2", "--netwidth", "16", "--netdepth_fine", "2",
            "--netwidth_fine", "16", "--multires", "2", "--multires_views", "2",
            "--N_rand", "16", "--ray_chunk", "64", "--i_print", "1", "--fast_mode",
            "--ret_cluster", *extra]


def test_run_nerf_from_a_raw_scene_to_views_and_videos(tmp_path, monkeypatch):
    """A raw Blender scene at lego's flags (``--no_batching``, ``white_bkgd``,
    ``half_res``), prepared by ``main`` itself, then 4 steps with
    ``--precrop_iters 3`` (steps 1 and 2, counted from 1, sample the centre
    crop), a test image due at steps 2 and 4 and a video at step 4; then
    ``--eval --eval_video`` from its checkpoint, and ``--eval_video`` alone
    (the videos, no training)."""
    data, logs = tmp_path / "raw", tmp_path / "logs"
    synthetic.write_blender_scene(str(data), 16, (2, 1, 1))
    steps, images = [], []
    sample = tdatasets.ViewDataset.sample_batch

    def spy(self, rng, batch_size, step=10**9):
        batch = sample(self, rng, batch_size, step=step)
        h0, h1, w0, w1 = self.crop()
        crop = np.asarray(self.rays)[:, h0:h1, w0:w1].reshape(-1, 2, 3)
        inside = (batch["rays"].transpose(1, 0, 2)[:, None] == crop[None]).all((2, 3)).any(1)
        steps.append((step, bool(inside.all())))
        return batch

    monkeypatch.setattr(tdatasets.ViewDataset, "sample_batch", spy)
    monkeypatch.setattr(tsummary.SummaryWriter, "add_image",
                        lambda self, tag, img, step: images.append((tag, img.shape, step)))
    args, _ = run_nerf.create_arg_parser().parse_known_args(_argv(
        data, logs, "--max_steps", "4", "--precrop_iters", "3", "--i_img", "2",
        "--i_video", "4", "--i_weights", "4"))
    assert args.no_batching and args.white_bkgd and args.half_res
    run_nerf.main(args, device="cpu")
    assert [s for s, _ in steps] == [1, 2, 3, 4] and steps[0][1] and steps[1][1]
    assert images == [(t, (8, 8, c), s) for s in (2, 4)
                      for t, c in (("test/rgb", 3), ("test/disp", 1))]
    run = logs / "v"
    videos = {f"{k}_4.mp4" for k in ("rgb", "disp", "sem", "clus")}
    assert videos <= set(os.listdir(run))
    assert tckpt.load_checkpoint(str(run / "checkpoints" / "last.ckpt"))[1] == 4

    args, _ = run_nerf.create_arg_parser().parse_known_args(_argv(
        data, logs, "--eval", "--eval_video"))
    os.remove(run / "eval" / "log.json")
    run_nerf.main(args, device="cpu")
    videos = {f"{k}_v.mp4" for k in ("rgb", "disp", "sem", "clus")}
    assert videos <= set(os.listdir(run)) and os.path.exists(run / "eval" / "log.json")
    for f in videos:
        os.remove(run / f)
    args, _ = run_nerf.create_arg_parser().parse_known_args(_argv(data, logs, "--eval_video"))
    run_nerf.main(args, device="cpu")
    assert videos <= set(os.listdir(run)) and len(steps) == 4  # no step taken
    assert tckpt.load_checkpoint(str(run / "checkpoints" / "last.ckpt"))[1] == 4
