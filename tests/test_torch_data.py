"""The port's dataset preparation and samplers vs nerfsos_tpu's (CPU, numpy).

Every raw scene here is written by the test (tiny images; PNGs through the
port's own writer or PIL), prepared by both packages' ``gen_dataset`` and
compared array by array; the pose functions, the image decoders and the
samplers are held against the JAX package's on the same inputs.
"""
import json
import os
import shutil
import struct
import sys
import zlib

import numpy as np
import pytest
import torch

from nerfsos_torch.data import datasets as tdatasets
from nerfsos_torch.data import gen_dataset as tgen
from nerfsos_torch.data import image_io as tio
from nerfsos_torch.data import poses as tposes
from nerfsos_torch.data import ray_utils as trays
from nerfsos_torch.data import synthetic
from nerfsos_torch.utils.image import read_png, write_png
from nerfsos_tpu.data import datasets as jdatasets
from nerfsos_tpu.data import gen_dataset as jgen
from nerfsos_tpu.data import poses as jposes
from nerfsos_tpu.data import ray_utils as jrays

ARRAY_TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for torch in this module's tests (the tier-1
    run's pytest workers share the machine's cores)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


# ------------------------------------------------------------- raw scenes


def _img(rng, h, w, c=3):
    return (rng.random((h, w, c)) * 255).astype(np.uint8)


def _pose(rng):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    return np.concatenate([np.concatenate([q, rng.normal(size=(3, 1)) * 3], 1),
                           [[0.0, 0.0, 0.0, 1.0]]], 0)


def _toydesk(root, rng):
    """``{home}/processed/desk/`` with idx-keyed frames (a gap at idx 2) and
    ``{home}/split/desk_train_0.8/{train,test}.txt``."""
    base = os.path.join(root, "processed", "desk")
    os.makedirs(os.path.join(base, "full"))
    frames = []
    for idx in (0, 1, 3, 4, 5):
        write_png(os.path.join(base, "full", f"{idx}.png"), _img(rng, 6, 8))
        frames.append({"idx": idx, "file_path": f"full/{idx}",
                       "transform_matrix": _pose(rng).tolist()})
    with open(os.path.join(base, "transforms_full.json"), "w") as f:
        json.dump({"frames": frames}, f)
    split = os.path.join(root, "split", "desk_train_0.8")
    os.makedirs(split)
    for name, ids in (("train", [0, 1, 3, 7]), ("test", [4, 5])):
        with open(os.path.join(split, f"{name}.txt"), "w") as f:
            f.write("\n".join(map(str, ids)) + "\n")
    return base, []


def _tankstemple(root, rng):
    os.makedirs(os.path.join(root, "pose"))
    os.makedirs(os.path.join(root, "rgb"))
    for i in range(5):
        np.savetxt(os.path.join(root, "pose", f"{i % 2}_{i:04d}.txt"), _pose(rng))
        write_png(os.path.join(root, "rgb", f"{i % 2}_{i:04d}.png"), _img(rng, 6, 8, 4))
    np.savetxt(os.path.join(root, "intrinsics.txt"), np.diag([9.0, 9.0, 1.0, 1.0]))
    return root, ["--white_bkgd"]


def _linemod(root, rng):
    K = [[7.0, 0.0, 4.0], [0.0, 7.0, 3.0], [0.0, 0.0, 1.0]]
    for s, n in (("train", 3), ("val", 2), ("test", 2)):
        os.makedirs(os.path.join(root, s))
        frames = []
        for i in range(n):
            path = os.path.join(root, s, f"{i}.png")
            write_png(path, _img(rng, 6, 8, 4))
            frames.append({"file_path": path, "transform_matrix": _pose(rng).tolist(),
                           "intrinsic_matrix": K})
        with open(os.path.join(root, f"transforms_{s}.json"), "w") as f:
            json.dump({"frames": frames, "near": 0.6 + 0.1 * n, "far": 3.3}, f)
    return root, ["--half_res", "--test_skip", "1"]


def _deepvoxels(root, rng):
    for split, n in (("train", 2), ("test", 2), ("validation", 2)):
        base = os.path.join(root, split, "cube")
        os.makedirs(os.path.join(base, "pose"))
        os.makedirs(os.path.join(base, "rgb"))
        for i in range(n):
            np.savetxt(os.path.join(base, "pose", f"{i:06d}.txt"), _pose(rng).reshape(1, 16))
            write_png(os.path.join(base, "rgb", f"{i:06d}.png"), _img(rng, 4, 4))
    with open(os.path.join(root, "train", "cube", "intrinsics.txt"), "w") as f:
        f.write("420.0 256.0 256.0 0.\n0. 0. 0.\n0.5\n1.0\n512 512\n")
    return root, ["--dv_scene", "cube", "--test_skip", "1"]


def _llff_custom(root, rng):
    """toydesk_custom: the LLFF layout with ``masks/`` (one mask per image)."""
    synthetic.write_llff_scene(root, 6, 8, n_views=5, factor=2)
    return root, ["--factor", "2", "--llffhold", "2"]


def _llff_no_masks_dir(root, rng):
    """synthetic_custom: the LLFF layout without a mask directory (the loader
    takes the images as masks)."""
    synthetic.write_llff_scene(root, 6, 8, n_views=5, factor=2)
    shutil.rmtree(os.path.join(root, "masks"))
    return root, ["--factor", "2", "--llffhold", "2"]


def _llff_minify(root, rng):
    """Full-resolution images only: ``--factor 2`` minifies with PIL."""
    synthetic.write_llff_scene(root, 12, 16, n_views=4, factor=2)
    shutil.rmtree(os.path.join(root, "images_2"))
    for f in os.listdir(os.path.join(root, "masks")):  # masks at the minified size
        m = read_png(os.path.join(root, "masks", f))
        write_png(os.path.join(root, "masks", f), m[::2, ::2])
    return root, ["--factor", "2", "--llffhold", "2"]


SCENES = {
    "llff": ("llff", lambda r, g: (synthetic.write_llff_scene(r, 6, 8, n_views=9, factor=8)
                                   or r, ["--w_pose"])),
    "llff_spherify": ("llff", lambda r, g: (synthetic.write_llff_scene(r, 6, 8, n_views=9,
                                                                       factor=8)
                                            or r, ["--spherify", "--llffhold", "3"])),
    "llff_ndc_minify": ("llff", lambda r, g: (_llff_minify(r, g)[0],
                                              ["--factor", "2", "--llffhold", "2", "--ndc"])),
    "blender": ("blender", lambda r, g: (synthetic.write_blender_scene(r, 8, (3, 2, 2))
                                         or r, ["--half_res", "--white_bkgd",
                                                "--test_skip", "1"])),
    "blender_black": ("blender", lambda r, g: (synthetic.write_blender_scene(r, 6, (2, 1, 1))
                                               or r, [])),
    "toydesk": ("toydesk", _toydesk),
    "tankstemple": ("tankstemple", _tankstemple),
    "LINEMOD": ("LINEMOD", _linemod),
    "deepvoxels": ("deepvoxels", _deepvoxels),
    "toydesk_custom": ("toydesk_custom", _llff_custom),
    "synthetic_custom": ("synthetic_custom", _llff_no_masks_dir),
}


def _prepare(tmp_path, name):
    """The scene written once, copied, and prepared by each package from its
    own copy (LLFF's minification writes into the scene)."""
    data_type, write = SCENES[name]
    raw = tmp_path / "raw"
    base, flags = write(str(raw), np.random.default_rng(7))
    outs = {}
    for pkg, gen in (("jax", jgen), ("torch", tgen)):
        copy = str(tmp_path / f"raw_{pkg}")
        shutil.copytree(str(raw), copy)
        data = base.replace(str(raw), copy)
        out = str(tmp_path / f"out_{pkg}")
        args, _ = gen.create_arg_parser().parse_known_args(
            ["--data_type", data_type, "--data_path", data, *flags])
        gen.generate_dataset(args, out)
        outs[pkg] = out
    return outs


@pytest.mark.parametrize("name", sorted(SCENES))
def test_gen_dataset_matches_jax(tmp_path, name):
    """Every ``.npy`` both packages write, to 1e-6, and ``meta.json`` equal
    (the paths of the copies aside)."""
    outs = _prepare(tmp_path, name)
    files = sorted(os.listdir(outs["jax"]))
    assert sorted(os.listdir(outs["torch"])) == files
    assert {"rays_train.npy", "rgbs_test.npy", "masks_val.npy", "rays_exhibit.npy",
            "meta.json"} <= set(files)
    for f in files:
        if f.endswith(".npy"):
            want, got = (np.load(os.path.join(outs[p], f)) for p in ("jax", "torch"))
            assert got.shape == want.shape and got.dtype == want.dtype, f
            np.testing.assert_allclose(got, want, rtol=0, atol=ARRAY_TOL, err_msg=f)
    want, got = (json.load(open(os.path.join(outs[p], "meta.json"))) for p in ("jax", "torch"))
    assert got == want


def test_gen_dataset_cli_prepares_a_blender_scene(tmp_path):
    """``python -m nerfsos_torch.data.gen_dataset`` with a config file (lego's
    flags: ``half_res``, ``white_bkgd``) writes into the scene directory."""
    import subprocess

    synthetic.write_blender_scene(str(tmp_path), 8, (2, 1, 1))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-m", "nerfsos_torch.data.gen_dataset", "--config",
         os.path.join(repo, "configs", "lego.txt"), "--data_path", str(tmp_path)],
        cwd=repo, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    meta = json.load(open(tmp_path / "meta.json"))
    assert (meta["H"], meta["W"], meta["half_res"], meta["white_bkgd"]) == (4, 4, True, True)
    assert np.load(tmp_path / "rgbs_train.npy").shape == (2, 4, 4, 3)


# ------------------------------------------------------------- pose math


def _llff_poses(rng, n=7):
    poses = np.zeros((n, 3, 5), np.float32)
    for i in range(n):
        a = 0.15 * (i - n // 2)
        poses[i, :, :4] = tposes.viewmatrix(np.array([np.sin(a), 0.1 * i, np.cos(a)]),
                                            np.array([0.0, 1.0, 0.0]),
                                            rng.normal(size=3) * 0.3)
        poses[i, :, 4] = [24, 32, 30.0]
    return poses


def test_pose_functions_match_jax(rng):
    poses = _llff_poses(rng)
    bds = rng.uniform(1.0, 6.0, (poses.shape[0], 2))
    pairs = [
        (lambda m: m.normalize(np.array([3.0, -4.0, 12.0])), "normalize"),
        (lambda m: m.viewmatrix(np.array([0.2, 0.3, 1.0]), np.array([0, 1.0, 0]),
                                np.array([1.0, 2, 3])), "viewmatrix"),
        (lambda m: m.poses_avg(poses), "poses_avg"),
        (lambda m: m.recenter_poses(poses), "recenter_poses"),
        (lambda m: np.stack(m.render_path_spiral(m.poses_avg(poses), np.array([0, 1.0, 0]),
                                                 np.array([0.4, 0.3, 0.2]), 3.0, 0.5, 2, 30)),
         "render_path_spiral"),
        (lambda m: np.concatenate([np.asarray(x).reshape(-1) for x in
                                   m.spherify_poses(poses, bds)]), "spherify_poses"),
        (lambda m: np.stack([m.pose_spherical(a, -30.0, 4.0) for a in (-180, -45, 10, 170)]),
         "pose_spherical"),
        (lambda m: np.array(m.inward_nearfar_heuristic(poses[:, :3, 3], 0.07)),
         "inward_nearfar_heuristic"),
    ]
    for fn, name in pairs:
        np.testing.assert_allclose(fn(tposes), fn(jposes), rtol=0, atol=ARRAY_TOL, err_msg=name)


def test_rays_and_synthetic_poses_match_jax(rng):
    K = trays.persp_intrinsics(9, 7, 11.0)
    np.testing.assert_array_equal(K, jrays.persp_intrinsics(9, 7, 11.0))
    c2ws = np.stack([_pose(rng)[:3] for _ in range(3)])
    np.testing.assert_allclose(trays.persp_rays_batch(9, 7, K, c2ws),
                               jrays.persp_rays_batch(9, 7, K, c2ws), rtol=0, atol=ARRAY_TOL)
    assert synthetic.pose_spherical is tposes.pose_spherical
    np.testing.assert_array_equal(synthetic.persp_rays(9, 7, 11.0, c2ws),
                                  jrays.persp_rays_batch(9, 7, K, c2ws))


# ------------------------------------------------------------- images


def _png_with_filters(path, arr, filters):
    """An 8-bit PNG of ``arr`` whose row y is encoded with filter
    ``filters[y % len(filters)]`` (0 none, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    h, w = arr.shape[:2]
    c = 1 if arr.ndim == 2 else arr.shape[2]
    x = arr.reshape(h, w * c).astype(np.int64)
    raw = bytearray()
    for y in range(h):
        ft = filters[y % len(filters)]
        up = x[y - 1] if y else np.zeros(w * c, np.int64)
        left = np.concatenate([np.zeros(c, np.int64), x[y, :-c]])
        ul = np.concatenate([np.zeros(c, np.int64), up[:-c]])
        if ft == 0:
            pred = np.zeros_like(up)
        elif ft == 1:
            pred = left
        elif ft == 2:
            pred = up
        elif ft == 3:
            pred = (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
        raw += bytes([ft]) + bytes(((x[y] - pred) % 256).astype(np.uint8))
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]

    def chunk(tag, body):
        return struct.pack(">I", len(body)) + tag + body + struct.pack(
            ">I", zlib.crc32(tag + body) & 0xFFFFFFFF)

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype,
                                                                   0, 0, 0))
                + chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
def test_png_decoder_matches_pil(tmp_path, rng, mode):
    """PIL's own PNGs (its adaptive filters: None, Sub, Up and Paeth on this
    image) and one written with every filter in turn, Average included,
    decode to PIL's array."""
    from PIL import Image

    c = len(mode)
    yy, xx = np.mgrid[:24, :31]
    img = np.stack([(xx * 9 + yy * 2) % 256, (yy * 11) % 256, (xx * yy // 3) % 256,
                    (xx + yy) % 256], -1)[..., :c]
    img[::5] = rng.integers(0, 256, img[::5].shape)
    img[2::7] = 128
    arr = img.astype(np.uint8)
    arr = arr[..., 0] if c == 1 else arr
    pil_path, own_path = str(tmp_path / "pil.png"), str(tmp_path / "own.png")
    Image.fromarray(arr, mode).save(pil_path)
    _png_with_filters(own_path, arr, [0, 1, 2, 3, 4])
    for path in (pil_path, own_path):
        with Image.open(path) as im:
            want = np.asarray(im)
        got = read_png(path)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(20, 24, 10, 12), (21, 25, 10, 12), (13, 17, 5, 7)])
def test_resize_area_matches_cv2(rng, shape):
    import cv2

    H, W, h, w = shape
    for c in (3, 4):
        img = rng.random((H, W, c)).astype(np.float32)
        got = tio.resize_area(img, h, w)
        want = cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)
        assert got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=0, atol=ARRAY_TOL)


def test_pil_routes_raise_a_plain_error_without_pil(tmp_path, monkeypatch, rng):
    """With PIL hidden: PNGs decode through numpy (PIL's array), a JPEG and
    LLFF's minification raise an error naming the file and PIL."""
    from PIL import Image

    arr = _img(rng, 5, 7)
    Image.fromarray(arr).save(tmp_path / "a.png")
    Image.fromarray(arr).save(tmp_path / "a.jpg")
    scene = tmp_path / "scene"
    synthetic.write_llff_scene(str(scene), 6, 8, n_views=3, factor=2)
    shutil.rmtree(scene / "images_2")
    monkeypatch.setitem(sys.modules, "PIL", None)
    np.testing.assert_array_equal(tio.imread(str(tmp_path / "a.png")), arr)
    with pytest.raises(RuntimeError, match=r"a\.jpg.*PIL"):
        tio.imread(str(tmp_path / "a.jpg"))
    with pytest.raises(RuntimeError, match=r"images.*minifying needs PIL"):
        tio.minify(str(scene), factors=[2])


# ------------------------------------------------------------- samplers


@pytest.fixture(scope="module")
def blender_out(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("blender"))
    synthetic.write_blender_scene(root, 20, (4, 2, 2))
    args, _ = tgen.create_arg_parser().parse_known_args(
        ["--data_type", "blender", "--data_path", root, "--white_bkgd", "--test_skip", "1"])
    tgen.generate_dataset(args, root)
    return root


@pytest.mark.parametrize("step", [1, 99, 100, 10**9])
def test_view_dataset_draws_as_jax(blender_out, step):
    """The same ``Generator`` gives the same image, pixels and rays before
    (``step < precrop_iters``: the centre crop) and after the precrop."""
    kw = dict(split="train", precrop_iters=100, precrop_frac=0.5)
    t, j = tdatasets.ViewDataset(blender_out, **kw), jdatasets.ViewDataset(blender_out, **kw)
    got = t.sample_batch(np.random.default_rng(step), 64, step=step)
    want = j.sample_batch(np.random.default_rng(step), 64, step=step)
    assert got.keys() == want.keys() == {"rays", "target"}
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    if step < 100:  # every ray through a pixel of the centre crop
        h0, h1, w0, w1 = t.crop()
        assert (h0, h1, w0, w1) == (5, 15, 5, 15)
        rays = np.asarray(t.rays)[:, h0:h1, w0:w1].reshape(-1, 2, 3)
        hit = (got["rays"].transpose(1, 0, 2)[:, None] == rays[None]).all((2, 3)).any(1)
        assert hit.all()


def test_exhibit_dataset_matches_jax(blender_out):
    t, j = tdatasets.ExhibitDataset(blender_out), jdatasets.ExhibitDataset(blender_out)
    assert len(t) == len(j) == 40
    assert t.near_far() == j.near_far()
    for i in (0, 17, 39):
        got, want = t.get_view(i), j.get_view(i)
        assert got.keys() == want.keys() == {"rays"}
        np.testing.assert_array_equal(got["rays"], want["rays"])


def test_datasets_prepare_a_raw_scene_from_the_flags(tmp_path):
    """Without ``meta.json`` a dataset given the run's flags prepares the
    directory first (the JAX datasets' rule); without the flags it says how."""
    root = str(tmp_path)
    synthetic.write_blender_scene(root, 8, (2, 1, 1))
    with pytest.raises(FileNotFoundError, match="gen_dataset"):
        tdatasets.RayDataset(root, split="test")
    args, _ = tgen.create_arg_parser().parse_known_args(
        ["--data_type", "blender", "--data_path", root, "--test_skip", "1"])
    ds = tdatasets.RayDataset(root, split="test", args=args)
    assert ds.get_view(0)["rays"].shape == (2, 8, 8, 3)
    assert os.path.exists(os.path.join(root, "rays_exhibit.npy"))
