"""The port's SOS quality gate (``nerfsos_torch/tools/validate_sos_protocol.py``)
and the DINO foreground flip vs nerfsos_tpu's, on the CPU: the twin's scene
against JAX's ``build_dataset``, each phase's flags against JAX's ``_args``,
the whole twin at a tiny size, the gate's verdict, and ``find_fg_flip`` with
the photometric stand-in and a seeded ViT (bridged) against JAX's, alone and
through ``run_nerf.main --eval --use_dino``."""
import importlib.util
import io
import json
import os
import types

import jax
import numpy as np
import pytest
import torch

from nerfsos_torch import run_nerf
from nerfsos_torch.engines import checkpoint as tckpt
from nerfsos_torch.engines import eval as teval
from nerfsos_torch.models import extractor as text
from nerfsos_torch.models.vit import VisionTransformer as TorchViT
from nerfsos_torch.tools import validate_sos_protocol as vsp
from nerfsos_torch.utils.image import read_png
from nerfsos_tpu.engines import eval as jeval
from nerfsos_tpu.models import extractor as jext
from nerfsos_tpu.models import vit as jvit

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ("--netdepth", "2", "--netwidth", "32", "--netdepth_fine", "2", "--netwidth_fine", "32",
        "--N_samples", "8", "--N_importance", "8")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for torch in this module's tests (restored after):
    the tier-1 run's pytest workers share the machine's cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def jax_protocol():
    """The JAX twin, ``tools/validate_sos_protocol.py``, as a module."""
    spec = importlib.util.spec_from_file_location(
        "jax_validate_sos_protocol", os.path.join(REPO, "tools", "validate_sos_protocol.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_scene_matches_jax_build_dataset(jax_protocol, tmp_path):
    jax_protocol.build_dataset(str(tmp_path / "jax"))
    vsp.build_dataset(str(tmp_path / "torch"))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "torch"))
    assert len(names) == 11  # rays, rgbs, masks x train/val/test, rays_exhibit, meta.json
    for name in names:
        want, got = tmp_path / "jax" / name, tmp_path / "torch" / name
        if name == "meta.json":
            assert json.loads(got.read_text()) == json.loads(want.read_text())
            continue
        w, g = np.load(want), np.load(got)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if name.startswith("masks"):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=name)
    masks = np.load(tmp_path / "torch" / "masks_test.npy")
    assert masks.shape == (2, 64, 64, 1) and 0 < masks.mean() < 1


def _jax_phase_args(jax_protocol, monkeypatch):
    """The namespaces JAX's ``main`` passes to ``run_nerf.main`` for its
    three runs (no run: the entry point records them, the logs it reads
    back and the summary it writes are in memory)."""
    seen = {}
    real = jax_protocol.run_nerf

    def fake_open(path, mode="r"):
        if "w" in mode:
            return io.StringIO()
        return io.StringIO(json.dumps({"total_psnr": 25.0, "total_clus_ari": 0.9}))

    monkeypatch.setattr(jax_protocol, "build_dataset", lambda root: None)
    monkeypatch.setattr(jax_protocol, "run_nerf", types.SimpleNamespace(
        create_arg_parser=real.create_arg_parser,
        main=lambda args: seen.setdefault(args.expname, args)))
    monkeypatch.setattr(jax_protocol, "open", fake_open, raising=False)
    monkeypatch.setattr(jax_protocol.sys, "argv", ["validate_sos_protocol.py"])
    assert jax_protocol.main() == 0
    return seen


def test_phase_flags_match_jax_args(jax_protocol, monkeypatch):
    want = _jax_phase_args(jax_protocol, monkeypatch)
    proto = vsp.Protocol(root="/tmp/sos_protocol")  # JAX's root: the same path strings
    assert sorted(want) == ["finetune", "finetune_app", "pretrain"]
    for phase in ("pretrain", "geo", "app"):
        got = vars(proto.args(phase))
        ref = vars(want[vsp.EXPNAMES[phase]])
        shared = sorted(set(got) & set(ref))
        assert len(shared) > 80
        for k in shared:
            if k == "ckpt_path" and phase != "pretrain":
                # the port reads reference .ckpt files, JAX an orbax directory
                assert got[k] == ref[k] + ".ckpt", phase
            else:
                assert got[k] == ref[k], (phase, k)
    # the control is the geometry-only finetune with the loss's sign inverted
    geo, control = vars(proto.args("geo")), vars(proto.args("control"))
    assert {k for k in geo if geo[k] != control[k]} == {"expname", "Gcorrelation_w"}
    assert (geo["Gcorrelation_w"], control["Gcorrelation_w"]) == (1.0, -1.0)
    idle = proto.args("idle")
    assert idle.eval and idle.use_masks and idle.ckpt_path == proto.checkpoint
    bf16 = vsp.Protocol(root="r", compute_dtype="bfloat16")
    assert all(bf16.args(p).compute_dtype == "bfloat16" for p in vsp.PHASES)


def test_twin_runs_every_phase_at_a_tiny_size(tmp_path):
    """The whole gate through ``run_nerf.main`` on the CPU: 32 x 32 views,
    8 x 8 patches, a depth-2, width-32 net, 8 + 8 samples, 3 pretrain and
    2 finetune steps. No ARI threshold holds at this size; the frozen
    finetunes leave the eval's rgb as the pretrain's, bit for bit."""
    proto = vsp.Protocol(root=str(tmp_path), size=32, patch_size=8, pretrain_steps=3,
                         finetune_steps=2, extra=TINY + ("--ret_cluster",), device="cpu")
    summary = vsp.run_gate(proto)
    with open(tmp_path / "summary.json") as f:
        assert json.load(f) == json.loads(json.dumps(summary))
    for key in ("pretrain_psnr", "pretrain_seconds", "idle_clus_ari", "geo", "app", "control",
                "pass", "thresholds"):
        assert key in summary, key
    assert summary["thresholds"] == {"clus_ari": 0.5, "psnr_drop_db": 0.5}
    assert np.isfinite(summary["pretrain_psnr"]) and -1 <= summary["idle_clus_ari"] <= 1
    for kind in ("geo", "app", "control"):
        r = summary[kind]
        assert r["psnr"] == summary["pretrain_psnr"] and r["psnr_delta"] == 0.0, kind
        assert -1 <= r["clus_ari"] <= 1 and 0 <= r["fg_label_share"] <= 1, kind
        assert r["seconds"] > 0, kind
    assert isinstance(summary["control"]["refused"], bool)
    assert summary["pass"] == (summary["geo"]["pass"] and summary["app"]["pass"]
                               and summary["control"]["refused"])
    # each finetune resumed at the pretrain's step and ran its own steps
    for phase in ("geo", "app", "control"):
        ckpt = os.path.join(proto.run_dir(phase), "checkpoints", "last.ckpt")
        assert tckpt.load_checkpoint(ckpt)[1] == 5, phase
    # the geometry-only run trained the head with the loss's sign as given
    for phase, w in (("geo", "1.0"), ("control", "-1.0")):
        with open(os.path.join(proto.run_dir(phase), "args.txt")) as f:
            assert f"Gcorrelation_w = {w}\n" in f.read(), phase


@pytest.mark.parametrize("case, want", [
    ("pass", True), ("geo_ari", False), ("app_psnr_drop", False), ("geo_psnr_moved", False),
    ("control_passes", False), ("control_psnr_moved", False), ("geo_only", True)])
def test_verdict_holds_the_gate(case, want):
    runs = {"pretrain": {"psnr": 25.0}, "idle": {"clus_ari": 0.1},
            "geo": {"psnr": 25.0, "clus_ari": 0.9}, "app": {"psnr": 25.0, "clus_ari": 0.5},
            "control": {"psnr": 25.0, "clus_ari": 0.49}}
    if case == "geo_ari":
        runs["geo"]["clus_ari"] = 0.4999
    elif case == "app_psnr_drop":  # within 0.5 dB, but not the pretrain's rgb
        runs["app"]["psnr"] = 24.6
    elif case == "geo_psnr_moved":
        runs["geo"]["psnr"] = 25.0 + 1e-6
    elif case == "control_passes":
        runs["control"]["clus_ari"] = 0.5
    elif case == "control_psnr_moved":
        runs["control"]["psnr"] = 24.0
    elif case == "geo_only":
        del runs["app"]
    summary = vsp.verdict(runs)
    assert summary["pass"] is want
    assert summary["control"]["refused"] is (case != "control_passes")
    assert summary["geo"]["pass"] is (case != "geo_ari")
    assert summary["idle_clus_ari"] == 0.1


def _extractors(kind):
    """(JAX extractor, the port's) with the same weights: the photometric
    stand-in, or a 2-block ViT with 16-pixel patches (seeded in JAX, bridged)."""
    if kind == "synthetic":
        je = jext.SyntheticExtractor()
        return je, text.SyntheticExtractor(proj=tckpt.synthetic_params_from_jax(
            jax.tree_util.tree_map(np.asarray, je.params)))
    je = jext.VitExtractor("dino_vits16")
    je.vit = jvit.VisionTransformer(patch_size=16, embed_dim=32, depth=2, num_heads=2,
                                    pos_embed_size=224)
    je.init(jax.random.PRNGKey(1))
    te = text.VitExtractor(vit=TorchViT(patch_size=16, embed_dim=32, depth=2, num_heads=2))
    te.vit.load_state_dict(tckpt.vit_state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, je.params)))
    return je, te


@pytest.mark.parametrize("kind", ["synthetic", "vit"])
@pytest.mark.parametrize("hw", [(32, 48), (40, 50)])  # (40, 50): cropped to 32 x 48
def test_find_fg_flip_matches_jax(kind, hw):
    """Labels and their complement: one orientation is kept and the other
    flipped, as JAX orients them."""
    je, te = _extractors(kind)
    rng = np.random.default_rng(3)
    rgb = rng.uniform(size=(*hw, 3)).astype(np.float32)
    rgb[8:24, 12:36] = 0.9 * rgb[8:24, 12:36] + 0.1  # a patch-aligned "object"
    labels = (rng.uniform(size=(*hw, 1)) > 0.5).astype(np.int32)
    flipped = []
    for c in (labels, 1 - labels):
        want = jeval.find_fg_flip(je, rgb, c)
        got = teval.find_fg_flip(te, rgb, c)
        np.testing.assert_array_equal(got, np.asarray(want))
        flipped.append(not np.array_equal(got, c))
    assert sorted(flipped) == [False, True]


def test_find_fg_flip_keeps_the_labels_of_an_image_smaller_than_a_patch():
    _, te = _extractors("synthetic")
    labels = np.random.default_rng(4).integers(0, 2, (6, 8, 1))
    got = teval.find_fg_flip(te, np.random.default_rng(5).uniform(size=(6, 8, 3)), labels)
    assert got is labels


def test_eval_with_dino_writes_oriented_clusters(tmp_path, monkeypatch, capsys):
    """``run_nerf.main --eval --use_dino --dino_synthetic`` orients every
    view's ``clus_*.png`` by JAX's ``find_fg_flip`` on the same image and
    labels, after the metrics, and no longer says the flip is not ported."""
    proto = vsp.Protocol(root=str(tmp_path), size=32, pretrain_steps=2, extra=TINY,
                         device="cpu")
    proto.build_dataset()
    run_nerf.main(proto.args("pretrain"), device="cpu")
    calls = []
    real = teval.find_fg_flip

    def spy(dino, rgb, clustering):
        out = real(dino, rgb, clustering)
        calls.append((rgb, clustering, out))
        return out

    monkeypatch.setattr(teval, "find_fg_flip", spy)
    argv = proto.argv("idle") + ["--use_dino", "--dino_synthetic", "--ret_cluster",
                                 "--expname", "eval_dino"]
    os.makedirs(tmp_path / "logs" / "eval_dino")
    capsys.readouterr()
    run_nerf.main(run_nerf.create_arg_parser().parse_known_args(argv)[0], device="cpu")
    printed = capsys.readouterr().out
    assert "not ported" not in printed and "Photometric oracle extractor" in printed
    assert len(calls) == 2
    je = jext.SyntheticExtractor()
    eval_dir = tmp_path / "logs" / "eval_dino" / "eval"
    for i, (rgb, clustering, out) in enumerate(calls):
        np.testing.assert_array_equal(out, np.asarray(jeval.find_fg_flip(je, rgb, clustering)))
        np.testing.assert_array_equal(read_png(str(eval_dir / f"clus_{i:03d}.png")),
                                      (out[..., 0] * 255).astype(np.uint8))
    # the ARI was taken before the flip: the idle eval's, whose labels were not flipped
    os.makedirs(proto.run_dir("idle"))
    run_nerf.main(proto.args("idle"), device="cpu")
    with open(eval_dir / "log.json") as f, open(os.path.join(proto.run_dir("idle"), "eval",
                                                             "log.json")) as g:
        assert json.load(f)["clus_ari"] == json.load(g)["clus_ari"]


@pytest.mark.parametrize("shape", [(4, 3, 16, 16, 11, 11), (2, 5, 64, 64, 11, 11),
                                   (3, 2, 7, 9, 5, 6)])
def test_grid_sample_product_matches_torch_and_jax(shape):
    """The appearance loss's sampling as products (deterministic on the
    card: the bilinear matrix up to 1024 source pixels, its two axis factors
    above, as the 64 x 64 case takes) against ``F.grid_sample`` and JAX's,
    values and the source's gradient; coordinates past the border and on it."""
    from nerfsos_torch.ops.grid_sample import grid_sample_bilinear
    from nerfsos_tpu.ops.grid_sample import grid_sample_bilinear as jax_grid_sample

    N, C, H, W, Hg, Wg = shape
    rng = np.random.default_rng(6)
    t = rng.normal(size=(N, C, H, W)).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, (N, Hg, Wg, 2)).astype(np.float32)
    grid[0, 0, :2] = [[1.0, 1.0], [-1.0, -1.0]]
    tt = torch.from_numpy(t).requires_grad_(True)
    got = grid_sample_bilinear(tt, torch.from_numpy(grid))
    want = torch.nn.functional.grid_sample(tt, torch.from_numpy(grid), mode="bilinear",
                                           padding_mode="border", align_corners=True)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(jax_grid_sample(t, grid)), rtol=0, atol=1e-6)
    g = torch.from_numpy(rng.normal(size=got.shape).astype(np.float32))
    (d_got,), (d_want,) = (torch.autograd.grad(x, tt, g) for x in (got, want))
    np.testing.assert_allclose(d_got.numpy(), d_want.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 4])
def test_cli_seed_goes_to_every_run(monkeypatch, seed):
    """``--seed`` reaches every run's flags, and a seed other than the JAX
    twin's 0 gets a root of its own."""
    seen = {}

    def run_gate(proto, geo_only=False, skip_pretrain=False):
        seen["proto"] = proto
        return {"pass": True}

    monkeypatch.setattr(vsp, "run_gate", run_gate)
    assert vsp.main(["--seed", str(seed)]) == 0
    proto = seen["proto"]
    assert os.path.basename(proto.root) == ("float32" if seed == 0 else f"float32_s{seed}")
    for phase in vsp.PHASES:
        assert proto.args(phase).seed == seed
