"""The SOS quality gate of the port: the twin of the JAX package's
``tools/validate_sos_protocol.py``, through ``nerfsos_torch.run_nerf``.

    python -m nerfsos_torch.tools.validate_sos_protocol [--compute_dtype float32|bfloat16]
        [--geo-only] [--skip-pretrain] [--root DIR] [--seed N]

On the card (``run_nerf.main`` runs on ``cuda:0``), with the JAX twin's
scene, flags and schedule:

1. the analytic scene of ``build_dataset``: a textured sphere (mask 1) in a
   textured background shell, 64 x 64 views, 16 train and 2 test, ground-
   truth masks from the ray-sphere hit test (read by the ARI metric only);
2. ``pretrain``: the RGB pretrain of the 8 x 256 net with its semantic
   head (idle), 1500 steps of 4096 rays;
3. ``idle``: that checkpoint evaluated with ``--use_masks``: the clus ARI of
   the untrained head (a reading, not a gate);
4. ``geo``: from the pretrain's ``last.ckpt``, 500 frozen-backbone patch
   steps (``--max_steps 2000`` is global) with the geometry correlation
   loss alone, the seeded ViT-S/16 giving its similarity matrix;
5. ``app`` (skipped with ``--geo-only``): the same with the appearance loss
   dominant (``correlation_w 1``, ``Gcorrelation_w 0.01``) on the
   photometric stand-in (``--dino_synthetic``);
6. ``control``: ``geo`` with the loss's sign inverted (``--Gcorrelation_w
   -1.0``: gradient ascent on the geometry loss), which the gate must
   refuse.

The gate (the JAX twin's): each of ``geo`` and ``app`` reaches a held-out
clus ARI of at least 0.5 with its PSNR within 0.5 dB of the pretrain's.
Beyond it: a frozen finetune cannot move the rgb of the eval render, so
each finetune's PSNR equals the pretrain's exactly (``psnr_delta`` 0), and
the control is refused. ``summary.json`` under the root holds every
reading; the exit code is 0 only when all of this holds. ``--compute_dtype``
is passed to every run (a bf16 gate pretrains at bf16); the default root is
``build/sos_protocol/<dtype>`` in the checkout. ``--skip-pretrain`` reuses
the root's pretrain when its eval log is there. ``--seed`` (default 0, the
JAX twin's) goes to every run: the pretrain's net starts from the JAX entry
point's initial weights at that seed (``models/seeded``), and the gate's
verdict depends on that draw (PERF.md §7); a seed other than 0 runs under
``build/sos_protocol/<dtype>_s<seed>``.

``Protocol`` runs each phase alone (``chip_smoke.py`` counts the kernels'
launches around each); its image size, patch size, step counts and extra
flags (``--netdepth``, ``--N_samples``, ...) shrink it for the CPU test
(``device="cpu"``). The thresholds are fixed.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Dict, Optional, Sequence

import numpy as np

from nerfsos_torch.data.synthetic import (FAR, NEAR, R_CAM, persp_rays, pose_spherical,
                                          render_analytic)

SIZE = 64  # H = W
FOCAL_PER_PIXEL = 80.0 / 64  # the JAX twin's focal 80 at 64 pixels
N_TRAIN, N_TEST = 16, 2
PRETRAIN_STEPS, FINETUNE_STEPS = 1500, 500
ARI_GATE = 0.5  # each finetune's held-out clus ARI, at least
PSNR_DROP_DB = 0.5  # each finetune's PSNR, at most this far below the pretrain's

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PHASES = ("pretrain", "idle", "geo", "app", "control")
EXPNAMES = {"pretrain": "pretrain", "idle": "pretrain_idle", "geo": "finetune",
            "app": "finetune_app", "control": "finetune_control"}
HEAD = ("--use_semantics", "--sem_with_coord", "--raw_noise_std", "1.0")
GEO_PARAMS = ("--geo_corr_params", "0.5", "1", "3", "1")
LOSS_FLAGS = {
    "geo": ("--use_dino", "--use_geoCorr", "--Gcorrelation_w", "1.0") + GEO_PARAMS,
    "app": ("--use_dino", "--dino_synthetic", "--use_correlation", "--use_geoCorr",
            "--correlation_w", "1.0", "--Gcorrelation_w", "0.01") + GEO_PARAMS,
    "control": ("--use_dino", "--use_geoCorr", "--Gcorrelation_w", "-1.0") + GEO_PARAMS,
}


def build_dataset(root: str, size: int = SIZE) -> None:
    """The JAX twin's ``build_dataset`` at ``size`` x ``size`` pixels (the
    focal scaled with it): 18 cameras on a circle at pitches -10, -25, -40
    degrees in turn; views 0-15 train, 16-17 val and test (and exhibit);
    ``meta.json`` with the split indices. No poses are written."""
    os.makedirs(root, exist_ok=True)
    focal = FOCAL_PER_PIXEL * size
    angles = np.linspace(0.0, 360.0, N_TRAIN + N_TEST, endpoint=False)
    poses = np.stack([pose_spherical(a, -25.0 - 15.0 * ((i % 3) - 1), R_CAM)[:3, :4]
                      for i, a in enumerate(angles)])
    rays = persp_rays(size, size, focal, poses)
    rgbs, masks = (np.stack(x) for x in zip(*(render_analytic(r) for r in rays)))
    i_train, i_test = np.arange(N_TRAIN), np.arange(N_TRAIN, N_TRAIN + N_TEST)
    for split, idx in (("train", i_train), ("val", i_test), ("test", i_test)):
        np.save(os.path.join(root, f"rays_{split}.npy"), rays[idx])
        np.save(os.path.join(root, f"rgbs_{split}.npy"), rgbs[idx])
        np.save(os.path.join(root, f"masks_{split}.npy"), masks[idx])
    np.save(os.path.join(root, "rays_exhibit.npy"), rays[i_test])
    with open(os.path.join(root, "meta.json"), "w") as f:
        json.dump({"H": size, "W": size, "focal": focal, "near": NEAR, "far": FAR,
                   "i_train": i_train.tolist(), "i_val": i_test.tolist(),
                   "i_test": i_test.tolist(), "ndc": False, "factor": 1,
                   "spherify": False, "llffhold": 0, "half_res": False,
                   "white_bkgd": False, "test_skip": 1, "dv_scene": ""}, f)


def fg_label_share(eval_dir: str, data: str) -> Optional[float]:
    """The share of the test views' sphere pixels whose ``clus_*.png`` label
    is 1 (written with ``--ret_cluster``, after the foreground flip); None
    when no such image was written."""
    from nerfsos_torch.utils.image import read_png

    masks = np.load(os.path.join(data, "masks_test.npy"))[..., 0] > 0.5
    paths = [os.path.join(eval_dir, f"clus_{i:03d}.png") for i in range(masks.shape[0])]
    if not all(os.path.exists(p) for p in paths):
        return None
    labels = np.stack([read_png(p) for p in paths]) == 255
    return float(labels[masks].mean())


@dataclasses.dataclass
class Protocol:
    """The gate's runs under ``root`` (``data/``, ``logs/<expname>/``)."""

    root: str
    compute_dtype: str = "float32"
    size: int = SIZE
    patch_size: int = 16
    pretrain_steps: int = PRETRAIN_STEPS
    finetune_steps: int = FINETUNE_STEPS
    extra: Sequence[str] = ()
    device: Optional[str] = None  # run_nerf.main's: None is the card

    @property
    def data(self) -> str:
        return os.path.join(self.root, "data")

    @property
    def logs(self) -> str:
        return os.path.join(self.root, "logs")

    def run_dir(self, phase: str) -> str:
        return os.path.join(self.logs, EXPNAMES[phase])

    @property
    def checkpoint(self) -> str:
        return os.path.join(self.run_dir("pretrain"), "checkpoints", "last.ckpt")

    def argv(self, phase: str) -> list:
        """The phase's flags: the JAX twin's ``_args`` base, the phase's own,
        ``--compute_dtype`` and the caller's ``extra`` (last, so they win)."""
        argv = ["--expname", EXPNAMES[phase], "--basedir", self.logs,
                "--data_path", self.data, "--data_type", "llff",
                "--N_samples", "64", "--N_importance", "128",
                "--lrate", "5e-4", "--i_print", "200",
                "--i_weights", "100000", "--i_testset", "1000000",
                "--i_video", "1000000", "--i_img", "1000000"]
        if phase == "pretrain":
            argv += ["--max_steps", str(self.pretrain_steps), "--batch_size", "4096", *HEAD]
        elif phase == "idle":
            argv += [*HEAD, "--eval", "--use_masks", "--ckpt_path", self.checkpoint]
        else:
            # --max_steps is global: the checkpoint resumes at the pretrain's step
            argv += ["--max_steps", str(self.pretrain_steps + self.finetune_steps), *HEAD,
                     "--patch_tune", "--patch_size", str(self.patch_size),
                     "--patch_stride", "2", "--batch_size", "8", "--fix_backbone",
                     *LOSS_FLAGS[phase], "--ckpt_path", self.checkpoint, "--use_masks"]
        return argv + ["--compute_dtype", self.compute_dtype, *self.extra]

    def args(self, phase: str) -> argparse.Namespace:
        from nerfsos_torch import run_nerf

        args, _ = run_nerf.create_arg_parser().parse_known_args(self.argv(phase))
        return args

    def build_dataset(self) -> None:
        build_dataset(self.data, self.size)

    def read(self, phase: str) -> Dict[str, float]:
        """The phase's eval log: held-out PSNR and clus ARI, and the share of
        sphere pixels labelled 1 (None without ``--ret_cluster``)."""
        eval_dir = os.path.join(self.run_dir(phase), "eval")
        with open(os.path.join(eval_dir, "log.json")) as f:
            log = json.load(f)
        return {"psnr": log["total_psnr"], "clus_ari": log["total_clus_ari"],
                "fg_label_share": fg_label_share(eval_dir, self.data)}

    def run(self, phase: str) -> Dict[str, float]:
        """``run_nerf.main`` for one phase; its readings and seconds."""
        from nerfsos_torch import run_nerf

        if phase == "idle":  # --eval needs its run directory
            os.makedirs(self.run_dir(phase), exist_ok=True)
        t0 = time.perf_counter()
        run_nerf.main(self.args(phase), device=self.device)
        seconds = time.perf_counter() - t0
        out = self.read(phase)
        out["seconds"] = seconds
        print(f"[protocol] {self.compute_dtype} {phase}: held-out PSNR {out['psnr']:.4f} dB, "
              f"clus ARI {out['clus_ari']:.4f} ({seconds:.1f} s)", flush=True)
        return out


def verdict(runs: Dict[str, Dict[str, float]]) -> dict:
    """The summary of the runs (``pretrain``, ``idle``, ``geo``, ``app`` and
    ``control``; ``app`` may be missing): each finetune's ``psnr_delta``
    against the pretrain, the JAX gate's ``pass`` for ``geo`` and ``app``,
    ``refused`` for the control, and the whole ``pass``."""
    pre = runs["pretrain"]["psnr"]
    summary = {"pretrain_psnr": pre, "pretrain_seconds": runs["pretrain"].get("seconds"),
               "idle_clus_ari": runs["idle"]["clus_ari"],
               "thresholds": {"clus_ari": ARI_GATE, "psnr_drop_db": PSNR_DROP_DB}}
    ok = True
    for kind in ("geo", "app", "control"):
        if kind not in runs:
            continue
        r = dict(runs[kind])
        r["psnr_delta"] = r["psnr"] - pre
        gate = r["clus_ari"] >= ARI_GATE and r["psnr"] >= pre - PSNR_DROP_DB
        if kind == "control":
            r["refused"] = not gate
            ok = ok and r["refused"] and r["psnr_delta"] == 0.0
        else:
            r["pass"] = gate
            ok = ok and gate and r["psnr_delta"] == 0.0
        summary[kind] = r
    summary["pass"] = ok
    return summary


def run_gate(proto: Protocol, geo_only: bool = False, skip_pretrain: bool = False) -> dict:
    """Every phase in order; writes ``summary.json`` under the root."""
    proto.build_dataset()
    print("[protocol] dataset written:", proto.data)
    runs = {}
    if skip_pretrain and os.path.exists(os.path.join(proto.run_dir("pretrain"), "eval",
                                                     "log.json")):
        runs["pretrain"] = proto.read("pretrain")
    else:
        runs["pretrain"] = proto.run("pretrain")
    for phase in ("idle", "geo") + (() if geo_only else ("app",)) + ("control",):
        runs[phase] = proto.run(phase)
    summary = verdict(runs)
    summary["compute_dtype"] = proto.compute_dtype
    with open(os.path.join(proto.root, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    for kind in ("geo", "app", "control"):
        if kind in summary:
            print(f"[protocol] {kind}: psnr_delta {summary[kind]['psnr_delta']!r}")
    print(f"[protocol] {'PASS' if summary['pass'] else 'FAIL'} ({json.dumps(summary)})")
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--compute_dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--geo-only", action="store_true")
    ap.add_argument("--skip-pretrain", action="store_true")
    ap.add_argument("--root", default=None,
                    help="default: build/sos_protocol/<compute_dtype> in the checkout")
    ap.add_argument("--seed", type=int, default=0, help="every run's --seed")
    a = ap.parse_args(argv)
    name = a.compute_dtype + (f"_s{a.seed}" if a.seed else "")
    root = a.root or os.path.join(HERE, "build", "sos_protocol", name)
    extra = ("--seed", str(a.seed)) if a.seed else ()
    summary = run_gate(Protocol(root=root, compute_dtype=a.compute_dtype, extra=extra),
                       geo_only=a.geo_only, skip_pretrain=a.skip_pretrain)
    return 0 if summary["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
