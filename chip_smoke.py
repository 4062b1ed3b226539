"""Smoke run of the PyTorch port on one CUDA card: kernels, then the --eval path.

    python3 chip_smoke.py

Phases (one line each; any failure raises and the exit code is nonzero):
  0. the card (nvidia-smi name and power limit), torch and CUDA versions;
  1. build the kernels from nerfsos_torch/csrc with nvcc (seconds);
  2. K1 (fused coarse weights) vs its plain PyTorch version at the flagship
     width: depth 8, width 256, multires 10, 64 samples, 8192 rays;
  3. K2 (fused fine render) vs its plain version: 192 samples, semantic head
     with coordinates (sem_dim 2), multires_views 4, fixed sorted z; then
     again without the semantic head;
  4. the main path: an analytic scene with one 378x504 test view and seeded
     flagship weights saved as a reference-format .ckpt, evaluated through
     ``nerfsos_torch.run_nerf.main --eval``; the kernels' launch counters
     must show both kernels ran, log.json must hold finite metrics, and the
     view is rendered again by the plain path and compared.
The last lines are the card, one JSON object with the kernels' numbers, and
``{"ok": true, "device": {...}}``. Scratch files go to build/chip_smoke/.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
# Bound on |kernel - plain| for weights and maps. Both sides are fp32; the
# inputs of every sin/exp are bit-identical (explicit rounding, no FMA
# contraction), and what differs is the summation order of the MLP layers
# (K <= 319 terms per output, relative ~1e-6 per layer after 8+ layers)
# and of the composite sums. Weights and maps are O(1), so 1e-4 leaves two
# orders of margin over that rounding while still catching any indexing or
# layout fault, which moves values by O(1e-2) or more.
TOL = 1e-4


def phase(name: str, **fields) -> None:
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 5, warmup: int = 2) -> float:
    """Mean milliseconds per call from CUDA events, after warmup."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def seeded_field(seed: int, **kw):
    """A NeRFField whose weights come from a seeded torch.Generator (the
    default Linear init's U(-1/sqrt(fan_in), 1/sqrt(fan_in)))."""
    from nerfsos_torch.models.fields import NeRFField

    field = NeRFField(**kw)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in field.modules():
            if isinstance(m, torch.nn.Linear):
                b = 1.0 / math.sqrt(m.in_features)
                m.weight.uniform_(-b, b, generator=g)
                m.bias.uniform_(-b, b, generator=g)
    return field.cuda().eval()


def ray_inputs(n: int, s: int, seed: int):
    """Rays from a sphere of radius 4 towards the origin (unnormalized
    directions), their unit viewdirs, and sorted z in [2, 6]."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = 4.0 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = -o / 4.0 * rng.uniform(0.8, 1.2, size=(n, 1)) + 0.1 * rng.normal(size=(n, 3))
    v = d / np.linalg.norm(d, axis=1, keepdims=True)
    z = np.sort(rng.uniform(2.0, 6.0, size=(n, s)), axis=1)
    odv = torch.from_numpy(np.concatenate([o, d, v], axis=1).astype(np.float32)).cuda()
    return odv, torch.from_numpy(z.astype(np.float32)).cuda()


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max())


def kernel_vs_plain_k1(fr) -> dict:
    field = seeded_field(0, net_depth=8, net_width=256, multires=10, multires_views=4)
    odv, z = ray_inputs(8192, 64, seed=0)
    od = odv[:, :6].contiguous()
    with torch.no_grad():
        got = fr.fused_coarse_weights(field, od, z)
        want = fr.coarse_weights_plain(field, od, z)
        torch.cuda.synchronize()
        err = max_err(got, want)
        ms = cuda_ms(lambda: fr.fused_coarse_weights(field, od, z))
        plain_ms = cuda_ms(lambda: fr.coarse_weights_plain(field, od, z))
    if not (torch.isfinite(got).all() and err <= TOL):
        raise SystemExit(f"K1 disagrees with its plain version: max_abs_err={err} > {TOL}")
    phase("K1", rays=8192, samples=64, max_abs_err=err, tol=TOL, ms=ms, plain_ms=plain_ms)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def kernel_vs_plain_k2(fr, use_semantics: bool) -> dict:
    field = seeded_field(1, net_depth=8, net_width=256, multires=10, multires_views=4,
                         use_semantics=use_semantics, sem_with_coord=use_semantics, sem_dim=2)
    odv, z = ray_inputs(8192, 192, seed=1)
    with torch.no_grad():
        maps, w = fr.fused_render(field, odv, z)
        maps_p, w_p = fr.render_plain(field, odv, z)
        torch.cuda.synchronize()
        err = max(max_err(maps, maps_p), max_err(w, w_p))
        ms = cuda_ms(lambda: fr.fused_render(field, odv, z))
        plain_ms = cuda_ms(lambda: fr.render_plain(field, odv, z))
    if maps.shape != (8192, 5 + (2 if use_semantics else 0)):
        raise SystemExit(f"K2 maps shape {tuple(maps.shape)}")
    if not (torch.isfinite(maps).all() and torch.isfinite(w).all() and err <= TOL):
        raise SystemExit(f"K2 disagrees with its plain version: max_abs_err={err} > {TOL}")
    phase("K2", rays=8192, samples=192, semantics=use_semantics, max_abs_err=err, tol=TOL,
          ms=ms, plain_ms=plain_ms)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def main_path(fr) -> dict:
    from nerfsos_torch import run_nerf
    from nerfsos_torch.data.datasets import RayDataset
    from nerfsos_torch.data.synthetic import write_sphere_scene
    from nerfsos_torch.engines import checkpoint as ckpt_lib
    from nerfsos_torch.engines import eval as eval_lib
    from nerfsos_torch.models.nerf import NeRFConfig, NeRFNet

    data, logs = os.path.join(WORK, "data"), os.path.join(WORK, "logs")
    H, W = 378, 504
    write_sphere_scene(data, H, W, n_views=1)
    os.makedirs(os.path.join(logs, "smoke"), exist_ok=True)
    cfg = NeRFConfig(n_samples=64, n_importance=128, use_semantics=True, sem_with_coord=True)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        ckpt_net = NeRFNet(cfg)
    ckpt = os.path.join(WORK, "seeded.ckpt")
    ckpt_lib.save_checkpoint(ckpt, 0, ckpt_net)

    argv = ["--expname", "smoke", "--basedir", logs, "--data_path", data,
            "--data_type", "llff", "--eval", "--fast_mode", "--ret_cluster", "--clus_no_sfm",
            "--sem_with_coord", "--N_samples", "64", "--N_importance", "128",
            "--use_masks", "--ckpt_path", ckpt]
    args, _ = run_nerf.create_arg_parser().parse_known_args(argv)

    views = []
    orig = eval_lib.eval_one_view

    def recording_eval_one_view(*a, **kw):
        ret, metrics = orig(*a, **kw)
        views.append(ret)
        return ret, metrics

    fr.fused_coarse_weights.launches = 0
    fr.fused_render.launches = 0
    eval_lib.eval_one_view = recording_eval_one_view
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_nerf.main(args)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        eval_lib.eval_one_view = orig
    launches = {"K1": fr.fused_coarse_weights.launches, "K2": fr.fused_render.launches}
    phase("eval", view=f"{H}x{W}", seconds_incl_load_and_metrics=seconds, launches=launches)
    if min(launches.values()) < 1:
        raise SystemExit(f"the --eval run did not go through both kernels: {launches}")

    with open(os.path.join(logs, "smoke", "eval", "log.json")) as f:
        log = json.load(f)
    for k in ("total_mse", "total_psnr", "total_ssim"):
        if not (isinstance(log.get(k), float) and math.isfinite(log[k])):
            raise SystemExit(f"log.json {k}={log.get(k)!r} is not finite")
    if not os.path.exists(os.path.join(logs, "smoke", "eval", "rgb_000.png")):
        raise SystemExit("rgb_000.png was not written")
    (ret,) = views
    for k in ("rgb", "depth", "acc", "disp", "semantics", "weights"):
        if not np.isfinite(ret[k]).all():
            raise SystemExit(f"rendered {k} holds non-finite values")
    phase("eval_metrics", psnr=log["total_psnr"], ssim=log["total_ssim"],
          clus_ari=log["total_clus_ari"], sem_ari=log["total_sem_ari"])

    # the same view again, render only: kernel path vs plain path
    net, _ = run_nerf.build_model(args, torch.device("cuda"))
    state, _ = ckpt_lib.load_checkpoint(ckpt)
    net.load_state_dict(state)
    plain = NeRFNet(dataclasses.replace(net.cfg, fused_field=False)).cuda().eval()
    plain.load_state_dict(state)
    dataset = RayDataset(data, split="test")
    rays, near_far = dataset.get_view(0)["rays"], dataset.near_far()
    out, secs = {}, {}
    for name, model in (("kernel", net), ("plain", plain)):
        render = eval_lib.make_render_fn(model, *near_far)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[name] = render(rays)
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
    d_rgb = (out["kernel"]["rgb"] - out["plain"]["rgb"]).abs().amax(dim=-1)
    frac = float((d_rgb > 1e-3).float().mean())
    phase("render", view=f"{H}x{W}", kernel_s=secs["kernel"], plain_s=secs["plain"],
          rgb_max_abs_diff=float(d_rgb.max()), frac_rays_over_1e_3=frac)
    # importance samples may move by one bin where a u falls on a CDF edge, so
    # the end-to-end check bounds the share of rays that differ, not the max
    if frac > 1e-3:
        raise SystemExit(f"{frac:.2%} of rays differ by more than 1e-3 from the plain path")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    smi = smi_line()
    phase("device", nvidia_smi=repr(smi), torch=torch.__version__, cuda=torch.version.cuda,
          count=torch.cuda.device_count())
    if torch.backends.cuda.matmul.allow_tf32:
        raise SystemExit("torch.backends.cuda.matmul.allow_tf32 must be off")

    from nerfsos_torch import _build
    from nerfsos_torch.ops import fused_render as fr

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    phase("build", seconds=time.perf_counter() - t0, lib=os.path.relpath(lib_path, ROOT))
    with open(lib_path + ".log") as f:
        for line in f:
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())

    k1 = kernel_vs_plain_k1(fr)
    k2 = kernel_vs_plain_k2(fr, use_semantics=True)
    kernel_vs_plain_k2(fr, use_semantics=False)
    launches = main_path(fr)

    src = "nerfsos_torch/csrc/fused_render.cu"
    kernels = [
        {"name": "K1 fused_coarse_weights", "route": "cuda", "source": src,
         "replaces": "nerfsos_tpu/ops/pallas/fused_render.py:458",
         "launches": launches["K1"], **k1},
        {"name": "K2 fused_render", "route": "cuda", "source": src,
         "replaces": "nerfsos_tpu/ops/pallas/fused_render.py:369",
         "launches": launches["K2"], **k2},
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
