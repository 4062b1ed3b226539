"""Smoke run of the PyTorch port on one CUDA card: kernels, the --eval path,
then the train path.

    python3 chip_smoke.py

Phases (one line each; any failure raises and the exit code is nonzero):
  0. the card (nvidia-smi name and power limit), torch and CUDA versions;
  1. build the kernels from nerfsos_torch/csrc with nvcc, one compiler per
     source at once (seconds), and print ptxas's register/spill report;
  2. K1 (fused coarse weights) vs its plain PyTorch version at the flagship
     width: depth 8, width 256, multires 10, 64 samples, 8192 rays;
  3. K2 (fused fine render) vs its plain version: 192 samples, semantic head
     with coordinates (sem_dim 2), multires_views 4, fixed sorted z; then
     again without the semantic head;
  4. the eval path: an analytic scene with one 378x504 test view and seeded
     flagship weights saved as a reference-format .ckpt, evaluated through
     ``nerfsos_torch.run_nerf.main --eval``; the kernels' launch counters
     must show both kernels ran, log.json must hold finite metrics, the run's
     seconds are split into render, metrics and the rest, and the view is
     rendered again by the plain path and compared;
  5. K3 (fused RGB train pass) vs its plain version at the flagship width,
     sigma noise 1 from a fixed seed, fixed sorted z: at 4096 rays coarse
     S=64 and fine S=192 with the semantic head, then S=192 with white_bkgd
     and no semantic head; at 1024 rays (the train step's size) S=64 and
     S=192; maps, weights and every gradient leaf, and the gradients of two
     calls must be bitwise equal;
  6. the train path: ``run_nerf.main`` without --eval, with the flags of
     configs/flower_full.txt (N_rand 1024, 64 + 128 samples, noise 1, the
     semantic head) on 8 train views at 378x504, 30 steps: K3 launches twice
     a step, the loss is finite and falls, the 10/20/30-step checkpoints hold
     optimizer state, the final eval runs through K1/K2, and the last step's
     two K3 calls (importance-sampled z for the fine one) agree with the
     plain version on their inputs;
  7. resume: ``main`` again with 40 steps resumes from latest.ckpt at step 30
     with the Adam state and launches K3 twice a step;
  8. train step timings (CUDA events) at 1024, 4096 and 16384 rays on the
     kernel path and at 1024 and 4096 on the plain path (16384 when it fits).
The last lines are the card, one JSON object with the kernels' numbers, and
``{"ok": true, "device": {...}}``. Scratch files go to build/chip_smoke/.
"""
from __future__ import annotations

import copy
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
# Bound on max |kernel - plain| of each K3 gradient leaf, relative to that
# leaf's max |plain|, before the leaf's flip allowance (below). Both sides
# are fp32, but a dW entry sums up to 4096 x 192 = 786k products in another
# order on each side (the kernel per 64-point k step, then per chunk, then
# per CTA; cuBLAS in its own blocking), and the cotangents themselves pass
# through the 8-layer reverse sweep; fp32 summation of n terms moves a sum by
# ~sqrt(n) * 2^-24 of its terms' scale, ~5e-5 at n = 786k. 1e-3 leaves an
# order of margin while a layout or indexing fault moves a leaf by O(1e-2)
# (one 512-point chunk of a 1024 x 64 call) to O(1) of its scale.
GRAD_TOL = 1e-3
# A gate (a trunk or views relu, or the relu of sigma + noise) whose input
# lies within this share of its layer's largest |input| of 0 may take the
# other side in the kernel than in the plain version: their inputs differ by
# rounding alone (fp32 sums in another order), far below 1e-6 of the layer's
# largest. A flipped gate moves every leaf by up to that point's whole term,
# which in a 1024-ray train step is above GRAD_TOL of a leaf ([train_k3]);
# each leaf therefore gets twice the largest term of a point near a gate on
# top of GRAD_TOL. tests/test_torch_cuda.py picks rays with no trunk or
# views gate near 0, so that its leaves are held to GRAD_TOL alone.
GATE_MARGIN = 1e-6
# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bytes/s, and the fp32-accurate
# tensor-core rate of the 3xTF32 products the kernels use (495 TFLOP/s TF32
# dense / 3).
HBM_BYTES_S = 3.35e12
FP32_MMA_FLOP_S = 495e12 / 3


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


def linear_shapes(field):
    """(name, in, out) of every dense layer of a NeRFField."""
    return [(n, m.in_features, m.out_features) for n, m in field.named_modules()
            if isinstance(m, torch.nn.Linear)]


def field_flops(field, kind: str) -> float:
    """Matrix-product FLOP per point: 'k1' the trunk and alpha head, 'k2' every
    layer, 'k3' the forward of every layer + the input-gradient products of
    K3's reverse sweep (each trunk layer but the first on its h input,
    feature and alpha on h, views on the feature input, rgb) + the
    weight-gradient products of every layer but the semantic head."""
    shapes = linear_shapes(field)
    mlp = field.mlp
    fwd = sum(2 * i * o for _, i, o in shapes)
    if kind == "k1":
        return sum(2 * i * o for n, i, o in shapes if "pts_linears" in n or "alpha" in n)
    if kind == "k2":
        return fwd
    W = mlp.width
    dx = (2 * W * W * (mlp.depth - 1) + 2 * W * W + 2 * W + 2 * (W // 2) * W
          + 2 * 3 * (W // 2))
    dw = sum(2 * i * o for n, i, o in shapes if "semantic" not in n)
    return fwd + dx + dw


def bound_ms(bytes_moved: float, flops: float) -> dict:
    """The least time the card could take: the larger of the bytes over HBM
    and the operations over the fp32-accurate tensor-core rate."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_S * 1e3, flops / FP32_MMA_FLOP_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations"}


def n_params(field) -> int:
    return sum(p.numel() for p in field.parameters())


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
    bound = bound_ms(4 * (8192 * (6 + 2 * 64) + n_params(field)),
                     8192 * 64 * field_flops(field, "k1"))
    phase("K1", rays=8192, samples=64, max_abs_err=err, tol=TOL, ms=ms, plain_ms=plain_ms,
          **bound)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bound, "library_ms": None}


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
    bound = bound_ms(4 * (8192 * (9 + 2 * 192 + maps.shape[1]) + n_params(field)),
                     8192 * 192 * field_flops(field, "k2"))
    phase("K2", rays=8192, samples=192, semantics=use_semantics, max_abs_err=err, tol=TOL,
          ms=ms, plain_ms=plain_ms, **bound)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bound, "library_ms": None}


def plain_k3_with_gates(field, odv, z, gt, kw):
    """K3's plain version, and what a gate that flips between it and the
    kernel can move: per point, the least |input| of any of its gates
    relative to that layer's largest (``slack [R*S]``); per dense layer (by
    name), the point's largest |input| and largest |output cotangent|, whose
    product bounds the point's term in every entry of the layer's dW."""
    from nerfsos_torch.ops import fused_render as fr

    mlp = field.mlp
    R, S = z.shape
    P = R * S
    gates = [*mlp.pts_linears, mlp.views_linears[0], mlp.alpha_linear]
    noise = (fr.noise_plain(kw["seed"], R, S, kw["noise_std"], z.device).reshape(P, 1)
             if kw["noise_std"] > 0 else 0.0)
    slack = torch.full((P,), float("inf"), device=z.device)
    terms = {}

    def hook(mod, inputs, out):
        t = terms[mod] = [inputs[0].detach().reshape(P, -1).abs().amax(1), torch.zeros_like(slack)]
        if out.requires_grad:
            out.register_hook(lambda g: t.__setitem__(1, g.reshape(P, -1).abs().amax(1)))
        if any(mod is m for m in gates):
            pre = (out.detach().reshape(P, -1) + (noise if mod is mlp.alpha_linear else 0.0)).abs()
            torch.minimum(slack, pre.amin(1) / pre.max(), out=slack)

    handles = [m.register_forward_hook(hook) for m in field.modules()
               if isinstance(m, torch.nn.Linear)]
    try:
        want = fr.rgb_train_grads_plain(field, odv, z, gt, **kw)
    finally:
        for h in handles:
            h.remove()
    names = {m: n for n, m in field.named_modules()}
    return want, slack, {names[m]: t for m, t in terms.items()}


def flip_allowance(slack, terms) -> dict:
    """Per gradient leaf: twice the largest term of a point with a gate
    within GATE_MARGIN of 0, or 0 where there is none."""
    near = slack <= GATE_MARGIN
    allow = {}
    for name, (x, g) in terms.items():
        x, g = x[near], g[near]
        allow[f"{name}.weight"] = 2 * float((x * g).max()) if near.any() else 0.0
        allow[f"{name}.bias"] = 2 * float(g.max()) if near.any() else 0.0
    return allow


def check_k3(what: str, got, want, slack, terms) -> dict:
    """K3's (grads, maps, weights) vs its plain version's: maps and weights
    to TOL, every gradient leaf to GRAD_TOL of its max |plain| plus the
    leaf's flip allowance; raises."""
    (g, maps, w), (gp, maps_p, w_p) = got, want
    err = max(max_err(maps, maps_p), max_err(w, w_p))
    allow = flip_allowance(slack, terms)
    grad_err, worst, over = 0.0, "", 0.0
    for name, ref in gp.items():
        scale = max(float(ref.abs().max()), 1e-12)
        e = max_err(g[name], ref)
        if e / scale >= grad_err:
            grad_err, worst = e / scale, name
        over = max(over, e / (GRAD_TOL * scale + allow[name]))
    finite = all(torch.isfinite(t).all() for t in (maps, w, *g.values()))
    if not (maps.shape == maps_p.shape and finite and err <= TOL and over <= 1.0):
        raise SystemExit(f"K3 disagrees with its plain version ({what}): maps {tuple(maps.shape)} "
                         f"vs {tuple(maps_p.shape)}, maps/weights max_abs_err={err} (tol {TOL}), "
                         f"grads {grad_err} of the leaf's max at {worst}, worst leaf error over "
                         f"its bound {over}, finite={finite}")
    return {"max_abs_err": err, "tol": TOL, "grad_rel_err": grad_err, "worst_leaf": worst,
            "grad_tol": GRAD_TOL, "near_gate_points": int((slack <= GATE_MARGIN).sum()),
            "grad_err_over_bound": over}


def kernel_vs_plain_k3(fr, R: int, S: int, use_semantics: bool, white_bkgd: bool) -> dict:
    field = seeded_field(2, net_depth=8, net_width=256, multires=10, multires_views=4,
                         use_semantics=use_semantics, sem_dim=2)
    odv, z = ray_inputs(R, S, seed=2 + S)
    gt = torch.from_numpy(np.random.default_rng(3).uniform(0, 1, (R, 3)).astype(np.float32)).cuda()
    kw = dict(white_bkgd=white_bkgd, noise_std=1.0, seed=1234567)
    got = fr.fused_rgb_train_grads(field, odv, z, gt, **kw)
    g2, _, _ = fr.fused_rgb_train_grads(field, odv, z, gt, **kw)
    torch.cuda.synchronize()
    close = check_k3(f"R={R} S={S}", got, *plain_k3_with_gates(field, odv, z, gt, kw))
    if not all(torch.equal(got[0][k], g2[k]) for k in g2):
        raise SystemExit(f"K3's gradients differ between two calls (R={R} S={S})")
    ms = cuda_ms(lambda: fr.fused_rgb_train_grads(field, odv, z, gt, **kw))
    plain_ms = cuda_ms(lambda: fr.rgb_train_grads_plain(field, odv, z, gt, **kw), reps=3)
    flops = R * S * field_flops(field, "k3")
    bound = bound_ms(4 * (R * (9 + 3 + 2 * S + got[1].shape[1]) + 2 * n_params(field)), flops)
    phase("K3", rays=R, samples=S, semantics=use_semantics, white_bkgd=white_bkgd, **close,
          deterministic=True, ms=ms, plain_ms=plain_ms, tflop=flops / 1e12, **bound)
    return {"max_abs_err": close["max_abs_err"], "ms": ms, "plain_ms": plain_ms, **bound,
            "library_ms": None}


def eval_path(fr) -> dict:
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

    views, spent = [], {"view": 0.0, "render": 0.0}
    orig = eval_lib.eval_one_view

    def timed(key, fn, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        spent[key] += time.perf_counter() - t0
        return out

    def recording_eval_one_view(render_fn, *a, **kw):
        ret, metrics = timed("view", orig, lambda rays: timed("render", render_fn, rays), *a, **kw)
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
    # the run's seconds: the view's render, then its k-means, ARI and SSIM,
    # then the rest (arguments, model, checkpoint, data, PNGs, logs)
    phase("eval", view=f"{H}x{W}", seconds=seconds, render_s=spent["render"],
          metrics_s=spent["view"] - spent["render"], rest_s=seconds - spent["view"],
          launches=launches)
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
    state, _, _ = ckpt_lib.load_checkpoint(ckpt)
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


TRAIN_STEPS, RESUME_STEPS = 30, 40


def train_args(data: str, logs: str, max_steps: int):
    """The flagship pretrain flags (configs/flower_full.txt: N_rand 1024,
    64 + 128 samples, raw_noise_std 1, the semantic head by default) on the
    smoke scene."""
    from nerfsos_torch import run_nerf

    argv = ["--config", os.path.join(ROOT, "configs", "flower_full.txt"),
            "--expname", "smoke_train", "--basedir", logs, "--data_path", data,
            "--max_steps", str(max_steps), "--i_print", "10", "--i_weights", "10",
            "--i_testset", "1000000", "--fast_mode"]
    args, _ = run_nerf.create_arg_parser().parse_known_args(argv)
    return args


def run_train(fr, max_steps: int, capture_step: int = -1) -> dict:
    """``run_nerf.main`` in train mode with every kernel count set to 0 just
    before and read just after; the train step is wrapped to record each
    step's index and loss and the Adam step count it starts from. At
    ``capture_step`` the inputs (the field as it was, rays, z, targets,
    noise seed) and outputs of both K3 calls are kept in ``rec["k3_calls"]``."""
    from nerfsos_torch import run_nerf
    from nerfsos_torch.engines import trainer

    rec = {"steps": [], "losses": [], "adam_step_at_start": None, "k3_calls": []}
    orig = trainer.make_rgb_train_step
    capturing = [False]

    def recording_grads(field, odv, z, gt, **kw):
        out = fr.fused_rgb_train_grads(field, odv, z, gt, **kw)
        if capturing[0]:
            rec["k3_calls"].append((copy.deepcopy(field), odv.clone(), z.clone(), gt.clone(),
                                    kw, out))
        return out

    def recording_make_step(net, optimizer, *a, **kw):
        step = orig(net, optimizer, *a, grads_fn=recording_grads, **kw)
        first = next(net.parameters())

        def recorded(batch, global_step):
            if rec["adam_step_at_start"] is None:
                st = optimizer.state.get(first, {})
                rec["adam_step_at_start"] = int(st["step"]) if "step" in st else 0
            capturing[0] = global_step == capture_step
            metrics = step(batch, global_step)
            rec["steps"].append(global_step)
            rec["losses"].append(metrics["loss"])
            return metrics

        return recorded

    args = train_args(os.path.join(WORK, "data"), os.path.join(WORK, "logs"), max_steps)
    fr.fused_coarse_weights.launches = 0
    fr.fused_render.launches = 0
    fr.fused_rgb_train_grads.launches = 0
    trainer.make_rgb_train_step = recording_make_step
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_nerf.main(args)
        torch.cuda.synchronize()
        rec["seconds"] = time.perf_counter() - t0
    finally:
        trainer.make_rgb_train_step = orig
    rec["launches"] = {"K1": fr.fused_coarse_weights.launches, "K2": fr.fused_render.launches,
                       "K3": fr.fused_rgb_train_grads.launches}
    rec["losses"] = [float(x) for x in rec["losses"]]
    return rec


def check_checkpoints(run_dir: str, names) -> None:
    from nerfsos_torch.engines import checkpoint as ckpt_lib

    for name in names:
        path = os.path.join(run_dir, "checkpoints", name)
        if not os.path.exists(path):
            raise SystemExit(f"{name} was not written")
        _, _, opt = ckpt_lib.load_checkpoint(path)
        if not (opt and opt.get("state")):
            raise SystemExit(f"{name} holds no optimizer state")


def check_final_eval(run_dir: str) -> dict:
    with open(os.path.join(run_dir, "eval", "log.json")) as f:
        log = json.load(f)
    for k in ("total_mse", "total_psnr", "total_ssim"):
        if not (isinstance(log.get(k), float) and math.isfinite(log[k])):
            raise SystemExit(f"final eval log.json {k}={log.get(k)!r} is not finite")
    return log


def train_path(fr) -> dict:
    from nerfsos_torch.data.synthetic import write_sphere_scene

    write_sphere_scene(os.path.join(WORK, "data"), 378, 504, n_views=8, split="train")
    rec = run_train(fr, TRAIN_STEPS, capture_step=TRAIN_STEPS - 1)
    losses, launches = rec["losses"], rec["launches"]
    run_dir = os.path.join(WORK, "logs", "smoke_train")
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    phase("train", steps=len(losses), views="8x378x504", seconds_incl_load_and_eval=rec["seconds"],
          launches=launches, loss_first10=first, loss_last10=last,
          loss_step1=losses[0], loss_step30=losses[-1])
    if rec["steps"] != list(range(TRAIN_STEPS)):
        raise SystemExit(f"train ran steps {rec['steps']}")
    if launches["K3"] != 2 * TRAIN_STEPS or min(launches["K1"], launches["K2"]) < 1:
        raise SystemExit(f"the train run did not go through the kernels as expected: {launches}")
    if not (all(math.isfinite(x) for x in losses) and last < first):
        raise SystemExit(f"train loss not finite or not falling: {losses}")
    check_checkpoints(run_dir, ["00000010.ckpt", "00000020.ckpt", "00000030.ckpt",
                                "latest.ckpt", "last.ckpt"])
    log = check_final_eval(run_dir)
    phase("train_eval", psnr=log["total_psnr"], ssim=log["total_ssim"])
    # the last step's two K3 calls (coarse: stratified z; fine: the coarse z
    # and the importance samples, sorted) against the plain version on the
    # same inputs; only the plain version runs here
    if len(rec["k3_calls"]) != 2:
        raise SystemExit(f"captured {len(rec['k3_calls'])} K3 calls of step {TRAIN_STEPS - 1}")
    for name, (field, odv, z, gt, kw, got) in zip(("coarse", "fine"), rec["k3_calls"]):
        close = check_k3(f"train step {TRAIN_STEPS - 1}, {name}", got,
                         *plain_k3_with_gates(field, odv, z, gt, kw))
        phase("train_k3", step=TRAIN_STEPS - 1, field=name, rays=z.shape[0], samples=z.shape[1],
              **close)
    return launches


def resume_path(fr) -> None:
    rec = run_train(fr, RESUME_STEPS)
    phase("resume", first_step=rec["steps"][0], adam_step_at_start=rec["adam_step_at_start"],
          launches=rec["launches"], loss_first=rec["losses"][0], loss_last=rec["losses"][-1])
    if rec["steps"] != list(range(TRAIN_STEPS, RESUME_STEPS)):
        raise SystemExit(f"resume ran steps {rec['steps']}, not {TRAIN_STEPS}..{RESUME_STEPS - 1}")
    if rec["adam_step_at_start"] != TRAIN_STEPS:
        raise SystemExit(f"the Adam state was not restored: step {rec['adam_step_at_start']}")
    if rec["launches"]["K3"] != 2 * (RESUME_STEPS - TRAIN_STEPS):
        raise SystemExit(f"resume launched K3 {rec['launches']['K3']} times")
    if not all(math.isfinite(x) for x in rec["losses"]):
        raise SystemExit(f"resume loss not finite: {rec['losses']}")
    check_checkpoints(os.path.join(WORK, "logs", "smoke_train"), ["00000040.ckpt"])


def train_step_timings(fr) -> None:
    """ms per train step (CUDA events) on the kernel path and on the plain
    path (K3's plain version in place of the kernel), with the step's
    matrix-product FLOP and its share of the bound."""
    from nerfsos_torch import run_nerf
    from nerfsos_torch.data.datasets import RayDataset
    from nerfsos_torch.engines import state as state_lib
    from nerfsos_torch.engines.trainer import make_rgb_train_step

    args = train_args(os.path.join(WORK, "data"), os.path.join(WORK, "logs"), 0)
    net, _ = run_nerf.build_model(args, torch.device("cuda"))
    optimizer = state_lib.make_optimizer(net.parameters(), args.lrate)
    schedule = state_lib.exp_decay_schedule(args.lrate, args.decay_rate, args.decay_step * 1000)
    dataset = RayDataset(os.path.join(WORK, "data"), split="train")
    near, far = dataset.near_far()
    per_ray = (args.N_samples * field_flops(net.nerf, "k3")
               + (args.N_samples + args.N_importance) * field_flops(net.nerf_fine, "k3"))
    total = torch.cuda.get_device_properties(0).total_memory
    peak = {}
    for path, grads_fn, sizes in (("kernel", fr.fused_rgb_train_grads, (1024, 4096, 16384)),
                                  ("plain", fr.rgb_train_grads_plain, (1024, 4096, 16384))):
        step = make_rgb_train_step(net, optimizer, schedule, near, far, args.rgb_w, args.seed,
                                   grads_fn=grads_fn)
        for R in sizes:
            if path == "plain" and R == 16384:
                need = 4 * peak[4096]
                if need > 0.9 * total:
                    phase("train_step", path=path, rays=R,
                          skipped=f"needs ~{need / 2**30:.1f} GiB (4 x the 4096-ray step's "
                                  f"peak), the card has {total / 2**30:.1f} GiB")
                    continue
            b = dataset.sample_batch(np.random.default_rng(R), R)
            batch = {k: torch.as_tensor(b[k], device="cuda") for k in ("rays", "target")}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reps = 2 if R == 16384 else 5
            ms = cuda_ms(lambda: step(batch, 0), reps=reps, warmup=1)
            peak[R] = torch.cuda.max_memory_allocated()
            flops = R * per_ray
            bound = flops / FP32_MMA_FLOP_S * 1e3
            phase("train_step", path=path, rays=R, ms=ms, rays_per_s=R / ms * 1e3,
                  tflop=flops / 1e12, bound_ms=bound, share_of_bound=bound / ms,
                  peak_gib=peak[R] / 2**30)


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
    launches = eval_path(fr)
    kernel_vs_plain_k3(fr, 4096, 64, use_semantics=True, white_bkgd=False)
    k3 = kernel_vs_plain_k3(fr, 4096, 192, use_semantics=True, white_bkgd=False)
    kernel_vs_plain_k3(fr, 4096, 192, use_semantics=False, white_bkgd=True)
    kernel_vs_plain_k3(fr, 1024, 64, use_semantics=True, white_bkgd=False)
    kernel_vs_plain_k3(fr, 1024, 192, use_semantics=True, white_bkgd=False)
    train_launches = train_path(fr)
    resume_path(fr)
    train_step_timings(fr)

    src = "nerfsos_torch/csrc/fused_render.cu"
    kernels = [
        {"name": "K1 fused_coarse_weights", "route": "cuda", "source": src,
         "replaces": "nerfsos_tpu/ops/pallas/fused_render.py:458",
         "launches": launches["K1"], **k1},
        {"name": "K2 fused_render", "route": "cuda", "source": src,
         "replaces": "nerfsos_tpu/ops/pallas/fused_render.py:369",
         "launches": launches["K2"], **k2},
        {"name": "K3 fused_rgb_train_grads", "route": "cuda",
         "source": "nerfsos_torch/csrc/train_render.cu",
         "replaces": "nerfsos_tpu/ops/pallas/fused_render.py:940",
         "launches": train_launches["K3"], **k3},
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
