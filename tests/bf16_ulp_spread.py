"""K3's and K6's bf16 modes against the spread of their bf16 plain versions'
own last-bit moves, on two steps of real runs (card; a script, not
collected by pytest).

chip_smoke holds a bf16 kernel's gradient leaves within BF16_WITNESS times
``bf16_witness``, the plain version's move when every bias is scaled by
1 +- 2^-22. Two runs read past that bound:

- ``k3_nobatch``: ``[train_nobatch_bf16]`` on the nets' JAX draws
  (``models/seeded``, zero biases: the nudges move nothing), configs/
  lego.txt's ``--no_batching`` run on chip_smoke's raw Blender scene, 10
  steps at bf16 with ``--precrop_iters 5``; step 9's coarse K3 call read
  1.047 of the bound, and its maps put 1.27% of their rows past TOL
  (bf16_columns' bound: 1%);
- ``k6_step44``: ``[sos_full_bf16]`` with the seeded DINO ViT at torch's
  default law: chip_smoke's ``[train]`` pretrain and its resume (30 + 10
  steps), then 5 full finetune steps at bf16; step 44's fine K6 call read
  1.865.

For each K3 or K6 call of that step this prints one JSON line: per leaf,
the kernel's distance from the bf16 plain version beside the plain
version's own moves under ``--draws`` draws of every sample depth
stepped one float32 ulp up or down (chip_smoke.z_ulp_draws), their largest
(or GRAD_TOL of the leaf's max, the larger) and median and the kernel's
rank among them, beside the bias nudges' move and two faults that must lie
outside the spread: the fp32 kernel in the bf16
kernel's place, and the bf16 plain version with its gated cotangents left
unrounded (chip_smoke.unrounded_gate_fault). K3's maps: the share of rows
past TOL (bf16_columns' reading) for the kernel and for each draw. And one
wave of the call's rays (chip_smoke.bf16_planes): the kernel's stored
planes against the plain forward, its reverse sweep against the plain
sweep on those planes. A kernel inside the spread of the plain version's
own moves, with the sweep agreeing on its planes, differs from it by
rounding flips; one outside it is at fault.

    python tests/bf16_ulp_spread.py --case k3_nobatch|k6_step44 [--draws 32]
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def k3_nobatch_calls(cs, fr):
    """Step 9's two K3 calls of [train_nobatch_bf16] on the JAX draws:
    (name, field, plain(f, zz) -> (grads, maps, weights), kernel output,
    fp32 kernel output, z, odv, a launch of its rows, semantics)."""
    import torch

    from nerfsos_torch import run_nerf

    cs.gen_dataset_path()
    steps = cs.NOBATCH_STEPS_BF16
    argv = ["--config", os.path.join(HERE, "configs", "lego.txt"), "--expname", "k3_nobatch",
            "--basedir", os.path.join(cs.WORK, "logs"), "--data_path", cs.raw_scene("blender"),
            "--max_steps", str(steps), "--precrop_iters", str(cs.NOBATCH_PRECROP_BF16),
            "--precrop_frac", "0.5", "--i_print", "10", "--i_weights", str(steps),
            "--i_testset", "1000000", "--fast_mode", "--compute_dtype", "bfloat16"]
    args, _ = run_nerf.create_arg_parser().parse_known_args(argv)
    rec = cs.run_train(fr, args, {}, ["fused_rgb_train_grads"], steps - 1)
    out = []
    for part, ((field, odv, z, gt), kw, got) in zip(("coarse", "fine"),
                                                   rec["calls"]["fused_rgb_train_grads"]):
        kw = {k: v for k, v in kw.items() if k != "compute_dtype"}

        def plain(f, zz, odv=odv, gt=gt, kw=kw):
            return fr.rgb_train_grads_plain(f, odv, zz, gt, compute_dtype=torch.bfloat16,
                                            **kw)

        f32 = fr.fused_rgb_train_grads(field, odv, z, gt, **kw)
        launch = (lambda field=field, odv=odv, z=z, gt=gt, kw=kw, rows=slice(None):
                  fr._train_grads_launch(field, odv[rows], z[rows], gt[rows], None, bf16=True,
                                         **kw))
        out.append((part, field, plain, got, f32, z, odv, launch, False))
    return out


def k6_step44_calls(cs, fr):
    """Step 44's two K6 calls of [sos_full_bf16] with the seeded ViT at
    torch's law, chip_smoke's fixtures before its gate."""
    import torch

    from nerfsos_torch import run_nerf
    from nerfsos_torch.data.synthetic import write_sphere_scene
    from nerfsos_torch.engines import checkpoint as ckpt_lib
    from nerfsos_torch.engines import sos
    from nerfsos_torch.models import mlp, seeded, vit

    mlp.flax_dense_init_ = lambda layer: None
    seeded.jax_seeded_init_ = lambda net, seed: None
    vit.flax_dense_init_ = lambda layer: None
    cs.TRAIN_STEPS, cs.RESUME_STEPS, cs.MODE_STEPS = 30, 40, 5
    write_sphere_scene(os.path.join(cs.WORK, "data"), cs.H_VIEW, cs.W_VIEW, n_views=1)
    cs.train_path(fr)
    cs.resume_path(fr)
    sos_data = os.path.join(cs.WORK, "sos_data")
    write_sphere_scene(sos_data, 192, 256, n_views=1, split="test")
    write_sphere_scene(sos_data, 384, 512, n_views=8, split="train")
    ckpt = os.path.join(cs.WORK, "logs", "smoke_train", "checkpoints", "last.ckpt")
    last = ckpt_lib.load_checkpoint(ckpt)[1] + cs.MODE_STEPS - 1
    args = cs.sos_args(ckpt, last + 1, "k6_step44", drop=("--fix_backbone",),
                       extra=("--compute_dtype", "bfloat16"))
    cap = cs.Capture(fr, ["train_render_grads"])
    orig = sos.make_sos_train_step

    def recording(net, *a, **kw):
        step = orig(net, *a, **kw)

        def recorded(batch, global_step):
            cap.on = global_step == last
            try:
                return step(batch, global_step)
            finally:
                cap.on = False

        return recorded

    sos.make_sos_train_step = recording
    try:
        run_nerf.main(args)
    finally:
        sos.make_sos_train_step = orig
        cap.close()
    out = []
    for (field, odv, z, dmaps, dw), kw, got in cap.calls["train_render_grads"]:
        kw = {k: v for k, v in kw.items() if k != "compute_dtype"}

        def plain(f, zz, odv=odv, dmaps=dmaps, dw=dw, kw=kw):
            return fr.train_render_grads_plain(f, odv, zz, dmaps, dw,
                                               compute_dtype=torch.bfloat16, **kw)

        f32 = fr.train_render_grads(field, odv, z, dmaps, dw, **kw)
        launch = (lambda field=field, odv=odv, z=z, dmaps=dmaps, dw=dw, kw=kw, rows=slice(None):
                  fr._train_grads_launch(field, odv[rows], z[rows], dmaps[rows],
                                         None if dw is None else dw[rows], bf16=True,
                                         white_bkgd=None, **kw))
        part = "coarse" if z.shape[1] == args.N_samples else "fine"
        out.append((part, field, plain, got, f32, z, odv, launch, True))
    return out


def planes_skew(cs, fr, field, launch, odv, z, sem) -> dict:
    """Per stored activation plane of one wave (``launch``): the share of its
    entries that differ from the plain bf16 forward's, the share of those
    where the kernel's is the smaller in magnitude (rounding flips of an
    unbiased sum split evenly), and the share of entries whose relu gate
    differs (one of the two zero)."""
    mlp = field.mlp
    R, S = z.shape
    with cs.torch.no_grad():
        f = fr.bf16_train_forward(field, odv, z)

    def plane(p, n):
        return cs.workspace_planes(fr, launch, R, S, p, n)

    pairs = {"feat": (plane(fr._P_FEAT, mlp.feature_linear.out_features), f["feat"]),
             "hv": (plane(fr._P_HV, mlp.views_linears[0].out_features), f["hv"]),
             **{f"act{i}": (plane(fr._P_ACT0 + i, lin.out_features), f["acts"][i])
                for i, lin in enumerate(mlp.pts_linears)}}
    if sem:
        pairs["s_act"] = (plane(fr._P_ACT0 + mlp.depth, mlp.semantic_linear[0].out_features),
                          f["s_act"])
    out = {}
    for k, (a, b) in pairs.items():
        d = a != b
        n = int(d.sum())
        out[k] = {"differ": n / d.numel(),
                  "toward_zero": float((a.abs() < b.abs())[d].float().mean()) if n else None,
                  "gate_flips": float(((a == 0) != (b == 0)).float().mean())}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--case", choices=["k3_nobatch", "k6_step44"], required=True)
    ap.add_argument("--draws", type=int, default=32)
    a = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from nerfsos_torch import _build
    from nerfsos_torch.ops import fused_render as fr

    cs.WORK = os.path.join(HERE, "build", f"ulp_spread_{a.case}")
    shutil.rmtree(cs.WORK, ignore_errors=True)
    os.makedirs(cs.WORK)
    _build.library()
    calls = (k3_nobatch_calls if a.case == "k3_nobatch" else k6_step44_calls)(cs, fr)
    for part, field, plain, got, f32, z, odv, launch, sem in calls:
        k3 = not sem

        def leaves(out):
            return out[0] if k3 else out

        want_all = plain(field, z)
        want = leaves(want_all)
        kernel = leaves(got)
        draws = {k: [] for k in want}
        maps_share = []
        if k3:
            w = want_all[1].float()
            scale = w.abs().amax(0).clamp(min=1.0)

            def share(x):
                e = (x.float().reshape(w.shape) - w).abs() / scale
                return float((e > cs.TOL).any(1).float().mean())

            def entry(x):
                return float(((x.float().reshape(w.shape) - w).abs() / scale).max())

        for out in cs.z_ulp_draws(lambda zz: plain(field, zz), z, a.draws):
            for k, ref in want.items():
                draws[k].append(cs.max_err(leaves(out)[k], ref))
            if k3:
                maps_share.append(share(out[1]))
            del out
        witness = cs.bf16_witness(lambda f: leaves(plain(f, z)), field, want)
        fault = cs.unrounded_gate_fault(fr, lambda: leaves(plain(field, z)))
        control = leaves(f32)
        per_leaf = {}
        for k, ref in want.items():
            e = cs.max_err(kernel[k], ref)
            spread = sorted(draws[k])
            top = max(spread[-1], cs.GRAD_TOL * float(ref.abs().max()), 1e-30)
            per_leaf[k] = {
                "kernel": e, "leaf_max": float(ref.abs().max()),
                "bias_witness": witness[k],
                "over_bf16_leaves_bound": e / max(cs.BF16_WITNESS * witness[k],
                                                  cs.GRAD_TOL * float(ref.abs().max()), 1e-30),
                "draws_max": spread[-1], "draws_median": spread[len(spread) // 2],
                "kernel_rank": sum(1 for x in spread if x < e), "draws": len(spread),
                "kernel_over_draws_max": e / top,
                "fp32_kernel_over_draws_max": cs.max_err(control[k], ref) / top,
                "unrounded_gate_fault_over_draws_max": cs.max_err(fault[k], ref) / top}
        line = {"case": a.case, "call": part, "rays": z.shape[0], "samples": z.shape[1],
                "max_over_bf16_leaves_bound": max(v["over_bf16_leaves_bound"]
                                                  for v in per_leaf.values()),
                "leaves_beyond_the_draws": {k: v["kernel_over_draws_max"]
                                            for k, v in per_leaf.items()
                                            if v["kernel_over_draws_max"] > 1.0},
                "max_kernel_over_draws_max": max(v["kernel_over_draws_max"]
                                                 for v in per_leaf.values()),
                "max_fp32_kernel_over_draws_max": max(v["fp32_kernel_over_draws_max"]
                                                      for v in per_leaf.values()),
                "max_fault_over_draws_max": max(v["unrounded_gate_fault_over_draws_max"]
                                                for v in per_leaf.values())}
        if k3:
            line["maps"] = {"kernel_flip_rows": share(got[1]),
                            "kernel_entry_over_bf16_entry": entry(got[1]) / cs.BF16_ENTRY,
                            "fp32_kernel_flip_rows": share(f32[1]),
                            "draws_flip_rows_max": max(maps_share),
                            "draws_flip_rows_median": sorted(maps_share)[len(maps_share) // 2],
                            "draws_flip_rows": maps_share}
        # one wave of chunks at a time: the stored planes and the sweep on them
        R = {s: r for r, s in cs.BF16_PLANES_SHAPES}.get(z.shape[1], 256)
        planes = {}
        for w0 in range(0, min(z.shape[0], 4 * R), R):
            rows = slice(w0, w0 + R)
            try:
                flat, *_, launch_ = launch(rows=rows)
                skew = planes_skew(cs, fr, field, launch_, odv[rows], z[rows], sem)
                planes[f"rays {w0}-{w0 + R - 1}"] = {"skew": skew}
                planes[f"rays {w0}-{w0 + R - 1}"].update(cs.bf16_planes(
                    fr, f"{a.case} {part}, rays {w0}-", field,
                    fr.unpack_grads(field, flat, sem), launch_, odv[rows], z[rows], sem))
                del flat, launch_
            except SystemExit as e:  # a reading here, not the end of the run
                planes.setdefault(f"rays {w0}-{w0 + R - 1}", {})["refused"] = str(e)
        line["planes"] = planes
        line["leaves"] = per_leaf
        print(json.dumps(line), flush=True)
        del want_all, want, fault
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
