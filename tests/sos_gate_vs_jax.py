"""The SOS gate's finetunes run by the port and by nerfsos_tpu from one
checkpoint, on the CPU: does the JAX package's finetune segment the gate's
scene where the port's does not?

    python tests/sos_gate_vs_jax.py --root DIR [--size 64] [--patch_size 16]
        [--pretrain_steps 1500] [--finetune_steps 500] [--seeds 0 1 2]
        [--phases app geo control] [--extra "--netdepth 4 --netwidth 64 ..."]
        [--pretrain_extra "--batch_size 1024"] [--checkpoint PRETRAIN.ckpt]

``nerfsos_torch.tools.validate_sos_protocol``'s scene, pretrain and idle
reading run once through the port (``device="cpu"``); then each phase, at
each ``--seed``, runs twice from the pretrain's ``last.ckpt``: through
``nerfsos_torch.run_nerf.main`` and through the JAX entry point's ``main``
(its plain XLA path on the CPU, which loads the same reference-format
checkpoint), with the same flags. Each run draws its own batches and noise;
the table printed last (and ``vs_jax.json`` under the root) holds every
run's held-out clus ARI and PSNR. ``--extra`` shrinks the net for the CPU,
``--pretrain_extra`` the pretrain's batch; ``--checkpoint`` starts from a
pretrain made elsewhere (on the card, at the gate's full size).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shlex
import shutil
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if HERE not in sys.path:
    sys.path.insert(0, HERE)


def _read(logs: str, expname: str) -> dict:
    with open(os.path.join(logs, expname, "eval", "log.json")) as f:
        log = json.load(f)
    return {"psnr": log["total_psnr"], "clus_ari": log["total_clus_ari"]}


def run_pair(proto, phase: str, seed: int, packages=("torch", "jax")) -> dict:
    """``phase`` at ``seed`` through each package's entry point; each run's
    held-out readings and seconds."""
    import run_nerf as jax_run_nerf

    from nerfsos_torch import run_nerf as torch_run_nerf

    out = {}
    for pkg in packages:
        name = f"{phase}_{pkg}_s{seed}"
        argv = proto.argv(phase) + ["--expname", name, "--seed", str(seed)]
        t0 = time.perf_counter()
        if pkg == "torch":
            args, _ = torch_run_nerf.create_arg_parser().parse_known_args(argv)
            torch_run_nerf.main(args, device="cpu")
        else:
            args, _ = jax_run_nerf.create_arg_parser().parse_known_args(argv)
            jax_run_nerf.main(args)
        r = _read(proto.logs, name)
        r["seconds"] = time.perf_counter() - t0
        print(f"[vs_jax] {phase} seed {seed} {pkg}: clus ARI {r['clus_ari']:.4f}, "
              f"PSNR {r['psnr']:.4f} ({r['seconds']:.1f} s)", flush=True)
        out[pkg] = r
    return out


def main(argv=None) -> dict:
    from nerfsos_torch.tools import validate_sos_protocol as vsp

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--size", type=int, default=vsp.SIZE)
    ap.add_argument("--patch_size", type=int, default=16)
    ap.add_argument("--pretrain_steps", type=int, default=vsp.PRETRAIN_STEPS)
    ap.add_argument("--finetune_steps", type=int, default=vsp.FINETUNE_STEPS)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--phases", nargs="+", default=["app", "geo", "control"],
                    choices=["app", "geo", "control"])
    ap.add_argument("--packages", nargs="+", default=["torch", "jax"],
                    choices=["torch", "jax"])
    ap.add_argument("--extra", default="", help="flags added to every run")
    ap.add_argument("--pretrain_extra", default="", help="flags added to the pretrain's")
    ap.add_argument("--checkpoint", default=None,
                    help="a pretrain's last.ckpt (one from the card) in place of the pretrain")
    a = ap.parse_args(argv)
    proto = vsp.Protocol(root=a.root, size=a.size, patch_size=a.patch_size,
                         pretrain_steps=a.pretrain_steps, finetune_steps=a.finetune_steps,
                         extra=tuple(shlex.split(a.extra)), device="cpu")
    proto.build_dataset()
    if a.checkpoint:
        os.makedirs(os.path.dirname(proto.checkpoint), exist_ok=True)
        shutil.copyfile(a.checkpoint, proto.checkpoint)
        pre = {"checkpoint": a.checkpoint}
    elif os.path.exists(os.path.join(proto.run_dir("pretrain"), "eval", "log.json")):
        pre = proto.read("pretrain")
    else:
        pre = dataclasses.replace(
            proto, extra=proto.extra + tuple(shlex.split(a.pretrain_extra))).run("pretrain")
    table = {"pretrain": pre, "idle": proto.run("idle"), "runs": {}}
    for phase in a.phases:
        for seed in a.seeds:
            table["runs"][f"{phase}_s{seed}"] = run_pair(proto, phase, seed, a.packages)
    with open(os.path.join(a.root, "vs_jax.json"), "w") as f:
        json.dump(table, f, indent=1)
    print(json.dumps(table))
    return table


if __name__ == "__main__":
    main()
