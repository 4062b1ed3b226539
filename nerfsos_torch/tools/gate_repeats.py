"""One finetune of the SOS quality gate on the card at several seeds, for
its spread: the gate's scene and pretrain (the root's own when it is
there), then a run of ``--phase`` (``geo``, ``app`` or ``control``) from
that checkpoint for each of ``--seeds`` (the finetune's batches and noise;
the checkpoint holds every weight; a seed given twice repeats its run),
each with its held-out clus ARI and PSNR and whether its semantic head is
bit for bit that of the first run.

    python -m nerfsos_torch.tools.gate_repeats [--compute_dtype float32|bfloat16]
        [--phase app] [--seeds 0,1,2] [-- extra run_nerf flags]

Flags after ``--`` go to every finetune (``--no_fused_field``: the plain
path). The runs go under ``build/gate_repeats/<dtype>`` in the checkout.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import torch

from nerfsos_torch.tools import validate_sos_protocol as vsp


def run_seeds(proto: vsp.Protocol, phase: str, seeds) -> list:
    """A run of ``phase`` for each seed in ``seeds`` from ``proto``'s
    pretrain (run first when it is missing); one dict a run, printed."""
    from nerfsos_torch import run_nerf
    from nerfsos_torch.engines import checkpoint as ckpt_lib

    proto.build_dataset()
    if not os.path.exists(proto.checkpoint):  # the gate's pretrain, without the extra flags
        dataclasses.replace(proto, extra=()).run("pretrain")
    out, first_head = [], None
    for r, seed in enumerate(seeds):
        name = f"{vsp.EXPNAMES[phase]}_{r}_s{seed}"
        argv = proto.argv(phase) + ["--expname", name, "--seed", str(seed)]
        run_nerf.main(run_nerf.create_arg_parser().parse_known_args(argv)[0], device=proto.device)
        run_dir = os.path.join(proto.logs, name)
        with open(os.path.join(run_dir, "eval", "log.json")) as f:
            log = json.load(f)
        state = ckpt_lib.load_checkpoint(os.path.join(run_dir, "checkpoints", "last.ckpt"))[0]
        head = {k: v for k, v in state.items() if "semantic_linear" in k}
        first_head = head if first_head is None else first_head
        rec = {"dtype": proto.compute_dtype, "phase": phase, "run": r, "seed": seed,
               "extra": list(proto.extra), "clus_ari": log["total_clus_ari"],
               "psnr": log["total_psnr"],
               "head_bitwise_as_run_0": all(torch.equal(v, first_head[k])
                                            for k, v in head.items())}
        print("[gate_repeats] " + json.dumps(rec), flush=True)
        out.append(rec)
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    extra = argv[argv.index("--") + 1:] if "--" in argv else []
    argv = argv[:argv.index("--")] if "--" in argv else argv
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--compute_dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--phase", default="app", choices=["geo", "app", "control"])
    ap.add_argument("--seeds", default="0,1,2", help="comma-separated")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gate_repeats: no CUDA device visible", file=sys.stderr)
        return 1
    proto = vsp.Protocol(root=os.path.join(vsp.HERE, "build", "gate_repeats", a.compute_dtype),
                         compute_dtype=a.compute_dtype, extra=tuple(extra))
    run_seeds(proto, a.phase, [int(s) for s in a.seeds.split(",")])
    return 0


if __name__ == "__main__":
    sys.exit(main())
