"""The appearance loss of the flagship SOS step on the card, forward and
backward, with this checkout's grid sampling and with another tree's (a
parent unpacked under a directory of the checkout), in turns in one
process: the ms of each (CUDA events, the median of 5 rounds of 20 calls)
and the memory it holds at its peak beyond its inputs, at the flagship's
shapes (``scripts/train_flower_node0.sh``: 8 patches of 64 x 64, both heads'
2-channel codes; DINO features 384 x 14 x 14; 11 x 11 samples a patch;
``--app_corr_params`` at its default); also how far apart the two are (the
loss relative to its size, the codes' gradients relative to their max) and
whether each repeats its gradients bit for bit. One JSON line, after the
card's name and power limit.

    python -m nerfsos_torch.tools.sampler_ab --other build/parent
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys


def load_sampler(root: str):
    """``grid_sample_bilinear`` of the checkout at ``root``."""
    path = os.path.join(root, "nerfsos_torch", "ops", "grid_sample.py")
    spec = importlib.util.spec_from_file_location(f"grid_sample_{abs(hash(root))}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.grid_sample_bilinear


def main(argv=None) -> int:
    import torch

    from nerfsos_torch.losses import correlation

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, help="the other checkout's root")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    samplers = {"this": correlation.grid_sample_bilinear, "other": load_sampler(a.other)}
    app = correlation.CorrelationLoss.from_params([0.18, 0.67, 0.46, 0.63], use_sim_matrix=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    B, P = 8, 64
    feat = torch.randn(B, 384, 14, 14, device="cuda", generator=g)
    codes = [torch.randn(B, 2, P, P, device="cuda", generator=g).requires_grad_(True)
             for _ in range(2)]
    coords = correlation.draw_pair_coords(g, B, app.feature_samples, torch.device("cuda"))
    sim = torch.randn(B, B, device="cuda", generator=g)

    def call():
        for c in codes:
            c.grad = None
        a0, a1 = app.pair_heads(coords, feat, codes[0], codes[1], sim)
        (a0 + a1).backward()
        return (a0 + a1).detach(), [c.grad.clone() for c in codes]

    out, ms, first = {}, {k: [] for k in samplers}, {}
    try:
        for name, fn in samplers.items():
            correlation.grid_sample_bilinear = fn
            loss, grads = call()
            again = call()[1]
            first[name] = (loss, grads)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            call()
            torch.cuda.synchronize()
            out[name] = {"peak_mib": (torch.cuda.max_memory_allocated() - base) / 2**20,
                         "repeats_bitwise": all(torch.equal(x, y) for x, y in zip(grads, again))}
        for _ in range(5):
            for name, fn in samplers.items():
                correlation.grid_sample_bilinear = fn
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                for _ in range(20):
                    call()
                end.record()
                torch.cuda.synchronize()
                ms[name].append(start.elapsed_time(end) / 20)
    finally:
        correlation.grid_sample_bilinear = samplers["this"]
    for name in samplers:
        out[name]["ms_median"] = statistics.median(ms[name])
        out[name]["ms"] = ms[name]
    (l0, g0), (l1, g1) = first["this"], first["other"]
    out["loss_rel_diff"] = float((l0 - l1).abs() / l1.abs().clamp_min(1e-30))
    out["grad_max_rel_diff"] = max(float((x - y).abs().max() / y.abs().max())
                                   for x, y in zip(g0, g1))
    out["other"]["root"] = a.other
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
