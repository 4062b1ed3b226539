"""The classic field forwards' bf16 modes (K8a/K8e, K8b's and K8d's head
rules) against their bf16 plain versions on points near the origin, beside
the plain version's own rounding flips: per call, the largest entry error
over BF16_ENTRY of its column's scale max(1, max |plain|) and the share of
rows beyond TOL (chip_smoke's bf16_points readings), for the kernel, for
the plain version on the field with its biases nudged by 1 +- 2^-22
(chip_smoke's ``nudged``: the larger of the two), for the fp32 kernel and
for chip_smoke's tail fault. Fields at the flagship width (8 x 256,
multires 10/4, the semantic head with its coordinates), seeded as
tests/test_torch_cuda.py's field tests seed them (field 60 on points 61,
n = 4097; field 69 on points 70, n = 1000), at the default init and with
the alpha head's weights scaled by 100, on points of norm ~2 and ~8.
One JSON line a call.

    python -m nerfsos_torch.tools.bf16_field_flips
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import numpy as np
    import torch

    from nerfsos_torch.models.fields import NeRFField
    from nerfsos_torch.ops import fused_field as ff

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    bf = torch.bfloat16

    def reading(x, w):
        x, w = (t.detach().float().reshape(t.shape[0], -1) for t in (x, w))
        e = (x - w).abs() / w.abs().amax(0).clamp(min=1.0)
        return float(e.max()) / cs.BF16_ENTRY, float((e > cs.TOL).any(1).float().mean())

    for fseed, pseed, n in ((60, 61, 4097), (69, 70, 1000)):
        for alpha in (1.0, 100.0):
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(fseed)
                field = NeRFField(net_depth=8, net_width=256, multires=10, multires_views=4,
                                  use_semantics=True, sem_with_coord=True, sem_dim=2)
            field = field.cuda().eval()
            with torch.no_grad():
                field.mlp.alpha_linear.weight.mul_(alpha)
            nudged = [cs.nudged(field, s) for s in (1.0, -1.0)]
            for scale in (2.0, 8.0):
                rng = np.random.default_rng(pseed)
                pts = torch.from_numpy((rng.normal(size=(n, 3)) * scale).astype(np.float32))
                d = rng.normal(size=(n, 3))
                d = torch.from_numpy((d / np.linalg.norm(d, axis=1, keepdims=True))
                                     .astype(np.float32))
                pts, dirs = pts.cuda(), d.cuda()
                calls = {"K8a": (lambda f: ff.sigma_plain(f, pts, bf),
                                 lambda dt: ff.fused_sigma_apply(field, pts, dt))}
                for rule, heads in (("K8b", True), ("K8d", False)):
                    calls[rule] = (lambda f, h=heads: ff.field_plain(f, pts, dirs, bf, h),
                                   lambda dt, h=heads: ff.field_forward(field, pts, dirs, dt, h))
                with torch.no_grad():
                    for name, (plain, kernel) in calls.items():
                        want, got = plain(field), kernel(bf)
                        wit = [reading(plain(f), want) for f in nudged]
                        print(json.dumps({
                            "kernel": name, "field_seed": fseed, "alpha_scale": alpha,
                            "points": n, "norm": scale, "entry_over_bound": reading(got, want)[0],
                            "rows_beyond_tol": reading(got, want)[1],
                            "witness_entry_over_bound": max(w[0] for w in wit),
                            "witness_rows_beyond_tol": max(w[1] for w in wit),
                            "fp32_entry_over_bound": reading(kernel(torch.float32), want)[0],
                            "tail_fault_entry_over_bound": reading(cs.tail_fault(got), want)[0]}),
                            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
