"""The eval render's rgb, kernel path against plain path, beside the plain
path against itself on the field nudged by 1 +- 2^-22, for a fresh flagship
net drawn by each init law: the port's default (the JAX package's flax
``Dense`` law) and torch's ``nn.Linear`` law (the fixtures of chip_smoke's
phases before the SOS gate). chip_smoke's ``[render]`` net and view: seed
0, 8 x 256, 64 + 128 samples, the semantic head with its coordinates, the
378 x 504 view of ``write_sphere_scene``. Per law and pair of renders: the
largest per-ray rgb distance and the share of rays beyond 1e-3 (the
``[render]`` check allows 0.1%). One JSON line a law, after the card's name
and power limit.

    python -m nerfsos_torch.tools.render_init_law [--root DIR]
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NUDGE = 2.0**-22


def nudged(net, sign: float):
    """A copy of ``net`` with every Linear's weight and bias scaled by
    1 + sign * 2^-22 (the flax law's biases are zero)."""
    import torch

    m = copy.deepcopy(net)
    with torch.no_grad():
        for lin in m.modules():
            if isinstance(lin, torch.nn.Linear):
                lin.weight.mul_(1.0 + sign * NUDGE)
                lin.bias.mul_(1.0 + sign * NUDGE)
    return m


def main(argv=None) -> int:
    import torch

    from nerfsos_torch.data.datasets import RayDataset
    from nerfsos_torch.data.synthetic import write_sphere_scene
    from nerfsos_torch.engines import eval as eval_lib
    from nerfsos_torch.models import mlp
    from nerfsos_torch.models.nerf import NeRFConfig, NeRFNet

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=None, help="the scene's directory (default: a temporary one)")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    with tempfile.TemporaryDirectory() as tmp:
        data = a.root or tmp
        write_sphere_scene(data, 378, 504, n_views=1)
        dataset = RayDataset(data, split="test")
        rays, near_far = dataset.get_view(0)["rays"], dataset.near_far()
    cfg = NeRFConfig(n_samples=64, n_importance=128, use_semantics=True, sem_with_coord=True)
    port_init = mlp.flax_dense_init_
    for law in ("flax", "torch"):
        if law == "torch":
            mlp.flax_dense_init_ = lambda layer: None  # each nn.Linear keeps its own draw
        try:
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(0)
                plain = NeRFNet(cfg).cuda().eval()
        finally:
            mlp.flax_dense_init_ = port_init
        kernel = NeRFNet(dataclasses.replace(cfg, fused_field=True)).cuda().eval()
        kernel.load_state_dict(plain.state_dict())
        nets = {"kernel": kernel, "plain": plain, "plain_up": nudged(plain, 1.0),
                "plain_down": nudged(plain, -1.0)}
        rgb = {k: eval_lib.make_render_fn(n, *near_far)(rays)["rgb"] for k, n in nets.items()}
        out = {"law": law, "rays": int(rgb["plain"][..., 0].numel())}
        for k in ("kernel", "plain_up", "plain_down"):
            d = (rgb[k] - rgb["plain"]).abs().amax(dim=-1)
            out[f"{k}_vs_plain"] = {"max_abs_diff": float(d.max()),
                                    "frac_rays_over_1e_3": float((d > 1e-3).float().mean())}
        print(json.dumps(out), flush=True)
        del nets, kernel, plain, rgb
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
