"""The ``--rand_neg`` SOS finetune step of a checkout on the card, for an A/B
against another tree in one call: runs chip_smoke.py's ``[sos_randneg]``
phase (5 steps from the ``[train]`` run's checkpoint, the last step's
K7b/K7c calls held against their plain versions) and then
``[sos_randneg_step]`` (the 32768-ray step's ms on the kernel and the plain
path in turns, with peak memory), with that checkout's package and this
checkout's ``chip_smoke.py`` phases, in the scene and checkpoint that a
``chip_smoke.py`` run left under that checkout's ``build/chip_smoke``.

    python -m nerfsos_torch.tools.sos_steps [--root DIR]

``--root`` is the checkout whose package is timed (default: this one). To
A/B against a parent unpacked under ``build/parent``, run its own
``chip_smoke.py`` there first (its frozen and full steps are its
``[sos_step]`` and ``[sos_full_step]``), then this with ``--root
build/parent``.
"""
from __future__ import annotations

import argparse
import importlib.util
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    root = os.path.abspath(ap.parse_args().root)
    sys.path = [root] + [p for p in sys.path if os.path.abspath(p or ".") != HERE] + [HERE]
    for name in [m for m in sys.modules if m == "nerfsos_torch" or m.startswith("nerfsos_torch.")]:
        del sys.modules[name]
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = chip_smoke
    spec.loader.exec_module(chip_smoke)
    import torch

    from nerfsos_torch.ops import flash_corr as fc
    from nerfsos_torch.ops import fused_render as fr

    if not torch.cuda.is_available():
        print("sos_steps: no CUDA device visible", file=sys.stderr)
        return 1
    if os.path.dirname(os.path.abspath(fr.__file__)) != os.path.join(root, "nerfsos_torch", "ops"):
        raise SystemExit(f"imported {fr.__file__}, not the package of {root}")
    chip_smoke.WORK = os.path.join(root, "build", "chip_smoke")
    chip_smoke.phase("sos_steps", root=root, nvidia_smi=repr(chip_smoke.smi_line()))
    run = chip_smoke.sos_mode_path(fr, fc, "randneg")
    chip_smoke.sos_step_timings(fr, fc, run, "sos_randneg_step", parts=False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
