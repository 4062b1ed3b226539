"""K3's, K6's, the mip kernels' (K9, K10a, K10b, K11) and the classic field
kernels' (K8a, K8b, K8f, K8c) fp32 kernels of a checkout on the card, for an
A/B against another tree in one call: runs
chip_smoke.py's ``[fp32_train_kernels]`` phase (the digests of their
outputs on seeded flagship-width inputs and their times) with that
checkout's package and this checkout's ``chip_smoke.py``, then the same
calls in their bf16 modes (``[bf16_train_kernels]``, digests alone).

    python -m nerfsos_torch.tools.fp32_train_kernels [--root DIR]

``--root`` is the checkout whose package runs (default: this one), e.g. a
parent unpacked under ``build/parent`` by ``git archive``; its kernels are
built under its own ``build/kernels``. Its digests are what
``chip_smoke.FP32_FINGERPRINTS`` and ``BF16_FINGERPRINTS`` hold this
tree's to.
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

    from nerfsos_torch.ops import fused_render as fr

    if not torch.cuda.is_available():
        print("fp32_train_kernels: no CUDA device visible", file=sys.stderr)
        return 1
    if os.path.dirname(os.path.abspath(fr.__file__)) != os.path.join(root, "nerfsos_torch", "ops"):
        raise SystemExit(f"imported {fr.__file__}, not the package of {root}")
    # print another tree's digests, hold them to nothing
    chip_smoke.FP32_FINGERPRINTS = chip_smoke.BF16_FINGERPRINTS = None
    chip_smoke.phase("fp32_train_kernels_tree", root=root,
                     nvidia_smi=repr(chip_smoke.smi_line()))
    chip_smoke.fp32_train_kernels(fr)
    chip_smoke.fp32_train_kernels(fr, bf16=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
