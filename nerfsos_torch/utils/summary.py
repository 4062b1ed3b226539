"""Logging of a train run (port of ``run_nerf.py``'s ``SummaryWriter``).

Every scalar goes to ``<log_dir>/scalars.jsonl`` as one
``{"tag", "value", "step"}`` line; TensorBoard event files are written too
when ``torch.utils.tensorboard`` imports (it needs the ``tensorboard``
package). Images (``add_image``, the ``--i_img`` test view) are written
only through TensorBoard, as the JAX package writes them.
"""
from __future__ import annotations

import importlib.util
import json
import os


def tensorboard_available() -> bool:
    """Whether the ``tensorboard`` package that ``torch.utils.tensorboard``
    needs is there (found, not imported)."""
    try:
        return importlib.util.find_spec("tensorboard") is not None
    except ValueError:  # a module set to None in sys.modules
        return False


class SummaryWriter:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        try:
            from torch.utils.tensorboard import SummaryWriter as TBWriter
        except ImportError:
            self._tb = None
        else:
            self._tb = TBWriter(log_dir=log_dir)
        self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")

    def add_scalar(self, tag: str, value, step: int) -> None:
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)
        self._jsonl.write(json.dumps({"tag": tag, "value": float(value), "step": step}) + "\n")
        self._jsonl.flush()

    def add_image(self, tag: str, img, step: int) -> bool:
        """An ``[H, W, C]`` uint8 image at ``step``; False when there is no
        TensorBoard writer to take it."""
        if self._tb is None:
            return False
        self._tb.add_image(tag, img, step, dataformats="HWC")
        return True

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        self._jsonl.close()
