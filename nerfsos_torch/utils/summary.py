"""Scalar logging of a train run (port of ``run_nerf.py``'s ``SummaryWriter``).

Every scalar goes to ``<log_dir>/scalars.jsonl`` as one
``{"tag", "value", "step"}`` line; TensorBoard event files are written too
when ``torch.utils.tensorboard`` imports (it needs the ``tensorboard``
package).
"""
from __future__ import annotations

import json
import os


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

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        self._jsonl.close()
