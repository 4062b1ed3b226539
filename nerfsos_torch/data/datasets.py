"""Per-view ray datasets for evaluation (numpy).

Reads the prepared dataset layout of ``nerfsos_tpu/data/datasets.py`` (the
reference's on-disk contract): ``meta.json`` with ``near``/``far``/``focal``/
``H``/``W``, ``rays_{split}[_x{subsample}].npy`` ``[N, H, W, 2, 3]``,
``rgbs_{split}*.npy`` ``[N, H, W, 3]`` and optional ``masks_{split}.npy``.
Only the eval access (``get_view``) is ported; the train samplers and the
raw-scene preparation (``gen_dataset``) are not yet.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Tuple

import numpy as np


class RayDataset:
    """Per-image rays (and targets, masks) of one split."""

    def __init__(self, root_dir: str, split: str = "test", subsample: int = 0,
                 use_masks: bool = True, bin_thres: float = 0.3):
        meta_path = os.path.join(root_dir, "meta.json")
        if not os.path.exists(meta_path):
            raise FileNotFoundError(
                f"{meta_path} missing: prepare the dataset first (raw-scene preparation "
                "is not ported yet)")
        with open(meta_path) as f:
            self.meta = json.load(f)
        for k in ("near", "far"):
            if k not in self.meta:
                raise IOError("Missing required meta data")
        sfx = f"_x{subsample}" if subsample else ""
        self.rays = np.load(os.path.join(root_dir, f"rays_{split}{sfx}.npy"), mmap_mode="r")
        rgb_path = os.path.join(root_dir, f"rgbs_{split}{sfx}.npy")
        self.rgbs = np.load(rgb_path, mmap_mode="r") if os.path.exists(rgb_path) else None
        if use_masks:
            mask_path = os.path.join(root_dir, f"masks_{split}.npy")
            if os.path.exists(mask_path):
                masks = np.load(mask_path)
            else:
                print("Warning! Masks path is wrong, use all-ones masks")
                masks = np.ones(self.rays.shape[:3] + (1,), np.float32)
            if bin_thres != -1:
                self.masks = (masks > bin_thres).astype(np.int64)
            else:
                self.masks = masks.astype(np.float32)
        else:
            self.masks = np.zeros(self.rays.shape[:3] + (1,), np.float32)
        self.image_count, self.height, self.width = self.rays.shape[:3]

    def __len__(self) -> int:
        return self.image_count

    def near_far(self) -> Tuple[float, float]:
        return self.meta["near"], self.meta["far"]

    def get_view(self, i: int) -> Dict[str, np.ndarray]:
        """Rays ``[2, H, W, 3]``, masks ``[H, W, 1]`` and, if present, target ``[H, W, 3]``."""
        out = {"rays": np.asarray(self.rays[i]).transpose(2, 0, 1, 3),
               "masks": np.asarray(self.masks[i])}
        if self.rgbs is not None:
            out["target"] = np.asarray(self.rgbs[i])
        return out
