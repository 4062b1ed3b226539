"""Ray datasets (numpy): per-view access for evaluation, the shuffled ray
pool for training.

Reads the prepared dataset layout of ``nerfsos_tpu/data/datasets.py`` (the
reference's on-disk contract): ``meta.json`` with ``near``/``far``/``focal``/
``H``/``W``, ``rays_{split}[_x{subsample}].npy`` ``[N, H, W, 2, 3]``,
``rgbs_{split}*.npy`` ``[N, H, W, 3]`` and optional ``masks_{split}.npy``.
Ported: ``get_view`` and, for the ``train`` split, the flat ray pool and
``sample_batch`` (``--N_rand`` rays drawn with replacement). Not yet: the
per-view sampler (``ViewDataset``, ``--no_batching``), the patch sampler
(``PatchDataset``, ``--patch_tune``) and the raw-scene preparation
(``gen_dataset``).
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
        self.split = split
        if split == "train":
            self._flat_rays = np.asarray(self.rays).reshape(-1, 2, 3)
            self._flat_rgbs = np.asarray(self.rgbs).reshape(-1, self.rgbs.shape[-1])
            self._flat_masks = np.asarray(self.masks).reshape(-1, self.masks.shape[-1])

    def __len__(self) -> int:
        return self._flat_rays.shape[0] if self.split == "train" else self.image_count

    def sample_batch(self, rng: np.random.Generator, batch_size: int) -> Dict[str, np.ndarray]:
        """``batch_size`` rays of the pool, uniformly with replacement (the
        JAX sampler's draw): ``rays [2, B, 3]``, ``target [B, 3]``,
        ``masks [B, 1]``."""
        idx = rng.integers(0, self._flat_rays.shape[0], size=batch_size)
        return {"rays": np.ascontiguousarray(self._flat_rays[idx].transpose(1, 0, 2)),
                "target": self._flat_rgbs[idx], "masks": self._flat_masks[idx]}

    def near_far(self) -> Tuple[float, float]:
        return self.meta["near"], self.meta["far"]

    def get_view(self, i: int) -> Dict[str, np.ndarray]:
        """Rays ``[2, H, W, 3]``, masks ``[H, W, 1]`` and, if present, target ``[H, W, 3]``."""
        out = {"rays": np.asarray(self.rays[i]).transpose(2, 0, 1, 3),
               "masks": np.asarray(self.masks[i])}
        if self.rgbs is not None:
            out["target"] = np.asarray(self.rgbs[i])
        return out
