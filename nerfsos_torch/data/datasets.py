"""Ray datasets (numpy): per-view access for evaluation, the shuffled ray
pool, the patch and the per-view samplers for training, the exhibit path.

Port of ``nerfsos_tpu/data/datasets.py``. Reads the prepared dataset layout
(the reference's on-disk contract, written by ``data/gen_dataset``):
``meta.json`` with ``near``/``far``/``focal``/``H``/``W``,
``rays_{split}[_x{subsample}].npy`` ``[N, H, W, 2, 3]``, ``rgbs_{split}*.npy``
``[N, H, W, 3]`` and optional ``masks_{split}.npy``. Given the run's flags
(``args``), a directory without ``meta.json`` is prepared first from the raw
scene at ``args.data_path`` (``gen_dataset.generate_dataset``), as the JAX
datasets do. :class:`RayDataset` (``get_view``; for the ``train`` split the
flat ray pool, ``--N_rand`` rays drawn with replacement),
:class:`PatchDataset` (``--patch_tune``, with a numpy copy of the JAX
package's ``gather_patches``), :class:`ViewDataset` (``--no_batching``:
one image a step, the centre crop for ``--precrop_iters`` steps) and
:class:`ExhibitDataset` (``rays_exhibit.npy``, the videos' render path)
draw as the JAX samplers do from the same numpy ``Generator``.
"""
from __future__ import annotations

import json
import math
import os
from typing import Dict, Tuple

import numpy as np


class RayDataset:
    """Per-image rays (and targets, masks) of one split."""

    def __init__(self, root_dir: str, split: str = "test", subsample: int = 0,
                 use_masks: bool = True, bin_thres: float = 0.3, ret_k: bool = False,
                 args=None, rgb: bool = True):
        meta_path = os.path.join(root_dir, "meta.json")
        if not os.path.exists(meta_path):
            if args is None:
                raise FileNotFoundError(f"{meta_path} missing: prepare the dataset with "
                                        "python -m nerfsos_torch.data.gen_dataset")
            print("Dataset not prepared, generating rays ...")
            from nerfsos_torch.data.gen_dataset import generate_dataset

            generate_dataset(args, root_dir)
        with open(meta_path) as f:
            self.meta = json.load(f)
        for k in ("near", "far"):
            if k not in self.meta:
                raise IOError("Missing required meta data")
        sfx = f"_x{subsample}" if subsample else ""
        self.rays = np.load(os.path.join(root_dir, f"rays_{split}{sfx}.npy"), mmap_mode="r")
        rgb_path = os.path.join(root_dir, f"rgbs_{split}{sfx}.npy")
        self.rgbs = np.load(rgb_path, mmap_mode="r") if rgb and os.path.exists(rgb_path) else None
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
        self.poses = np.zeros([self.image_count, 3, 4], np.float32)
        pose_path = os.path.join(root_dir, f"poses_{split}.npy")
        if ret_k:
            if os.path.exists(pose_path):
                self.poses = np.load(pose_path)
            else:
                print(f"[Warning!] poses_{split}.npy missing.")
        if split == "train" and type(self) is RayDataset:
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

    def radii(self) -> float:
        """mip-NeRF's base radius: a pixel's footprint, ``2 / max(H, W)``
        scaled by ``2 / sqrt(12)``."""
        return 2.0 / max(self.height, self.width) * 2 / math.sqrt(12)

    def get_view(self, i: int) -> Dict[str, np.ndarray]:
        """Rays ``[2, H, W, 3]``, masks ``[H, W, 1]`` and, if present, target ``[H, W, 3]``."""
        out = {"rays": np.asarray(self.rays[i]).transpose(2, 0, 1, 3),
               "masks": np.asarray(self.masks[i])}
        if self.rgbs is not None:
            out["target"] = np.asarray(self.rgbs[i])
        return out


def gather_patches(src: np.ndarray, img_idx: np.ndarray, h_idx: np.ndarray,
                   w_idx: np.ndarray, patch: int, stride: int) -> np.ndarray:
    """Strided ``patch x patch`` crops: ``src [N, H, W, ...]`` -> ``[B, P, P, ...]``
    (``nerfsos_tpu/data/native.gather_patches``)."""
    cs = patch * stride
    out = np.empty((img_idx.shape[0], patch, patch) + src.shape[3:], src.dtype)
    for b, (i, h, w) in enumerate(zip(img_idx, h_idx, w_idx)):
        out[b] = src[i, h:h + cs:stride, w:w + cs:stride]
    return out


class PatchDataset(RayDataset):
    """Random strided crops, the NeRF-SOS training set: a random
    ``patch_size * patch_stride`` window per image, strided by
    ``patch_stride``, so ``patch_size ** 2`` rays a patch. Images are taken
    in a per-epoch shuffle without replacement."""

    def __init__(self, root_dir: str, split: str = "train", patch_size: int = 64,
                 patch_stride: int = 1, **kw):
        super().__init__(root_dir, split=split, **kw)
        self.patch_size = patch_size
        self.patch_stride = patch_stride
        self.crop_size = patch_size * patch_stride
        if self.crop_size > min(self.height, self.width):
            raise ValueError(f"crop {self.crop_size} exceeds image {self.height}x{self.width}")
        self._rays = np.asarray(self.rays)
        self._rgbs = np.asarray(self.rgbs)
        self._masks = np.asarray(self.masks)
        self._perm = np.empty(0, np.int64)

    def __len__(self) -> int:
        return self.image_count

    def _next_image_indices(self, rng: np.random.Generator, n: int) -> np.ndarray:
        parts = []
        while n > 0:
            if self._perm.size == 0:
                self._perm = rng.permutation(self.image_count)
            take = min(n, self._perm.size)
            parts.append(self._perm[:take])
            self._perm = self._perm[take:]
            n -= take
        return np.concatenate(parts)

    def sample_batch(self, rng: np.random.Generator, batch_size: int) -> Dict[str, np.ndarray]:
        """``rays [2, B P P, 3]``, ``target [B P P, 3]``, ``masks [B P P, 1]``,
        ``poses [B, 3, 4]``, ``start_idx [B, 2]``."""
        P, s = self.patch_size, self.patch_stride
        img_idx = self._next_image_indices(rng, batch_size)
        h_idx = rng.integers(0, self.height - self.crop_size + 1, size=batch_size)
        w_idx = rng.integers(0, self.width - self.crop_size + 1, size=batch_size)
        rays = gather_patches(self._rays, img_idx, h_idx, w_idx, P, s)
        rgbs = gather_patches(self._rgbs, img_idx, h_idx, w_idx, P, s)
        masks = gather_patches(self._masks, img_idx, h_idx, w_idx, P, s)
        return {
            "rays": np.ascontiguousarray(rays.reshape(batch_size * P * P, 2, 3).transpose(1, 0, 2)),
            "target": rgbs.reshape(batch_size * P * P, -1),
            "masks": masks.reshape(batch_size * P * P, -1),
            "poses": self.poses[img_idx].astype(np.float32),
            "start_idx": np.stack([h_idx, w_idx], -1).astype(np.float32),
        }


class ViewDataset(RayDataset):
    """One image a step, ``batch_size`` of its pixels drawn without
    replacement (``--no_batching``); before ``precrop_iters`` steps only
    from the centre crop of ``precrop_frac`` of each side. The step is an
    argument (the reference's sampler counted its own calls)."""

    def __init__(self, root_dir: str, split: str = "train", precrop_iters: int = 0,
                 precrop_frac: float = 0.5, **kw):
        super().__init__(root_dir, split=split, **kw)
        self.precrop_iters = precrop_iters
        self.precrop_frac = precrop_frac
        self._rays = np.asarray(self.rays)
        self._rgbs = np.asarray(self.rgbs)

    def __len__(self) -> int:
        return self.image_count

    def crop(self) -> Tuple[int, int, int, int]:
        """The centre crop's rows ``[h0, h1)`` and columns ``[w0, w1)``."""
        H, W = self.height, self.width
        dH, dW = int(H // 2 * self.precrop_frac), int(W // 2 * self.precrop_frac)
        return H // 2 - dH, H // 2 + dH, W // 2 - dW, W // 2 + dW

    def sample_batch(self, rng: np.random.Generator, batch_size: int,
                     step: int = 10**9) -> Dict[str, np.ndarray]:
        """``rays [2, B, 3]``, ``target [B, 3]`` of one random image; step
        ``step`` (the JAX loop's count, from 1) samples the centre crop while
        ``step < precrop_iters``."""
        i = int(rng.integers(0, self.image_count))
        H, W = self.height, self.width
        if step < self.precrop_iters:
            h0, h1, w0, w1 = self.crop()
            hs = rng.integers(h0, h1, size=batch_size)
            ws = rng.integers(w0, w1, size=batch_size)
        else:
            flat = rng.choice(H * W, size=batch_size, replace=False)
            hs, ws = flat // W, flat % W
        rays = self._rays[i, hs, ws]  # [B, 2, 3]
        return {"rays": np.ascontiguousarray(rays.transpose(1, 0, 2)),
                "target": self._rgbs[i, hs, ws]}


class ExhibitDataset(RayDataset):
    """The render path's rays (``rays_exhibit.npy``), the frames of the
    videos; no targets, no masks."""

    def __init__(self, root_dir: str, **kw):
        kw.setdefault("use_masks", False)
        super().__init__(root_dir, split="exhibit", rgb=False, **kw)

    def get_view(self, i: int) -> Dict[str, np.ndarray]:
        """Rays ``[2, H, W, 3]``."""
        return {"rays": np.asarray(self.rays[i]).transpose(2, 0, 1, 3)}
