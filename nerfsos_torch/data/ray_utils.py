"""Pinhole rays for dataset preparation (numpy), vectorised over all poses.

Port of ``nerfsos_tpu/data/ray_utils.py``: the intrinsics matrix and the
rays of a batch of camera-to-world poses in the prepared dataset's on-disk
layout ``[N, H, W, 2, 3]`` (origin, direction), one einsum for all poses.
"""
from __future__ import annotations

import numpy as np


def persp_intrinsics(height: int, width: int, focal: float) -> np.ndarray:
    return np.array(
        [[focal, 0.0, width / 2.0], [0.0, focal, height / 2.0], [0.0, 0.0, 1.0]],
        dtype=np.float64,
    )


def persp_rays_batch(height: int, width: int, K: np.ndarray, c2ws: np.ndarray) -> np.ndarray:
    """Rays for a batch of poses.

    Args:
      c2ws: [N, 3, 4] (or [N, 4, 4]) camera-to-world poses.
    Returns:
      [N, H, W, 2, 3] float32 — the reference's on-disk layout
      (``data/gen_dataset.py:189-190`` after permute).
    """
    c2ws = np.asarray(c2ws)[:, :3, :4]
    j, i = np.meshgrid(np.arange(height, dtype=np.float64),
                       np.arange(width, dtype=np.float64), indexing="ij")
    dirs = np.stack(
        [(i - K[0, 2]) / K[0, 0], -(j - K[1, 2]) / K[1, 1], -np.ones_like(i)], axis=-1
    )  # [H, W, 3]
    rays_d = np.einsum("hwc,nrc->nhwr", dirs, c2ws[:, :3, :3])
    rays_o = np.broadcast_to(c2ws[:, None, None, :3, 3], rays_d.shape)
    return np.stack([rays_o, rays_d], axis=-2).astype(np.float32)  # [N, H, W, 2, 3]
