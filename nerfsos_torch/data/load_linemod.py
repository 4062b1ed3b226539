"""LINEMOD scene loading. Parity: reference ``data/load_LINEMOD.py``.

Port of ``nerfsos_tpu/data/load_linemod.py`` (numpy).
"""
from __future__ import annotations

import json
import os

import numpy as np

from nerfsos_torch.data.image_io import imread, resize_area
from nerfsos_torch.data.poses import pose_spherical


def load_linemod_data(basedir: str, half_res: bool = False, testskip: int = 1):
    splits = ["train", "val", "test"]
    metas = {}
    for s in splits:
        with open(os.path.join(basedir, f"transforms_{s}.json")) as fp:
            metas[s] = json.load(fp)

    all_imgs, all_poses, counts = [], [], [0]
    for s in splits:
        meta = metas[s]
        skip = 1 if (s == "train" or testskip == 0) else testskip
        imgs, poses = [], []
        for frame in meta["frames"][::skip]:
            imgs.append(imread(frame["file_path"]))
            poses.append(np.array(frame["transform_matrix"]))
        imgs = (np.array(imgs) / 255.0).astype(np.float32)
        poses = np.array(poses).astype(np.float32)
        counts.append(counts[-1] + imgs.shape[0])
        all_imgs.append(imgs)
        all_poses.append(poses)

    i_split = [np.arange(counts[i], counts[i + 1]) for i in range(3)]
    imgs = np.concatenate(all_imgs, 0)
    poses = np.concatenate(all_poses, 0)

    H, W = imgs[0].shape[:2]
    K = meta["frames"][0]["intrinsic_matrix"]
    focal = float(K[0][0])

    render_poses = np.stack(
        [pose_spherical(angle, -30.0, 4.0) for angle in np.linspace(-180, 180, 40 + 1)[:-1]], 0
    ).astype(np.float32)

    if half_res:
        H, W = H // 2, W // 2
        focal = focal / 2.0
        imgs = np.stack([resize_area(img[..., :3], H, W) for img in imgs], 0)

    near = float(np.floor(min(metas["train"]["near"], metas["test"]["near"])))
    far = float(np.ceil(max(metas["train"]["far"], metas["test"]["far"])))
    return imgs, poses, render_poses, [H, W, focal], K, i_split, near, far
