"""Blender synthetic scene loading (lego etc.).

Port of ``nerfsos_tpu/data/load_blender.py`` (numpy).

Parity: reference ``data/load_blender.py`` — ``transforms_{split}.json``,
RGBA kept, 40-pose spherical render path at phi=-30, radius 4, optional
half-res area resize.
"""
from __future__ import annotations

import json
import os

import numpy as np

from nerfsos_torch.data.image_io import imread, resize_area
from nerfsos_torch.data.poses import pose_spherical


def load_blender_data(basedir: str, half_res: bool = False, testskip: int = 1):
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
            fname = os.path.join(basedir, frame["file_path"] + ".png")
            imgs.append(imread(fname))
            poses.append(np.array(frame["transform_matrix"]))
        imgs = (np.array(imgs) / 255.0).astype(np.float32)  # RGBA kept
        poses = np.array(poses).astype(np.float32)
        counts.append(counts[-1] + imgs.shape[0])
        all_imgs.append(imgs)
        all_poses.append(poses)

    i_split = [np.arange(counts[i], counts[i + 1]) for i in range(3)]
    imgs = np.concatenate(all_imgs, 0)
    poses = np.concatenate(all_poses, 0)

    H, W = imgs[0].shape[:2]
    camera_angle_x = float(meta["camera_angle_x"])
    focal = 0.5 * W / np.tan(0.5 * camera_angle_x)

    render_poses = np.stack(
        [pose_spherical(angle, -30.0, 4.0) for angle in np.linspace(-180, 180, 40 + 1)[:-1]], 0
    ).astype(np.float32)

    if half_res:
        H, W = H // 2, W // 2
        focal = focal / 2.0
        imgs = np.stack([resize_area(img, H, W) for img in imgs], 0)

    return imgs, poses, render_poses, [H, W, focal], i_split
