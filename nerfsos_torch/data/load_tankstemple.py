"""Tanks & Temples (NSVF-format) loading.

Port of ``nerfsos_tpu/data/load_tankstemple.py`` (numpy).

Parity: reference ``data/load_tankstemple.py`` minus the stray ``st()``
debugger breakpoint at its line 18 (SURVEY.md §7.4.7).
"""
from __future__ import annotations

import glob
import os

import numpy as np

from nerfsos_torch.data.image_io import imread


def load_tankstemple_data(basedir: str):
    pose_paths = sorted(glob.glob(os.path.join(basedir, "pose", "*txt")))
    rgb_paths = sorted(glob.glob(os.path.join(basedir, "rgb", "*png")))

    all_poses, all_imgs = [], []
    i_split = [[], []]
    for i, (pose_path, rgb_path) in enumerate(zip(pose_paths, rgb_paths)):
        i_set = int(os.path.split(rgb_path)[-1][0])  # filename prefix 0_/1_ encodes split
        all_poses.append(np.loadtxt(pose_path).astype(np.float32))
        all_imgs.append((imread(rgb_path) / 255.0).astype(np.float32))
        i_split[i_set].append(i)

    imgs = np.stack(all_imgs, 0)
    poses = np.stack(all_poses, 0)
    i_split.append(i_split[-1])  # test = val

    K = np.loadtxt(os.path.join(basedir, "intrinsics.txt"))
    H, W = imgs[0].shape[:2]
    focal = float(K[0, 0])

    path_traj = os.path.join(basedir, "test_traj.txt")
    if os.path.isfile(path_traj):
        render_poses = np.loadtxt(path_traj).reshape(-1, 4, 4).astype(np.float32)
    else:
        render_poses = poses[i_split[-1]]
    return imgs, poses, render_poses, [H, W, focal], K, i_split
