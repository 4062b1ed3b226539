"""ToyDesk (object-nerf) scene loading, plus COLMAP binary readers.

Port of ``nerfsos_tpu/data/load_toydesk.py`` (numpy).

Parity: reference ``data/load_toydesk.py`` — idx-keyed ``transforms_full.json``
frames padded to the max index, the y/z flip ``fix_rot``, and train/test
splits read from ``{data_home}/split/{slice}_train_0.8/{train,test}.txt``.
The COLMAP ``images.bin`` reader is kept for parity with the reference's
embedded reconstruction tooling (``:196-240``).
"""
from __future__ import annotations

import collections
import json
import os
import struct

import numpy as np

from nerfsos_torch.data.image_io import imread

Image = collections.namedtuple(
    "Image", ["id", "qvec", "tvec", "camera_id", "name", "xys", "point3D_ids"]
)


def qvec2rotmat(qvec: np.ndarray) -> np.ndarray:
    w, x, y, z = qvec
    return np.array(
        [
            [1 - 2 * y**2 - 2 * z**2, 2 * x * y - 2 * w * z, 2 * z * x + 2 * w * y],
            [2 * x * y + 2 * w * z, 1 - 2 * x**2 - 2 * z**2, 2 * y * z - 2 * w * x],
            [2 * z * x - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x**2 - 2 * y**2],
        ]
    )


def _read_next_bytes(fid, num_bytes, fmt, endian="<"):
    return struct.unpack(endian + fmt, fid.read(num_bytes))


def read_images_binary(path: str):
    """COLMAP ``images.bin`` reader (same wire format as reconstruction.cc)."""
    images = {}
    with open(path, "rb") as fid:
        num = _read_next_bytes(fid, 8, "Q")[0]
        for _ in range(num):
            props = _read_next_bytes(fid, 64, "idddddddi")
            image_id = props[0]
            qvec = np.array(props[1:5])
            tvec = np.array(props[5:8])
            camera_id = props[8]
            name = ""
            c = _read_next_bytes(fid, 1, "c")[0]
            while c != b"\x00":
                name += c.decode("utf-8")
                c = _read_next_bytes(fid, 1, "c")[0]
            n2d = _read_next_bytes(fid, 8, "Q")[0]
            raw = _read_next_bytes(fid, 24 * n2d, "ddq" * n2d)
            xys = np.column_stack([list(map(float, raw[0::3])), list(map(float, raw[1::3]))])
            p3d = np.array(list(map(int, raw[2::3])))
            images[image_id] = Image(image_id, qvec, tvec, camera_id, name, xys, p3d)
    return images


def _load_data(basedir: str):
    with open(f"{basedir}/transforms_full.json") as f:
        pose_dict = json.load(f)

    idx_list = [item["idx"] for item in pose_dict["frames"]]
    _max = max(idx_list)

    first = imread(f"{basedir}/{pose_dict['frames'][0]['file_path']}.png")
    height, width = first.shape[:2]
    imgs = np.zeros([_max + 1, height, width, 3], np.float32)
    poses = np.zeros([_max + 1, 4, 4], np.float32)
    for item in pose_dict["frames"]:
        i = item["idx"]
        poses[i] = np.array(item["transform_matrix"])
        imgs[i] = imread(f"{basedir}/{item['file_path']}.png")[..., :3] / 255.0
    masks = np.expand_dims(np.zeros_like(imgs)[..., 0], -1)
    return poses, imgs, masks, idx_list


def load_toydesk_data(basedir: str):
    poses, imgs, masks, idx_list = _load_data(basedir)

    fix_rot = np.array([1, 0, 0, 0, -1, 0, 0, 0, -1]).reshape(3, 3)
    poses_ = poses.copy()
    for idx in range(poses.shape[0]):
        poses_[idx, :3, :3] = poses[idx, :3, :3] @ fix_rot

    data_home, slc = basedir.split("/processed/")
    slc = slc.split("/")[0]

    def read_split(name):
        with open(f"{data_home}/split/{slc}_train_0.8/{name}.txt") as f:
            vals = [x.strip() for x in f.readlines()]
        return [int(x) for x in vals if x and int(x) in idx_list]

    i_train, i_test = read_split("train"), read_split("test")
    i_split = [np.array(i_train), np.array(i_test), np.array(i_test)]
    return (
        imgs.astype(np.float32),
        poses_.astype(np.float32),
        None,  # render_poses (exhibit falls back to train poses)
        masks.astype(np.float32),
        i_split,
        None,  # hwf (caller applies the reference default [353, 640, 466.772])
    )
