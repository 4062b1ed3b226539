"""Camera pose manipulation for LLFF-style forward-facing and 360 captures
(numpy).

Port of ``nerfsos_tpu/data/poses.py`` (the reference's pose pipeline,
``data/load_llff.py:130-246`` in VITA-Group/NeRF-SOS): average pose,
recentering, spherification with a 120-pose circular render path, the
2-rotation spiral render path, Blender's spherical poses and the inward
near/far heuristic.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


def normalize(x: np.ndarray) -> np.ndarray:
    return x / np.linalg.norm(x)


def viewmatrix(z: np.ndarray, up: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """[3, 4] camera-to-world from forward z, up hint, and position."""
    vec2 = normalize(z)
    vec0 = normalize(np.cross(up, vec2))
    vec1 = normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, pos], axis=1)


def poses_avg(poses: np.ndarray) -> np.ndarray:
    """Average pose of an [N, 3, 5] (pose | hwf) stack. Returns [3, 5]."""
    hwf = poses[0, :3, -1:]
    center = poses[:, :3, 3].mean(0)
    vec2 = normalize(poses[:, :3, 2].sum(0))
    up = poses[:, :3, 1].sum(0)
    return np.concatenate([viewmatrix(vec2, up, center), hwf], axis=1)


def recenter_poses(poses: np.ndarray) -> np.ndarray:
    """Rigidly transform all poses so the average pose is the identity.

    Parity: reference ``data/load_llff.py:171-184``.
    """
    poses_ = poses.copy()
    bottom = np.reshape([0, 0, 0, 1.0], [1, 4])
    c2w = poses_avg(poses)
    c2w = np.concatenate([c2w[:3, :4], bottom], axis=-2)
    bottom = np.tile(bottom[None], [poses.shape[0], 1, 1])
    homo = np.concatenate([poses[:, :3, :4], bottom], axis=-2)
    poses_[:, :3, :4] = (np.linalg.inv(c2w) @ homo)[:, :3, :4]
    return poses_


def render_path_spiral(
    c2w: np.ndarray,
    up: np.ndarray,
    rads: np.ndarray,
    focal: float,
    zrate: float,
    rots: int,
    N: int,
) -> List[np.ndarray]:
    """Spiral camera path around the average pose.

    Parity: reference ``data/load_llff.py:158-167``.
    """
    out = []
    rads = np.array(list(rads) + [1.0])
    hwf = c2w[:, 4:5]
    for theta in np.linspace(0.0, 2.0 * np.pi * rots, N + 1)[:-1]:
        c = c2w[:3, :4] @ (np.array([np.cos(theta), -np.sin(theta), -np.sin(theta * zrate), 1.0]) * rads)
        z = normalize(c - c2w[:3, :4] @ np.array([0, 0, -focal, 1.0]))
        out.append(np.concatenate([viewmatrix(z, up, c), hwf], axis=1))
    return out


def spherify_poses(poses: np.ndarray, bds: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Re-center 360 captures on the point nearest all camera axes; emit a
    120-pose circular render path at the centroid height.

    Parity: reference ``data/load_llff.py:190-246``.
    """

    def p34_to_44(p):
        return np.concatenate(
            [p, np.tile(np.eye(4)[-1].reshape(1, 1, 4), [p.shape[0], 1, 1])], axis=1
        )

    rays_d = poses[:, :3, 2:3]
    rays_o = poses[:, :3, 3:4]

    # least-squares point closest to all camera optical axes
    A_i = np.eye(3) - rays_d * np.transpose(rays_d, [0, 2, 1])
    b_i = -A_i @ rays_o
    pt_mindist = np.squeeze(
        -np.linalg.inv((np.transpose(A_i, [0, 2, 1]) @ A_i).mean(0)) @ b_i.mean(0)
    )

    center = pt_mindist
    up = (poses[:, :3, 3] - center).mean(0)
    vec0 = normalize(up)
    vec1 = normalize(np.cross([0.1, 0.2, 0.3], vec0))
    vec2 = normalize(np.cross(vec0, vec1))
    c2w = np.stack([vec1, vec2, vec0, center], axis=1)

    poses_reset = np.linalg.inv(p34_to_44(c2w[None])) @ p34_to_44(poses[:, :3, :4])

    rad = np.sqrt(np.mean(np.sum(np.square(poses_reset[:, :3, 3]), -1)))
    sc = 1.0 / rad
    poses_reset[:, :3, 3] *= sc
    bds = bds * sc
    rad *= sc

    centroid = np.mean(poses_reset[:, :3, 3], 0)
    zh = centroid[2]
    radcircle = np.sqrt(rad**2 - zh**2)
    new_poses = []
    for th in np.linspace(0.0, 2.0 * np.pi, 120):
        camorigin = np.array([radcircle * np.cos(th), radcircle * np.sin(th), zh])
        up = np.array([0, 0, -1.0])
        vec2 = normalize(camorigin)
        vec0 = normalize(np.cross(vec2, up))
        vec1 = normalize(np.cross(vec2, vec0))
        new_poses.append(np.stack([vec0, vec1, vec2, camorigin], 1))
    new_poses = np.stack(new_poses, 0)

    new_poses = np.concatenate(
        [new_poses, np.broadcast_to(poses[0, :3, -1:], new_poses[:, :3, -1:].shape)], -1
    )
    poses_reset = np.concatenate(
        [poses_reset[:, :3, :4], np.broadcast_to(poses[0, :3, -1:], poses_reset[:, :3, -1:].shape)], -1
    )
    return poses_reset, new_poses, bds


def pose_spherical(theta_deg: float, phi_deg: float, radius: float) -> np.ndarray:
    """Blender-style camera-to-world pose on a sphere of ``radius`` (reference
    ``data/load_blender.py:10-34``)."""
    th, phi = np.deg2rad(theta_deg), np.deg2rad(phi_deg)
    trans = np.eye(4)
    trans[2, 3] = radius
    rp = np.eye(4)
    rp[1, 1], rp[1, 2] = np.cos(phi), -np.sin(phi)
    rp[2, 1], rp[2, 2] = np.sin(phi), np.cos(phi)
    rt = np.eye(4)
    rt[0, 0], rt[0, 2] = np.cos(th), -np.sin(th)
    rt[2, 0], rt[2, 2] = np.sin(th), np.cos(th)
    flip = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], dtype=np.float64)
    return flip @ rt @ rp @ trans


def inward_nearfar_heuristic(cam_o: np.ndarray, ratio: float = 0.05) -> Tuple[float, float]:
    """near/far from max pairwise camera distance (``data/gen_dataset.py:253-257``)."""
    dist = np.linalg.norm(cam_o[:, None] - cam_o, axis=-1)
    far = float(dist.max())
    return far * ratio, far
