"""An analytic scene in the prepared-dataset layout (numpy only).

A textured sphere (foreground, mask 1) inside a textured background shell,
seen from cameras on a circle: the scene of ``tools/validate_sos_protocol.py``
at any image size. Ground-truth rgb and masks come from ray-sphere hits, so
a render can be scored without real data or pretrained weights.
"""
from __future__ import annotations

import json
import os

import numpy as np

R_CAM, R_SPHERE, R_BG = 4.0, 1.0, 8.0
NEAR, FAR = 2.0, 13.0


def pose_spherical(theta_deg: float, phi_deg: float, radius: float) -> np.ndarray:
    """Blender-style camera-to-world pose on a sphere of ``radius``."""
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


def persp_rays(height: int, width: int, focal: float, c2ws: np.ndarray) -> np.ndarray:
    """Pinhole rays for poses ``[N, 3|4, 4]`` -> ``[N, H, W, 2, 3]`` float32."""
    c2ws = np.asarray(c2ws)[:, :3, :4]
    j, i = np.meshgrid(np.arange(height, dtype=np.float64), np.arange(width, dtype=np.float64),
                       indexing="ij")
    dirs = np.stack([(i - width / 2.0) / focal, -(j - height / 2.0) / focal, -np.ones_like(i)],
                    axis=-1)
    rays_d = np.einsum("hwc,nrc->nhwr", dirs, c2ws[:, :3, :3])
    rays_o = np.broadcast_to(c2ws[:, None, None, :3, 3], rays_d.shape)
    return np.stack([rays_o, rays_d], axis=-2).astype(np.float32)


def _texture(p: np.ndarray, freq: float, base: np.ndarray, amp: float) -> np.ndarray:
    s = np.sin(freq * p[..., 0]) * np.sin(freq * p[..., 1]) * np.sin(freq * p[..., 2])
    return np.clip(base + amp * s[..., None] * np.array([1.0, -0.5, 0.25]), 0.0, 1.0)


def _ray_sphere(o: np.ndarray, d: np.ndarray, radius: float):
    a = np.sum(d * d, -1)
    b = 2.0 * np.sum(o * d, -1)
    c = np.sum(o * o, -1) - radius**2
    disc = b * b - 4 * a * c
    sq = np.sqrt(np.maximum(disc, 0.0))
    t0, t1 = (-b - sq) / (2 * a), (-b + sq) / (2 * a)
    t = np.where(t0 > 1e-3, t0, t1)
    return (disc > 0) & (t > 1e-3), t


def render_analytic(rays: np.ndarray):
    """rays ``[H, W, 2, 3]`` -> (rgb ``[H, W, 3]``, mask ``[H, W, 1]``)."""
    o, d = rays[..., 0, :], rays[..., 1, :]
    hit_fg, t_fg = _ray_sphere(o, d, R_SPHERE)
    _, t_bg = _ray_sphere(o, d, R_BG)  # the camera is inside the shell
    fg = _texture(o + t_fg[..., None] * d, 6.0, np.array([0.85, 0.35, 0.25]), 0.25)
    bg = _texture(o + t_bg[..., None] * d, 1.5, np.array([0.2, 0.45, 0.7]), 0.2)
    rgb = np.where(hit_fg[..., None], fg, bg).astype(np.float32)
    return rgb, hit_fg[..., None].astype(np.float32)


def write_sphere_scene(root: str, height: int, width: int, n_views: int = 1,
                       split: str = "test") -> None:
    """Write ``n_views`` views of the scene as ``split`` (rays, rgbs, masks
    and the camera-to-world ``poses_{split}.npy [N, 3, 4]``) plus
    ``meta.json``.

    Splits already in ``root`` are kept, so a ``train`` split can be written
    beside a ``test`` one, of the same size or another (the datasets take
    each split's size from its arrays; ``meta.json``'s ``H``, ``W`` and
    ``focal`` are the last split's): ``PatchDataset`` at the flagship
    ``--patch_size 64 --patch_stride 6`` needs train views of at least 384
    pixels a side. The train cameras sit half a step further round the
    circle than the test cameras."""
    os.makedirs(root, exist_ok=True)
    focal = 1.25 * width
    angles = np.linspace(0.0, 360.0, n_views, endpoint=False)
    if split == "train":
        angles = angles + 180.0 / n_views
    poses = np.stack([pose_spherical(a, -25.0 - 15.0 * ((i % 3) - 1), R_CAM)
                      for i, a in enumerate(angles)])
    rays = persp_rays(height, width, focal, poses)
    rgbs, masks = zip(*(render_analytic(r) for r in rays))
    np.save(os.path.join(root, f"rays_{split}.npy"), rays)
    np.save(os.path.join(root, f"rgbs_{split}.npy"), np.stack(rgbs))
    np.save(os.path.join(root, f"masks_{split}.npy"), np.stack(masks))
    np.save(os.path.join(root, f"poses_{split}.npy"), poses[:, :3, :4].astype(np.float32))
    with open(os.path.join(root, "meta.json"), "w") as f:
        json.dump({"H": height, "W": width, "focal": focal, "near": NEAR, "far": FAR}, f)
