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

from nerfsos_torch.data.poses import pose_spherical
from nerfsos_torch.data.ray_utils import persp_intrinsics, persp_rays_batch

R_CAM, R_SPHERE, R_BG = 4.0, 1.0, 8.0
NEAR, FAR = 2.0, 13.0


def persp_rays(height: int, width: int, focal: float, c2ws: np.ndarray) -> np.ndarray:
    """Pinhole rays for poses ``[N, 3|4, 4]`` -> ``[N, H, W, 2, 3]`` float32."""
    return persp_rays_batch(height, width, persp_intrinsics(height, width, focal), c2ws)


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


def write_llff_scene(root: str, height: int, width: int, n_views: int = 12,
                     factor: int = 8) -> None:
    """A raw LLFF scene of the analytic sphere (the layout of
    ``nerf_llff_data/<scene>`` after minification): ``n_views`` forward-facing
    PNGs of ``height x width`` in ``images_{factor}/`` (and the same files in
    ``images/``, of which the loader reads only the first file's shape),
    their masks in ``masks/`` and ``poses_bounds.npy`` (LLFF's
    [down, right, back] camera axes, the full-resolution ``H, W, focal``
    column, each view's near and far depth). The cameras sit on a circle of
    radius 0.5 at distance ``R_CAM`` looking at the sphere."""
    from nerfsos_torch.data.poses import normalize, viewmatrix
    from nerfsos_torch.utils.image import write_png

    focal = 1.1 * width
    poses = []
    for i in range(n_views):
        th = 2.0 * np.pi * i / n_views
        pos = np.array([0.5 * np.cos(th), 0.5 * np.sin(th), R_CAM])
        poses.append(viewmatrix(normalize(pos), np.array([0.0, 1.0, 0.0]), pos))
    poses = np.stack(poses)  # [N, 3, 4], NeRF's [right, up, back]
    rays = persp_rays(height, width, focal, poses)
    for d in ("images", f"images_{factor}", "masks"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    for i, r in enumerate(rays):
        rgb, mask = render_analytic(r)
        img = np.round(rgb * 255).astype(np.uint8)
        for d in ("images", f"images_{factor}"):
            write_png(os.path.join(root, d, f"image{i:03d}.png"), img)
        write_png(os.path.join(root, "masks", f"image{i:03d}.png"),
                  (mask[..., 0] * 255).astype(np.uint8))
    llff = np.concatenate([-poses[:, :, 1:2], poses[:, :, 0:1], poses[:, :, 2:4]], 2)
    hwf = np.broadcast_to(np.array([height * factor, width * factor, focal * factor],
                                   np.float64)[None, :, None], (n_views, 3, 1))
    bounds = np.tile([[R_CAM - 1.5, R_CAM + R_BG]], (n_views, 1))
    np.save(os.path.join(root, "poses_bounds.npy"),
            np.concatenate([np.concatenate([llff, hwf], 2).reshape(n_views, 15), bounds], 1))


def write_blender_scene(root: str, size: int, counts=(8, 2, 2),
                        camera_angle_x: float = 0.6911112070083618) -> None:
    """A raw Blender scene of the analytic sphere (the layout of
    ``nerf_synthetic/<scene>``): RGBA PNGs of ``size x size``, the sphere
    opaque on a transparent background, ``counts`` views of the train, val
    and test splits on the upper hemisphere of radius ``R_CAM``, and
    ``transforms_{split}.json``."""
    from nerfsos_torch.utils.image import write_png

    focal = 0.5 * size / np.tan(0.5 * camera_angle_x)
    for s, (split, n) in enumerate(zip(("train", "val", "test"), counts)):
        os.makedirs(os.path.join(root, split), exist_ok=True)
        angles = np.linspace(-180.0, 180.0, n, endpoint=False) + 37.0 * s
        poses = np.stack([pose_spherical(a, -30.0 - 10.0 * (i % 2), R_CAM)
                          for i, a in enumerate(angles)])
        frames = []
        for i, r in enumerate(persp_rays(size, size, focal, poses)):
            rgb, mask = render_analytic(r)
            rgba = np.concatenate([rgb * mask, mask], -1)
            write_png(os.path.join(root, split, f"r_{i}.png"),
                      np.round(rgba * 255).astype(np.uint8))
            frames.append({"file_path": f"./{split}/r_{i}",
                           "transform_matrix": poses[i].tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": camera_angle_x, "frames": frames}, f)
