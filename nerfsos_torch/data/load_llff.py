"""LLFF forward-facing (and CO3D-as-LLFF / toydesk_custom) scene loading.

Port of ``nerfsos_tpu/data/load_llff.py`` (numpy).

Behavior parity with the reference loader (``data/load_llff.py`` and its
near-clone ``data/load_toydesk_custom.py`` in VITA-Group/NeRF-SOS):
``poses_bounds.npy`` parsing, axis fix, bound rescale by ``1/(min_bd * 0.75)``,
recentering, optional spherification (120-pose circle path) or spiral path,
masks from ``segments/`` or ``masks/``, min-distance holdout view. Minification
uses in-process PIL instead of ImageMagick.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from nerfsos_torch.data import poses as pose_utils
from nerfsos_torch.data.image_io import imread, list_images, minify


def _load_data(
    basedir: str,
    factor: Optional[int] = None,
    width: Optional[int] = None,
    height: Optional[int] = None,
    mask_dirs: Tuple[str, ...] = ("segments", "masks"),
    mask_fallback_imgdir: bool = False,
):
    poses_arr = np.load(os.path.join(basedir, "poses_bounds.npy"))
    poses = poses_arr[:, :-2].reshape([-1, 3, 5]).transpose([1, 2, 0])
    bds = poses_arr[:, -2:].transpose([1, 0])

    img0 = list_images(os.path.join(basedir, "images"))[0]
    sh = imread(img0).shape

    sfx = ""
    if factor is not None and factor != 1:
        sfx = f"_{factor}"
        minify(basedir, factors=[factor])
    elif height is not None:
        factor = sh[0] / float(height)
        width = int(sh[1] / factor)
        minify(basedir, resolutions=[[height, width]])
        sfx = f"_{width}x{height}"
    elif width is not None:
        factor = sh[1] / float(width)
        height = int(sh[0] / factor)
        minify(basedir, resolutions=[[height, width]])
        sfx = f"_{width}x{height}"
    else:
        factor = 1

    imgdir = os.path.join(basedir, "images" + sfx)
    if not os.path.exists(imgdir):
        raise FileNotFoundError(imgdir)

    maskdir = None
    for d in mask_dirs:
        cand = os.path.join(basedir, d)
        if os.path.exists(cand):
            maskdir = cand
            break
    if maskdir is None:
        if mask_fallback_imgdir:
            maskdir = imgdir
        else:
            raise FileNotFoundError(
                f"no mask dir among {mask_dirs} under {basedir} "
                "(reference data/load_llff.py:93-98 requires one)"
            )

    imgfiles = list_images(imgdir)
    maskfiles = list_images(maskdir)
    if poses.shape[-1] != len(imgfiles):
        raise RuntimeError(f"Mismatch between imgs {len(imgfiles)} and poses {poses.shape[-1]}")

    sh = imread(imgfiles[0]).shape
    poses[:2, 4, :] = np.array(sh[:2]).reshape([2, 1])
    poses[2, 4, :] = poses[2, 4, :] * 1.0 / factor

    imgs = np.stack([imread(f)[..., :3] / 255.0 for f in imgfiles], -1)
    masks = np.stack([np.expand_dims(imread(f) / 255.0, -1) for f in maskfiles], -1)
    if masks.ndim == 5:  # rgb masks -> take first channel
        masks = masks[:, :, :1, 0, :]
        masks = np.expand_dims(masks[:, :, 0], 2)
    print("Loaded image data", imgs.shape, poses[:, -1, 0])
    return poses, bds, imgs, masks


def load_llff_data(
    basedir: str,
    factor: int = 8,
    recenter: bool = True,
    bd_factor: Optional[float] = 0.75,
    spherify: bool = False,
    path_zflat: bool = False,
    mask_dirs: Tuple[str, ...] = ("segments", "masks"),
    mask_fallback_imgdir: bool = False,
):
    """Returns (images [N,H,W,3], poses [N,3,5], bds [N,2], render_poses,
    i_test, masks [N,H,W,1]). Parity: reference ``data/load_llff.py:249-325``.
    """
    poses, bds, imgs, masks = _load_data(
        basedir, factor=factor, mask_dirs=mask_dirs, mask_fallback_imgdir=mask_fallback_imgdir
    )
    print("Loaded", basedir, bds.min(), bds.max())

    # LLFF -> NeRF axis convention: [down, right, back] -> [right, up, back]
    poses = np.concatenate([poses[:, 1:2, :], -poses[:, 0:1, :], poses[:, 2:, :]], 1)
    poses = np.moveaxis(poses, -1, 0).astype(np.float32)
    imgs = np.moveaxis(imgs, -1, 0).astype(np.float32)
    masks = np.moveaxis(masks, -1, 0).astype(np.float32)
    bds = np.moveaxis(bds, -1, 0).astype(np.float32)

    sc = 1.0 if bd_factor is None else 1.0 / (bds.min() * bd_factor)
    poses[:, :3, 3] *= sc
    bds *= sc

    if recenter:
        poses = pose_utils.recenter_poses(poses)

    if spherify:
        poses, render_poses, bds = pose_utils.spherify_poses(poses, bds)
    else:
        c2w = pose_utils.poses_avg(poses)
        up = pose_utils.normalize(poses[:, :3, 1].sum(0))

        # reasonable focus depth from the bounds
        close_depth, inf_depth = bds.min() * 0.9, bds.max() * 5.0
        dt = 0.75
        focal = 1.0 / ((1.0 - dt) / close_depth + dt / inf_depth)

        tt = poses[:, :3, 3]
        rads = np.percentile(np.abs(tt), 90, 0)
        c2w_path = c2w
        N_views, N_rots = 120, 2
        if path_zflat:
            zloc = -close_depth * 0.1
            c2w_path[:3, 3] = c2w_path[:3, 3] + zloc * c2w_path[:3, 2]
            rads[2] = 0.0
            N_rots = 1
            N_views = N_views // 2
        render_poses = pose_utils.render_path_spiral(
            c2w_path, up, rads, focal, zrate=0.5, rots=N_rots, N=N_views
        )

    render_poses = np.array(render_poses).astype(np.float32)

    c2w = pose_utils.poses_avg(poses)
    dists = np.sum(np.square(c2w[:3, 3] - poses[:, :3, 3]), -1)
    i_test = int(np.argmin(dists))
    print("HOLDOUT view is", i_test)

    return (
        imgs.astype(np.float32),
        poses.astype(np.float32),
        bds,
        render_poses,
        i_test,
        masks.astype(np.float32),
    )


def load_toydesk_custom_data(basedir, factor=6, recenter=True, bd_factor=0.75,
                             spherify=False, path_zflat=False):
    """toydesk_custom/tankstemple_custom/synthetic_custom: LLFF pipeline with
    ``masks/`` first and image-dir fallback (reference ``data/load_toydesk_custom.py``)."""
    return load_llff_data(
        basedir, factor=factor, recenter=recenter, bd_factor=bd_factor,
        spherify=spherify, path_zflat=path_zflat,
        mask_dirs=("masks",), mask_fallback_imgdir=True,
    )
