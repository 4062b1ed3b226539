"""Dataset preparation: raw scenes -> the prepared ``.npy`` ray/rgb/mask
layout.

Port of ``nerfsos_tpu/data/gen_dataset.py`` (the reference's
``data/gen_dataset.py``), with the same flags, data types and on-disk
artifacts (``rays_{split}.npy [N, H, W, 2, 3]``, ``rgbs_{split}.npy``,
``masks_{split}.npy``, ``rays_exhibit.npy``, ``poses_{split}.npy`` with
``--w_pose``, ``meta.json``), so a scene prepared by either package is read
by both. Rays for all poses come from one numpy einsum (``ray_utils``).

    python -m nerfsos_torch.data.gen_dataset --config configs/flower_full.txt \
        --data_type llff [--data_path DIR] [--output_path DIR]

Images are decoded by ``data/image_io.imread``: PNGs need nothing beyond
numpy, JPEGs and LLFF's minification (``--factor`` with no ``images_{f}/``
yet) need PIL. ``llff`` also takes CO3D scenes laid out as LLFF.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Any, Optional

import numpy as np

from nerfsos_torch.data import ray_utils
from nerfsos_torch.data.poses import inward_nearfar_heuristic

DATA_TYPES = [
    "llff", "blender", "LINEMOD", "deepvoxels", "tankstemple", "toydesk",
    "toydesk_custom", "dtu", "tankstemple_custom", "synthetic_custom",
]


def create_arg_parser() -> argparse.ArgumentParser:
    from nerfsos_torch.engines.config import ConfigArgumentParser

    parser = ConfigArgumentParser()
    parser.add_argument("--config", type=str, default=None, help="Path to config file")
    parser.add_argument("--data_type", "--dataset_type", type=str, required=True,
                        choices=DATA_TYPES)
    parser.add_argument("--data_path", "--datadir", type=str, required=True)
    parser.add_argument("--output_path", type=str, default="")
    parser.add_argument("--ndc", action="store_true", default=False)
    parser.add_argument("--spherify", action="store_true", default=False)
    parser.add_argument("--factor", type=int, default=8)
    parser.add_argument("--llffhold", type=int, default=8)
    parser.add_argument("--half_res", action="store_true", default=False)
    parser.add_argument("--white_bkgd", action="store_true", default=False)
    parser.add_argument("--test_skip", type=int, default=8)
    parser.add_argument("--dv_scene", type=str, default="greek",
                        choices=["armchair", "cube", "greek", "vase"])
    parser.add_argument("--inverse_y", default=False)
    parser.add_argument("--w_pose", action="store_true", default=False)
    return parser


def generate_dataset(args: Any, output_path: str) -> None:
    if not os.path.exists(args.data_path):
        raise FileNotFoundError(args.data_path)

    K: Optional[np.ndarray] = None
    masks = None
    render_poses = None

    if args.data_type in ("llff", "dtu"):
        from nerfsos_torch.data.load_llff import load_llff_data

        images, poses, bds, render_poses, i_test, masks = load_llff_data(
            args.data_path, factor=args.factor, recenter=True, bd_factor=0.75,
            spherify=args.spherify,
        )
        hwf = poses[0, :3, -1]
        poses = poses[:, :3, :4]
        i_test = [i_test] if not isinstance(i_test, (list, np.ndarray)) else i_test
        if args.llffhold > 0:
            i_test = np.arange(images.shape[0])[:: args.llffhold]
        i_val = i_test
        i_train = np.array(
            [i for i in np.arange(int(images.shape[0])) if i not in i_test and i not in i_val]
        )
        if args.ndc:
            near, far = 0.0, 1.0
        else:
            near, far = float(bds.min()) * 0.9, float(bds.max())

    elif args.data_type == "blender":
        from nerfsos_torch.data.load_blender import load_blender_data

        images, poses, render_poses, hwf, i_split = load_blender_data(
            args.data_path, args.half_res, args.test_skip
        )
        i_train, i_val, i_test = i_split
        near, far = 2.0, 6.0
        if args.white_bkgd:
            images = images[..., :3] * images[..., -1:] + (1.0 - images[..., -1:])
        else:
            images = images[..., :3]

    elif args.data_type == "LINEMOD":
        from nerfsos_torch.data.load_linemod import load_linemod_data

        images, poses, render_poses, hwf, K, i_split, near, far = load_linemod_data(
            args.data_path, args.half_res, args.test_skip
        )
        i_train, i_val, i_test = i_split
        if images.shape[-1] == 4:
            if args.white_bkgd:
                images = images[..., :3] * images[..., -1:] + (1.0 - images[..., -1:])
            else:
                images = images[..., :3]
        K = np.asarray(K, dtype=np.float64)

    elif args.data_type == "deepvoxels":
        from nerfsos_torch.data.load_deepvoxels import load_dv_data

        images, poses, render_poses, hwf, i_split = load_dv_data(
            scene=args.dv_scene, basedir=args.data_path, testskip=args.test_skip
        )
        i_train, i_val, i_test = i_split
        hemi_R = np.mean(np.linalg.norm(poses[:, :3, -1], axis=-1))
        near, far = hemi_R - 1.0, hemi_R + 1.0

    elif args.data_type == "tankstemple":
        from nerfsos_torch.data.load_tankstemple import load_tankstemple_data

        images, poses, render_poses, hwf, K, i_split = load_tankstemple_data(args.data_path)
        i_train, i_val, i_test = i_split
        near, far = inward_nearfar_heuristic(poses[i_train, :3, 3])
        if images.shape[-1] == 4:
            if args.white_bkgd:
                images = images[..., :3] * images[..., -1:] + (1.0 - images[..., -1:])
            else:
                images = images[..., :3] * images[..., -1:]

    elif args.data_type == "toydesk":
        from nerfsos_torch.data.load_toydesk import load_toydesk_data

        images, poses, render_poses, masks, i_split, hwf = load_toydesk_data(args.data_path)
        i_train, i_val, i_test = i_split
        near, far = 0.0, 1.0
        if hwf is None:
            hwf = [353, 640, 466.772]

    elif args.data_type in ("toydesk_custom", "tankstemple_custom", "synthetic_custom"):
        from nerfsos_torch.data.load_llff import load_toydesk_custom_data

        images, poses, bds, render_poses, i_test, masks = load_toydesk_custom_data(
            args.data_path, factor=args.factor, recenter=True, bd_factor=0.75,
            spherify=args.spherify,
        )
        hwf = poses[0, :3, -1]
        poses = poses[:, :3, :4]
        i_test = [i_test] if not isinstance(i_test, (list, np.ndarray)) else i_test
        if args.llffhold > 0:
            i_test = np.arange(images.shape[0])[:: args.llffhold]
        i_val = i_test
        i_train = np.array(
            [i for i in np.arange(int(images.shape[0])) if i not in i_test and i not in i_val]
        )
        if args.ndc:
            near, far = 0.0, 1.0
        else:
            near, far = float(bds.min()) * 0.9, float(bds.max())
    else:
        raise ValueError(f"Unknown dataset type: {args.data_type}")

    if masks is None:
        masks = np.ones(images.shape[:3] + (1,), np.float32)

    H, W, focal = hwf
    H, W = int(H), int(W)
    if K is None:
        K = ray_utils.persp_intrinsics(H, W, focal)
    i_train, i_val, i_test = map(np.asarray, (i_train, i_val, i_test))
    print("Intrinsics:", K, "\nsplits:", i_train, i_val, i_test)

    rays = ray_utils.persp_rays_batch(H, W, K, poses[:, :3, :4])  # [N, H, W, 2, 3]

    if render_poses is None:
        print("> Warning! render_poses is None, using train poses")
        render_poses = poses[i_train]
    render_poses = np.asarray(render_poses)
    rays_exhibit = ray_utils.persp_rays_batch(H, W, K, render_poses[:, :3, :4])

    os.makedirs(output_path, exist_ok=True)
    for split, idx in [("train", i_train), ("val", i_val), ("test", i_test)]:
        np.save(os.path.join(output_path, f"rays_{split}.npy"), rays[idx])
        np.save(os.path.join(output_path, f"rgbs_{split}.npy"), images[idx].astype(np.float32))
        np.save(os.path.join(output_path, f"masks_{split}.npy"), masks[idx].astype(np.float32))
        if getattr(args, "w_pose", False):
            np.save(os.path.join(output_path, f"poses_{split}.npy"), poses[idx])
    np.save(os.path.join(output_path, "rays_exhibit.npy"), rays_exhibit)

    meta_dict = {
        "H": H, "W": W, "focal": float(focal),
        "near": float(near), "far": float(far),
        "i_train": i_train.tolist(), "i_val": i_val.tolist(), "i_test": i_test.tolist(),
        "ndc": bool(args.ndc), "factor": int(args.factor),
        "spherify": bool(args.spherify), "llffhold": int(args.llffhold),
        "half_res": bool(args.half_res), "white_bkgd": bool(args.white_bkgd),
        "test_skip": int(args.test_skip), "dv_scene": args.dv_scene,
    }
    with open(os.path.join(output_path, "meta.json"), "w") as f:
        json.dump(meta_dict, f)
    print("Saved dataset to", output_path)


def main():
    parser = create_arg_parser()
    args, _ = parser.parse_known_args()
    output_path = args.output_path or args.data_path
    os.makedirs(output_path, exist_ok=True)
    generate_dataset(args, output_path)


if __name__ == "__main__":
    main()
