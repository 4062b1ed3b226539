"""NeRF-SOS on PyTorch — the command-line entry point of the port.

``python -m nerfsos_torch.run_nerf --config configs/<scene>.txt --eval ...``
takes the flags of the repository's ``run_nerf.py`` (the same names, types
and defaults) and the same run-directory layout. Implemented: ``--eval``
(render the test split, write metrics and images to ``<basedir>/<expname>/eval``).
The train, ``--eval_video``, ``--eval_vol`` and ``--mipnerf`` modes stop
with "not yet ported".

The model runs on ``cuda:0`` when a card is visible, else on the CPU. On
CUDA the eval render goes through the fused kernels (``ops/fused_render.py``)
unless ``--no_fused_field`` is given or the configuration is outside
``supports_fused``; on the CPU the same code path runs their plain versions.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from nerfsos_torch.engines.config import ConfigArgumentParser


def create_arg_parser() -> ConfigArgumentParser:
    parser = ConfigArgumentParser()

    # basic options
    parser.add_argument("--config", type=str, default=None, help="config file path")
    parser.add_argument("--expname", type=str, help="experiment name")
    parser.add_argument("--basedir", type=str, default="./logs/")
    parser.add_argument("--gpuid", type=int, default=0, help="CUDA device index")
    parser.add_argument("--eval", action="store_true")
    parser.add_argument("--eval_video", action="store_true")
    parser.add_argument("--eval_vol", action="store_true")
    parser.add_argument("--vol_extents", nargs="+", type=float, default=[2.0])
    parser.add_argument("--vol_size", type=float, default=2.0 / 256)

    # dataset options
    parser.add_argument("--data_path", "--datadir", type=str, required=True)
    parser.add_argument("--data_type", "--dataset_type", type=str, required=True,
                        choices=["llff", "blender", "LINEMOD", "deepvoxels", "toydesk",
                                 "toydesk_custom", "tankstemple", "tankstemple_custom",
                                 "synthetic_custom", "dtu"])
    parser.add_argument("--subsample", type=int, default=0)
    parser.add_argument("--ndc", action="store_true", default=False)
    parser.add_argument("--spherify", action="store_true", default=False)
    parser.add_argument("--factor", type=int, default=8)
    parser.add_argument("--llffhold", type=int, default=8)
    parser.add_argument("--half_res", action="store_true", default=False)
    parser.add_argument("--white_bkgd", action="store_true", default=False)
    parser.add_argument("--test_skip", type=int, default=8)
    parser.add_argument("--dv_scene", type=str, default="greek",
                        choices=["armchair", "cube", "greek", "vase"])

    # training options
    parser.add_argument("--netdepth", type=int, default=8)
    parser.add_argument("--netwidth", type=int, default=256)
    parser.add_argument("--netdepth_fine", type=int, default=8)
    parser.add_argument("--netwidth_fine", type=int, default=256)
    parser.add_argument("--max_steps", "--N_iters", type=int, default=200000)
    parser.add_argument("--batch_size", "--N_rand", type=int, default=32 * 32 * 4)
    parser.add_argument("--lrate", type=float, default=5e-4)
    parser.add_argument("--ray_chunk", type=int, default=1024 * 32,
                        help="rays per render chunk")
    parser.add_argument("--pts_chunk", type=int, default=1024 * 256,
                        help="accepted for parity; points are not chunked")
    parser.add_argument("--no_batching", action="store_true")
    parser.add_argument("--decay_step", "--lrate_decay", type=int, default=250,
                        help="exp lr decay iteration (in 1000 steps)")
    parser.add_argument("--decay_rate", type=float, default=0.1)
    parser.add_argument("--no_reload", action="store_true")
    parser.add_argument("--ckpt_path", type=str, default="")
    parser.add_argument("--pin_mem", action="store_true", default=True)
    parser.add_argument("--num_workers", type=int, default=8,
                        help="accepted for parity")
    parser.add_argument("--compute_dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"],
                        help="MLP activation dtype (the port runs float32 only)")
    parser.add_argument("--no_fused_field", action="store_true",
                        help="render with plain PyTorch instead of the fused kernels")

    # rendering options
    parser.add_argument("--N_samples", type=int, default=64)
    parser.add_argument("--N_importance", type=int, default=64)
    parser.add_argument("--perturb", type=float, default=1.0)
    parser.add_argument("--use_viewdirs", action="store_true", default=True)
    parser.add_argument("--no_viewdirs", action="store_false", dest="use_viewdirs")
    parser.add_argument("--mipnerf", action="store_true", default=False)
    parser.add_argument("--use_embed", action="store_true", default=True)
    parser.add_argument("--no_embed", action="store_false", dest="use_embed")
    parser.add_argument("--conv_embed", action="store_true", default=False)
    parser.add_argument("--multires", type=int, default=10)
    parser.add_argument("--multires_views", type=int, default=4)
    parser.add_argument("--raw_noise_std", type=float, default=0.0)
    parser.add_argument("--precrop_iters", type=int, default=0)
    parser.add_argument("--precrop_frac", type=float, default=0.5)

    # logging/saving options
    parser.add_argument("--i_print", type=int, default=500)
    parser.add_argument("--i_verbose", type=int, default=500)
    parser.add_argument("--i_img", type=int, default=900000)
    parser.add_argument("--log_img_idx", type=int, default=0)
    parser.add_argument("--i_weights", type=int, default=10000)
    parser.add_argument("--i_testset", type=int, default=50000)
    parser.add_argument("--i_video", type=int, default=50000)

    # NeRF-SOS options
    parser.add_argument("--use_semantics", action="store_true", default=True)
    parser.add_argument("--no_semantics", action="store_true", default=False)
    parser.add_argument("--sem_w", type=float, default=0,
                        help="parity only: the semantic CE loss is dead code upstream")
    parser.add_argument("--rgb_w", type=float, default=1)
    parser.add_argument("--load_nostrict", action="store_true", default=False)
    parser.add_argument("--patch_tune", action="store_true", default=False)
    parser.add_argument("--patch_size", type=int, default=32)
    parser.add_argument("--patch_stride", type=int, default=1)
    parser.add_argument("--bin_thres", type=float, default=0.3)
    parser.add_argument("--use_dino", action="store_true", default=False)
    parser.add_argument("--dino_ckpt", type=str, default="",
                        help="local path to DINO ViT-S/16 torch weights (not read yet)")
    parser.add_argument("--dino_synthetic", action="store_true", default=False,
                        help="photometric oracle extractor (not ported yet)")
    parser.add_argument("--lpips_path", type=str, default="",
                        help="LPIPS linear-head weights (not ported yet: lpips is null)")
    parser.add_argument("--lpips_backbone_path", type=str, default="",
                        help="LPIPS backbone weights (not ported yet)")
    parser.add_argument("--lpips_net", type=str, default="alex",
                        choices=["alex", "vgg"])
    parser.add_argument("--debug_nans", action="store_true", default=False,
                        help="torch anomaly detection")
    parser.add_argument("--use_contrast", action="store_true", default=False)
    parser.add_argument("--fast_mode", action="store_true", default=False)
    parser.add_argument("--contrast_w", type=float, default=0)
    parser.add_argument("--verbose", action="store_true", default=False)
    parser.add_argument("--sem_layer", type=int, default=2)
    parser.add_argument("--fix_backbone", action="store_true", default=False)
    parser.add_argument("--ret_cluster", action="store_true", default=False)
    parser.add_argument("--correlation_w", type=float, default=0.001)
    parser.add_argument("--Gcorrelation_w", type=float, default=0.001)
    parser.add_argument("--use_correlation", action="store_true", default=False)
    parser.add_argument("--clus_no_sfm", action="store_true", default=False)
    parser.add_argument("--sem_dim", type=int, default=2)
    parser.add_argument("--N_cluster", type=int, default=2)
    parser.add_argument("--self_corr_w", type=float, default=0)
    parser.add_argument("--sem_with_coord", action="store_true", default=False)
    parser.add_argument("--sem_with_geo", action="store_true", default=False)
    parser.add_argument("--use_geoCorr", action="store_true", default=False)
    parser.add_argument("--pos_corr_w", type=float, default=0)
    parser.add_argument("--use_sim_matrix", action="store_true", default=False)
    parser.add_argument("--app_corr_params", nargs="*", type=float,
                        default=[0.18, 0.67, 0.46, 0.63])
    parser.add_argument("--geo_corr_params", nargs="*", type=float,
                        default=[3.0, 0.67, 10.0, 0.63])
    parser.add_argument("--use_masks", action="store_true", default=False)
    parser.add_argument("--rand_neg", action="store_true", default=False)
    parser.add_argument("--seed", type=int, default=0)
    return parser


def build_model(args, device: torch.device):
    """``NeRFNet`` from the flags, initialised from ``--seed``, on ``device``."""
    from nerfsos_torch.models.nerf import NeRFConfig, NeRFNet
    from nerfsos_torch.ops.fused_render import supports_fused

    cfg = NeRFConfig(
        netdepth=args.netdepth, netwidth=args.netwidth,
        netdepth_fine=args.netdepth_fine, netwidth_fine=args.netwidth_fine,
        n_samples=args.N_samples, n_importance=args.N_importance,
        use_viewdirs=args.use_viewdirs, use_embed=args.use_embed,
        multires=args.multires, multires_views=args.multires_views,
        conv_embed=args.conv_embed, perturb=args.perturb,
        raw_noise_std=args.raw_noise_std, white_bkgd=args.white_bkgd,
        use_semantics=args.use_semantics, sem_layer=args.sem_layer, sem_dim=args.sem_dim,
        sem_with_coord=args.sem_with_coord, sem_with_geo=args.sem_with_geo,
        ray_block=args.ray_chunk, compute_dtype=args.compute_dtype,
    )
    cfg = dataclasses.replace(cfg, fused_field=not args.no_fused_field and supports_fused(cfg))
    with torch.random.fork_rng(devices=[]):  # seeded init, global RNG left as it was
        torch.manual_seed(args.seed)
        net = NeRFNet(cfg)
    return net.to(device).eval(), cfg


def main(args) -> None:
    from nerfsos_torch.data.datasets import RayDataset
    from nerfsos_torch.engines import checkpoint as ckpt_lib
    from nerfsos_torch.engines import eval as eval_lib

    for flag in ("mipnerf", "eval_video", "eval_vol"):
        if getattr(args, flag):
            raise SystemExit(f"--{flag}: not yet ported to nerfsos_torch")
    if not args.eval:
        raise SystemExit("training: not yet ported to nerfsos_torch (use --eval)")
    if args.no_semantics:
        args.use_semantics = False
    device = torch.device(f"cuda:{args.gpuid}" if torch.cuda.is_available() else "cpu")
    print(f"> Semantic branch is {args.use_semantics}")
    print(f"> Device: {device}")

    run_dir = os.path.join(args.basedir, args.expname)
    ckpt_dir = os.path.join(run_dir, "checkpoints")
    if not os.path.exists(run_dir):
        print("Error: The specified working directory does not exist!")
        return
    os.makedirs(ckpt_dir, exist_ok=True)

    net, cfg = build_model(args, device)
    print("Num of Params:", sum(p.numel() for p in net.parameters()))
    print(f"> Fused eval kernels: {net.fused}")

    ckpt_path = args.ckpt_path
    if not ckpt_path and not args.no_reload:
        ckpt_path = ckpt_lib.find_latest_checkpoint(ckpt_dir) or ""
    if ckpt_path:
        if not os.path.exists(ckpt_path):
            raise SystemExit(f"[Error:] ckpt path {ckpt_path} not exist!")
        if not (ckpt_path.endswith(".ckpt") and os.path.isfile(ckpt_path)):
            raise SystemExit(f"{ckpt_path}: only reference-format .ckpt files load in "
                             "nerfsos_torch (orbax checkpoints are read by nerfsos_tpu)")
        print("Reloading from checkpoint:", ckpt_path)
        state, _ = ckpt_lib.load_checkpoint(ckpt_path)
        ckpt_lib.load_model_state(net, state, strict=not args.load_nostrict)

    if args.use_dino:
        print("[Warning!] the DINO foreground flip is not ported: cluster labels keep "
              "their k-means orientation")
    print("Loading nerf data:", args.data_path)
    test_set = RayDataset(args.data_path, split="test", subsample=args.subsample,
                          use_masks=args.use_masks, bin_thres=args.bin_thres)
    print("> Start to evaluate")
    eval_lib.evaluate(net, test_set, save_dir=os.path.join(run_dir, "eval"),
                      fast_mode=args.fast_mode, ret_cluster=args.ret_cluster,
                      clus_no_sfm=args.clus_no_sfm, n_cluster=args.N_cluster)


if __name__ == "__main__":
    np.random.seed(0)
    parsed, _ = create_arg_parser().parse_known_args()
    main(parsed)
