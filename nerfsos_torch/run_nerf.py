"""NeRF-SOS on PyTorch — the command-line entry point of the port.

``python -m nerfsos_torch.run_nerf --config configs/<scene>.txt ...`` takes
the flags of the repository's ``run_nerf.py`` (the same names, types and
defaults) and the same run-directory layout. Implemented:

- train (no mode flag): the RGB pretrain on the ``train`` split's ray pool,
  ``--N_rand`` rays a step, Adam with the exponential LR decay; logs at
  ``--i_print`` (``tensorboard/scalars.jsonl``), checkpoints at
  ``--i_weights`` (``checkpoints/{step:08d}.ckpt`` and ``latest.ckpt``, with
  the optimizer state), a test-set eval at ``--i_testset``, and at the end
  ``last.ckpt`` and a final eval into ``eval/``. It resumes from the newest
  checkpoint of the run (``--no_reload`` starts afresh);
- ``--eval``: render the test split, write metrics and images to
  ``<basedir>/<expname>/eval``. Every eval (``--eval``, the test-set
  evals, the final one) of a run with ``--use_dino`` orients the cluster
  labels of ``clus_*.png`` by the extractor's attention (the DINO
  foreground flip, ``engines/eval.find_fg_flip``);
- ``--patch_tune`` with the SOS losses (``--use_dino`` and
  ``--use_correlation``/``--use_geoCorr``): the NeRF-SOS finetune on
  ``PatchDataset`` batches (``engines/sos.py``), of the semantic head alone
  with ``--fix_backbone`` and of the whole network without it, with random
  negatives under ``--rand_neg``; DINO ViT-S/16 from ``--dino_ckpt``
  (seeded weights and a warning when the file is missing) or the
  photometric stand-in (``--dino_synthetic``), the train-time ARI at
  ``--i_print``, checkpoints, test-set evals and a final eval as above.
  The losses read the coarse pass's outputs, so a net with no fine pass
  (``--N_importance 0``) stops up front (the JAX package fails on the
  missing ``rgb0``);
- ``--patch_tune`` without the SOS losses: the RGB train step on
  ``PatchDataset`` batches (of the semantic head alone with
  ``--fix_backbone``, as the JAX entry point's masked optimizer).

- ``--mipnerf`` (train and ``--eval``): mip-NeRF, one field shared by the
  coarse and fine passes, no semantic head, the test split's base
  ``radii`` threaded into the train step and the evals; its fused passes
  are K9 (renders) and K10a with K10b as its backward (training). With the
  SOS losses it stops: they need the semantic head;
- ``--eval_vol``: the density export (``engines/eval.export_density``) of
  the restored net on the x14 grid of ``--vol_extents`` (one value or
  three) and ``--vol_size``, into ``<basedir>/<expname>/eval/density.mrc``
  and ``density.ply``; the field kernel (K11 with ``--mipnerf``) queries it.

- ``--no_batching``: the RGB train step on one image a step
  (``ViewDataset``), the centre crop of ``--precrop_frac`` of each side
  while the step, counted from 1 as the JAX loop counts it, is below
  ``--precrop_iters`` (all 8 Blender configs);
- ``--i_img``: the test view ``--log_img_idx`` rendered and scored, its rgb
  and disparity written to TensorBoard (``utils/summary.add_image``; not
  written without the ``tensorboard`` package); ``--i_video``: the exhibit
  path's videos (``rays_exhibit.npy``, ``engines/eval.render_video``) into
  the run directory, suffixed with the step; ``--eval_video``: the
  restored net's videos into the run directory, suffixed with
  ``--expname``, and no training (without an exhibit set it trains, as the
  JAX entry point does); with ``--eval``, the same after the eval (the JAX
  entry point returns from ``--eval`` before its ``--eval_video``). The
  videos are mp4s through cv2 or imageio (``utils/io.write_video``), which
  raises when neither is importable; a run that would write images or
  videos that this machine cannot write says so in one line at its start
  (``unwritten_outputs_note``).

A data directory without ``meta.json`` is prepared from the raw scene
first (``data/gen_dataset``, the ``--data_type`` flags), as the JAX entry
point does. Each RGB step draws its batch and its noise from ``(--seed,
step)`` alone, so a resumed run trains as an uninterrupted one
would (the JAX entry point restarts its batch stream); a patch step draws
from ``(--seed, step)`` too, and its images from the dataset's per-epoch
shuffle, which a resume starts afresh.

``main(args, device=None)`` runs on ``cuda:{--gpuid}`` and raises when no
card is visible; the CPU only when the caller passes ``device="cpu"`` (the
tests). The fused kernels (``ops/fused_render.py``: K3 for the RGB step,
K4 with K5 or K6 for the SOS step, K1/K2 for the eval render, K9/K10a/K10b
under ``--mipnerf``; ``ops/fused_field.py``: the field kernels for a net
with no fine pass (``--N_importance 0``), for noisy density-only coarse
passes and for ``--eval_vol``; ``ops/flash_corr.py``: K7 for the geometry
loss) run unless
``--no_fused_field`` is given or the
configuration is outside ``supports_fused``; on the CPU the same code path
runs their plain versions.

``--compute_dtype bfloat16`` runs the MLPs and the DINO ViT at bf16, as the
JAX entry point does. Every mode runs on the kernels' bf16 modes: the RGB
pretrain (K3; also ``--patch_tune`` without the SOS losses), ``--eval``
(K1, K2), the ``--patch_tune --fix_backbone`` SOS finetune (K4, K5), the
full ``--patch_tune`` finetune (K4, K6), every mode of ``--mipnerf``
(train: K10a with K10b; ``--eval``: K9; ``--eval_vol``: K11), a net with
no fine pass (``--N_importance 0``: K8d with K8f), the classic
``--eval_vol`` (K8b) and a noisy density-only view (K8e, K8d), their
test-set views and resumes included. With ``--no_fused_field`` every mode
runs at bf16 on the eager field.

``--debug_nans`` runs the whole of ``main`` under
``torch.autograd.set_detect_anomaly`` and checks each step's loss and
gradients with ``utils/debug.assert_finite`` (``FloatingPointError`` on a
nan or inf): the fused RGB step forms its gradients in a kernel, outside
autograd, where anomaly mode sees nothing.
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import time

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
                        help="MLP and DINO activation dtype (bfloat16: the RGB pretrain, "
                             "--eval, both SOS finetunes and every --mipnerf mode on the "
                             "kernels; every mode with --no_fused_field)")
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
                        help="local path to DINO ViT-S/16 torch weights")
    parser.add_argument("--dino_synthetic", action="store_true", default=False,
                        help="photometric stand-in for DINO (no weights needed)")
    parser.add_argument("--lpips_path", type=str, default="",
                        help="LPIPS linear-head weights (not ported yet: lpips is null)")
    parser.add_argument("--lpips_backbone_path", type=str, default="",
                        help="LPIPS backbone weights (not ported yet)")
    parser.add_argument("--lpips_net", type=str, default="alex",
                        choices=["alex", "vgg"])
    parser.add_argument("--debug_nans", action="store_true", default=False,
                        help="torch anomaly detection, and each step's loss and "
                             "gradients checked for nan/inf")
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


def model_config(args):
    """The model's ``NeRFConfig`` from the flags (``fused_field`` where
    ``--no_fused_field`` is not given and ``supports_fused`` holds)."""
    from nerfsos_torch.models.nerf import NeRFConfig
    from nerfsos_torch.ops.fused_render import supports_fused

    cfg = NeRFConfig(
        netdepth=args.netdepth, netwidth=args.netwidth,
        netdepth_fine=args.netdepth_fine, netwidth_fine=args.netwidth_fine,
        n_samples=args.N_samples, n_importance=args.N_importance,
        use_viewdirs=args.use_viewdirs, use_embed=args.use_embed,
        multires=args.multires, multires_views=args.multires_views,
        conv_embed=args.conv_embed, perturb=args.perturb,
        raw_noise_std=args.raw_noise_std, white_bkgd=args.white_bkgd,
        use_semantics=args.use_semantics and not args.mipnerf,
        sem_layer=args.sem_layer, sem_dim=args.sem_dim,
        sem_with_coord=args.sem_with_coord, sem_with_geo=args.sem_with_geo,
        ray_block=args.ray_chunk, compute_dtype=args.compute_dtype,
        frozen_backbone=args.fix_backbone,
    )
    return dataclasses.replace(cfg, fused_field=not args.no_fused_field and supports_fused(cfg))


def build_model(args, device: torch.device):
    """``NeRFNet`` (``MipNeRFNet`` under ``--mipnerf``, without the semantic
    head) from the flags, on ``device``; its MLPs start from the JAX entry
    point's initial weights at ``--seed`` (``models/seeded``)."""
    from nerfsos_torch.models import seeded
    from nerfsos_torch.models.mip import MipNeRFNet
    from nerfsos_torch.models.nerf import NeRFNet

    cfg = model_config(args)
    with torch.random.fork_rng(devices=[]):  # seeded init, global RNG left as it was
        torch.manual_seed(args.seed)
        net = MipNeRFNet(cfg) if args.mipnerf else NeRFNet(cfg)
    seeded.jax_seeded_init_(net, args.seed)
    return net.to(device).eval(), cfg


def write_args_file(args, path: str) -> None:
    """The resolved flags, one ``key = value`` line each (``args.txt``)."""
    with open(path, "w") as f:
        for k in sorted(vars(args)):
            f.write(f"{k} = {getattr(args, k)}\n")


def _resolve_device(args, device) -> torch.device:
    device = torch.device(f"cuda:{args.gpuid}" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; the port runs on the card "
                           "(pass device='cpu' to main to run on the CPU)")
    return device


def build_dino(args, device: torch.device):
    """The frozen DINO extractor (JAX ``run_nerf.build_dino``): ViT-S/16 with
    the ``--dino_ckpt`` weights, seeded weights and a warning when the file
    is missing, or the photometric stand-in with ``--dino_synthetic``; at
    ``--compute_dtype``, as the JAX entry point runs it."""
    from nerfsos_torch.models.extractor import SyntheticExtractor, VitExtractor
    from nerfsos_torch.models.nerf import compute_dtype_of

    dtype = compute_dtype_of(args.compute_dtype)
    if args.dino_synthetic:
        print("> Photometric oracle extractor (--dino_synthetic): informative "
              "features without pretrained weights — quality gates only.")
        return SyntheticExtractor(dtype=dtype).to(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(42)
        dino = VitExtractor("dino_vits16", dtype=dtype)
    if args.dino_ckpt and os.path.exists(args.dino_ckpt):
        dino.load_torch_checkpoint(args.dino_ckpt)
        print(f"> Loaded DINO weights from {args.dino_ckpt}")
    else:
        print("[Warning!] No --dino_ckpt provided; DINO is randomly initialized "
              "(correlation-loss features will be meaningless; fine for smoke runs).")
    return dino.to(device)


def _check_patch_tune(args) -> None:
    """The SOS losses need DINO (JAX ``run_nerf.py:327-329``)."""
    if not args.use_dino and (args.use_correlation or args.use_geoCorr):
        raise SystemExit("--use_correlation/--use_geoCorr require --use_dino "
                         "(the reference crashes here implicitly; we validate up front)")


def unwritten_outputs_note(args, start: int) -> str:
    """The line a run from step ``start`` prints when it would write test
    images (a multiple of ``--i_img`` within ``--max_steps``) and the
    ``tensorboard`` package that takes them is missing, or videos (the data
    directory's ``rays_exhibit.npy`` with a multiple of ``--i_video`` within
    ``--max_steps`` or ``--eval_video``) and neither cv2 nor imageio is
    there to encode them; '' when it would write neither or can write
    both."""
    from nerfsos_torch.utils.io import video_writer
    from nerfsos_torch.utils.summary import tensorboard_available

    def due(every: int) -> bool:
        return every > 0 and (start // every + 1) * every <= args.max_steps

    exhibit = os.path.exists(os.path.join(args.data_path, "rays_exhibit.npy"))
    missing = []
    train = not args.eval
    if train and due(args.i_img) and not tensorboard_available():
        missing.append("test images (--i_img): no tensorboard package, they are not written")
    if (exhibit and (args.eval_video or train and due(args.i_video))
            and video_writer() == "none"):
        missing.append("videos (--i_video, --eval_video): neither cv2 nor imageio, the run "
                       "stops with an error at its first video")
    return "[Warning!] " + "; ".join(missing) if missing else ""


def main(args, device=None) -> None:
    if not args.debug_nans:
        return _main(args, device)
    print("> torch anomaly detection and finite checks of the loss and gradients enabled")
    with torch.autograd.set_detect_anomaly(True):
        return _main(args, device)


def _main(args, device) -> None:
    from nerfsos_torch.data.datasets import (ExhibitDataset, PatchDataset, RayDataset,
                                             ViewDataset)
    from nerfsos_torch.engines import checkpoint as ckpt_lib
    from nerfsos_torch.engines import eval as eval_lib
    from nerfsos_torch.engines import state as state_lib
    from nerfsos_torch.engines.trainer import make_rgb_train_step
    from nerfsos_torch.utils import debug
    from nerfsos_torch.utils.image import to8b
    from nerfsos_torch.utils.summary import SummaryWriter

    patch_mode = args.patch_tune and not args.eval
    if patch_mode:
        _check_patch_tune(args)
    sos_mode = patch_mode and args.use_dino and (args.use_correlation or args.use_geoCorr)
    if sos_mode and args.mipnerf:
        raise SystemExit("--mipnerf has no semantic head: the SOS losses need one")
    if sos_mode and args.N_importance <= 0:
        raise SystemExit("the SOS losses read the coarse pass's outputs (rgb0, semantics0): "
                         "they need a fine pass, --N_importance > 0")
    if args.no_semantics:
        args.use_semantics = False
    device = _resolve_device(args, device)
    print(f"> Semantic branch is {args.use_semantics}")
    print(f"> Device: {device}")

    run_dir = os.path.join(args.basedir, args.expname)
    ckpt_dir = os.path.join(run_dir, "checkpoints")
    log_dir = os.path.join(run_dir, "tensorboard")
    if not os.path.exists(run_dir) and args.eval:
        print("Error: The specified working directory does not exist!")
        return
    for d in (run_dir, ckpt_dir, log_dir):
        os.makedirs(d, exist_ok=True)
    if not args.eval:
        write_args_file(args, os.path.join(run_dir, "args.txt"))
        if args.config and os.path.exists(args.config):
            shutil.copy(args.config, os.path.join(run_dir, "config.txt"))

    net, cfg = build_model(args, device)
    schedule = state_lib.exp_decay_schedule(args.lrate, args.decay_rate, args.decay_step * 1000)
    # no optimizer for --eval or --eval_vol: the first one built imports torch._dynamo (seconds)
    optimizer = None if args.eval or args.eval_vol else state_lib.make_optimizer(
        net, args.lrate, fix_backbone=args.fix_backbone)
    print("Num of Params:", sum(p.numel() for p in net.parameters()))
    print(f"> Fused kernels: {net.fused}")
    dino = build_dino(args, device) if args.use_dino else None

    global_step = 0
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
        state, global_step, opt_state = ckpt_lib.load_checkpoint(ckpt_path)
        full = ckpt_lib.load_model_state(net, state, strict=not args.load_nostrict)
        # resume (run_nerf.py:358-427 of the JAX entry point): the Adam state
        # comes back when every parameter did; otherwise fresh moments and
        # the LR of global_step
        if optimizer is not None:
            if opt_state is not None and not full:
                print("[resume] partial param load: skipping optimizer state")
                opt_state = None
            if opt_state is not None:
                try:
                    optimizer.load_state_dict(opt_state)
                except ValueError:
                    print("[Error]: optimizer initialization failed!")
                    opt_state = None
            if opt_state is None:
                state_lib.fast_forward_lr(optimizer, schedule, global_step)

    note = "" if args.eval_vol else unwritten_outputs_note(args, global_step)
    if note:
        print(note)
    print("Loading nerf data:", args.data_path)
    test_set = RayDataset(args.data_path, split="test", args=args, subsample=args.subsample,
                          use_masks=args.use_masks, bin_thres=args.bin_thres)
    try:
        exhibit_set = ExhibitDataset(args.data_path, args=args, subsample=args.subsample)
    except FileNotFoundError:
        exhibit_set = None
        print("Warning: No exhibit set!")
    # mip-NeRF's base radius, from the test split as the JAX entry point takes it
    net_kwargs = {"radii": test_set.radii()} if args.mipnerf else {}

    def do_evaluate(save_dir):
        return eval_lib.evaluate(net, test_set, save_dir=save_dir, fast_mode=args.fast_mode,
                                 ret_cluster=args.ret_cluster, clus_no_sfm=args.clus_no_sfm,
                                 n_cluster=args.N_cluster, dino=dino, **net_kwargs)

    def do_video(save_dir, suffix):
        return eval_lib.render_video(net, exhibit_set, save_dir=save_dir, suffix=suffix,
                                     ret_cluster=args.ret_cluster, clus_no_sfm=args.clus_no_sfm,
                                     n_cluster=args.N_cluster, dino=dino, **net_kwargs)

    if args.eval:
        print("> Start to evaluate")
        do_evaluate(os.path.join(run_dir, "eval"))
        if args.eval_video and exhibit_set is not None:
            do_video(run_dir, args.expname)
        return

    if args.eval_video and exhibit_set is not None:
        do_video(run_dir, args.expname)
        return

    if args.eval_vol:
        print("> Start to export density")
        extents = args.vol_extents
        if len(extents) == 1:
            extents = extents * 3
        if len(extents) != 3:
            print("Unsupported length of extents:", extents)
            return
        eval_lib.export_density(net, extents=tuple(extents), voxel_size=args.vol_size,
                                save_dir=os.path.join(run_dir, "eval"))
        return

    near, far = test_set.near_far()
    if args.no_batching:
        train_set = ViewDataset(args.data_path, split="train", args=args,
                                subsample=args.subsample, precrop_iters=args.precrop_iters,
                                precrop_frac=args.precrop_frac)
    elif patch_mode:
        train_set = PatchDataset(args.data_path, split="train", args=args,
                                 subsample=args.subsample, patch_size=args.patch_size,
                                 patch_stride=args.patch_stride, bin_thres=args.bin_thres,
                                 ret_k=args.use_geoCorr)
    else:
        train_set = RayDataset(args.data_path, split="train", args=args,
                               subsample=args.subsample, bin_thres=args.bin_thres)
    if sos_mode:
        from nerfsos_torch.engines.sos import SOSConfig, make_sos_train_step, online_seg_metrics
        from nerfsos_torch.losses.correlation import CorrelationLoss, GeoCorrelationLoss

        sos_cfg = SOSConfig(
            batch_size=args.batch_size, patch_size=args.patch_size,
            patch_stride=args.patch_stride, rgb_w=args.rgb_w,
            correlation_w=args.correlation_w, Gcorrelation_w=args.Gcorrelation_w,
            contrast_w=args.contrast_w, use_dino=args.use_dino,
            use_correlation=args.use_correlation, use_geoCorr=args.use_geoCorr,
            use_contrast=args.use_contrast, fix_backbone=args.fix_backbone)
        app_loss = CorrelationLoss.from_params(
            args.app_corr_params, use_sim_matrix=args.use_sim_matrix, rand_neg=args.rand_neg)
        geo_loss = GeoCorrelationLoss.from_params(
            args.geo_corr_params, use_sim_matrix=args.use_sim_matrix, rand_neg=args.rand_neg)
        step_fn = make_sos_train_step(net, dino, app_loss, geo_loss, sos_cfg, optimizer,
                                      schedule, near, far, seed=args.seed)
    else:
        step_fn = make_rgb_train_step(net, optimizer, schedule, near, far, rgb_w=args.rgb_w,
                                      seed=args.seed, net_kwargs=net_kwargs)
    writer = SummaryWriter(log_dir)

    def save(name):
        ckpt_lib.save_checkpoint(os.path.join(ckpt_dir, name), global_step, net, optimizer)

    print(f"> Start Iteration from {global_step}")
    time0 = time.time()
    while global_step < args.max_steps:
        rng = np.random.default_rng([args.seed, global_step])
        if args.no_batching and not patch_mode:  # the JAX loop's step, counted from 1
            batch = train_set.sample_batch(rng, args.batch_size, step=global_step + 1)
        else:
            batch = train_set.sample_batch(rng, args.batch_size)
        device_batch = {k: torch.as_tensor(batch[k], device=device) for k in ("rays", "target")}
        metrics = step_fn(device_batch, global_step)
        if args.debug_nans:
            debug.assert_finite(metrics["loss"], f"step {global_step}: loss")
            debug.assert_finite({n: p.grad for n, p in net.named_parameters()},
                                f"step {global_step}: grad")
        global_step += 1

        if global_step % args.i_print == 0 or global_step == 1:
            m = {k: float(v) for k, v in metrics.items()}
            avg_time = (time.time() - time0) / args.i_print
            rays_per_step = device_batch["target"].shape[0]
            print(f"[Logging info]: expname: {args.expname}")
            if sos_mode:
                # the semantics again, noise-free, for the online ARI (JAX
                # run_nerf.py:571-578; reference trainer :174-198)
                with torch.no_grad():
                    out = net(device_batch["rays"], (near, far), train=False)
                seg = online_seg_metrics(out["semantics"], batch["masks"], args.batch_size,
                                         args.patch_size, n_cluster=args.N_cluster,
                                         clus_no_sfm=args.clus_no_sfm)
                print(f"[TRAIN] Iter: {global_step}/{args.max_steps} "
                      f"Loss: {m['loss']:.4f} L_sem0:{m['sem0']:.4f} "
                      f"L_sem1:{m['sem1']:.4f} L_img0:{m['img0']:.4f} "
                      f"L_img1:{m['img1']:.4f} L_contrast:{m['contrast']:.4f}")
                print(f"L_corr0:{m['corr0']:.4f} L_corr1:{m['corr1']:.4f} "
                      f"L_geo_corr0:{m['geo_corr0']:.4f} L_geo_corr1:{m['geo_corr1']:.4f} "
                      f"PSNR: {m['psnr']:.4f} Average Time: {avg_time:.4f} "
                      f"({rays_per_step / max(avg_time, 1e-9):.0f} rays/s)")
                print(f"clus_ari: {seg['clus_ari']:.4f} clus_ari_fg: {seg['clus_ari_fg']:.4f} "
                      f"sem_ari: {seg['sem_ari']:.4f} sem_ari_fg: {seg['sem_ari_fg']:.4f}")
            else:
                print(f"[TRAIN] Iter: {global_step}/{args.max_steps} Loss: {m['loss']:.4f} "
                      f"L_img0:{m.get('img0', 0):.4f} L_img1:{m['img1']:.4f} "
                      f"PSNR: {m['psnr']:.4f} Average Time: {avg_time:.4f} "
                      f"({rays_per_step / max(avg_time, 1e-9):.0f} rays/s)")
            time0 = time.time()
            writer.add_scalar("train/loss", m["loss"], global_step)
            writer.add_scalar("train/psnr", m["psnr"], global_step)
            writer.add_scalar("l_rate/group_0", schedule(global_step), global_step)

        if global_step % args.i_img == 0:
            view = test_set.get_view(args.log_img_idx)
            render_fn = eval_lib.make_render_fn(net, near, far, **net_kwargs)
            ret, _ = eval_lib.eval_one_view(render_fn, view, clus_no_sfm=args.clus_no_sfm,
                                            n_cluster=args.N_cluster)
            writer.add_image("test/rgb", to8b(ret["rgb"]), global_step)
            writer.add_image("test/disp", to8b(ret["disp"] / np.max(ret["disp"])), global_step)

        if global_step % args.i_weights == 0:
            print("Checkpointing at", os.path.join(ckpt_dir, f"{global_step:08d}.ckpt"))
            save(f"{global_step:08d}.ckpt")
            save("latest.ckpt")

        if global_step % args.i_testset == 0:
            print("Evaluating test images ...")
            md = do_evaluate(os.path.join(run_dir, f"testset_{global_step:08d}"))
            writer.add_scalar("test/mse", md["mse"], global_step)
            writer.add_scalar("test/psnr", md["psnr"], global_step)

        if global_step % args.i_video == 0 and exhibit_set is not None:
            do_video(run_dir, str(global_step))

    save("last.ckpt")
    writer.close()
    do_evaluate(os.path.join(run_dir, "eval"))


if __name__ == "__main__":
    np.random.seed(0)
    parsed, _ = create_arg_parser().parse_known_args()
    main(parsed)
