"""Evaluation engine: per-view eval, the test-set sweep, the exhibit videos
and the density export.

Port of ``nerfsos_tpu/engines/eval.py`` (``make_render_fn``,
``eval_one_view``, ``find_fg_flip``, ``evaluate``, ``render_video``,
``export_density``): the same metrics, the same files
(``rgb_/depth_/depth_*_/alpha_/sem_/clus_*.png``, ``log.json``, ``log.txt``;
``rgb/disp/sem/clus{_suffix}.mp4``), the same ``log.json`` keys, and the
cluster labels of ``clus_*.png`` and ``clus*.mp4`` oriented by the DINO
attention when an extractor is given. Differences: LPIPS is reported as NaN
(null in ``log.json``), as the JAX engine does when no weights are given;
``depth_*_.png`` has no colorbar strip.
"""
from __future__ import annotations

import contextlib
import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from nerfsos_torch.losses.photometric import img2mse, mse2psnr
from nerfsos_torch.models.extractor import resize_nearest_torch
from nerfsos_torch.models.mip import MipNeRFNet
from nerfsos_torch.models.nerf import NeRFNet
from nerfsos_torch.ops.kmeans import segmap_cluster
from nerfsos_torch.ops.ssim import ssim as ssim_fn
from nerfsos_torch.utils import io as io_utils
from nerfsos_torch.utils.image import colorize, to8b, write_png
from nerfsos_torch.utils.metrics import adjusted_rand_score

METRIC_KEYS = ["mse", "psnr", "ssim", "lpips", "clus_ari", "clus_ari_fg", "sem_ari", "sem_ari_fg"]


def _json_nan_to_null(obj):
    """NaN/inf -> None so log.json stays valid JSON with honest nulls."""
    if isinstance(obj, dict):
        return {k: _json_nan_to_null(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_json_nan_to_null(v) for v in obj]
    if isinstance(obj, float) and not np.isfinite(obj):
        return None
    return obj


def _np_softmax(x: np.ndarray) -> np.ndarray:
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


@contextlib.contextmanager
def fp32_exact():
    """Full-fp32 device math for the metrics. Matrix products must already be
    fp32 (``torch.backends.cuda.matmul.allow_tf32`` is off by default); cuDNN's
    TF32, on by default, would put SSIM's convolutions at ~3 digits, so it is
    switched off here and restored afterwards."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("torch.backends.cuda.matmul.allow_tf32 is on: eval needs fp32 products")
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def make_render_fn(net: nn.Module, near: float, far: float, **net_kwargs):
    """Full-image render: ``rays [2, H, W, 3]`` (numpy or tensor) -> dict of
    tensors on the net's device; ``net_kwargs`` threads model statics
    (mip-NeRF's ``radii``). A ``NeRFNet``'s coarse pass runs density-only
    (``coarse_outputs=False``); a ``MipNeRFNet`` renders both passes in
    full, as the JAX package's does. The rays are chunked by
    ``cfg.ray_block``."""
    if isinstance(net, NeRFNet):
        net_kwargs.setdefault("coarse_outputs", False)
    device = next(net.parameters()).device

    @torch.no_grad()
    def render(rays) -> Dict[str, torch.Tensor]:
        rays = torch.as_tensor(np.array(rays, dtype=np.float32), device=device)
        return net(rays, (near, far), train=False, **net_kwargs)

    return render


def eval_one_view(render_fn, batch: Dict[str, np.ndarray], *, clus_no_sfm: bool = False,
                  n_cluster: int = 2, kmeans_first: Optional[int] = None
                  ) -> Tuple[Dict[str, np.ndarray], Dict[str, float]]:
    """Render one view and score it. ``kmeans_first``: the k-means start index
    (see ``ops/kmeans.segmap_cluster``)."""
    out = render_fn(batch["rays"])
    device = out["rgb"].device
    ret = {k: v.cpu().numpy() for k, v in out.items()}

    clus_ari = clus_ari_fg = sem_ari = sem_ari_fg = 0.0
    if "semantics" in ret:
        sem_gt = np.asarray(batch.get("masks", np.zeros_like(ret["disp"]))).astype(np.int32)
        if clus_no_sfm:
            sem_prob = ret["semantics"]
            sem_pred_sft = np.argmax(_np_softmax(sem_prob), -1)[..., None]
        else:
            sem_prob = _np_softmax(ret["semantics"])
            sem_pred_sft = np.argmax(sem_prob, -1)[..., None]
        with fp32_exact():
            sem_pred_clus = segmap_cluster(torch.from_numpy(sem_prob).to(device), n_cluster,
                                           first=kmeans_first).cpu().numpy().astype(np.int32)
        sem_pred_sft = sem_pred_sft.astype(np.int32)
        ret["sem"] = sem_pred_sft
        ret["clustering"] = sem_pred_clus
        fg = sem_gt == 1
        clus_ari = adjusted_rand_score(sem_gt, sem_pred_clus)
        clus_ari_fg = adjusted_rand_score(sem_gt[fg], sem_pred_clus[fg])
        sem_ari = adjusted_rand_score(sem_gt, sem_pred_sft)
        sem_ari_fg = adjusted_rand_score(sem_gt[fg], sem_pred_sft[fg])

    metrics: Dict[str, float] = {}
    if "target" in batch:
        target = np.asarray(batch["target"])
        ret["target_s"] = target
        target_t = torch.tensor(target, dtype=torch.float32, device=device)
        mse = float(img2mse(out["rgb"], target_t))
        metrics["mse"] = mse
        metrics["psnr"] = float(mse2psnr(torch.tensor(mse, dtype=torch.float32)))
        with fp32_exact():
            metrics["ssim"] = float(ssim_fn(out["rgb"], target_t, data_format="HWC"))
        metrics["lpips"] = float("nan")  # LPIPS is not ported: null in log.json
        metrics.update(clus_ari=clus_ari, clus_ari_fg=clus_ari_fg,
                       sem_ari=sem_ari, sem_ari_fg=sem_ari_fg)
    return ret, metrics


@torch.no_grad()
def find_fg_flip(dino, rgb: np.ndarray, clustering: np.ndarray) -> np.ndarray:
    """Cluster labels ``[H, W, 1]`` oriented so that label 1 is the
    foreground the extractor ``dino`` attends to (JAX ``find_fg_flip``;
    reference ``engines/eval.py:133-144``): the image ``rgb [H, W, 3]``
    cropped to a multiple of the patch size, the no-resize CLS attention
    nearest-upsampled to ``H x W``, the labels flipped when cluster 0 holds
    more attention a pixel than cluster 1. An image smaller than a patch
    has no attention to go by: its labels are kept (the JAX function
    raises on it)."""
    H, W = rgb.shape[:2]
    ps = dino.patch_size
    Hc, Wc = (H // ps) * ps, (W // ps) * ps
    if Hc == 0 or Wc == 0:
        return clustering
    x = torch.from_numpy(np.ascontiguousarray(rgb[None, :Hc, :Wc, :], dtype=np.float32))
    attn = dino.get_vit_attn_feat(x.to(dino.device), resize=False)["attn"]
    attn = attn.to(torch.float32).reshape(1, Hc // ps, Wc // ps, 1)
    attn = resize_nearest_torch(attn, H, W)[0, :, :, 0].cpu().numpy()
    if np.mean(attn[clustering[..., 0] == 1]) < np.mean(attn[clustering[..., 0] == 0]):
        return np.ones_like(clustering) - clustering
    return clustering


def evaluate(net: nn.Module, dataset, save_dir: Optional[str] = None, fast_mode: bool = False,
             ret_cluster: bool = False, clus_no_sfm: bool = False, n_cluster: int = 2,
             kmeans_first: Optional[int] = None, dino=None,
             **net_kwargs) -> Dict[str, float]:
    """Test-set sweep: metrics per view, PNGs and ``log.json``/``log.txt``.
    Without a semantic head (mip-NeRF) the ARI metrics are 0 and no
    ``sem_``/``clus_`` images are written. With an extractor ``dino`` the
    cluster labels written to ``clus_*.png`` are oriented by
    :func:`find_fg_flip` (JAX's ``find_fg``), after the metrics (an ARI does
    not see the flip)."""
    near, far = dataset.near_far()
    render_fn = make_render_fn(net, near, far, **net_kwargs)

    all_metrics: Dict[str, list] = {k: [] for k in METRIC_KEYS}
    n_views = len(dataset)
    for i in range(n_views):
        if fast_mode and i >= 1:
            continue
        batch = dataset.get_view(i)
        ret, metrics = eval_one_view(render_fn, batch, clus_no_sfm=clus_no_sfm,
                                     n_cluster=n_cluster, kmeans_first=kmeans_first)
        for k in METRIC_KEYS:
            all_metrics[k].append(metrics.get(k, 0.0))
        clustering = ret.get("clustering")
        if clustering is not None and dino is not None:
            clustering = find_fg_flip(dino, ret["rgb"], clustering)
        print(f"[TEST] Iter {i+1}/{n_views} " +
              " ".join(f"{k}: {metrics.get(k, 0.0):.4f}" for k in METRIC_KEYS))

        if save_dir is not None:
            img, alpha, depth = ret["rgb"], ret["acc"], ret["depth"]
            os.makedirs(save_dir, exist_ok=True)
            write_png(os.path.join(save_dir, f"rgb_{i:03d}.png"), to8b(img))
            write_png(os.path.join(save_dir, f"depth_{i:03d}.png"), to8b(depth / np.max(depth)))
            dviz = colorize(depth[..., 0])
            write_png(os.path.join(save_dir, f"depth_{i:03d}_.png"), to8b(dviz / np.max(dviz)))
            write_png(os.path.join(save_dir, f"alpha_{i:03d}.png"), to8b(alpha / np.max(alpha)))
            if "sem" in ret:
                write_png(os.path.join(save_dir, f"sem_{i:03d}.png"),
                          (ret["sem"][..., 0] * 255).astype(np.uint8))
            if ret_cluster and clustering is not None:
                write_png(os.path.join(save_dir, f"clus_{i:03d}.png"),
                          (clustering[..., 0] * 255).astype(np.uint8))

    def mean(k):
        return float(np.mean(all_metrics[k])) if all_metrics[k] else 0.0

    total_mse = mean("mse")
    finite_lpips = [v for v in all_metrics["lpips"] if np.isfinite(v)]
    totals = {
        "total_mse": total_mse,
        "total_psnr": (float(mse2psnr(torch.tensor(total_mse, dtype=torch.float32)))
                       if total_mse > 0 else 0.0),
        "total_ssim": mean("ssim"),
        "total_lpips": float(np.mean(finite_lpips)) if finite_lpips else float("nan"),
        **{f"total_{k}": mean(k) for k in ["clus_ari", "clus_ari_fg", "sem_ari", "sem_ari_fg"]},
    }
    print("[TEST] " + " ".join(f"{k}: {v:.4f}" for k, v in totals.items()))

    if save_dir is not None:
        dump = _json_nan_to_null({**all_metrics, **totals})
        with open(os.path.join(save_dir, "log.json"), "w") as f:
            json.dump(dump, f)
        with open(os.path.join(save_dir, "log.txt"), "w") as f:
            for i in range(len(all_metrics["mse"])):
                print(f"[TEST] Iter {i+1}/{n_views} MSE: {all_metrics['mse'][i]} "
                      f"PSNR: {all_metrics['psnr'][i]} SSIM: {all_metrics['ssim'][i]} "
                      f"LPIPS: {all_metrics['lpips'][i]}", file=f)
            print(f"[TEST] MSE: {totals['total_mse']} PSNR: {totals['total_psnr']} "
                  f"SSIM: {totals['total_ssim']} LPIPS: {totals['total_lpips']}", file=f)

    return {"mse": totals["total_mse"], "psnr": totals["total_psnr"],
            "ssim": totals["total_ssim"], "lpips": totals["total_lpips"],
            **{k: totals[f"total_{k}"] for k in ["clus_ari", "clus_ari_fg", "sem_ari", "sem_ari_fg"]}}


def render_video(net: nn.Module, dataset, save_dir: str, suffix: str = "", fps: int = 30,
                 quality: int = 8, ret_cluster: bool = True, clus_no_sfm: bool = False,
                 n_cluster: int = 2, dino=None, kmeans_first: Optional[int] = None,
                 **net_kwargs) -> Dict[str, np.ndarray]:
    """The exhibit path's videos (JAX ``render_video``; reference
    ``engines/eval.py:215-274``): every view of ``dataset``
    (``ExhibitDataset``) through :func:`eval_one_view`, then
    ``rgb{_suffix}.mp4``, ``disp{_suffix}.mp4`` and, with a semantic head,
    ``sem{_suffix}.mp4`` and (``ret_cluster``) ``clus{_suffix}.mp4`` under
    ``save_dir``, the cluster labels oriented by :func:`find_fg_flip` when
    an extractor ``dino`` is given (``kmeans_first`` as in
    :func:`evaluate`). Returns the frames' arrays (``rgb``, ``disp``, and
    ``sem``/``clus`` where written)."""
    near, far = dataset.near_far()
    render_fn = make_render_fn(net, near, far, **net_kwargs)
    rgbs, disps, sems, clusters = [], [], [], []
    for i in range(len(dataset)):
        ret, _ = eval_one_view(render_fn, dataset.get_view(i), clus_no_sfm=clus_no_sfm,
                               n_cluster=n_cluster, kmeans_first=kmeans_first)
        if "sem" in ret:
            sems.append(ret["sem"])
        if ret_cluster and "clustering" in ret:
            clustering = ret["clustering"]
            if dino is not None:
                clustering = find_fg_flip(dino, ret["rgb"], clustering)
            clusters.append(clustering)
        rgbs.append(ret["rgb"])
        disps.append(ret["disp"])

    sfx = f"_{suffix}" if suffix else ""
    os.makedirs(save_dir, exist_ok=True)
    frames = {"rgb": np.stack(rgbs, 0), "disp": np.stack(disps, 0)}
    io_utils.write_video(os.path.join(save_dir, f"rgb{sfx}.mp4"), to8b(frames["rgb"]),
                         fps=fps, quality=quality)
    io_utils.write_video(os.path.join(save_dir, f"disp{sfx}.mp4"),
                         to8b(frames["disp"] / np.max(frames["disp"])), fps=fps, quality=quality)
    if sems:
        frames["sem"] = np.stack(sems, 0)
        io_utils.write_video(os.path.join(save_dir, f"sem{sfx}.mp4"), to8b(frames["sem"]),
                             fps=fps, quality=quality)
    if clusters:
        frames["clus"] = np.stack(clusters, 0)
        io_utils.write_video(os.path.join(save_dir, f"clus{sfx}.mp4"),
                             (frames["clus"] * 255).astype(np.uint8), fps=fps, quality=quality)
    return frames


@torch.no_grad()
def export_density(net: nn.Module, extents: Tuple[float, float, float] = (2.0, 2.0, 2.0),
                   voxel_size: float = 2.0 / 256.0, save_dir: str = "", scale: float = 14.0,
                   chunk: int = 1 << 18) -> np.ndarray:
    """Dense sigma export (JAX ``export_density``; reference
    ``engines/eval.py:285-307``): a grid of ``int(extent / voxel_size)``
    points an axis over the extents ``(h, w, d)`` centred on 0, x from
    ``w``, scaled by ``scale``, indexed ``[x, y, z]``; the fine field (the
    coarse one of a net with no fine pass, the one field of a mip net, at
    zero covariance) queried with zero viewdirs in chunks of ``chunk``
    points: relu of the sigma column (the column before the semantics, the
    last of a mip field's). Writes ``density.mrc`` and ``density.ply`` under
    ``save_dir`` when given. The kernels take a ragged last chunk as it is."""
    h, w, d = extents
    xs = np.linspace(-w / 2, w / 2, int(w / voxel_size), dtype=np.float32)
    ys = np.linspace(-h / 2, h / 2, int(h / voxel_size), dtype=np.float32)
    zs = np.linspace(-d / 2, d / 2, int(d / voxel_size), dtype=np.float32)
    pts = np.stack(np.meshgrid(xs, ys, zs, indexing="ij"), -1) * scale  # [W, H, D, 3]
    shape = pts.shape[:3]
    flat = torch.from_numpy(pts.reshape(-1, 3))
    device = next(net.parameters()).device
    mip = isinstance(net, MipNeRFNet)
    out = torch.empty(flat.shape[0], dtype=torch.float32, device=device)
    for i in range(0, flat.shape[0], chunk):
        p = flat[i:i + chunk].to(device)
        zeros = torch.zeros_like(p)
        if mip:
            sigma = net.field_query(p, zeros, zeros)[:, -1]
        else:
            raw = net.field_query(p, zeros)
            sem_dim = net.cfg.sem_dim if net.cfg.use_semantics else 0
            sigma = raw[:, raw.shape[-1] - 1 - sem_dim]  # sigma sits before the semantics
        out[i:i + p.shape[0]] = torch.relu(sigma)
    sigma = out.cpu().numpy().reshape(shape)
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        io_utils.write_mrc(os.path.join(save_dir, "density.mrc"), sigma)
        io_utils.write_voxel_ply(os.path.join(save_dir, "density.ply"), sigma)
    return sigma
