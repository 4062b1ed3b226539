"""The NeRF-SOS patch finetune step (the flagship path's second half).

Port of ``nerfsos_tpu/engines/sos.py`` for one device (its ``axis=None``
body): render the batch's patches, run the frozen DINO ViT on the rendered
RGB, and add the RGB, appearance-correlation and geometry-correlation (and,
optionally, contrastive) losses; autograd and Adam make the step.

Kept from the JAX package:

- the DINO input is nearest-resized to ``(patch_size * patch_stride)^2`` and
  ImageNet-normalised, then the extractor resizes to 224 and normalises
  again (the reference's double normalisation);
- the ViT sees a detached input unless ``use_contrast`` (only the contrast
  term can differentiate through it);
- both correlation losses train both heads (coarse ``'0'`` and fine), and the
  geometry loss takes the fine depth for both, filtered with the
  batch-global largest depth under ``max_depth``;
- the negatives are the CLS similarity matrix's argmin: both heads share
  them, so the appearance loss's four evaluations run as one batch and the
  geometry loss's on the quad kernels K7f/K7g. With ``rand_neg`` each head
  of each loss draws its own permutation, and each head's loss is a
  neg and a self helper mean of its own (the single-head geometry kernels
  K7b/K7c). The similarity matrix is always formed, so ``use_sim_matrix``
  changes nothing here (as in the JAX step);
- ``fix_backbone``: only the semantic head is trained. The optimizer holds
  it alone (``engines/state.make_optimizer``) and the fused train render's
  backward is K5 (``NeRFConfig.frozen_backbone``), so the trunk's reverse
  sweep never runs. Without it every leaf trains and the fused train
  render's backward is K6.

Randomness is explicit: the step's generator and noise seeds come from
``engines/trainer.step_randomness``. After the render the same generator
draws, in this order, the appearance loss's coordinates
(:func:`draw_pair_coords`) and, when a loss takes random negatives, the
four permutations of :func:`draw_negatives`. Both can be given by the
caller instead.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from nerfsos_torch.engines.state import set_lr
from nerfsos_torch.engines.trainer import step_randomness
from nerfsos_torch.losses.correlation import (CorrelationLoss, GeoCorrelationLoss,
                                              draw_pair_coords, get_similarity_matrix,
                                              nerf_contrastive)
from nerfsos_torch.losses.photometric import img2mse, mse2psnr
from nerfsos_torch.models.extractor import normalize_imagenet, resize_nearest_torch
from nerfsos_torch.models.nerf import NeRFNet
from nerfsos_torch.ops.kmeans import kmeans
from nerfsos_torch.utils.metrics import adjusted_rand_score

Batch = Dict[str, torch.Tensor]  # rays [2, B P P, 3], target [B P P, 3] on the net's device


@dataclasses.dataclass(frozen=True)
class SOSConfig:
    """SOS loss and pipeline flags (the reference ``run_nerf.py`` SOS group)."""

    batch_size: int = 8
    patch_size: int = 64
    patch_stride: int = 6
    rgb_w: float = 1.0
    correlation_w: float = 1.0
    Gcorrelation_w: float = 0.01
    contrast_w: float = 0.0
    use_dino: bool = True
    use_correlation: bool = True
    use_geoCorr: bool = True
    use_contrast: bool = False
    fix_backbone: bool = False


def _to_patches(x: torch.Tensor, B: int, P: int) -> torch.Tensor:
    """``[B P P, C]`` -> ``[B, C, P, P]`` (the losses' NCHW layout)."""
    return x.reshape(B, P, P, -1).permute(0, 3, 1, 2)


def draw_negatives(generator: Optional[torch.Generator], app_loss: CorrelationLoss,
                   geo_loss: GeoCorrelationLoss, batch: int,
                   sim_matrix: torch.Tensor) -> torch.Tensor:
    """``[4, B]``: the negatives of the appearance loss's coarse and fine
    heads, then the geometry loss's, each ``loss.negative_index`` in that
    order (a loss without ``rand_neg`` takes the argmin and draws nothing)."""
    return torch.stack([loss.negative_index(generator, batch, sim_matrix)
                        for loss in (app_loss, app_loss, geo_loss, geo_loss)])


def sos_loss_fn(net: NeRFNet, extractor, app_loss: CorrelationLoss, geo_loss: GeoCorrelationLoss,
                cfg: SOSConfig, batch: Batch, near: float, far: float, *,
                generator: Optional[torch.Generator] = None,
                noise_seeds: Tuple[int, int] = (0, 0),
                coords: Optional[torch.Tensor] = None,
                negatives: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The SOS loss and its terms. ``coords [4 B, F, F, 2]``: the appearance
    loss's sample coordinates (own patches coarse, fine, then negative
    patches coarse, fine; :func:`draw_pair_coords` from ``generator`` when
    None). ``negatives [4, B]``: with ``rand_neg``, the heads' negatives
    (:func:`draw_negatives` from ``generator`` when None)."""
    if net.fused and cfg.fix_backbone != net.cfg.frozen_backbone:
        raise ValueError("the fused train render needs NeRFConfig.frozen_backbone == "
                         "SOSConfig.fix_backbone (its backward is K5 exactly when frozen)")
    B, P = cfg.batch_size, cfg.patch_size
    out = net(batch["rays"], (near, far), train=True, generator=generator,
              noise_seeds=noise_seeds)
    gt = batch["target"]
    img_loss, img_loss0 = img2mse(out["rgb"], gt), img2mse(out["rgb0"], gt)
    loss = cfg.rgb_w * (img_loss + img_loss0)
    zero = torch.zeros((), device=gt.device)
    metrics = {"img1": img_loss, "img0": img_loss0, "psnr": mse2psnr(img_loss),
               "psnr0": mse2psnr(img_loss0), "sem0": zero, "sem1": zero, "corr0": zero,
               "corr1": zero, "geo_corr0": zero, "geo_corr1": zero, "contrast": zero}

    if cfg.use_dino:
        rgb_patches = out["rgb"].reshape(B, P, P, 3)
        if not cfg.use_contrast:
            rgb_patches = rgb_patches.detach()
        with torch.set_grad_enabled(cfg.use_contrast and torch.is_grad_enabled()):
            side = P * cfg.patch_stride
            dino_in = normalize_imagenet(resize_nearest_torch(rgb_patches, side, side))
            dino = extractor.get_vit_attn_feat(dino_in)
        # float32 for the losses (a bf16 stand-in's outputs are bf16; the
        # JAX losses promote them on their first float32 operand)
        tokens = dino["feat"].to(torch.float32)
        fs = math.isqrt(tokens.shape[1])
        feat = tokens.reshape(B, fs, fs, -1).permute(0, 3, 1, 2)
        cls_all = dino["cls_"].to(torch.float32)
        sim_matrix = get_similarity_matrix(cls_all)
        sem0 = _to_patches(out["semantics0"], B, P)
        sem = _to_patches(out["semantics"], B, P)

        if cfg.use_correlation and coords is None:
            coords = draw_pair_coords(generator, B, app_loss.feature_samples, gt.device)
        rand = ((cfg.use_correlation and app_loss.rand_neg)
                or (cfg.use_geoCorr and geo_loss.rand_neg))
        if rand and negatives is None:
            negatives = draw_negatives(generator, app_loss, geo_loss, B, sim_matrix)

        if cfg.use_correlation:
            if app_loss.rand_neg:  # each head on its own coordinates and negatives
                c = torch.chunk(coords, 4)
                a0 = app_loss.single(torch.cat([c[0], c[2]]), negatives[0], feat, sem0)
                a1 = app_loss.single(torch.cat([c[1], c[3]]), negatives[1], feat, sem)
            else:
                a0, a1 = app_loss.pair_heads(coords, feat, sem0, sem, sim_matrix)
            corr0, corr1 = cfg.correlation_w * a0, cfg.correlation_w * a1
            loss = loss + corr0 + corr1
            metrics.update(corr0=corr0, corr1=corr1)

        if cfg.use_geoCorr:
            depth = _to_patches(out["depth"], B, P).detach()  # the fine depth for both heads
            pts = geo_loss._filtered_points(depth, _to_patches(batch["rays"][0], B, P),
                                            _to_patches(batch["rays"][1], B, P))
            if geo_loss.rand_neg:
                g0 = cfg.Gcorrelation_w * geo_loss.single(pts, sem0, negatives[2])
                g1 = cfg.Gcorrelation_w * geo_loss.single(pts, sem, negatives[3])
            else:
                neg = torch.argmin(sim_matrix, dim=0)
                n0, n1, s0, s1 = geo_loss.quad(pts, pts[neg], sem0, sem0[neg], sem, sem[neg])
                g0 = cfg.Gcorrelation_w * (geo_loss.neg_weight * n0 + geo_loss.self_weight * s0)
                g1 = cfg.Gcorrelation_w * (geo_loss.neg_weight * n1 + geo_loss.self_weight * s1)
            loss = loss + g0 + g1
            metrics.update(geo_corr0=g0, geo_corr1=g1)

        if cfg.use_contrast:
            c = cfg.contrast_w * nerf_contrastive(cls_all)
            loss = loss + c
            metrics.update(contrast=c)

    metrics["loss"] = loss
    return loss, metrics


def make_sos_train_step(net: NeRFNet, extractor, app_loss: CorrelationLoss,
                        geo_loss: GeoCorrelationLoss, cfg: SOSConfig,
                        optimizer: torch.optim.Optimizer, schedule: Callable[[float], float],
                        near: float, far: float, seed: int = 0
                        ) -> Callable[[Batch, int], Dict[str, torch.Tensor]]:
    """``step(batch, global_step)``: one update of the parameters the
    optimizer holds (the semantic head alone under ``fix_backbone``, every
    leaf without it); returns the detached metrics (device tensors)."""
    device = next(net.parameters()).device
    trained = [p for group in optimizer.param_groups for p in group["params"]]

    def step(batch: Batch, global_step: int) -> Dict[str, torch.Tensor]:
        generator, noise_seeds = step_randomness(seed, global_step, device)
        optimizer.zero_grad(set_to_none=True)
        loss, metrics = sos_loss_fn(net, extractor, app_loss, geo_loss, cfg, batch, near, far,
                                    generator=generator, noise_seeds=noise_seeds)
        loss.backward()
        for p in trained:  # a leaf no loss reaches: a zero update, as optax
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        set_lr(optimizer, schedule(global_step))
        optimizer.step()
        return {k: v.detach() for k, v in metrics.items()}

    return step


def _np_softmax(x: np.ndarray) -> np.ndarray:
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def online_seg_metrics(semantics: torch.Tensor, masks: np.ndarray, batch_size: int,
                       patch_size: int, n_cluster: int = 2, clus_no_sfm: bool = False,
                       firsts: Optional[np.ndarray] = None) -> Dict[str, float]:
    """The periodic train-time ARI (reference ``engines/trainer.py:174-198``):
    ``semantics [B P P, sem]``, ``masks [B P P, 1]``; k-means per patch on
    the (softmaxed unless ``clus_no_sfm``) semantics, from the start indices
    ``firsts [B]`` (drawn from a generator seeded 0 when None)."""
    sem = semantics.detach().reshape(batch_size, patch_size * patch_size, -1)
    prob = sem if clus_no_sfm else torch.softmax(sem, dim=-1)
    sft = np.argmax(_np_softmax(sem.cpu().numpy()), -1)
    if firsts is None:
        g = torch.Generator().manual_seed(0)
        firsts = torch.randint(patch_size * patch_size, (batch_size,), generator=g).numpy()
    labels = np.stack([kmeans(prob[b], n_cluster, int(firsts[b]))[0].cpu().numpy()
                       for b in range(batch_size)])
    gt = np.asarray(masks).reshape(batch_size, -1)
    fg = gt == 1
    return {"clus_ari": adjusted_rand_score(gt.reshape(-1), labels.reshape(-1)),
            "clus_ari_fg": adjusted_rand_score(gt[fg], labels[fg]),
            "sem_ari": adjusted_rand_score(gt.reshape(-1), sft.reshape(-1)),
            "sem_ari_fg": adjusted_rand_score(gt[fg], sft[fg])}
