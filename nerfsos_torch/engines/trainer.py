"""The RGB train step (the pretrain stage of NeRF-SOS).

Port of ``nerfsos_tpu/engines/trainer.py`` (single device):

- :func:`rgb_loss_fn`: coarse + fine MSE through the net's
  ``forward(train=True)``, differentiated by autograd; used when the
  configuration is outside :func:`supports_fused_rgb_loss`, and for a
  ``MipNeRFNet`` (``net_kwargs`` carries its ``radii``), whose fused train
  render is K10a with K10b as its backward;
- :func:`fused_rgb_value_and_grads`: the fused path, one K3 pass per field
  (``ops/fused_render.fused_rgb_train_grads``: forward, maps, the in-kernel
  img2mse cotangent and the reverse sweep), with the importance resampling
  between the passes; the unscaled grads are multiplied by ``rgb_w / (R * 3)``;
- :func:`make_rgb_train_step`: grads, then the LR of the step, then Adam.

Randomness: each step draws from a generator and two noise seeds that
depend on ``(seed, global_step)`` alone (:func:`step_randomness`), so a
resumed run draws what an uninterrupted one would. On the CPU the fused
path runs K3's plain version: no choice between the paths is made by device.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from nerfsos_torch.core import sampling
from nerfsos_torch.engines.state import set_lr
from nerfsos_torch.losses.photometric import img2mse, mse2psnr
from nerfsos_torch.models.nerf import NeRFNet
from nerfsos_torch.ops import fused_render as fr

Batch = Dict[str, torch.Tensor]  # rays [2, B, 3], target [B, 3] on the net's device


def step_randomness(seed: int, global_step: int,
                    device: torch.device) -> Tuple[torch.Generator, Tuple[int, int]]:
    """The step's randomness from ``(seed, global_step)``: a generator on
    ``device`` for the stratified and importance u, and the coarse and fine
    noise seeds in ``[0, 2^31 - 1)``. All three come from numpy's
    ``SeedSequence`` of the pair on the host, so no step waits on the device
    for its seeds."""
    words = np.random.SeedSequence([seed, global_step]).generate_state(3, np.uint64)
    generator = torch.Generator(device=device).manual_seed(int(words[0]))
    return generator, (int(words[1] % (2**31 - 1)), int(words[2] % (2**31 - 1)))


def rgb_loss_fn(net: nn.Module, batch: Batch, near: float, far: float, rgb_w: float = 1.0,
                generator: torch.Generator = None, noise_seeds: Tuple[int, int] = (0, 0),
                net_kwargs: Optional[Dict[str, Any]] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Coarse + fine MSE (reference ``engines/trainer.py:113-121``);
    ``net_kwargs`` threads model statics (mip-NeRF's ``radii``)."""
    out = net(batch["rays"], (near, far), train=True, generator=generator,
              noise_seeds=noise_seeds, **(net_kwargs or {}))
    img_loss = img2mse(out["rgb"], batch["target"])
    loss = rgb_w * img_loss
    metrics = {"img1": img_loss, "psnr": mse2psnr(img_loss)}
    if "rgb0" in out:
        img_loss0 = img2mse(out["rgb0"], batch["target"])
        loss = loss + rgb_w * img_loss0
        metrics.update(img0=img_loss0, psnr0=mse2psnr(img_loss0))
    metrics["loss"] = loss
    return loss, {k: v.detach() for k, v in metrics.items()}


def supports_fused_rgb_loss(net: nn.Module) -> bool:
    """K3's loss-in-kernel step: a fused ``NeRFNet`` with a fine pass."""
    if not isinstance(net, NeRFNet):
        return False
    cfg = net.cfg
    return net.fused and cfg.use_viewdirs and cfg.n_importance > 0


def fused_rgb_value_and_grads(net: NeRFNet, batch: Batch, near: float, far: float,
                              rgb_w: float, generator: torch.Generator,
                              noise_seeds: Tuple[int, int],
                              grads_fn: Callable = fr.fused_rgb_train_grads
                              ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Grads keyed by ``net.named_parameters()`` names and the metrics
    ``img0``, ``img1``, ``psnr``, ``psnr0``, ``loss``. ``grads_fn`` is the K3
    wrapper, or its plain version to time the step without the kernel; it
    runs at the net's compute dtype (K3's bf16 mode at bf16)."""
    cfg = net.cfg
    rays_o = batch["rays"][0].to(torch.float32)
    rays_d = batch["rays"][1].to(torch.float32)
    gt = batch["target"].to(torch.float32).contiguous()
    R = rays_o.shape[0]
    viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    near_b = torch.full((R, 1), near, dtype=torch.float32, device=rays_o.device)
    far_b = torch.full((R, 1), far, dtype=torch.float32, device=rays_o.device)
    z_vals = sampling.stratified_sample(near_b, far_b, cfg.n_samples, perturb=cfg.perturb,
                                        lindisp=cfg.lindisp, generator=generator)
    odv = torch.cat([rays_o, rays_d, viewdirs], dim=1).contiguous()
    kw = dict(white_bkgd=cfg.white_bkgd, noise_std=cfg.raw_noise_std,
              compute_dtype=net.compute_dtype)

    g_c, maps0, w0 = grads_fn(net.nerf, odv, z_vals.contiguous(), gt, seed=noise_seeds[0], **kw)
    z_all, _ = sampling.importance_sample(z_vals, w0, cfg.n_importance,
                                          det=cfg.perturb == 0.0, generator=generator)
    g_f, maps, _ = grads_fn(net.nerf_fine, odv, z_all.contiguous(), gt, seed=noise_seeds[1], **kw)

    scale = rgb_w / (R * 3)
    grads = {f"nerf.{k}": v * scale for k, v in g_c.items()}
    grads.update({f"nerf_fine.{k}": v * scale for k, v in g_f.items()})

    def rgbm(m: torch.Tensor) -> torch.Tensor:
        return m[:, 0:3] + (1.0 - m[:, 4:5]) if cfg.white_bkgd else m[:, 0:3]

    img_loss, img_loss0 = img2mse(rgbm(maps), gt), img2mse(rgbm(maps0), gt)
    metrics = {"img1": img_loss, "psnr": mse2psnr(img_loss), "img0": img_loss0,
               "psnr0": mse2psnr(img_loss0), "loss": rgb_w * (img_loss + img_loss0)}
    return grads, metrics


def make_rgb_train_step(net: nn.Module, optimizer: torch.optim.Optimizer,
                        schedule: Callable[[float], float], near: float, far: float,
                        rgb_w: float = 1.0, seed: int = 0,
                        grads_fn: Callable = fr.fused_rgb_train_grads,
                        net_kwargs: Optional[Dict[str, Any]] = None
                        ) -> Callable[[Batch, int], Dict[str, torch.Tensor]]:
    """``step(batch, global_step)``: one update, where ``global_step`` counts
    the updates made before it; returns the metrics (device tensors).
    ``net_kwargs``: model statics for the autograd path (mip-NeRF's
    ``radii``)."""
    fused = supports_fused_rgb_loss(net)
    params = dict(net.named_parameters())
    device = next(net.parameters()).device

    def step(batch: Batch, global_step: int) -> Dict[str, torch.Tensor]:
        generator, noise_seeds = step_randomness(seed, global_step, device)
        if fused:
            grads, metrics = fused_rgb_value_and_grads(net, batch, near, far, rgb_w, generator,
                                                       noise_seeds, grads_fn)
            for name, p in params.items():
                p.grad = grads[name]
        else:
            optimizer.zero_grad(set_to_none=True)
            loss, metrics = rgb_loss_fn(net, batch, near, far, rgb_w, generator, noise_seeds,
                                        net_kwargs)
            loss.backward()
            for p in params.values():  # unused (semantic head): a zero update, as optax
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        set_lr(optimizer, schedule(global_step))
        optimizer.step()
        return metrics

    return step
