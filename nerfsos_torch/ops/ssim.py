"""Windowed SSIM (gaussian 11x11, sigma 1.5) as depthwise ``conv2d``.

Port of ``nerfsos_tpu/ops/ssim.py``: zero-padded depthwise gaussian blurs,
C1 = 0.01^2, C2 = 0.03^2, mean over the whole map. On CUDA the caller must
keep cuDNN's TF32 off (``torch.backends.cudnn.allow_tf32``), which is on by
default and would round the convolutions to ~3 digits.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def gaussian_window(window_size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    g = torch.tensor([math.exp(-((x - window_size // 2) ** 2) / (2 * sigma**2))
                      for x in range(window_size)], dtype=torch.float32)
    g = g / g.sum()
    return torch.outer(g, g)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         data_format: str = "NCHW") -> torch.Tensor:
    """Mean SSIM of two images in [0, 1]; ``data_format`` 'NCHW' or 'HWC'."""
    if data_format == "HWC":
        img1, img2 = img1.permute(2, 0, 1)[None], img2.permute(2, 0, 1)[None]
    C = img1.shape[1]
    win = gaussian_window(window_size).to(img1).expand(C, 1, window_size, window_size)

    def blur(x):
        return F.conv2d(x, win, padding=window_size // 2, groups=C)

    mu1, mu2 = blur(img1), blur(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1**2, mu2**2, mu1 * mu2
    sigma1_sq = blur(img1 * img1) - mu1_sq
    sigma2_sq = blur(img2 * img2) - mu2_sq
    sigma12 = blur(img1 * img2) - mu1_mu2
    C1, C2 = 0.01**2, 0.03**2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))
    return ssim_map.mean()
