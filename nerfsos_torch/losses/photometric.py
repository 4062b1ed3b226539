"""Photometric loss and PSNR (port of ``nerfsos_tpu/losses/photometric.py``)."""
from __future__ import annotations

import math

import torch


def img2mse(x: torch.Tensor, y: torch.Tensor, reduction: str = "mean") -> torch.Tensor:
    """Channel-mean squared error, then reduced over pixels."""
    diff = torch.mean((x - y) ** 2, dim=-1)
    if reduction == "mean":
        return torch.mean(diff)
    if reduction == "sum":
        return torch.sum(diff)
    return diff


def mse2psnr(mse: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log(mse) / math.log(10.0)
