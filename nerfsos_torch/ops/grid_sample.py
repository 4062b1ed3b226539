"""Bilinear grid sampling with the reference's conventions.

Port of ``nerfsos_tpu/ops/grid_sample.py``, which reimplements exactly
``F.grid_sample(t, grid, mode='bilinear', padding_mode='border',
align_corners=True)`` (reference ``utils/image.py:303-304``): here it is
that call.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample_bilinear(t: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """``t [N, C, H, W]``, ``grid [N, Hg, Wg, 2]`` (x then y in [-1, 1]) ->
    ``[N, C, Hg, Wg]``."""
    return F.grid_sample(t, grid, mode="bilinear", padding_mode="border", align_corners=True)
