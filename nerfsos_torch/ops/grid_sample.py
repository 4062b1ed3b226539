"""Bilinear grid sampling with the reference's conventions.

Port of ``nerfsos_tpu/ops/grid_sample.py``, which reimplements exactly
``F.grid_sample(t, grid, mode='bilinear', padding_mode='border',
align_corners=True)`` (reference ``utils/image.py:303-304``). Here the
sampling is made of products, whose backward is products too, so a step
repeats bit for bit on the card, where ``F.grid_sample``'s backward
accumulates with atomics in an order that changes from call to call:

- a source of at most 1024 pixels (the DINO 14 x 14 features, the gate's
  16 x 16 patches) is sampled through one product with the bilinear
  interpolation matrix, the form the JAX version takes for such sources;
- a larger one (the flagship's 64 x 64 patches of the semantic code) is
  sampled through the matrix's two factors, one an axis (each sample's two
  columns, then its two rows), where the JAX version gathers: two small
  products in place of a matrix of every sample by every pixel.
"""
from __future__ import annotations

import torch

DENSE_MAX_PIXELS = 1024  # the JAX version's bound for its matrix form


def _axis_weights(u: torch.Tensor, n: int) -> torch.Tensor:
    """``u [N, G]`` coordinates in [-1, 1] along an axis of ``n`` pixels ->
    ``[N, G, n]``: each sample's two linear weights on that axis, clamped to
    the border (a corner clamped onto its neighbour has weight 0, so the
    sums are exact)."""
    p = ((u + 1.0) / 2.0 * (n - 1)).clamp(0.0, n - 1)
    p0 = torch.floor(p)
    f = (p - p0).unsqueeze(-1)
    i0 = p0.long().unsqueeze(-1)
    w = u.new_zeros(*u.shape, n)
    w.scatter_add_(-1, i0, 1.0 - f)
    w.scatter_add_(-1, (i0 + 1).clamp(max=n - 1), f)
    return w


def grid_sample_bilinear(t: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """``t [N, C, H, W]``, ``grid [N, Hg, Wg, 2]`` (x then y in [-1, 1]; no
    gradient) -> ``[N, C, Hg, Wg]``: corners at -1 and +1, coordinates
    clamped to the border."""
    N, C, H, W = t.shape
    _, Hg, Wg, _ = grid.shape
    with torch.no_grad():
        wx = _axis_weights(grid[..., 0].reshape(N, -1), W)  # [N, G, W]
        wy = _axis_weights(grid[..., 1].reshape(N, -1), H)  # [N, G, H]
        if H * W <= DENSE_MAX_PIXELS:
            mat = (wy.unsqueeze(-1) * wx.unsqueeze(-2)).reshape(N, Hg * Wg, H * W).to(t.dtype)
        wx, wy = wx.to(t.dtype), wy.to(t.dtype)
    if H * W <= DENSE_MAX_PIXELS:
        out = torch.bmm(mat, t.reshape(N, C, H * W).transpose(1, 2))  # [N, G, C]
        return out.transpose(1, 2).reshape(N, C, Hg, Wg)
    rows = torch.bmm(t.reshape(N, C * H, W), wx.transpose(1, 2)).reshape(N, C, H, -1)
    return (rows * wy.transpose(1, 2).unsqueeze(1)).sum(2).reshape(N, C, Hg, Wg)
