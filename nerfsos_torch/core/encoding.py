"""Positional encoding (classic NeRF PE) and mip-NeRF's integrated PE.

Port of ``nerfsos_tpu/core/encoding.py``. The column order is bit-compatible
with the reference: ``[x, sin(f0·x), cos(f0·x), sin(f1·x), ...]``, each
frequency block laid out ``[sin(f·x), sin(f·y), sin(f·z), cos(f·x), ...]``.
The integrated PE has no raw-input columns: a ``sin`` block then a
``sin(y + pi/2)`` block, each frequency-major and channel-minor.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def freq_bands(n_freqs: int, max_freq: float, log_sampling: bool = True) -> torch.Tensor:
    """``2^linspace(0, max_freq, n)`` (log) or ``linspace(2^0, 2^max_freq, n)``."""
    if log_sampling:
        return 2.0 ** torch.linspace(0.0, max_freq, n_freqs)
    return torch.linspace(2.0**0.0, 2.0**max_freq, n_freqs)


def pe_dim(input_dim: int, n_freqs: int, include_input: bool = True) -> int:
    return input_dim * (2 * n_freqs + (1 if include_input else 0))


def positional_encoding(x: torch.Tensor, n_freqs: int, max_freq: float | None = None,
                        include_input: bool = True, log_sampling: bool = True) -> torch.Tensor:
    """Classic NeRF PE: ``[..., D] -> [..., pe_dim(D, n_freqs)]``."""
    if n_freqs == 0:
        return x
    if max_freq is None:
        max_freq = float(n_freqs - 1)
    bands = freq_bands(n_freqs, max_freq, log_sampling).to(x)
    xf = x[..., None, :] * bands[:, None]  # [..., F, D]
    emb = torch.cat([torch.sin(xf), torch.cos(xf)], dim=-1).reshape(*x.shape[:-1], -1)
    if include_input:
        emb = torch.cat([x, emb], dim=-1)
    return emb


def _trig_matmul_consts(input_dim: int, n_freqs: int, max_freq: float,
                        log_sampling: bool):
    """(M [D, 2*D*F], phase [2*D*F]) such that ``sin(x @ M + phase)`` equals
    ``positional_encoding(x)[..., D:]`` column for column (cos realised as
    ``sin(t + pi/2)``)."""
    if log_sampling:
        bands = (2.0 ** np.linspace(0.0, max_freq, n_freqs)).astype(np.float32)
    else:
        bands = np.linspace(2.0**0.0, 2.0**max_freq, n_freqs).astype(np.float32)
    cols = 2 * input_dim * n_freqs
    M = np.zeros((input_dim, cols), np.float32)
    phase = np.zeros((cols,), np.float32)
    k = 0
    for f in bands:
        for fn_phase in (0.0, math.pi / 2):  # sin block then cos block
            for c in range(input_dim):
                M[c, k] = f
                phase[k] = fn_phase
                k += 1
    return M, phase


def positional_encoding_fused(x: torch.Tensor, n_freqs: int, max_freq: float | None = None,
                              include_input: bool = True,
                              log_sampling: bool = True) -> torch.Tensor:
    """``positional_encoding`` as one phase map and one ``sin``.

    The phase ``x @ M + phase`` is formed by exact fp32 elementwise
    multiply-adds, never by a matrix product: frequencies reach 2^(F-1), so a
    TF32 or bf16 product would move the phase by radians. Each column of M
    has one nonzero power-of-two entry, so the sum below is exactly
    ``f·x_c`` and the single rounding is the ``+ phase``, as in the kernels.
    """
    if n_freqs == 0:
        return x
    if max_freq is None:
        max_freq = float(n_freqs - 1)
    M, phase = _trig_matmul_consts(x.shape[-1], n_freqs, max_freq, log_sampling)
    M = torch.as_tensor(M, device=x.device, dtype=x.dtype)
    phase = torch.as_tensor(phase, device=x.device, dtype=x.dtype)
    t = (x[..., :, None] * M).sum(dim=-2) + phase
    emb = torch.sin(t)
    if include_input:
        emb = torch.cat([x, emb], dim=-1)
    return emb


def ipe_dim(input_dim: int, n_freqs: int) -> int:
    return 2 * input_dim * n_freqs


def expected_sin(x: torch.Tensor, x_var: torch.Tensor) -> torch.Tensor:
    """``E[sin(z)]`` for ``z ~ N(x, x_var)``."""
    return torch.exp(-0.5 * x_var) * torch.sin(x)


def integrated_positional_encoding(x: torch.Tensor, x_cov_diag: torch.Tensor, n_freqs: int,
                                   max_freq: float | None = None,
                                   log_sampling: bool = True) -> torch.Tensor:
    """mip-NeRF's integrated PE of diagonal Gaussians: means ``x [..., D]``
    and variances ``x_cov_diag [..., D]`` -> ``[..., 2 D n_freqs]``. Each
    phase ``y = f·x_c`` is one fp32 product and the cos block is
    ``sin(y + pi/2)``, as the kernels form them."""
    if max_freq is None:
        max_freq = float(n_freqs - 1)
    bands = freq_bands(n_freqs, max_freq, log_sampling).to(x)
    y = (x[..., None, :] * bands[:, None]).reshape(*x.shape[:-1], -1)
    y_var = (x_cov_diag[..., None, :] * (bands[:, None] ** 2)).reshape(*x.shape[:-1], -1)
    return expected_sin(torch.cat([y, y + 0.5 * math.pi], dim=-1),
                        torch.cat([y_var, y_var], dim=-1))
