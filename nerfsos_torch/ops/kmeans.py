"""Lloyd's k-means for segmentation clustering (torch).

Port of ``nerfsos_tpu/ops/kmeans.py``: greedy farthest-point seeding from a
first centre, then a fixed number of Lloyd steps. The first centre's index is
an explicit argument (JAX draws it from ``PRNGKey(0)``), so a caller can
reproduce the JAX labels exactly.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def kmeans(x: torch.Tensor, k: int, first: int, iters: int = 25) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cluster rows of ``x [N, C]``; returns (labels [N] int32, centroids [k, C])."""
    cents = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
    cents[0] = x[first]
    for i in range(1, k):
        d = torch.sum((x[:, None, :] - cents[None, :i, :]) ** 2, dim=-1)
        cents[i] = x[torch.argmax(torch.min(d, dim=1).values)]
    for _ in range(iters):
        labels = torch.argmin(torch.sum((x[:, None, :] - cents[None]) ** 2, dim=-1), dim=1)
        one_hot = torch.nn.functional.one_hot(labels, k).to(x.dtype)
        counts = one_hot.sum(0)[:, None]
        sums = one_hot.T @ x
        cents = torch.where(counts > 0, sums / torch.clamp(counts, min=1), cents)
    labels = torch.argmin(torch.sum((x[:, None, :] - cents[None]) ** 2, dim=-1), dim=1)
    return labels.to(torch.int32), cents


def segmap_cluster(x: torch.Tensor, n_clusters: int = 2, first: Optional[int] = None) -> torch.Tensor:
    """Cluster an ``[H, W, C]`` logit map -> ``[H, W, 1]`` labels. Without
    ``first``, the start index is drawn from a ``torch.Generator`` seeded 0."""
    H, W, C = x.shape
    if first is None:
        g = torch.Generator().manual_seed(0)
        first = int(torch.randint(H * W, (1,), generator=g))
    labels, _ = kmeans(x.reshape(-1, C), n_clusters, first)
    return labels.reshape(H, W, 1)
