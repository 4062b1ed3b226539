"""Frozen DINO feature extraction for NeRF-SOS.

Port of ``nerfsos_tpu/models/extractor.py``'s main path:

- :func:`normalize_imagenet`, :func:`resize_nearest_torch` (torch
  ``F.interpolate(mode='nearest')`` indices, ``src = floor(dst * in / out)``);
- :class:`VitExtractor` (ViT-S/16 by default): ``get_vit_attn_feat`` resizes
  to 224 x 224 (nearest) and normalises, then returns ``attn`` (the last
  block's head-mean CLS -> patch attention ``[B, 1, N]``), ``cls_`` (the
  last block's CLS token ``[B, C]``) and ``feat`` (its patch tokens
  ``[B, N, C]``);
- :class:`SyntheticExtractor`: the photometric stand-in with the same
  contract (per-patch mean/std RGB through a fixed projection), for runs
  without pretrained weights.

Images are NHWC in [0, 1], as in the JAX package. The SOS step calls
``get_vit_attn_feat`` on an input that it has already resized and
normalised once: the double ImageNet normalisation is the reference's and
is kept.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from nerfsos_torch.models.vit import VisionTransformer

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_imagenet(x: torch.Tensor) -> torch.Tensor:
    """(x - mean) / std over the trailing channel axis (NHWC)."""
    mean = x.new_tensor(IMAGENET_MEAN)
    std = x.new_tensor(IMAGENET_STD)
    return (x - mean) / std


def resize_nearest_torch(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """``[B, H, W, C]`` -> ``[B, out_h, out_w, C]`` with the source index
    ``floor(dst * (in / out))`` taken in float32, as the JAX port does."""
    _, H, W, _ = x.shape
    hs = torch.floor(torch.arange(out_h, dtype=torch.float32) * np.float32(H / out_h)).long()
    ws = torch.floor(torch.arange(out_w, dtype=torch.float32) * np.float32(W / out_w)).long()
    return x[:, hs.to(x.device)][:, :, ws.to(x.device)]


class VitExtractor:
    """A frozen DINO ViT (an ``nn.Module`` in ``.vit``) and its API. ``dtype``:
    the ViT's (float32, or bfloat16 with flax's semantics; its outputs are
    float32 either way)."""

    def __init__(self, model_name: str = "dino_vits16", vit: Optional[VisionTransformer] = None,
                 dtype: torch.dtype = torch.float32):
        self.patch_size = 8 if "8" in model_name else 16
        small = ("s" in model_name.replace("dino_vit", "")) or ("small" in model_name)
        self.embed_dim = 384 if small else 768
        self.num_heads = 6 if small else 12
        self.vit = vit if vit is not None else VisionTransformer(
            patch_size=self.patch_size, embed_dim=self.embed_dim, depth=12,
            num_heads=self.num_heads, dtype=dtype)
        self.vit.eval().requires_grad_(False)

    def to(self, device) -> "VitExtractor":
        self.vit.to(device)
        return self

    @property
    def device(self) -> torch.device:
        return next(self.vit.parameters()).device

    def load_torch_checkpoint(self, path: str) -> None:
        """Load DINO weights (e.g. ``dino_deitsmall16_pretrain.pth``)."""
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
        self.vit.load_state_dict(sd)

    def get_vit_attn_feat(self, x: torch.Tensor, resize: bool = True) -> Dict[str, torch.Tensor]:
        """``x [B, H, W, 3]`` -> dict(attn ``[B, 1, N]``, cls_ ``[B, C]``,
        feat ``[B, N, C]``)."""
        if resize:
            x = resize_nearest_torch(x, 224, 224)
        out = self.vit(normalize_imagenet(x))
        return {"attn": out["attn_last"].mean(dim=1)[:, None, 0, 1:],
                "cls_": out["tokens"][:, 0, :], "feat": out["tokens"][:, 1:, :]}


def synthetic_projection(embed_dim: int = 384, seed: int = 0) -> torch.Tensor:
    """The stand-in's fixed projection ``[6, embed_dim]``: N(0, 1) / sqrt(6)
    from a seeded generator (the JAX package draws it from PRNGKey(0); tests
    carry its values over with ``engines.checkpoint.synthetic_params_from_jax``)."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn((6, embed_dim), generator=g) / math.sqrt(6.0)


class SyntheticExtractor:
    """Photometric stand-in for DINO with ``VitExtractor``'s contract: token
    features are per-patch mean/std RGB (after the 224 resize and the
    normalisation) through a fixed projection, ``cls_`` their mean, ``attn``
    the L1-normalised distance of each token's statistics from the image's.
    ``dtype`` (the JAX stand-in's): ``feat``, ``cls_`` (their mean) and
    ``attn`` are of it."""

    def __init__(self, embed_dim: int = 384, proj: Optional[torch.Tensor] = None,
                 dtype: torch.dtype = torch.float32):
        self.patch_size = 16
        self.embed_dim = embed_dim
        self.dtype = dtype
        self.proj = synthetic_projection(embed_dim) if proj is None else proj

    def to(self, device) -> "SyntheticExtractor":
        self.proj = self.proj.to(device)
        return self

    @property
    def device(self) -> torch.device:
        return self.proj.device

    def get_vit_attn_feat(self, x: torch.Tensor, resize: bool = True) -> Dict[str, torch.Tensor]:
        if resize:
            x = resize_nearest_torch(x, 224, 224)
        x = normalize_imagenet(x)
        B, H, W, _ = x.shape
        ps = self.patch_size
        gh, gw = H // ps, W // ps
        p = x.reshape(B, gh, ps, gw, ps, 3)
        mu = p.mean(dim=(2, 4))
        sd = torch.sqrt(torch.clamp((p * p).mean(dim=(2, 4)) - mu * mu, min=0.0))
        stats = torch.cat([mu, sd], dim=-1).reshape(B, gh * gw, 6)
        feat = (stats @ self.proj).to(self.dtype)
        sal = (stats - stats.mean(dim=1, keepdim=True)).abs().sum(-1)
        attn = sal / torch.clamp(sal.sum(dim=-1, keepdim=True), min=1e-8)
        return {"attn": attn[:, None, :].to(self.dtype), "cls_": feat.mean(dim=1), "feat": feat}
