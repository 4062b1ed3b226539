"""DINO Vision Transformer (ViT-S/16) with the last block's attention as an
output (``nn.Module``).

Port of ``nerfsos_tpu/models/vit.py``. The module names are the reference
DINO ones (``patch_embed.proj``, ``cls_token``, ``pos_embed``,
``blocks.{i}.norm1``, ``blocks.{i}.attn.qkv``, ``blocks.{i}.attn.proj``,
``blocks.{i}.norm2``, ``blocks.{i}.mlp.fc1``, ``blocks.{i}.mlp.fc2``,
``norm``), so a DINO ``.pth`` state dict loads with ``load_state_dict``.
``forward`` returns the last block's residual-stream tokens (pre-final-norm,
what the reference's block hook captures), the last block's post-softmax
attention and the final normed tokens.

Parity notes: qkv bias, LayerNorm eps 1e-6, exact (erf) GELU, attention
written out with its softmax (the attention map is an output). The patch
embedding's convolution has kernel = stride, so it is computed as one
matrix product over the flattened patches (a float32 product, where cuDNN
would take TF32 by default). Non-224 inputs resize the position embedding
as the JAX package does (``jax.image.resize(..., method="bicubic")``, see
:func:`cubic_resize_matrix`); the SOS path always feeds 224 x 224, where no
interpolation happens.

``dtype=torch.bfloat16`` (``--compute_dtype bfloat16``) runs it as the JAX
ViT does at ``dtype=bf16`` (flax's semantics, the parameters float32): every
Linear casts its input, weight and bias to bf16 (a bf16 product, a bf16
bias add), the residual stream is cast to bf16 after the position embedding
and stays bf16 through the blocks' adds, the attention's products and
softmax and the GELU run in bf16 op by op, as JAX's eager ops do (each
rounded), the LayerNorms promote to float32 (their
outputs float32, cast again by the next Linear), and the outputs are
float32.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from nerfsos_torch.models.mlp import flax_dense_init_


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis; in bf16 as jax.nn.softmax's ops run, each
    rounded to bf16 (exp of the shifted input, its sum, the quotient)."""
    if x.dtype == torch.float32:
        return torch.softmax(x, dim=-1)
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """The exact (erf) GELU; in bf16 as jax.nn.gelu(approximate=False)'s ops
    run, each rounded to bf16: ``0.5 x erfc(-x bf16(sqrt(1/2)))``."""
    if x.dtype == torch.float32:
        return F.gelu(x)
    sqrt_half = torch.tensor(math.sqrt(0.5), dtype=x.dtype, device=x.device)
    return (0.5 * x) * torch.erfc(-x * sqrt_half)


def _dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax's ``nn.Dense(dtype=dtype, param_dtype=float32)``: input, weight
    and bias cast to ``dtype`` (the float32 layer itself at float32)."""
    if dtype == torch.float32:
        return layer(x)
    return torch.matmul(x.to(dtype), layer.weight.to(dtype).t()) + layer.bias.to(dtype)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic convolution kernel with a = -0.5 at ``|x|``."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def cubic_resize_matrix(n_in: int, n_out: int) -> torch.Tensor:
    """``[n_in, n_out]`` weights of one axis of an antialiased bicubic resize
    with half-pixel centres (``jax.image.resize``'s ``compute_weight_mat``):
    the Keys kernel widened by ``n_in / n_out`` when the axis shrinks, each
    output's weights normalised over the input, outputs whose sample lies
    outside the input zeroed."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]).abs() / kernel_scale
    w = _keys_cubic(x)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(torch.finfo(torch.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)), torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _dense(self.fc2, _gelu(_dense(self.fc1, x, self.dtype)), self.dtype)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor):
        """``x [B, N, C]`` -> (out ``[B, N, C]``, attention ``[B, H, N, N]``
        float32)."""
        B, N, C = x.shape
        qkv = _dense(self.qkv, x, self.dtype).reshape(B, N, 3, self.num_heads,
                                                      C // self.num_heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        attn = _softmax((q @ k.transpose(-2, -1)) * self.scale)
        out = (attn @ v).transpose(1, 2).reshape(B, N, C)
        return _dense(self.proj, out, self.dtype), attn.to(torch.float32)


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads, dtype)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype)

    def forward(self, x: torch.Tensor):
        # the LayerNorms in float32, as flax's promote a bf16 input
        y, attn = self.attn(self.norm1(x.to(torch.float32)))
        x = x + y
        return x + self.mlp(self.norm2(x.to(torch.float32))), attn


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, embed_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.patch_size = patch_size
        self.proj = nn.Conv2d(3, embed_dim, kernel_size=patch_size, stride=patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x [B, H, W, 3]`` -> tokens ``[B, (H / p) (W / p), C]``, row-major
        patches: the convolution as a product over (channel, y, x) patches."""
        B, H, W, _ = x.shape
        p = self.patch_size
        patches = (x.reshape(B, H // p, p, W // p, p, 3).permute(0, 1, 3, 5, 2, 4)
                   .reshape(B, (H // p) * (W // p), 3 * p * p))
        w = self.proj.weight.reshape(self.proj.out_channels, -1)
        if self.dtype == torch.float32:
            return F.linear(patches, w, self.proj.bias)
        return (torch.matmul(patches.to(self.dtype), w.to(self.dtype).t())
                + self.proj.bias.to(self.dtype))


class VisionTransformer(nn.Module):
    """DINO ViT; input NHWC, already normalised by the caller. ``dtype``:
    float32, or bfloat16 with flax's semantics (the module docstring)."""

    def __init__(self, patch_size: int = 16, embed_dim: int = 384, depth: int = 12,
                 num_heads: int = 6, mlp_ratio: float = 4.0, pos_embed_size: int = 224,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if dtype not in (torch.float32, torch.bfloat16):
            raise NotImplementedError(f"the ViT runs float32 or bfloat16, not {dtype}")
        self.dtype = dtype
        self.patch_size = patch_size
        self.patch_embed = PatchEmbed(patch_size, embed_dim, dtype)
        n_pos = (pos_embed_size // patch_size) ** 2 + 1
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, n_pos, embed_dim))
        self.blocks = nn.ModuleList([Block(embed_dim, num_heads, mlp_ratio, dtype)
                                     for _ in range(depth)])
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)
        # the JAX package's seeded ViT: flax's truncated_normal(0.02) (a
        # normal of std 0.02 cut at +-2 std) for the two embeddings, flax's
        # default for its Dense and Conv layers
        nn.init.trunc_normal_(self.pos_embed, std=0.02, a=-0.04, b=0.04)
        nn.init.trunc_normal_(self.cls_token, std=0.02, a=-0.04, b=0.04)
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                flax_dense_init_(m)

    def interpolate_pos_encoding(self, npatch: int, w: int, h: int) -> torch.Tensor:
        N = self.pos_embed.shape[1] - 1
        if npatch == N and w == h:
            return self.pos_embed
        dim = self.pos_embed.shape[-1]
        side = int(math.sqrt(N))
        patch_pos = self.pos_embed[0, 1:].reshape(side, side, dim)
        rows = cubic_resize_matrix(side, w // self.patch_size).to(patch_pos)
        cols = cubic_resize_matrix(side, h // self.patch_size).to(patch_pos)
        patch_pos = torch.einsum("ijc,ia,jb->abc", patch_pos, rows, cols)
        return torch.cat([self.pos_embed[:, :1], patch_pos.reshape(1, -1, dim)], dim=1)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """``x [B, H, W, 3]`` -> dict(tokens, attn_last, normed)."""
        B, H, W, _ = x.shape
        x = self.patch_embed(x).to(torch.float32)
        x = torch.cat([self.cls_token.expand(B, -1, -1), x], dim=1)
        x = (x + self.interpolate_pos_encoding(x.shape[1] - 1, H, W)).to(self.dtype)
        attn = None
        for blk in self.blocks:
            x, attn = blk(x)
        x = x.to(torch.float32)
        return {"tokens": x, "attn_last": attn, "normed": self.norm(x)}
