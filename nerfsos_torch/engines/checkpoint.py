"""Checkpoints in the reference's torch format, and the bridge from flax params.

The reference saves ``{'global_step', 'model', 'optimizer'}`` as
``{step:08d}.ckpt`` and resumes from the lexicographically newest ``*.ckpt``
(``engines/checkpoint.py`` of ``nerfsos_tpu`` documents the same contract);
a train run writes ``{step:08d}.ckpt`` and ``latest.ckpt`` every
``--i_weights`` steps and ``last.ckpt`` at its end, ``optimizer`` holding
the Adam ``state_dict``.
``NeRFNet``'s parameter names are the reference's, so such a file loads with
``load_state_dict``. A ``MipNeRFNet`` saves its one field as ``mip.mlp.*``
with ``NeRFMLP``'s names (``pts_linears.i``, ``alpha_linear``, ...): the
JAX package's tree, ``{"mip": {"mlp": ...}}``. The reference's own mip-NeRF
module names are not known here, so whether its mip ``.ckpt`` files load
is unverified. :func:`state_dict_from_jax_params` is the inverse of
``nerfsos_tpu.engines.checkpoint._convert_field``: it turns a flax param tree
(numpy leaves, kernels ``[in, out]``) into a torch state dict
(weights ``[out, in]``). :func:`vit_state_dict_from_jax_params` does the
same for the DINO ViT (the inverse of ``nerfsos_tpu.models.vit.
torch_vit_state_to_flax``), and :func:`synthetic_params_from_jax` carries the
photometric stand-in's projection.
"""
from __future__ import annotations

import os
import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn


def find_latest_checkpoint(run_dir: str) -> Optional[str]:
    """Newest checkpoint in a run dir (``.ckpt`` files or orbax step dirs).

    The rule is the JAX package's: the lexicographically last name, so
    ``latest.ckpt`` wins over ``last.ckpt`` and over the 8-digit names. A run
    whose last step is not a multiple of ``--i_weights`` therefore resumes
    from its last ``--i_weights`` step (``latest``), not from ``last``, in
    both packages."""
    if not os.path.isdir(run_dir):
        return None
    cands = sorted(f for f in os.listdir(run_dir)
                   if f.endswith(".ckpt") or re.fullmatch(r"\d{8}|latest|last", f))
    return os.path.join(run_dir, cands[-1]) if cands else None


def save_checkpoint(path: str, step: int, net: nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None) -> None:
    """Write a reference-format ``.ckpt``; ``optimizer`` is ``{}`` without one."""
    torch.save({"global_step": int(step), "model": net.state_dict(),
                "optimizer": optimizer.state_dict() if optimizer is not None else {}}, path)


def load_checkpoint(path: str) -> Tuple[Dict[str, torch.Tensor], int, Optional[Dict[str, Any]]]:
    """Read a reference-format ``.ckpt`` (or a bare state dict) on the CPU:
    (model state, global step, optimizer state or None)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, Mapping) and "model" in ckpt:
        return dict(ckpt["model"]), int(ckpt.get("global_step", 0)), ckpt.get("optimizer") or None
    return dict(ckpt), 0, None


def load_model_state(net: nn.Module, state: Mapping[str, torch.Tensor],
                     strict: bool = True) -> bool:
    """``load_state_dict`` with the reference's ``--load_nostrict`` meaning:
    with ``strict=False`` missing, extra and shape-mismatched entries keep the
    model's fresh initialisation (torch alone would raise on a shape mismatch).
    Returns whether every parameter of ``net`` came from ``state``."""
    own = net.state_dict()
    if not strict:
        state = {k: v for k, v in state.items() if k in own and own[k].shape == v.shape}
    net.load_state_dict(state, strict=strict)
    return set(state) >= set(own)


def _field_state(field: Mapping[str, Any], prefix: str) -> Dict[str, torch.Tensor]:
    mlp = field["mlp"]
    sd: Dict[str, torch.Tensor] = {}

    def put(torch_name: str, flax_name: str) -> None:
        layer = mlp[flax_name]
        sd[f"{prefix}.mlp.{torch_name}.weight"] = torch.from_numpy(
            np.array(np.asarray(layer["kernel"]).T, np.float32, order="C"))
        sd[f"{prefix}.mlp.{torch_name}.bias"] = torch.from_numpy(
            np.array(layer["bias"], np.float32))

    i = 0
    while f"pts_linears_{i}" in mlp:
        put(f"pts_linears.{i}", f"pts_linears_{i}")
        i += 1
    if "output_linear" in mlp:
        put("output_linear", "output_linear")
    else:
        for torch_name, flax_name in (("alpha_linear", "alpha_linear"),
                                      ("feature_linear", "feature_linear"),
                                      ("views_linears.0", "views_linears_0"),
                                      ("rgb_linear", "rgb_linear")):
            put(torch_name, flax_name)
    j = 0
    while f"sem_{j}" in mlp:  # Sequential(Linear, ReLU, Linear, ...): Linear j at 2j
        put(f"semantic_linear.{2 * j}", f"sem_{j}")
        j += 1
    return sd


def state_dict_from_jax_params(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax params ``{'coarse': {'mlp': ...}, 'fine': ...}`` -> a ``NeRFNet``
    state dict with keys ``nerf.mlp.*`` / ``nerf_fine.mlp.*``; a mip-NeRF's
    ``{'mip': {'mlp': ...}}`` -> a ``MipNeRFNet`` state dict with keys
    ``mip.mlp.*`` (the names of ``NeRFMLP``)."""
    if "mip" in params:
        return _field_state(params["mip"], "mip")
    sd = _field_state(params["coarse"], "nerf")
    if "fine" in params:
        sd.update(_field_state(params["fine"], "nerf_fine"))
    return sd


def _np32(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32, order="C"))


def vit_state_dict_from_jax_params(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax ViT params -> a ``models.vit.VisionTransformer`` state dict (the
    reference DINO names): Conv kernel ``[k, k, Cin, Cout]`` ->
    ``[Cout, Cin, k, k]``, Dense kernels transposed, LayerNorm ``scale`` ->
    ``weight``."""
    sd = {"cls_token": _np32(params["cls_token"]), "pos_embed": _np32(params["pos_embed"]),
          "patch_embed.proj.weight": _np32(np.asarray(params["patch_embed"]["kernel"])
                                           .transpose(3, 2, 0, 1)),
          "patch_embed.proj.bias": _np32(params["patch_embed"]["bias"]),
          "norm.weight": _np32(params["norm"]["scale"]), "norm.bias": _np32(params["norm"]["bias"])}
    i = 0
    while f"blocks_{i}" in params:
        blk, b = params[f"blocks_{i}"], f"blocks.{i}"
        for n in ("norm1", "norm2"):
            sd[f"{b}.{n}.weight"] = _np32(blk[n]["scale"])
            sd[f"{b}.{n}.bias"] = _np32(blk[n]["bias"])
        for torch_name, (grp, name) in (("attn.qkv", ("attn", "qkv")), ("attn.proj", ("attn", "proj")),
                                        ("mlp.fc1", ("mlp", "fc1")), ("mlp.fc2", ("mlp", "fc2"))):
            sd[f"{b}.{torch_name}.weight"] = _np32(np.asarray(blk[grp][name]["kernel"]).T)
            sd[f"{b}.{torch_name}.bias"] = _np32(blk[grp][name]["bias"])
        i += 1
    return sd


def synthetic_params_from_jax(params: Mapping[str, Any]) -> torch.Tensor:
    """``SyntheticExtractor.params`` of the JAX package -> the port's
    ``SyntheticExtractor(proj=...)`` projection ``[6, embed_dim]``."""
    return _np32(params["proj"])
