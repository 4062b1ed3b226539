"""The JAX entry point's seeded initial weights for the port's NeRF MLPs.

``run_nerf.build_model`` builds the net (each layer drawn by the flax law
from torch's generator, ``models/mlp.flax_dense_init_``) and then hands it
to :func:`jax_seeded_init_`, which overwrites every ``nn.Linear`` of its
MLPs with the values the JAX package's ``run_nerf.main`` draws at the same
``--seed``: ``key, init_key = split(PRNGKey(seed))``; a classic net's
coarse and fine fields take the two halves of ``split(init_key)``, a
mip-NeRF's field ``init_key`` itself; each flax ``Dense`` ``mlp/<name>``
draws its kernel by ``lecun_normal`` from its path's key, and its bias is
zero. The draws come from ``utils/jax_random`` (numpy, no JAX).

Why the draws and not only the law: the SOS quality gate
(``tools/validate_sos_protocol``) passes or fails by the initial draw of
the net it pretrains. From torch's draws of the same law both of its fp32
finetunes fell to a held-out clus ARI of ~0.04; from the JAX entry point's
draws they reach ~0.98, as the JAX package's own runs did (PERF.md §6).
The port's seeded runs start where the JAX package's start.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from nerfsos_torch.utils import jax_random as jr


def flax_layer_name(name: str) -> str:
    """A ``NeRFMLP`` layer's name -> the JAX ``NeRFMLP``'s Dense name:
    ``pts_linears.3`` -> ``pts_linears_3``, ``views_linears.0`` ->
    ``views_linears_0``, ``semantic_linear.2`` -> ``sem_1`` (the Linear at
    Sequential index 2j is ``sem_j``); the others keep theirs."""
    if name.startswith("semantic_linear."):
        return f"sem_{int(name.split('.')[1]) // 2}"
    return name.replace(".", "_")


def field_keys(net: nn.Module, seed: int) -> dict:
    """``{field attribute: init key}`` as the JAX entry point splits them."""
    init_key = jr.split(jr.prng_key(seed))[1]
    if hasattr(net, "mip"):
        return {"mip": init_key}
    coarse, fine = jr.split(init_key)
    return {"nerf": coarse, "nerf_fine": fine}


@torch.no_grad()
def jax_seeded_init_(net: nn.Module, seed: int) -> None:
    """Overwrite the MLP layers of ``net`` (a ``NeRFNet`` or ``MipNeRFNet``)
    with the JAX entry point's initial weights at ``seed``."""
    for attr, key in field_keys(net, seed).items():
        field = getattr(net, attr, None)
        mlp = getattr(field, "mlp", None)
        if mlp is None:
            continue
        for name, layer in mlp.named_modules():
            if not isinstance(layer, nn.Linear):
                continue
            k = jr.flax_key(key, ("mlp", flax_layer_name(name), 1))
            kernel = jr.lecun_normal(k, (layer.in_features, layer.out_features))
            layer.weight.copy_(torch.from_numpy(np.ascontiguousarray(kernel.T)))
            layer.bias.zero_()
