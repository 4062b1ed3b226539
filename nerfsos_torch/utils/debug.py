"""Numerical guards for ``--debug_nans``.

Port of ``nerfsos_tpu/utils/debug.py``'s host checks (the reference's nan/inf
printers, ``utils/error.py``): ``check``, ``check_zero`` and
``check_all_zero`` print a diagnostic line per tensor; ``assert_finite``
raises ``FloatingPointError`` naming the first leaf that holds a nan or inf.
The JAX module's ``enable_nan_debugging`` has no copy here: the port's
``--debug_nans`` turns on ``torch.autograd.set_detect_anomaly`` and calls
``assert_finite`` on each step's loss and gradients (``run_nerf.main``), the
latter because the fused RGB step computes its gradients in a kernel, where
anomaly mode sees nothing.
"""
from __future__ import annotations

from typing import Iterable, Mapping, Tuple, Union

import torch

Tensors = Union[torch.Tensor, Mapping[str, torch.Tensor], Iterable[torch.Tensor]]


def _bad(t) -> bool:
    t = torch.as_tensor(t)
    return bool(torch.isnan(t).any() or torch.isinf(t).any())


def check(**tensors) -> None:
    """Print whether each tensor holds a nan or inf."""
    for name, t in tensors.items():
        print(f"! [Numerical] {name}: nan/inf={_bad(t)}")


def check_zero(**tensors) -> None:
    for name, t in tensors.items():
        print(f"! [Numerical] {name}: any_zero={bool((torch.as_tensor(t) == 0).any())}")


def check_all_zero(**tensors) -> None:
    for name, t in tensors.items():
        print(f"! [Numerical] {name}: all_zero={bool((torch.as_tensor(t) == 0).all())}")


def _leaves(tree: Tensors, name: str) -> Iterable[Tuple[str, torch.Tensor]]:
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _leaves(v, f"{name}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{name}[{i}]")
    elif tree is not None:
        yield name, tree


def assert_finite(tensors: Tensors, name: str = "tree") -> None:
    """Raise ``FloatingPointError`` naming the first leaf of ``tensors`` (a
    tensor, or a dict, list or tuple of them, nested) with a nan or inf."""
    for path, leaf in _leaves(tensors, name):
        if not bool(torch.isfinite(torch.as_tensor(leaf)).all()):
            raise FloatingPointError(f"{path} has nan/inf")
