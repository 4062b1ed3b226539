"""Optimizer, LR schedule and the semantic-head filter for training.

Port of ``nerfsos_tpu/engines/state.py``:

- :func:`exp_decay_schedule`: ``lr * rate^(step / steps)``, continuous in the
  step (the reference's ``engines/lr.py``);
- :func:`make_optimizer`: ``torch.optim.Adam`` with b1 0.9, b2 0.999, eps
  1e-8, as optax's ``adam``; the caller sets the LR before each update with
  :func:`set_lr`. Update ``k`` (0-based, counted in global steps, so from the
  resumed step on a resume) uses ``lr(k)``, as optax's ``scale_by_schedule``
  does. With ``fix_backbone`` (the frozen SOS finetune) Adam holds the
  semantic head alone and every other parameter stops requiring gradients,
  as the reference does (``run_nerf.py:307-318``), so the frozen leaves stay
  bit-equal (optax's ``multi_transform`` with ``set_to_zero``); without it
  Adam holds every parameter of a model, each requiring gradients;
- :func:`fast_forward_lr`: the LR of a resume whose Adam moments start fresh
  (a partial model load, or optimizer state that does not fit): the moments
  and their bias correction start at zero and the LR follows ``global_step``
  (the reference's ``scheduler.step(global_step)``);
- :func:`semantic_head_mask`: which parameters a ``--fix_backbone`` finetune
  trains (the reference's name test ``'semantic_linear' in name``).
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Union

import torch
import torch.nn as nn


def exp_decay_schedule(init_lr: float, decay_rate: float,
                       decay_steps: float) -> Callable[[float], float]:
    """``lr(step) = init_lr * decay_rate^(step / decay_steps)``."""

    def schedule(step: float) -> float:
        return init_lr * (decay_rate ** (step / decay_steps))

    return schedule


def make_optimizer(params: Union[Iterable[torch.Tensor], nn.Module], init_lr: float,
                   fix_backbone: bool = False) -> torch.optim.Adam:
    """Adam over ``params`` (tensors, or a model's parameters); with
    ``fix_backbone``, ``params`` is the model, and only its semantic head is
    trained. Without it, a model's every parameter requires gradients again."""
    if fix_backbone:
        mask = semantic_head_mask(params)
        for name, p in params.named_parameters():
            p.requires_grad_(mask[name])
        params = [p for name, p in params.named_parameters() if mask[name]]
    elif isinstance(params, nn.Module):
        params = list(params.parameters())
        for p in params:  # a module a --fix_backbone run froze trains again
            p.requires_grad_(True)
    return torch.optim.Adam(params, lr=init_lr, betas=(0.9, 0.999), eps=1e-8)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def fast_forward_lr(optimizer: torch.optim.Optimizer, schedule: Callable[[float], float],
                    global_step: int) -> None:
    """Fresh Adam moments, the LR of ``global_step``."""
    optimizer.state.clear()
    set_lr(optimizer, schedule(global_step))


def semantic_head_mask(net: nn.Module) -> Dict[str, bool]:
    """True for the semantic head's parameters (``semantic_linear.*``)."""
    return {name: "semantic_linear" in name for name, _ in net.named_parameters()}
