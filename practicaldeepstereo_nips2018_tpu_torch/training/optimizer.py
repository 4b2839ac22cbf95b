"""Optimizer and learning-rate schedule of the reference's training.

Port of ``practicaldeepstereo_nips2018_tpu/training/optimizer.py``. The
reference trains with ``torch.optim.RMSprop(lr=1e-2)`` and the other torch
defaults (alpha 0.99, eps 1e-8 outside the square root, no momentum, square
average starting at zero; reference ``train_on_flyingthings3d.py:68``); the
JAX package configured optax to that update. The schedule is torch's
``MultiStepLR(milestones=[6..10], gamma=0.5)`` stepped per epoch, written
as a pure function of the epoch index; :func:`set_learning_rate` puts its
value on the optimizer before each step. PSMNet trains with
:func:`adam` (its ``main.py``).
"""

from __future__ import annotations

from typing import Iterable, Sequence

import torch


def rmsprop(parameters: Iterable[torch.nn.Parameter],
            learning_rate: float = 1e-2) -> torch.optim.RMSprop:
    """Torch RMSprop: ``p -= lr * g / (sqrt(avg) + 1e-8)`` with
    ``avg = 0.99 * avg + 0.01 * g^2``. ``learning_rate`` is the starting
    rate; :func:`set_learning_rate` changes it."""
    return torch.optim.RMSprop(parameters, lr=learning_rate, alpha=0.99,
                               eps=1e-8)


def adam(parameters: Iterable[torch.nn.Parameter],
         learning_rate: float = 1e-3, betas: Sequence[float] = (0.9, 0.999),
         eps: float = 1e-8) -> torch.optim.Adam:
    """Torch Adam, PSMNet's optimiser: ``lr=1e-3``, ``betas=(0.9, 0.999)``,
    ``eps=1e-8`` outside the square root, no weight decay."""
    return torch.optim.Adam(parameters, lr=learning_rate, betas=tuple(betas),
                            eps=eps)


def multistep_lr(initial_learning_rate: float,
                 milestones: Sequence[int] = (6, 7, 8, 9, 10),
                 gamma: float = 0.5):
    """Returns epoch -> learning rate: ``gamma`` applied once for each
    milestone the (0-based) epoch index has reached."""
    milestones = sorted(milestones)

    def schedule(epoch: int) -> float:
        decays = sum(1 for milestone in milestones if epoch >= milestone)
        return initial_learning_rate * (gamma ** decays)

    return schedule


def set_learning_rate(optimizer: torch.optim.Optimizer,
                      learning_rate: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = learning_rate
