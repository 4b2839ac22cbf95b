"""The train and eval steps of the PDS trainer.

Port of the step functions of ``practicaldeepstereo_nips2018_tpu/training/
trainer.py::PDSTrainer`` (``_train_step``, ``_eval_step``) and of the
metadata its checkpoints carry (``_save_checkpoint``):

* :func:`train_step`: the similarities of :func:`~..models.network.apply`,
  the sub-pixel cross-entropy, its gradient and one RMSprop step at the
  given learning rate. On the card the hourglass's nine stride-1 3x3x3
  convs run K1 forward and K1 again for their input gradients.
* :func:`eval_step`: :func:`~..models.network.infer` (K1 and K2), then per
  example the 3-pixel error map and percentage and the mean absolute error
  (the JAX step ``vmap``s the metrics over the batch; here the batch loop
  is written out).

The epoch loop, logging and data come with the trainer class.
"""

from __future__ import annotations

import dataclasses

import torch

from practicaldeepstereo_nips2018_tpu_torch import models
from practicaldeepstereo_nips2018_tpu_torch.device import resolve_device
from practicaldeepstereo_nips2018_tpu_torch.ops import errors, loss
from practicaldeepstereo_nips2018_tpu_torch.training import optimizer as opt


def _as_disparities(ground_truth, device: torch.device) -> torch.Tensor:
    """``[B, H, W]`` numpy array or tensor -> float32 tensor on
    ``device``; unknown pixels stay ``inf``."""
    return torch.as_tensor(ground_truth, dtype=torch.float32, device=device)


def loss_and_gradients(network: models.PdsNetwork, left, right,
                       ground_truth, config: models.PDSConfig,
                       compute_dtype=None, loss_diversity: float = 1.0,
                       device: str | torch.device = "cuda"
                       ) -> torch.Tensor:
    """Sets every parameter's ``.grad`` to the gradient of the loss on this
    batch (replacing what was there) and returns the loss, detached."""
    device = resolve_device(device)
    for parameter in network.parameters():
        parameter.grad = None
    similarities = models.apply(network, left, right, config, compute_dtype,
                                device)
    value = loss.subpixel_cross_entropy(
        similarities, _as_disparities(ground_truth, device),
        diversity=loss_diversity, disparity_step=config.disparity_step)
    value.backward()
    return value.detach()


def train_step(network: models.PdsNetwork,
               optimizer: torch.optim.RMSprop, left, right, ground_truth,
               learning_rate: float,
               config: models.PDSConfig = models.PDSConfig(),
               compute_dtype=None, loss_diversity: float = 1.0,
               device: str | torch.device = "cuda") -> torch.Tensor:
    """One optimisation step on a batch; returns the loss as a device
    scalar (reading it waits for the card).

    Args:
        network: the weights (float32), on ``device``; updated in place.
        optimizer: RMSprop over ``network.parameters()``
            (:func:`~.optimizer.rmsprop`).
        left, right: ``[B, H, W, 3]`` images, 0..255.
        ground_truth: ``[B, H, W]`` disparities, unknown pixels ``inf``.
        learning_rate: this step's rate (:func:`~.optimizer.multistep_lr`
            of the epoch).
        config: static network configuration.
        compute_dtype: e.g. ``torch.bfloat16``; parameters, gradients and
            the optimizer state stay float32.
        loss_diversity: Laplace diversity of the loss target.
        device: ``"cuda"`` (default) or ``"cpu"``.

    The gradients stay in ``.grad`` after the step.
    """
    value = loss_and_gradients(network, left, right, ground_truth, config,
                               compute_dtype, loss_diversity, device)
    opt.set_learning_rate(optimizer, learning_rate)
    optimizer.step()
    return value


@torch.no_grad()
def eval_step(network: models.PdsNetwork, left, right, ground_truth,
              config: models.PDSConfig = models.PDSConfig(),
              compute_dtype=None, device: str | torch.device = "cuda"):
    """Returns (disparity ``[B, H, W]``, 3-pixel error map ``[B, H, W]``,
    3-pixel error in percent ``[B]``, mean absolute error ``[B]``), each
    example's metrics over its own known pixels."""
    device = resolve_device(device)
    disparity = models.infer(network, left, right, config, compute_dtype,
                             device)
    error_maps, three_pixels_errors, mean_absolute_errors = [], [], []
    for estimated, truth in zip(disparity,
                                _as_disparities(ground_truth, device)):
        error_map, three_pixels_error = errors.n_pixels_error(estimated,
                                                              truth)
        _, mean_absolute_error = errors.absolute_error(estimated, truth)
        error_maps.append(error_map)
        three_pixels_errors.append(three_pixels_error)
        mean_absolute_errors.append(mean_absolute_error)
    return (disparity, torch.stack(error_maps),
            torch.stack(three_pixels_errors),
            torch.stack(mean_absolute_errors))


def checkpoint_metadata(config: models.PDSConfig,
                        training_losses=(), test_errors=(),
                        initial_learning_rate: float = 1e-2,
                        milestones=(6, 7, 8, 9, 10), gamma: float = 0.5,
                        loss_diversity: float = 1.0) -> dict:
    """The metadata the JAX trainer writes with each checkpoint (its
    ``_save_checkpoint``), under the same keys, so that either package's
    trainer reads it."""
    return {
        "training_losses": [float(value) for value in training_losses],
        "test_errors": list(test_errors),
        "learning_rate_scheduler": {
            "initial_learning_rate": initial_learning_rate,
            "milestones": list(milestones),
            "gamma": gamma,
        },
        "network_config": dataclasses.asdict(config),
        "loss_diversity": loss_diversity,
    }
