"""The driver of PSMNet: the port's entry points that the cells time, and
the faults planted in them (``architectures/__init__.py`` says what a
driver provides).

Serving is ``serving.InferenceSession`` under a ``PSMConfig``; training
is ``models.PsmNetwork`` in ``train()`` mode with
``training.optimizer.adam`` and ``training.trainer.train_step``. The port
is imported inside the functions, never when this module is.

The faults, each a context manager that breaks the timed path underneath
a run and mends it on exit:

* ``altered_answer``: every head's map moved by 10 px where it is made;
* ``temperature``: every head's softmax taken over half the cost, twice
  its temperature;
* ``altered_loss``: each train step's loss raised by a tenth where it is
  returned;
* ``half_batch``: half of each batch left out of the train step, the mean
  taken over the rest;
* ``unchanged``: Adam's step leaves the state as it was.
"""

from __future__ import annotations

import contextlib

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# The port has no PSMNet path in a precision below bfloat16.
CONTROLS: dict[str, dict] = {}
SERVE_FAULTS = ("altered_answer", "temperature")
TRAIN_FAULTS = ("unchanged", "half_batch", "altered_loss")


def program_config(config: dict, maximum_disparity: int):
    """The port's ``PSMConfig`` from the configuration file's keys."""
    from practicaldeepstereo_nips2018_tpu_torch.models import psmnet
    return psmnet.PSMConfig(
        maximum_disparity=maximum_disparity,
        pyramid_pools=tuple(config.get("pyramid_pools",
                                       psmnet.PSMConfig.pyramid_pools)))


def serving(config: dict, traffic: dict, weights: dict, device, **options):
    """(``InferenceSession.predict``, the session's network)."""
    from practicaldeepstereo_nips2018_tpu_torch.serving import (
        InferenceSession)
    session = InferenceSession(
        weights, program_config(config, config["serve_maximum_disparity"]),
        compute_dtype=DTYPES[config["compute_dtype"]], device=device,
        batched_mode=traffic["batched_mode"])
    return session.predict, session._network


class Training:
    """``PsmNetwork`` from ``weights`` on ``device`` in ``train()`` mode,
    Adam at the configuration's rate, betas and eps, and the port's train
    step."""

    def __init__(self, config: dict, weights: dict, device, **options):
        from practicaldeepstereo_nips2018_tpu_torch.models import psmnet
        from practicaldeepstereo_nips2018_tpu_torch.training import (
            optimizer, trainer)
        self._trainer = trainer
        self.config, self.device = config, device
        self.learning_rate = config["learning_rate"]
        self.program_config = program_config(
            config, config["train_maximum_disparity"])
        self.network = psmnet.PsmNetwork(self.program_config)
        self.network.load_state_dict(weights)
        self.network.to(device).train()
        adam = config["adam"]
        self.beta1 = adam["betas"][0]
        self.optimizer = optimizer.adam(self.network.parameters(),
                                        self.learning_rate, adam["betas"],
                                        adam["eps"])

    def step(self, left, right, ground_truth) -> torch.Tensor:
        # ``train_step`` is looked up on each call, where a fault replaces
        # it.
        return self._trainer.train_step(
            self.network, self.optimizer, left, right, ground_truth,
            self.learning_rate, self.program_config,
            DTYPES[self.config["compute_dtype"]], device=self.device)

    def gradient_magnitudes(self) -> dict:
        """The first gradient as Adam got it, from its state after one
        step: ``exp_avg = (1 - beta1) g`` (no state: 0)."""
        gradients = {}
        for name, value in self.network.named_parameters():
            average = self.optimizer.state.get(value, {}).get("exp_avg")
            gradients[name] = (torch.zeros_like(value) if average is None
                               else average / (1 - self.beta1))
        return gradients


# -- faults ------------------------------------------------------------------

@contextlib.contextmanager
def _replaced(owner, name: str, replacement):
    original = getattr(owner, name)
    setattr(owner, name, replacement(original))
    try:
        yield
    finally:
        setattr(owner, name, original)


def _altered_answer(original):
    def soft_argmin(*args, **kwargs):
        return original(*args, **kwargs) + 10.0
    return soft_argmin


def _temperature(original):
    def soft_argmin(cost, *args, **kwargs):
        return original(cost * 0.5, *args, **kwargs)
    return soft_argmin


def _altered_loss(original):
    def train_step(*args, **kwargs):
        return original(*args, **kwargs) * 1.1
    return train_step


def _half_batch(original):
    def loss_and_gradients(network, left, right, ground_truth, *args,
                           **kwargs):
        keep = max(1, left.shape[0] // 2)
        return original(network, left[:keep], right[:keep],
                        ground_truth[:keep], *args, **kwargs)
    return loss_and_gradients


def _unchanged(original):
    def step(self, closure=None):
        return None
    return step


def planted(name: str):
    """The context manager that plants fault ``name``."""
    from practicaldeepstereo_nips2018_tpu_torch.ops import regression
    from practicaldeepstereo_nips2018_tpu_torch.training import trainer
    places = {"altered_answer": (regression, "soft_argmin", _altered_answer),
              "temperature": (regression, "soft_argmin", _temperature),
              "altered_loss": (trainer, "train_step", _altered_loss),
              "half_batch": (trainer, "loss_and_gradients", _half_batch),
              "unchanged": (torch.optim.Adam, "step", _unchanged)}
    if name not in places:
        raise ValueError(f"unknown fault {name!r}; known: {sorted(places)}")
    return _replaced(*places[name])
