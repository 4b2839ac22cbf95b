"""The driver of Practical Deep Stereo: the port's entry points that the
cells time, and the faults planted in them (``architectures/__init__.py``
says what a driver provides).

Serving is ``serving.InferenceSession``; training is ``models.PdsNetwork``
with ``training.optimizer.rmsprop`` and ``training.trainer.train_step``.
The port is imported inside the functions, never when this module is.

The faults, each a context manager that breaks the timed path underneath
a run and mends it on exit:

* ``altered_answer``: the estimator's map moved by 10 px where it is made;
* ``subpixel_offset``: the estimator's map moved by 1 px, inside its own
  window, so that only the sub-pixel step is wrong;
* ``subpixel_argmax``: the estimator's window cut to its best level, so
  that the map is the best level's disparity with no sub-pixel step;
* ``subpixel_temperature``: the estimator's softmax taken over half the
  scores, twice its temperature;
* ``altered_loss``: each train step's loss raised by a tenth where it is
  returned;
* ``half_batch``: half of each batch left out of the train step, the mean
  taken over the rest;
* ``unchanged``: the optimizer step leaves the state as it was.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# The port's own int8 path, the nearest precision below bfloat16 it has.
CONTROLS = {"int8": {"matching_tail_int8": True}}
SERVE_FAULTS = ("altered_answer", "subpixel_offset", "subpixel_argmax",
                "subpixel_temperature")
TRAIN_FAULTS = ("unchanged", "half_batch", "altered_loss")


def program_config(config: dict, maximum_disparity: int, **options):
    """The port's ``PDSConfig`` from the configuration file's keys."""
    from practicaldeepstereo_nips2018_tpu_torch.models import network
    fields = {field.name for field in dataclasses.fields(network.PDSConfig)}
    values = {key: value for key, value in config.items() if key in fields}
    values.update(options, maximum_disparity=maximum_disparity)
    return network.PDSConfig(**values)


def serving(config: dict, traffic: dict, weights: dict, device, **options):
    """(``InferenceSession.predict``, the session's network)."""
    from practicaldeepstereo_nips2018_tpu_torch.serving import (
        InferenceSession)
    session = InferenceSession(
        weights, program_config(config, config["serve_maximum_disparity"],
                                **options),
        compute_dtype=DTYPES[config["compute_dtype"]], device=device,
        batched_mode=traffic["batched_mode"])
    return session.predict, session._network


class Training:
    """``PdsNetwork`` from ``weights`` on ``device``, RMSprop at the
    configuration's learning rate, and the port's train step."""

    def __init__(self, config: dict, weights: dict, device, **options):
        from practicaldeepstereo_nips2018_tpu_torch.models import network
        from practicaldeepstereo_nips2018_tpu_torch.training import (
            optimizer, trainer)
        self._trainer = trainer
        self.config, self.device = config, device
        self.learning_rate = config["learning_rate"]
        self.program_config = program_config(
            config, config["train_maximum_disparity"], **options)
        self.network = network.PdsNetwork(self.program_config)
        self.network.load_state_dict(weights)
        self.network.to(device)
        self.optimizer = optimizer.rmsprop(self.network.parameters(),
                                           self.learning_rate)

    def step(self, left, right, ground_truth) -> torch.Tensor:
        # ``train_step`` is looked up on each call, where a fault replaces
        # it.
        return self._trainer.train_step(
            self.network, self.optimizer, left, right, ground_truth,
            self.learning_rate, self.program_config,
            DTYPES[self.config["compute_dtype"]],
            self.config["loss_diversity"], self.device)

    def gradient_magnitudes(self) -> dict:
        """The magnitude of each element of the first gradient as RMSprop
        got it, from its state after one step: ``avg = (1 - alpha) g^2``
        (no state: 0)."""
        alpha = self.config["rmsprop"]["alpha"]
        magnitudes = {}
        for name, value in self.network.named_parameters():
            average = self.optimizer.state.get(value, {}).get("square_avg")
            magnitudes[name] = (torch.zeros_like(value) if average is None
                                else (average / (1 - alpha)).sqrt())
        return magnitudes


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
    def subpixel_map(*args, **kwargs):
        return original(*args, **kwargs) + 10.0
    return subpixel_map


def _subpixel_offset(original):
    def subpixel_map(*args, **kwargs):
        return original(*args, **kwargs) + 1.0
    return subpixel_map


def _estimator_arguments(args, kwargs) -> tuple:
    """(scores, half_support_window, disparity_step) of a call of
    ``subpixel_map(similarities, half_support_window=4,
    disparity_step=2)``."""
    values = dict(zip(("similarities", "half_support_window",
                       "disparity_step"), args), **kwargs)
    return (values["similarities"], values.get("half_support_window", 4),
            values.get("disparity_step", 2))


def _subpixel_argmax(original):
    def subpixel_map(*args, **kwargs):
        scores, _, step = _estimator_arguments(args, kwargs)
        return step * scores.argmax(dim=-1).float()
    return subpixel_map


def _subpixel_temperature(original):
    def subpixel_map(*args, **kwargs):
        scores, window, step = _estimator_arguments(args, kwargs)
        return original(scores * 0.5, window, step)
    return subpixel_map


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
    from practicaldeepstereo_nips2018_tpu_torch.ops import subpixel
    from practicaldeepstereo_nips2018_tpu_torch.training import trainer
    places = {"altered_answer": (subpixel, "subpixel_map", _altered_answer),
              "subpixel_offset": (subpixel, "subpixel_map", _subpixel_offset),
              "subpixel_argmax": (subpixel, "subpixel_map", _subpixel_argmax),
              "subpixel_temperature": (subpixel, "subpixel_map",
                                       _subpixel_temperature),
              "altered_loss": (trainer, "train_step", _altered_loss),
              "half_batch": (trainer, "loss_and_gradients", _half_batch),
              "unchanged": (torch.optim.RMSprop, "step", _unchanged)}
    if name not in places:
        raise ValueError(f"unknown fault {name!r}; known: {sorted(places)}")
    return _replaced(*places[name])
