"""Faults planted in the port, for the readings and tests that show the
check catches them: each a context manager that breaks the timed path
underneath a run and mends it on exit.

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

import torch


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


SERVE = ("altered_answer", "subpixel_offset", "subpixel_argmax",
         "subpixel_temperature")
TRAIN = ("unchanged", "half_batch", "altered_loss")
