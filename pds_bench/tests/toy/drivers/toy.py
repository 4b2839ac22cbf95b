"""The driver of the toy stereo regressor: the program under test is a
``torch.nn`` module (``nn.Conv2d``, ``nn.BatchNorm2d``) trained with
``torch.optim.Adam``, which the toy yardstick judges."""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

CONTROLS: dict[str, dict] = {}
SERVE_FAULTS = ("altered_answer",)
TRAIN_FAULTS = ("unchanged",)


class Regressor(nn.Module):
    def __init__(self, features: int, maximum_disparity: int):
        super().__init__()
        self.tower = nn.Sequential(
            nn.Conv2d(3, features, 3, padding=1), nn.BatchNorm2d(features),
            nn.ReLU(), nn.Conv2d(features, features, 3, padding=1))
        self.maximum_disparity = maximum_disparity

    def forward(self, left: torch.Tensor, right: torch.Tensor
                ) -> torch.Tensor:
        features_left = self.tower(left.permute(0, 3, 1, 2) / 255.0)
        features_right = self.tower(right.permute(0, 3, 1, 2) / 255.0)
        width = features_right.shape[-1]
        volume = torch.stack([
            (features_left * F.pad(features_right[..., :width - d], (d, 0))
             ).mean(dim=1) for d in range(self.maximum_disparity)], dim=1)
        levels = torch.arange(self.maximum_disparity, device=left.device,
                              dtype=volume.dtype).view(1, -1, 1, 1)
        return (torch.softmax(volume, dim=1) * levels).sum(dim=1)


def serving(config: dict, traffic: dict, weights: dict, device, **options):
    network = Regressor(config["features"], config["serve_maximum_disparity"])
    network.load_state_dict(weights)
    network.to(device).eval()

    def predict(left: np.ndarray, right: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            return network(torch.as_tensor(left, device=device),
                           torch.as_tensor(right, device=device)
                           ).cpu().numpy()

    return predict, network


class Training:
    def __init__(self, config: dict, weights: dict, device, **options):
        self.network = Regressor(config["features"],
                                 config["train_maximum_disparity"])
        self.network.load_state_dict(weights)
        self.network.to(device).train()
        betas = tuple(config["adam"]["betas"])
        self.beta2 = betas[1]
        self.optimizer = torch.optim.Adam(
            self.network.parameters(), lr=config["learning_rate"],
            betas=betas, eps=config["adam"]["eps"])

    def step(self, left, right, ground_truth) -> torch.Tensor:
        self.optimizer.zero_grad(set_to_none=True)
        known = torch.isfinite(ground_truth)
        loss = F.smooth_l1_loss(self.network(left, right)[known],
                                ground_truth[known])
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    def gradient_magnitudes(self) -> dict:
        """From Adam's state after one step: ``exp_avg_sq = (1 - beta2)
        g^2`` (no state: 0)."""
        magnitudes = {}
        for name, value in self.network.named_parameters():
            average = self.optimizer.state.get(value, {}).get("exp_avg_sq")
            magnitudes[name] = (torch.zeros_like(value) if average is None
                                else (average / (1 - self.beta2)).sqrt())
        return magnitudes


@contextlib.contextmanager
def _replaced(owner, name: str, replacement):
    original = getattr(owner, name)
    setattr(owner, name, replacement)
    try:
        yield
    finally:
        setattr(owner, name, original)


def planted(name: str):
    """``altered_answer``: every map moved by 1 px; ``unchanged``: Adam's
    step leaves the state as it was."""
    forward = Regressor.forward
    places = {"altered_answer": (Regressor, "forward",
                                 lambda *args: forward(*args) + 1.0),
              "unchanged": (torch.optim.Adam, "step",
                            lambda self, closure=None: None)}
    if name not in places:
        raise ValueError(f"unknown fault {name!r}; known: {sorted(places)}")
    return _replaced(*places[name])
