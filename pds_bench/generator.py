"""The general generator: weights and traffic from ``--seed``.

Everything a run feeds the program, and the reference, is made here from
the seed, the configuration file and the traffic file, on the device, in a
few large calls:

* weights: under the keys of the architecture's ``weight_layout``, one
  uniform draw over the keys it draws, in its order, each scaled to
  PyTorch's default bound ``1 / sqrt(fan_in)``; the other keys filled with
  the value it gives them;
* stereo pairs: the left image uniform over 0..255, the right image the
  left one moved left by a whole disparity drawn per pair from the traffic's
  ``shift_range``, with uniform noise of +-``noise`` grey levels added;
* ground truth (training): uniform over ``[0, maximum)`` of the
  configuration's ``ground_truth``, its ``unknown_share`` of pixels
  infinite.

Every seed gives the same sizes and counts; only the values differ.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _generator(seed: int, device: torch.device, stream: int
               ) -> torch.Generator:
    """A generator for one stream of draws: the seed and the stream's
    number mixed, so the weights and the images never share draws."""
    generator = torch.Generator(device=device)
    generator.manual_seed((int(seed) * 1000003 + stream) % (2 ** 63))
    return generator


def make_weights(layout: dict[str, dict], seed: int, device
                 ) -> dict[str, torch.Tensor]:
    """The weights that ``layout`` (a yardstick's ``weight_layout``)
    describes, on ``device``, in its order."""
    device = torch.device(device)
    drawn = [key for key, entry in layout.items() if "fan_in" in entry]
    sizes = [int(np.prod(layout[key]["shape"])) for key in drawn]
    uniform = torch.rand(sum(sizes), generator=_generator(seed, device, 1),
                         device=device) * 2 - 1
    weights = {}
    offset = 0
    for key, size in zip(drawn, sizes):
        entry = layout[key]
        weights[key] = (uniform[offset:offset + size].view(entry["shape"])
                        / np.sqrt(entry["fan_in"]))
        offset += size
    for key, entry in layout.items():
        if key not in weights:
            weights[key] = torch.full(
                entry["shape"], entry["fill"], device=device,
                dtype=getattr(torch, entry.get("dtype", "float32")))
    return {key: weights[key] for key in layout}


@dataclasses.dataclass
class Pairs:
    """``count`` stereo pairs of ``batch`` images each: ``left`` and
    ``right`` ``[count, batch, H, W, 3]`` float32, 0..255."""
    left: torch.Tensor
    right: torch.Tensor


def make_pairs(config: dict, traffic: dict, seed: int, device, count: int
               ) -> Pairs:
    device = torch.device(device)
    generator = _generator(seed, device, 2)
    batch = traffic["batch"]
    height, width = config["height"], config["width"]
    shape = (count, batch, height, width, 3)
    left = torch.rand(shape, generator=generator, device=device) * 255.0
    low, high = traffic["shift_range"]
    shifts = torch.randint(low, high + 1, (count,), generator=generator,
                           device=device).tolist()
    noise = (torch.rand(shape, generator=generator, device=device) * 2 - 1
             ) * traffic["noise"]
    right = torch.stack([torch.roll(left[index], -shift, dims=2)
                         for index, shift in enumerate(shifts)])
    right = (right + noise).clamp_(0.0, 255.0)
    return Pairs(left, right)


def make_ground_truth(config: dict, traffic: dict, seed: int, device,
                      count: int) -> torch.Tensor:
    """``[count, batch, H, W]`` float32 disparities."""
    device = torch.device(device)
    generator = _generator(seed, device, 3)
    shape = (count, traffic["batch"], config["height"], config["width"])
    truth = config["ground_truth"]
    values = torch.rand(shape, generator=generator, device=device
                        ) * truth["maximum"]
    unknown = torch.rand(shape, generator=generator, device=device
                         ) < truth["unknown_share"]
    return values.masked_fill_(unknown, float("inf"))
