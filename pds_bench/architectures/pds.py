"""The yardstick of Practical Deep Stereo (``architectures/__init__.py``
says what a yardstick provides).

It wraps the plain float32 reference (``reference.py``) and the frozen
accounting (``accounting.py``), and imports nothing of the port. Serving is
judged per pixel of a seeded sample of the served maps against the
reference's scores on the same weights and images; training by the
reference's RMSprop steps from the same weights on the same first
batches.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pds_bench import accounting, reference

# The reference in the precisions below bfloat16's, every conv operand and
# result and their gradients rounded: the controls of ``calibrate.py``.
LOWERED = {"fp8": reference.fp8_e4m3, "bf16": reference.bfloat16}


def _exact(x: torch.Tensor) -> torch.Tensor:
    return x


def padded_size(config: dict) -> tuple[int, int]:
    """(height, width) padded to multiples of ``minimum_size``."""
    multiple = config["minimum_size"]
    return (-(-config["height"] // multiple) * multiple,
            -(-config["width"] // multiple) * multiple)


def weight_layout(config: dict) -> dict[str, dict]:
    """Under the reference's state_dict keys: conv weights and biases drawn
    at PyTorch's default bound (``fan_in`` the weight's second dimension
    times its taps); instance norms filled with weight 1 and bias 0."""
    shapes = reference.parameter_shapes(config)
    layout = {}
    for key, shape in shapes.items():
        weight_shape = shapes[key.rsplit(".", 1)[0] + ".weight"]
        if len(weight_shape) > 1:
            layout[key] = {"shape": shape,
                           "fan_in": int(np.prod(weight_shape[1:]))}
        else:
            layout[key] = {"shape": shape,
                           "fill": 1.0 if key.endswith("weight") else 0.0}
    return layout


def reference_map(weights: dict, config: dict, left, right,
                  maximum_disparity: int, quantize=_exact) -> torch.Tensor:
    """The reference's sub-pixel maps ``[B, H, W]`` of ``[B, H, W, 3]``
    images, one image at a time, TF32 off."""
    network = reference.Network(weights, config, quantize)
    with torch.no_grad(), reference.exact_float32():
        return torch.cat([reference.subpixel_map(
            network.similarities(left[i:i + 1], right[i:i + 1],
                                 maximum_disparity),
            config["estimator_half_support_window"],
            config["disparity_step"]) for i in range(left.shape[0])])


def served_gaps(similarities: torch.Tensor, disparity: torch.Tensor,
                half_support_window: int, disparity_step: int
                ) -> torch.Tensor:
    """Per pixel, how far the reference's best score lies above its best
    score among the levels that the served disparity can have come from
    (those within the estimator's window of it, which hold the served
    map's own best level): 0 where the served map sits on the reference's
    best, infinite where it is not finite or out of range.

    ``similarities`` ``[B, L, H, W]``, ``disparity`` ``[B, H, W]``."""
    levels = torch.arange(similarities.shape[1], device=similarities.device,
                          dtype=similarities.dtype).view(1, -1, 1, 1)
    inside = ((disparity_step * levels - disparity[:, None]).abs()
              <= half_support_window)
    chosen = similarities.masked_fill(~inside, -math.inf).amax(dim=1)
    return similarities.amax(dim=1) - chosen


def serve_readings(weights: dict, config: dict, left, right, maps: dict,
                   maximum_disparity: int, device) -> dict:
    """Per pixel of the sampled maps, against the float32 reference (TF32
    off) on the same weights and images: ``gap`` (:func:`served_gaps`),
    which judges the scores' best level, and ``offset``, the distance in
    pixels between the served disparity and the reference's own sub-pixel
    estimate, which judges the estimator's sub-pixel step."""
    network = reference.Network(weights, config)
    window = config["estimator_half_support_window"]
    step = config["disparity_step"]
    gaps, offsets = [], []
    with torch.no_grad(), reference.exact_float32():
        for key, served in maps.items():
            for image in range(served.shape[0]):
                scores = network.similarities(
                    torch.as_tensor(left[key][image:image + 1],
                                    device=device),
                    torch.as_tensor(right[key][image:image + 1],
                                    device=device), maximum_disparity)
                disparity = torch.as_tensor(served[image:image + 1],
                                            device=device)
                gaps.append(served_gaps(scores, disparity, window, step
                                        ).flatten().cpu())
                offsets.append((disparity - reference.subpixel_map(
                    scores, window, step)).abs().flatten().cpu())
                del scores
    return {"gap": torch.cat(gaps).double(),
            "offset": torch.cat(offsets).double()}


def serve_numbers(readings: dict) -> dict:
    """The numbers compared for a serving cell: the mean square gap and the
    share of pixels whose gap is over 0.1 (the best level); over the pixels
    whose gap is 0, the mean offset and the share of offsets over 0.25 px
    (the sub-pixel step)."""
    gaps, offsets = readings["gap"], readings["offset"]
    agreed = offsets[gaps == 0]
    return {"gap_square_mean": float((gaps ** 2).mean()),
            "share_over_0.1": float((gaps > 0.1).double().mean()),
            "offset_mean_px": float(agreed.mean()),
            "offset_share_over_0.25": float((agreed > 0.25).double().mean())}


def serve_diagnostics(readings: dict) -> dict:
    gaps, offsets = readings["gap"], readings["offset"]
    agreed = offsets[gaps == 0]
    quantiles = torch.quantile(agreed.float(), torch.tensor(
        [0.5, 0.9, 0.99])).tolist() if agreed.numel() else [math.nan] * 3
    return {"gap_max": float(gaps.max()), "gap_mean": float(gaps.mean()),
            "share_over_0.05": float((gaps > 0.05).double().mean()),
            "share_over_0.2": float((gaps > 0.2).double().mean()),
            "agreed_share": agreed.numel() / gaps.numel(),
            "offset_max_px": float(agreed.max()) if agreed.numel() else
            math.nan,
            "offset_quantiles_px": quantiles,
            "offset_share_over_0.5": float((agreed > 0.5).double().mean()),
            "offset_share_over_1": float((agreed > 1.0).double().mean()),
            "pixels": int(gaps.numel())}


def reference_steps(weights: dict, config: dict, batches,
                    maximum_disparity: int, quantize=_exact):
    """The sub-pixel cross-entropy and RMSprop of the configuration, TF32
    off (``reference.steps``)."""
    with reference.exact_float32():
        return reference.steps(
            weights, config, batches, maximum_disparity,
            config["learning_rate"], config["rmsprop"]["alpha"],
            config["rmsprop"]["eps"], config["loss_diversity"], quantize)


def useful_macs(config: dict, kind: str) -> int:
    """Useful multiply-adds of one image at the padded size: a forward pass
    to serve, the forward and both gradient passes to train."""
    count = (accounting.forward_useful_macs if kind == "serve"
             else accounting.train_useful_macs)
    return count(*padded_size(config), config[f"{kind}_maximum_disparity"],
                 config["number_of_regularization_features"])
