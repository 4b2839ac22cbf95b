"""The yardstick of a toy stereo regressor, a second architecture that
the harness's tests bring in from new files only.

The network: a shared tower, conv 3x3 -> BatchNorm -> ReLU -> conv 3x3,
on each image; a correlation volume (the channel mean of the left
features times the right ones moved right by ``d``, zero fill) over
``maximum_disparity`` levels; a softmax over the levels and its expected
disparity. Training: a smooth L1 loss over the known pixels, BatchNorm on
the batch's statistics, and Adam. Written functionally in float32, it
imports nothing of the driver it judges.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pds_bench import reference

BATCH_NORM_EPS = 1e-5
LOWERED = {"bf16": reference.bfloat16}


def _exact(x: torch.Tensor) -> torch.Tensor:
    return x


def weight_layout(config: dict) -> dict[str, dict]:
    features = config["features"]
    norm = {"shape": (features,)}
    return {
        "tower.0.weight": {"shape": (features, 3, 3, 3), "fan_in": 27},
        "tower.0.bias": {"shape": (features,), "fan_in": 27},
        "tower.1.weight": dict(norm, fill=1.0),
        "tower.1.bias": dict(norm, fill=0.0),
        "tower.1.running_mean": dict(norm, fill=0.0),
        "tower.1.running_var": dict(norm, fill=1.0),
        "tower.1.num_batches_tracked": {"shape": (), "fill": 0,
                                        "dtype": "int64"},
        "tower.3.weight": {"shape": (features, features, 3, 3),
                           "fan_in": 9 * features},
        "tower.3.bias": {"shape": (features,), "fan_in": 9 * features},
    }


def disparity(p: dict, left, right, maximum_disparity: int,
              training: bool = False, quantize=_exact) -> torch.Tensor:
    """``[B, H, W, 3]`` images (0..255) -> ``[B, H, W]`` disparities."""

    def tower(image):
        x = quantize(image.permute(0, 3, 1, 2).float() / 255.0)
        x = quantize(F.conv2d(x, quantize(p["tower.0.weight"]),
                              p["tower.0.bias"], padding=1))
        if training:
            mean = x.mean(dim=(0, 2, 3))
            variance = x.var(dim=(0, 2, 3), unbiased=False)
        else:
            mean = p["tower.1.running_mean"]
            variance = p["tower.1.running_var"]
        x = ((x - mean.view(1, -1, 1, 1))
             / torch.sqrt(variance.view(1, -1, 1, 1) + BATCH_NORM_EPS)
             * p["tower.1.weight"].view(1, -1, 1, 1)
             + p["tower.1.bias"].view(1, -1, 1, 1))
        return quantize(F.conv2d(F.relu(x), quantize(p["tower.3.weight"]),
                                 p["tower.3.bias"], padding=1))

    features_left, features_right = tower(left), tower(right)
    width = features_left.shape[-1]
    volume = []
    for d in range(maximum_disparity):
        moved = torch.zeros_like(features_right)
        moved[..., d:] = features_right[..., :width - d]
        volume.append((features_left * moved).mean(dim=1))
    probabilities = torch.softmax(torch.stack(volume, dim=1), dim=1)
    levels = torch.arange(maximum_disparity, dtype=probabilities.dtype,
                          device=probabilities.device).view(1, -1, 1, 1)
    return (probabilities * levels).sum(dim=1)


def reference_map(weights, config, left, right, maximum_disparity,
                  quantize=_exact) -> torch.Tensor:
    with torch.no_grad(), reference.exact_float32():
        return disparity(weights, left, right, maximum_disparity,
                         quantize=quantize)


def serve_readings(weights, config, left, right, maps, maximum_disparity,
                   device) -> dict:
    """Per pixel, the distance between the served and the reference's
    disparity."""
    gaps = []
    for key, served in maps.items():
        expected = reference_map(
            weights, config, torch.as_tensor(left[key], device=device),
            torch.as_tensor(right[key], device=device), maximum_disparity)
        gaps.append((torch.as_tensor(served, device=device) - expected
                     ).abs().flatten().cpu())
    return {"gap": torch.cat(gaps).double()}


def serve_numbers(readings: dict) -> dict:
    gaps = readings["gap"]
    return {"map_gap_max_px": float(gaps.max()),
            "map_gap_mean_px": float(gaps.mean())}


def serve_diagnostics(readings: dict) -> dict:
    return {"pixels": int(readings["gap"].numel())}


def reference_steps(weights, config, batches, maximum_disparity,
                    quantize=_exact):
    """Adam over ``batches`` from ``weights``: (each step's loss, the
    first gradient by key, each trained key's change)."""
    beta1, beta2 = config["adam"]["betas"]
    eps, learning_rate = config["adam"]["eps"], config["learning_rate"]
    trained = [key for key, value in weights.items()
               if value.is_floating_point() and ".running_" not in key]
    current = {key: weights[key].detach().clone() for key in trained}
    buffers = {key: value for key, value in weights.items()
               if key not in current}
    first = {key: torch.zeros_like(value) for key, value in current.items()}
    second = {key: torch.zeros_like(value) for key, value in current.items()}
    losses, first_gradients = [], None
    with reference.exact_float32():
        for step, (left, right, ground_truth) in enumerate(batches, 1):
            leaves = {key: value.requires_grad_(True)
                      for key, value in current.items()}
            known = torch.isfinite(ground_truth)
            estimate = disparity({**buffers, **leaves}, left, right,
                                 maximum_disparity, True, quantize)
            loss = F.smooth_l1_loss(estimate[known], ground_truth[known])
            gradients = dict(zip(leaves, torch.autograd.grad(
                loss, list(leaves.values()))))
            if first_gradients is None:
                first_gradients = gradients
            losses.append(float(loss.detach()))
            with torch.no_grad():
                for key, gradient in gradients.items():
                    first[key].mul_(beta1).add_((1 - beta1) * gradient)
                    second[key].mul_(beta2).add_((1 - beta2) * gradient ** 2)
                    corrected = first[key] / (1 - beta1 ** step)
                    scale = torch.sqrt(second[key] / (1 - beta2 ** step))
                    current[key] = (current[key] - learning_rate * corrected
                                    / (scale + eps)).detach()
    changes = {key: current[key] - weights[key] for key in current}
    return losses, first_gradients, changes


def useful_macs(config: dict, kind: str) -> int:
    """Two towers' convs and the volume's products, per image; training
    adds both gradient passes."""
    pixels = config["height"] * config["width"]
    features = config["features"]
    forward = pixels * (2 * (27 * features + 9 * features * features)
                        + config[f"{kind}_maximum_disparity"] * features)
    return forward if kind == "serve" else 3 * forward
