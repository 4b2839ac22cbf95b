"""Headline benchmark of the port on one NVIDIA GPU.

Port of the JAX package's root ``bench.py``: the same protocol and the
same keys, the port's own numbers.

    python -m practicaldeepstereo_nips2018_tpu_torch.bench

prints one JSON line:

* ``value``: seconds per image of ``models.infer`` at batch 1, 540x960,
  D=191, bfloat16 compute (the reference's published timing protocol);
* ``detail.eval_images_per_second``: batches of 2 and 4 through
  ``InferenceSession`` under its default ``"unroll"`` mode (one batch-1
  forward per image), the JAX bench's shipped serving default;
  ``detail.eval_images_per_second_direct``: the same under ``"direct"``
  (one batched forward). ``"map"`` is the ``"unroll"`` path in the port
  (``serving.py``), so it is not timed twice;
* ``detail.train_images_per_second``: ``training/trainer.py::train_step``
  at batch 1, 2 and 4, 540x960, D=255, bfloat16 compute, float32
  parameters, RMSprop at lr 1e-2, remat off; ``train_step_seconds`` is
  batch 1's;
* ``detail.flops`` and ``detail.train_flops``: the useful and executed
  MACs of ``utils/flops.py`` and the MFU they give over the card's
  bfloat16 peak (None for a device without a listed peak).

Timing is the JAX bench's: the median over ``repeats`` of the slope
between ``short`` and ``long`` chained calls (``utils/profiling.py::
StepTimer``, whose every measurement ends in ``torch.cuda.synchronize()``),
so that fixed costs cancel. The JAX bench threads a value-zero carried
dependency through its device loop to keep XLA from hoisting the body;
eager PyTorch hoists nothing, so there is none here. The inputs are on the
device before any timer starts, as the JAX bench times device-resident
inputs: images uniform noise x 255, ground truth uniform over [0, 200 *
D / 255), which is the JAX bench's [0, 200) at D=255, from
``torch.Generator`` seeds. The weights are drawn anew for each
configuration from the numpy ``seed`` (``training/weights.py::
random_jax_params``).

Beyond the JAX line, ``detail`` holds the card's name and power limit as
``nvidia-smi`` gives them (``device``), and per configuration
(``configurations``) every slope, the peak device memory, the kernel
launches of one untimed call before the timer, and the range of that
call's disparity map or the train step's last loss.

``vs_baseline`` is 0.62 s divided by the headline: 0.62 s per image is the
reference implementation's published time on an unspecified GPU
(``BASELINE.md``), not a TPU number.

A configuration that fails raises, and the program exits non-zero: none
is reported as null. :func:`run` takes the card unless the caller passes
``device="cpu"`` (the tests do); on a host without a card it raises.
"""

from __future__ import annotations

import collections
import json
import math
import subprocess
import sys

import torch

from practicaldeepstereo_nips2018_tpu_torch import models
from practicaldeepstereo_nips2018_tpu_torch.device import resolve_device
from practicaldeepstereo_nips2018_tpu_torch.ops import kernels
from practicaldeepstereo_nips2018_tpu_torch.serving import InferenceSession
from practicaldeepstereo_nips2018_tpu_torch.training import (
    optimizer, trainer, weights)
from practicaldeepstereo_nips2018_tpu_torch.utils import flops, profiling

BASELINE_SECONDS = 0.62
# The JAX bench's hourglass implementation; the port validates it and
# runs its one hourglass, which computes the same function.
FOLDED_IMPL = "banded_slab"
TRAIN_REMAT = False
LEARNING_RATE = 1e-2
COMPUTE_DTYPE = torch.bfloat16
# ``torch.Generator`` seeds of the inputs, the JAX bench's PRNG keys: the
# headline pair, the batched eval pairs, the training batch.
HEADLINE_SEED, EVAL_SEED, TRAIN_SEED = 1, 3, 2
# The training ground truth's upper end at D=255, scaled with D.
GROUND_TRUTH_MAXIMUM, GROUND_TRUTH_RANGE = 200.0, 255
MAP_MODE = ('"map" runs the "unroll" path in the port (serving.py): not '
            'timed twice')


def _images(batch: int, height: int, width: int,
            generator: torch.Generator, device: torch.device):
    """A left and a right ``[batch, height, width, 3]`` noise image,
    0..255, on ``device``."""
    return tuple((torch.rand((batch, height, width, 3), generator=generator)
                  * 255.0).to(device) for _ in range(2))


def _network(config: models.PDSConfig, seed: int,
             device: torch.device) -> models.PdsNetwork:
    """The weights drawn from the numpy ``seed``, on ``device``."""
    network = models.PdsNetwork(config)
    network.load_state_dict(weights.state_dict_from_jax_params(
        weights.random_jax_params(config, seed)))
    return network.to(device)


def training_batch(batch: int, height: int, width: int,
                   maximum_disparity: int, device="cpu"):
    """(left, right, ground truth) of the training configurations: the
    images of :func:`_images` and ground truth uniform over [0, 200 *
    ``maximum_disparity`` / 255)."""
    device = resolve_device(device)
    generator = torch.Generator().manual_seed(TRAIN_SEED)
    left, right = _images(batch, height, width, generator, device)
    ground_truth = torch.rand((batch, height, width), generator=generator) * (
        GROUND_TRUTH_MAXIMUM * maximum_disparity / GROUND_TRUTH_RANGE)
    return left, right, ground_truth.to(device)


def train_case(batch: int, height: int, width: int, maximum_disparity: int,
               seed: int = 0, device="cuda", compute_dtype=COMPUTE_DTYPE):
    """(network, RMSprop, step) of one training configuration: the weights
    from ``seed`` on ``device``, RMSprop at ``LEARNING_RATE`` over them and
    :func:`training_batch`; ``step()`` takes one ``train_step`` and returns
    its loss, a device scalar."""
    device = resolve_device(device)
    config = models.PDSConfig(maximum_disparity=maximum_disparity,
                              remat=TRAIN_REMAT,
                              folded_conv_impl=FOLDED_IMPL)
    network = _network(config, seed, device)
    rmsprop = optimizer.rmsprop(network.parameters(), LEARNING_RATE)
    left, right, ground_truth = training_batch(batch, height, width,
                                               maximum_disparity, device)

    def step():
        return trainer.train_step(network, rmsprop, left, right,
                                  ground_truth, LEARNING_RATE, config,
                                  compute_dtype=compute_dtype, device=device)

    return network, rmsprop, step


def _start_configuration(device: torch.device) -> None:
    """Frees what the previous configuration left in the allocator's cache
    and restarts the peak."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def _measure(step, device: torch.device, batch: int, timing: dict) -> tuple:
    """One untimed call of ``step`` (its kernel launches counted), then
    the timer. Returns (record, the untimed call's output)."""
    before = collections.Counter(kernels.launch_counts)
    output = step()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    launches = dict(collections.Counter(kernels.launch_counts) - before)
    measured = profiling.StepTimer(step, timing["short"], timing["long"]
                                   ).measure(timing["repeats"])
    seconds = measured["seconds_per_step"]
    if not math.isfinite(seconds) or seconds <= 0.0:
        raise RuntimeError(f"batch {batch}: the timer measured {seconds} s "
                           f"per call (slopes {measured['slopes']})")
    return {"batch": batch, "seconds": seconds,
            "slopes_s": measured["slopes"], "launches": launches,
            "peak_memory_bytes": (torch.cuda.max_memory_allocated(device)
                                  if device.type == "cuda" else None)
            }, output


def _map_record(record: dict, disparity: torch.Tensor) -> dict:
    record.update({"disparity_range": [float(disparity.min()),
                                       float(disparity.max())],
                   "disparity_finite": bool(torch.isfinite(disparity).all())})
    return record


def _headline(config: models.PDSConfig, height: int, width: int, seed: int,
              device: torch.device, timing: dict) -> dict:
    _start_configuration(device)
    network = _network(config, seed, device).eval()
    left, right = _images(1, height, width,
                          torch.Generator().manual_seed(HEADLINE_SEED),
                          device)
    record, disparity = _measure(
        lambda: models.infer(network, left, right, config,
                             compute_dtype=COMPUTE_DTYPE, device=device),
        device, 1, timing)
    record["mode"] = "models.infer"
    return _map_record(record, disparity)


def _serving(config: models.PDSConfig, mode: str, batch: int, height: int,
             width: int, seed: int, device: torch.device,
             timing: dict) -> dict:
    _start_configuration(device)
    session = InferenceSession(weights.state_dict_from_jax_params(
        weights.random_jax_params(config, seed)), config,
        compute_dtype=COMPUTE_DTYPE, device=device, batched_mode=mode)
    left, right = _images(batch, height, width,
                          torch.Generator().manual_seed(EVAL_SEED), device)
    record, disparity = _measure(lambda: session.infer(left, right), device,
                                 batch, timing)
    record["mode"] = mode
    return _map_record(record, disparity)


def _training(batch: int, height: int, width: int, maximum_disparity: int,
              seed: int, device: torch.device, timing: dict) -> dict:
    _start_configuration(device)
    _, _, step = train_case(batch, height, width, maximum_disparity, seed,
                         device)
    losses = []

    def kept_step():
        losses[:] = [step()]
        return losses[0]

    record, _ = _measure(kept_step, device, batch, timing)
    record["last_loss"] = float(losses[0])
    return record


def accounting(height: int, width: int, maximum_disparity: int,
               train_maximum_disparity: int, seconds: float,
               train_seconds: float | None, peak: float | None) -> tuple:
    """(``flops``, ``train_flops``) of the line: the MACs of one image at
    the padded size (a train step's are linear in the batch), and the MFU
    of ``seconds`` per image and ``train_seconds`` per batch-1 step over
    ``peak`` FLOP/s, None where either is unknown."""
    padded_height = -(-height // 64) * 64
    padded_width = -(-width // 64) * 64
    forward = flops.summarize(flops.forward_macs(
        padded_height, padded_width, maximum_disparity))
    training = flops.training_macs(padded_height, padded_width,
                                   train_maximum_disparity,
                                   remat=TRAIN_REMAT)

    def mfu_pct(gmacs, time):
        if peak is None or time is None:
            return None
        return round(100 * gmacs * 2e9 / time / peak, 1)

    forward_detail = {
        "folded_conv_impl": FOLDED_IMPL,
        "useful_gmacs": forward["useful_gmacs"],
        "executed_gmacs": forward["executed_gmacs"],
        "structural_overhead": forward["structural_overhead"],
        "peak_bf16_tflops": None if peak is None else peak / 1e12,
        "mfu_executed_pct": mfu_pct(forward["executed_gmacs"], seconds),
        "mfu_useful_pct": mfu_pct(forward["useful_gmacs"], seconds),
    }
    train_detail = {
        "remat": TRAIN_REMAT,
        "executed_gmacs": training["executed_gmacs"],
        "useful_gmacs": training["useful_gmacs"],
        "recompute_gmacs": training["recompute_gmacs"],
        "recompute_overhead_pct": training["recompute_overhead_pct"],
        "train_mfu_executed_pct": mfu_pct(training["executed_gmacs"],
                                          train_seconds),
        "train_mfu_useful_pct": mfu_pct(training["useful_gmacs"],
                                        train_seconds),
    }
    return forward_detail, train_detail


def _device_description(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them;
    ``"cpu"`` for the CPU."""
    if device.type != "cuda":
        return str(device)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def _throughput(configurations: dict, kind: str, batches) -> dict:
    return {str(batch): {
        "step_seconds": round(configurations[f"{kind}_{batch}"]["seconds"],
                              5),
        "images_per_second": round(
            batch / configurations[f"{kind}_{batch}"]["seconds"], 3)}
        for batch in batches}


def run(device="cuda", height: int = 540, width: int = 960,
        maximum_disparity: int = 191, train_maximum_disparity: int = 255,
        eval_batches=(2, 4), train_batches=(1, 2, 4), short: int = 2,
        long: int = 10, repeats: int = 5, seed: int = 0) -> dict:
    """Measures every configuration and returns the line (module
    docstring). The defaults are the JAX bench's constants."""
    device = resolve_device(device)
    timing = {"short": short, "long": long, "repeats": repeats}
    config = models.PDSConfig(maximum_disparity=maximum_disparity,
                              folded_conv_impl=FOLDED_IMPL)
    configurations = {"infer_1": _headline(config, height, width, seed,
                                           device, timing)}
    for mode in ("unroll", "direct"):
        for batch in eval_batches:
            configurations[f"{mode}_{batch}"] = _serving(
                config, mode, batch, height, width, seed, device, timing)
    for batch in train_batches:
        configurations[f"train_{batch}"] = _training(
            batch, height, width, train_maximum_disparity, seed, device,
            timing)
    _start_configuration(device)

    seconds = configurations["infer_1"]["seconds"]
    train_seconds = configurations.get("train_1", {}).get("seconds")
    peak = (flops.peak_bf16_flops(torch.cuda.get_device_name(device))
            if device.type == "cuda" else None)
    flops_detail, train_flops_detail = accounting(
        height, width, maximum_disparity, train_maximum_disparity, seconds,
        train_seconds, peak)
    return {
        "metric": "time_per_image",
        "value": round(seconds, 5),
        "unit": "s",
        "vs_baseline": round(BASELINE_SECONDS / seconds, 2),
        "detail": {
            "shape": [height, width],
            "maximum_disparity": maximum_disparity,
            "compute_dtype": "bfloat16",
            "device": _device_description(device),
            "frames_per_second": round(1.0 / seconds, 2),
            "eval_images_per_second": _throughput(configurations, "unroll",
                                                  eval_batches),
            "eval_images_per_second_direct": _throughput(
                configurations, "direct", eval_batches),
            "eval_map_mode": MAP_MODE,
            "slope_samples_s": [round(slope, 5) for slope
                                in configurations["infer_1"]["slopes_s"]],
            "baseline_seconds": BASELINE_SECONDS,
            "flops": flops_detail,
            "train_step_seconds": (round(train_seconds, 5)
                                   if train_seconds is not None else None),
            "train_images_per_second": _throughput(configurations, "train",
                                                   train_batches),
            "train_step_config": {
                "shape": [height, width], "batch": list(train_batches),
                "maximum_disparity": train_maximum_disparity,
                "compute_dtype": "bfloat16", "remat": TRAIN_REMAT,
            },
            "train_flops": train_flops_detail,
            "configurations": configurations,
        },
    }


def main() -> int:
    print(json.dumps(run()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
