"""The two kinds of cell, serving and training, driven through the port.

From the port the benchmark takes only the system under test:
``serving.InferenceSession`` (serving), ``models.PdsNetwork``,
``training.optimizer.rmsprop`` and ``training.trainer.train_step``
(training), the network's modules for the spans, and the kernels' build
and launch counts. Inputs, weights, metrics and the comparison that
decides ``correct`` are the benchmark's own.

A run: set-up (the kernels built or loaded, weights and traffic made from
the seed, the cell's one shape warmed up; for training the first three
steps, whose loss, first gradient and change the check compares), the
measured window, and in a traced run the span phase and the profiler
phase after it; then the device's peak memory is read, the program freed
and the reference run on what the window produced.
"""

from __future__ import annotations

import dataclasses
import math
import statistics
import time

import numpy as np
import torch

from pds_bench import accounting, generator, reference, spans, trace
from pds_bench.record import Record

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def program_config(config: dict, maximum_disparity: int, **options):
    """The port's ``PDSConfig`` from the configuration file's keys."""
    from practicaldeepstereo_nips2018_tpu_torch.models import network
    fields = {field.name for field in dataclasses.fields(network.PDSConfig)}
    values = {key: value for key, value in config.items() if key in fields}
    values.update(options, maximum_disparity=maximum_disparity)
    return network.PDSConfig(**values)


def padded(size: int, multiple: int) -> int:
    return -(-size // multiple) * multiple


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _mark(marks: list, name: str) -> None:
    """Notes the end of a part of set-up, for the run's info line."""
    marks.append((name, time.perf_counter()))


class ServeCell:
    """One client cycling over the traffic's distinct pairs, in a closed
    loop (each request sent when the previous map is back) or an open one
    (a request due every ``1 / rate`` seconds, as a camera's frames are,
    sent when due or, while the previous is still served, as soon as it is
    back; its latency counted from when it was due, and the latest send
    kept)."""

    kind = "serve"

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 **options):
        from practicaldeepstereo_nips2018_tpu_torch.serving import (
            InferenceSession)
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.batch = traffic["batch"]
        self.maximum_disparity = config["serve_maximum_disparity"]
        self.marks = []
        pairs = generator.make_pairs(config, traffic, seed, self.device,
                                     traffic["distinct"])
        self.left = pairs.left.cpu().numpy()
        self.right = pairs.right.cpu().numpy()
        del pairs
        _mark(self.marks, "inputs")
        self.session = InferenceSession(
            generator.make_weights(config, seed, self.device),
            program_config(config, self.maximum_disparity, **options),
            compute_dtype=DTYPES[config["compute_dtype"]],
            device=self.device, batched_mode=traffic["batched_mode"])
        self.network = self.session._network
        _mark(self.marks, "network")
        for _ in range(traffic["warmup_calls"]):
            self.iteration(0)
        _synchronize(self.device)
        _mark(self.marks, "warm_up")

    def iteration(self, index: int) -> np.ndarray:
        pair = index % len(self.left)
        return self.session.predict(self.left[pair], self.right[pair])

    def window(self, seconds: float) -> dict:
        latencies, kept = [], {}
        failed = 0
        shape = self.left.shape[1:4]
        interval = (1.0 / self.traffic["rate"]
                    if self.traffic["loop"] == "open" else 0.0)
        late = 0.0
        start = last = time.perf_counter()
        due = start
        index = 0
        while (due if interval else last) - start < seconds:
            sent = time.perf_counter()
            if sent >= due:
                late = max(late, sent - due)
            # The client waits for the next frame without sleeping, so the
            # host's core stays awake as a camera's polling thread does.
            while sent < due:
                sent = time.perf_counter()
            disparity = self.iteration(index)
            last = time.perf_counter()
            latencies.append(last - (due if interval else sent))
            if disparity.shape != shape:
                failed += 1
            kept[index % len(self.left)] = disparity
            index += 1
            due += interval
        self.kept = kept
        return {"start": start, "wall": last - start, "attempted": index,
                "failed": failed, "images": index * self.batch,
                "latencies": latencies, "latest_send_s": late}

    def metrics(self, window: dict) -> dict:
        latencies_ms = [value * 1e3 for value in window["latencies"]]
        return {"serve_p95_ms": float(np.percentile(latencies_ms, 95)),
                "serve_p50_ms": float(statistics.median(latencies_ms)),
                "serve_images_per_s": window["images"] / window["wall"]}

    def useful_flops_per_image(self) -> float:
        multiple = self.config["minimum_size"]
        return 2.0 * accounting.forward_useful_macs(
            padded(self.config["height"], multiple),
            padded(self.config["width"], multiple), self.maximum_disparity,
            self.config["number_of_regularization_features"])

    def free(self) -> None:
        del self.session, self.network

    def check(self) -> dict:
        """Compares a seeded sample of the window's maps with the reference
        (:func:`serve_numbers`)."""
        return serve_numbers(self.readings())

    def readings(self) -> dict:
        rng = np.random.default_rng(self.seed)
        keys = sorted(self.kept)
        sample = rng.choice(keys, size=min(self.traffic["check_samples"],
                                           len(keys)), replace=False)
        maps = {int(key): self.kept[int(key)] for key in sample}
        return serve_readings(self.config, self.seed, self.left, self.right,
                              maps, self.maximum_disparity, self.device)


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


def serve_readings(config: dict, seed: int, left, right, maps: dict,
                   maximum_disparity: int, device) -> dict:
    """Per pixel of the sampled maps, against the float32 reference (TF32
    off) on the same weights and images: ``gap`` (:func:`served_gaps`),
    which judges the scores' best level, and ``offset``, the distance in
    pixels between the served disparity and the reference's own sub-pixel
    estimate, which judges the estimator's sub-pixel step."""
    weights = generator.make_weights(config, seed, device)
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


class TrainCell:
    """Train steps back to back on a few distinct batches already on the
    device; the loss read once at the window's end."""

    kind = "train"
    CHECKED_STEPS = 3

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 **options):
        from practicaldeepstereo_nips2018_tpu_torch.models import network
        from practicaldeepstereo_nips2018_tpu_torch.training import (
            optimizer, trainer)
        self._trainer = trainer
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.batch = traffic["batch"]
        self.maximum_disparity = config["train_maximum_disparity"]
        self.learning_rate = config["learning_rate"]
        self.program_config = program_config(config, self.maximum_disparity,
                                             **options)
        count = traffic["distinct"]
        if count < self.CHECKED_STEPS:
            raise ValueError("a train traffic needs a distinct batch for "
                             f"each of the first {self.CHECKED_STEPS} steps")
        self.marks = []
        pairs = generator.make_pairs(config, traffic, seed, self.device,
                                     count)
        truth = generator.make_ground_truth(config, traffic, seed,
                                            self.device, count)
        self.batches = [(pairs.left[index], pairs.right[index], truth[index])
                        for index in range(count)]
        _synchronize(self.device)
        _mark(self.marks, "inputs")
        self.network = network.PdsNetwork(self.program_config)
        self.network.load_state_dict(
            generator.make_weights(config, seed, self.device))
        self.network.to(self.device)
        self.optimizer = optimizer.rmsprop(self.network.parameters(),
                                           self.learning_rate)
        _synchronize(self.device)
        _mark(self.marks, "network")
        # The first steps are the warm-up and what the check compares.
        start = {name: value.detach().clone()
                 for name, value in self.network.named_parameters()}
        self.losses = []
        for step in range(self.CHECKED_STEPS):
            self.losses.append(float(self.iteration(step)))
            _mark(self.marks, f"step_{step + 1}")
            if step == 0:
                self.first_gradients = self._gradient_magnitudes()
        self.changes = {name: value.detach() - start[name]
                        for name, value in self.network.named_parameters()}
        self.steps = self.CHECKED_STEPS
        _synchronize(self.device)

    def _gradient_magnitudes(self) -> dict:
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

    def iteration(self, index: int) -> torch.Tensor:
        left, right, truth = self.batches[index % len(self.batches)]
        return self._trainer.train_step(
            self.network, self.optimizer, left, right, truth,
            self.learning_rate, self.program_config,
            DTYPES[self.config["compute_dtype"]],
            self.config["loss_diversity"], self.device)

    def window(self, seconds: float) -> dict:
        start = time.perf_counter()
        first = self.steps
        loss = None
        while time.perf_counter() - start < seconds:
            loss = self.iteration(self.steps)
            self.steps += 1
        last_loss = float(loss)
        wall = time.perf_counter() - start
        attempted = self.steps - first
        return {"start": start, "wall": wall, "attempted": attempted,
                "failed": 0 if math.isfinite(last_loss) else attempted,
                "images": attempted * self.batch, "last_loss": last_loss}

    def metrics(self, window: dict) -> dict:
        return {"train_images_per_s": window["images"] / window["wall"]}

    def useful_flops_per_image(self) -> float:
        multiple = self.config["minimum_size"]
        return 2.0 * accounting.train_useful_macs(
            padded(self.config["height"], multiple),
            padded(self.config["width"], multiple), self.maximum_disparity,
            self.config["number_of_regularization_features"])

    def free(self) -> None:
        del self.network, self.optimizer

    def check(self) -> dict:
        return train_numbers(self.readings())

    def readings(self) -> dict:
        return train_readings(
            self.config, self.seed, self.batches[:self.CHECKED_STEPS],
            self.maximum_disparity, self.losses, self.first_gradients,
            self.changes, self.device)


def leaf_gaps(program: dict, reference_norms: dict, keys) -> dict:
    """Per leaf, the gap between the program's and the reference's norm,
    over the reference's norm of that leaf or of the median leaf,
    whichever is larger."""
    median = statistics.median(reference_norms[key] for key in keys)
    return {key: abs(program[key] - reference_norms[key])
            / max(reference_norms[key], median) for key in keys}


def train_readings(config: dict, seed: int, batches, maximum_disparity: int,
                   losses, first_gradients, changes, device) -> dict:
    """The program's checked steps beside the float32 reference's (TF32
    off), trained from the same weights on the same first batches.
    ``first_gradients`` may hold magnitudes only (as RMSprop's state gives
    them); ``changes`` are each parameter's change after the checked steps.
    ``moved``: the leaves whose reference first gradient has at least a
    thousandth of the median leaf's norm."""
    weights = generator.make_weights(config, seed, device)
    with reference.exact_float32():
        reference_losses, gradients, reference_changes = reference.steps(
            weights, config, batches, maximum_disparity,
            config["learning_rate"], config["rmsprop"]["alpha"],
            config["rmsprop"]["eps"], config["loss_diversity"])
    norms = {key: float(value.norm()) for key, value in gradients.items()}
    median = statistics.median(norms.values())
    return {"losses": list(losses), "reference_losses": reference_losses,
            "first_gradients": first_gradients, "gradients": gradients,
            "gradient_norms": norms, "changes": changes,
            "reference_changes": reference_changes,
            "moved": [key for key in norms if norms[key] >= 1e-3 * median]}


def change_gaps(readings: dict) -> dict:
    moved = readings["moved"]
    return leaf_gaps(
        {key: float(readings["changes"][key].norm()) for key in moved},
        {key: float(readings["reference_changes"][key].norm())
         for key in moved}, moved)


def train_numbers(readings: dict) -> dict:
    """The numbers compared for a training cell:

    * ``loss_gap_first``: the relative gap of the first step's loss;
    * ``gradient_gap``, ``gradient_gap_median``: the worst and the median
      leaf of the first gradient's norm (:func:`leaf_gaps`);
    * ``change_gap_median``: the median leaf of the parameters' change
      after the checked steps, over the moved leaves.
    """
    first, theirs = readings["losses"][0], readings["reference_losses"][0]
    norms = readings["gradient_norms"]
    gradient_gaps = leaf_gaps(
        {key: float(readings["first_gradients"][key].norm())
         for key in norms}, norms, list(norms))
    return {
        "loss_gap_first": abs(first - theirs) / abs(theirs),
        "gradient_gap_median": statistics.median(gradient_gaps.values()),
        "gradient_gap": max(gradient_gaps.values()),
        "change_gap_median": statistics.median(
            change_gaps(readings).values()),
    }


KINDS = {"serve": ServeCell, "train": TrainCell}


def span_requests(readers: dict, kind: str) -> dict:
    requests = {}
    for module in readers.values():
        backward = kind == "train" and getattr(module, "BACKWARD", False)
        for name, selector in getattr(module, "SPANS", {}).items():
            requests[name] = (selector, backward)
    return requests


def traced(runner, readers: dict, window: dict, peak) -> tuple:
    """The span phase and the profiler phase: (Record, Profile or None)."""
    cuda = runner.device.type == "cuda"
    traffic = runner.traffic
    record = Record(kind=runner.kind, window_seconds=window["wall"],
                    window_images=window["images"],
                    useful_flops_per_image=runner.useful_flops_per_image(),
                    peak_flops=peak, paced=traffic.get("loop") == "open")
    requests = span_requests(readers, runner.kind)
    index = getattr(runner, "steps", 0)
    if requests:
        hooks = spans.Spans(runner.network, requests, cuda)
        try:
            for step in range(traffic["span_iterations"]):
                runner.iteration(index + step)
            _synchronize(runner.device)
        finally:
            hooks.remove()
        record.spans = hooks.calls()
        record.span_images = traffic["span_iterations"] * runner.batch
        index += traffic["span_iterations"]
    profile = None
    if any(getattr(module, "PROFILE", False) for module in readers.values()):
        prefixes = sorted({prefix for module in readers.values()
                           for prefix in getattr(module, "UNDER", ())})
        iterations = traffic["profile_iterations"]

        def run():
            for step in range(iterations):
                with torch.profiler.record_function("pds_bench.iteration"):
                    runner.iteration(index + step)

        profile = trace.reduce(trace.profiled(run, cuda), iterations,
                               iterations * runner.batch, prefixes)
        record.profile = profile
    return record, profile


def read_metrics(readers: dict, per_layer: list, record: Record) -> dict:
    values = {}
    for metric in per_layer:
        value = readers[metric["name"].split(".")[0]].read(record)
        if value is not None:
            values[metric["name"]] = {"value": value, "unit": metric["unit"]}
    return values


def compare(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every compared number within its limit, the compared numbers each
    with its limit)."""
    checks = {}
    for name, limit in limits["numbers"].items():
        value = numbers[name]
        checks[name] = {"value": value, "limit": limit["limit"]}
    correct = all(math.isfinite(check["value"])
                  and check["value"] <= check["limit"]
                  for check in checks.values())
    return correct, checks
