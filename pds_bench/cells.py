"""The two kinds of cell, serving and training, driven through the port.

A cell's two modules (``registry.Cell``) hold what belongs to its
architecture: its driver gives the system under test (the serving
session's ``predict``, the training network, optimizer and step, the
module tree that the spans hook, the first gradient as the optimizer's
state holds it), its yardstick the weights' layout, the plain reference's
readings, the serving numbers compared and the useful work. What is the
same for every architecture stays here: the parts of set-up, the measured
windows (the open or closed serving loop, train steps back to back), the
training numbers, the traced phases and the comparison with the limits.
Inputs, weights, metrics and the comparison that decides ``correct`` are
the benchmark's own.

A run: set-up (the kernels built or loaded, weights and traffic made from
the seed, the cell's one shape warmed up; for training the first three
steps, whose loss, first gradient and change the check compares), the
measured window, and in a traced run the span phase and the profiler
phase after it; then the device's peak memory is read, the program freed
and the reference run on what the window produced.
"""

from __future__ import annotations

import math
import statistics
import time

import numpy as np
import torch

from pds_bench import generator, spans, trace
from pds_bench.record import Record


def make_weights(yardstick, config: dict, seed: int, device) -> dict:
    """The float32 weights of ``config`` under its yardstick's layout."""
    return generator.make_weights(yardstick.weight_layout(config), seed,
                                  device)


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

    def __init__(self, cell, seed: int, device, **options):
        """``cell``: a ``registry.Cell``; ``options`` go to the driver's
        session (a control's)."""
        config, traffic = cell.config, cell.traffic
        self.config, self.traffic, self.seed = config, traffic, seed
        self.yardstick = cell.yardstick
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
        self.predict, self.network = cell.driver.serving(
            config, traffic, make_weights(self.yardstick, config, seed,
                                          self.device),
            self.device, **options)
        _mark(self.marks, "network")
        for _ in range(traffic["warmup_calls"]):
            self.iteration(0)
        _synchronize(self.device)
        _mark(self.marks, "warm_up")

    def iteration(self, index: int) -> np.ndarray:
        pair = index % len(self.left)
        return self.predict(self.left[pair], self.right[pair])

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
        return 2.0 * self.yardstick.useful_macs(self.config, self.kind)

    def free(self) -> None:
        del self.predict, self.network

    def check(self) -> dict:
        """Compares a seeded sample of the window's maps with the reference
        (the yardstick's ``serve_numbers``)."""
        return self.yardstick.serve_numbers(self.readings())

    def readings(self) -> dict:
        rng = np.random.default_rng(self.seed)
        keys = sorted(self.kept)
        sample = rng.choice(keys, size=min(self.traffic["check_samples"],
                                           len(keys)), replace=False)
        maps = {int(key): self.kept[int(key)] for key in sample}
        return serve_readings(self.yardstick, self.config, self.seed,
                              self.left, self.right, maps,
                              self.maximum_disparity, self.device)


def serve_readings(yardstick, config: dict, seed: int, left, right,
                   maps: dict, maximum_disparity: int, device) -> dict:
    """What the served ``maps`` read against the yardstick's reference on
    the seed's weights and the same images."""
    return yardstick.serve_readings(
        make_weights(yardstick, config, seed, device), config, left, right,
        maps, maximum_disparity, device)


class TrainCell:
    """Train steps back to back on a few distinct batches already on the
    device; the loss read once at the window's end."""

    kind = "train"
    CHECKED_STEPS = 3

    def __init__(self, cell, seed: int, device, **options):
        """``cell``: a ``registry.Cell``; ``options`` go to the driver's
        ``Training``."""
        config, traffic = cell.config, cell.traffic
        self.config, self.traffic, self.seed = config, traffic, seed
        self.yardstick = cell.yardstick
        self.device = torch.device(device)
        self.batch = traffic["batch"]
        self.maximum_disparity = config["train_maximum_disparity"]
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
        self.training = cell.driver.Training(
            config, make_weights(self.yardstick, config, seed, self.device),
            self.device, **options)
        self.network = self.training.network
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
                self.first_gradients = self.training.gradient_magnitudes()
        self.changes = {name: value.detach() - start[name]
                        for name, value in self.network.named_parameters()}
        self.steps = self.CHECKED_STEPS
        _synchronize(self.device)

    def iteration(self, index: int) -> torch.Tensor:
        return self.training.step(*self.batches[index % len(self.batches)])

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
        return 2.0 * self.yardstick.useful_macs(self.config, self.kind)

    def free(self) -> None:
        del self.training, self.network

    def check(self) -> dict:
        return train_numbers(self.readings())

    def readings(self) -> dict:
        return train_readings(
            self.yardstick, self.config, self.seed,
            self.batches[:self.CHECKED_STEPS], self.maximum_disparity,
            self.losses, self.first_gradients, self.changes, self.device)


def leaf_gaps(program: dict, reference_norms: dict, keys) -> dict:
    """Per leaf, the gap between the program's and the reference's norm,
    over the reference's norm of that leaf or of the median leaf,
    whichever is larger."""
    median = statistics.median(reference_norms[key] for key in keys)
    return {key: abs(program[key] - reference_norms[key])
            / max(reference_norms[key], median) for key in keys}


def train_readings(yardstick, config: dict, seed: int, batches,
                   maximum_disparity: int, losses, first_gradients, changes,
                   device) -> dict:
    """The program's checked steps beside the yardstick's float32
    reference (TF32 off), trained from the same weights on the same first
    batches. ``first_gradients`` may hold magnitudes only (as the
    optimizer's state gives them); ``changes`` are each parameter's change
    after the checked steps. ``moved``: the leaves whose reference first
    gradient has at least a thousandth of the median leaf's norm."""
    reference_losses, gradients, reference_changes = (
        yardstick.reference_steps(
            make_weights(yardstick, config, seed, device), config, batches,
            maximum_disparity))
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
