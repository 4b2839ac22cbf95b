"""Readings that the limits of ``correct`` are set from, on the chip.

    python3 -m pds_bench.calibrate --workload <name> --seeds 1,2,... \\
        [--control-seeds 7,8,9] [--faults half_batch,...] [--seconds 2]

In one process, for each seed: the program as a run drives it (set-up, a
short window at the cell's own load, the check), then each control and
each fault on the control seeds. One JSON line per reading, with the
numbers the check compares (``pds_bench/cells.py`` and the cell's
yardstick) and, under ``diagnostics``, others that the limits' readings
name:

* ``program``: the port as the configuration states it;
* ``control_<name>`` (serving): the port's own lower-precision path, with
  the options of the driver's ``CONTROLS[name]`` (for PDS ``int8``,
  ``matching_tail_int8``, the nearest precision below bfloat16 that it
  has);
* ``reference_<name>``: the yardstick's reference itself in the program's
  place, rounded by its ``LOWERED[name]`` (for PDS ``fp8``, every conv
  operand and result and their gradients rounded to float8 e4m3, the
  control of a training cell, and ``bf16``, a second witness of what
  bfloat16 alone does);
* faults planted in the program by the driver's ``planted``.

The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch

from pds_bench import cells, generator, registry


def train_diagnostics(readings: dict) -> dict:
    norms = readings["gradient_norms"]
    median = statistics.median(norms.values())
    first = readings["first_gradients"]
    loss_gaps = [abs(mine - theirs) / abs(theirs) for mine, theirs in
                 zip(readings["losses"], readings["reference_losses"])]
    gradient_gaps = cells.leaf_gaps(
        {key: float(first[key].norm()) for key in norms}, norms, list(norms))
    magnitude_gaps = {
        key: float((first[key].abs() - readings["gradients"][key].abs()
                    ).norm()) / max(norms[key], median) for key in norms}
    change_gaps = cells.change_gaps(readings)
    return {"loss_gap": max(loss_gaps),
            "change_gap": max(change_gaps.values()),
            "change_leaf": max(change_gaps, key=change_gaps.get),
            "gradient_leaf": max(gradient_gaps, key=gradient_gaps.get),
            "magnitude_gap_median": statistics.median(
                magnitude_gaps.values()),
            "magnitude_gap": max(magnitude_gaps.values()),
            "unmoved_leaves": [key for key in norms
                               if key not in readings["moved"]]}


def numbers(cell, readings: dict) -> tuple[dict, dict]:
    """(the compared numbers, the diagnostics) of ``readings``."""
    if cell.traffic["kind"] == "serve":
        return (cell.yardstick.serve_numbers(readings),
                cell.yardstick.serve_diagnostics(readings))
    return cells.train_numbers(readings), train_diagnostics(readings)


def program_reading(cell, seed: int, seconds: float, device, **options):
    """(compared numbers, diagnostics, requests attempted) of the program
    driven as a run drives it, with a window of ``seconds`` for serving."""
    runner = cells.KINDS[cell.traffic["kind"]](cell, seed, device, **options)
    window = runner.window(seconds) if cell.traffic["kind"] == "serve" else {
        "attempted": 0}
    runner.free()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return (*numbers(cell, runner.readings()), window["attempted"])


def reference_reading(cell, seed: int, device, quantize):
    """The yardstick's reference rounded by ``quantize`` in the program's
    place, judged by the float32 reference: (compared numbers,
    diagnostics)."""
    config, traffic, yardstick = cell.config, cell.traffic, cell.yardstick
    weights = cells.make_weights(yardstick, config, seed, device)
    if traffic["kind"] == "serve":
        maximum = config["serve_maximum_disparity"]
        pairs = generator.make_pairs(config, traffic, seed, device,
                                     traffic["distinct"])
        maps = {key: yardstick.reference_map(
            weights, config, pairs.left[key], pairs.right[key], maximum,
            quantize).cpu().numpy()
            for key in range(min(traffic["check_samples"],
                                 traffic["distinct"]))}
        return numbers(cell, cells.serve_readings(
            yardstick, config, seed, pairs.left.cpu().numpy(),
            pairs.right.cpu().numpy(), maps, maximum, device))
    count = cells.TrainCell.CHECKED_STEPS
    pairs = generator.make_pairs(config, traffic, seed, device,
                                 traffic["distinct"])
    truth = generator.make_ground_truth(config, traffic, seed, device,
                                        traffic["distinct"])
    batches = [(pairs.left[i], pairs.right[i], truth[i])
               for i in range(count)]
    maximum = config["train_maximum_disparity"]
    losses, gradients, changes = yardstick.reference_steps(
        weights, config, batches, maximum, quantize)
    return numbers(cell, cells.train_readings(
        yardstick, config, seed, batches, maximum, losses, gradients,
        changes, device))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--controls", default="int8,fp8")
    parser.add_argument("--faults", default="")
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    cell = registry.cell(args.workload)
    serve = cell.traffic["kind"] == "serve"

    def seeds(text):
        return [int(value) for value in text.split(",") if value]

    def emit(what, seed, reading, started):
        compared, diagnostics, *attempted = reading
        extra = {"attempted": attempted[0]} if attempted else {}
        print(json.dumps({"workload": args.workload, "reading": what,
                          "seed": seed, "numbers": compared,
                          "diagnostics": diagnostics,
                          "seconds": time.perf_counter() - started,
                          **extra}), flush=True)

    for seed in seeds(args.seeds):
        started = time.perf_counter()
        emit("program", seed, program_reading(cell, seed, args.seconds,
                                              args.device), started)
    controls = [value for value in args.controls.split(",") if value]
    for seed in seeds(args.control_seeds):
        for name, options in cell.driver.CONTROLS.items():
            if serve and name in controls:
                started = time.perf_counter()
                emit(f"control_{name}", seed, program_reading(
                    cell, seed, args.seconds, args.device, **options),
                    started)
        for name, quantize in cell.yardstick.LOWERED.items():
            if name in controls:
                started = time.perf_counter()
                emit(f"reference_{name}", seed, reference_reading(
                    cell, seed, args.device, quantize), started)
        for name in [value for value in args.faults.split(",") if value]:
            started = time.perf_counter()
            with cell.driver.planted(name):
                reading = program_reading(cell, seed, args.seconds,
                                          args.device)
            emit(f"fault_{name}", seed, reading, started)
    return 0


if __name__ == "__main__":
    sys.exit(main())
