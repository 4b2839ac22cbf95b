"""Runs one cell of the benchmark once and prints its result line.

    python3 -m pds_bench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the cell's CUDA cards.
``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics (after the same measured window, a span phase and a
profiler phase). The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``, each number compared
with the reference beside its limit; the last lines of standard error
repeat the checks. Earlier lines say what ran: the card and its power
limit, the kernel launches per image or step, the last loss.

It exits non-zero, and prints no result, without the cards the cell asks
for, when the port it imports does not lie in the checkout, or when JAX
or the JAX package has been imported by the end of the run.
"""

from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
PROGRAM = "practicaldeepstereo_nips2018_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "practicaldeepstereo_nips2018_tpu")
# Build and kernel caches at fixed paths inside the checkout.
CACHES = {"TORCH_EXTENSIONS_DIR": ROOT / "build" / "torch_extensions",
          "TRITON_CACHE_DIR": ROOT / "build" / "triton"}


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole."""
    return sorted({name for name in sys.modules
                   if name.split(".")[0] in FORBIDDEN})


def _card(torch) -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False)
    lines = smi.stdout.strip().splitlines()
    return lines[0] if lines else torch.cuda.get_device_name(0)


def setup_parts(start: float, marks: list, end: float) -> dict:
    """Seconds of each part of set-up, from the process's start (``marks``:
    ``(name, time)`` at each part's end) to the window's."""
    parts, previous = {}, start
    for name, moment in [*marks, ("until_window", end)]:
        parts[name] = moment - previous
        previous = moment
    return parts


def measure(cell, seed: int, seconds: float, traced_run: bool, device,
            start: float, marks=()) -> dict:
    """Set-up, window, (trace,) check: the result and what ran. ``marks``:
    the parts of set-up before this call, ``(name, time)`` at each end."""
    import torch

    from pds_bench import accounting, cells
    from practicaldeepstereo_nips2018_tpu_torch.ops import kernels

    runner = cells.KINDS[cell.traffic["kind"]](cell, seed, device)
    kernels.launch_counts.clear()
    window = runner.window(seconds)
    launches = {name: count / window["attempted"]
                for name, count in sorted(kernels.launch_counts.items())}
    metrics = {}
    setup_s = window["start"] - start
    if not traced_run:
        e2e = runner.metrics(window)
        e2e["setup_s"] = setup_s
        metrics = {metric["name"]: {"value": e2e[metric["name"]],
                                    "unit": metric["unit"]}
                   for metric in cell.end_to_end}
    cuda = runner.device.type == "cuda"
    name = torch.cuda.get_device_name(runner.device) if cuda else "cpu"
    result = {"correct": False, "attempted": window["attempted"],
              "failed": window["failed"], "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu", "kind": name,
                         "count": 1}}
    if traced_run:
        record, profile = cells.traced(runner, cell.readers, window,
                                       accounting.peak_bf16_flops(name))
        metrics.update(cells.read_metrics(cell.readers, cell.per_layer,
                                          record))
        if profile is not None:
            from pds_bench import trace
            begin, end = profile.window_us
            result["device"]["busy_s"] = trace.union_us(profile.device) / 1e6
            result["device"]["window_s"] = (end - begin) / 1e6
            result["breakdown"] = trace.breakdown(profile)
    if cuda:
        torch.cuda.synchronize(runner.device)
        result["device"]["memory_peak_bytes"] = (
            torch.cuda.max_memory_allocated(runner.device))
    runner.free()
    if cuda:
        torch.cuda.empty_cache()
    numbers = runner.check()
    correct, checks = cells.compare(numbers, cell.limits)
    result["correct"] = correct and window["failed"] == 0
    result["checks"] = checks
    info = {"launches_per_iteration": launches, "numbers": numbers,
            "setup_s": setup_s, "setup_parts_s": setup_parts(
                start, [*marks, *runner.marks], window["start"]),
            "window_s": window["wall"]}
    for key in ("last_loss", "latest_send_s"):
        if key in window:
            info[key] = window[key]
    if len(window.get("latencies", ())) > 1:
        info["latency_ms_quartiles"] = [
            1e3 * value for value in statistics.quantiles(
                window["latencies"], n=4)]
    return {"result": result, "info": info}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    for variable, path in CACHES.items():
        path.mkdir(parents=True, exist_ok=True)
        os.environ[variable] = str(path)

    from pds_bench import registry
    cell = registry.cell(args.workload)

    import torch
    marks = [("imports", time.perf_counter())]
    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < cell.chips):
        print(f"pds_bench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}", file=sys.stderr)
        return 2
    import practicaldeepstereo_nips2018_tpu_torch as program
    if ROOT not in Path(program.__file__).resolve().parents:
        print(f"pds_bench: {PROGRAM} comes from {program.__file__}, not "
              f"from this checkout ({ROOT})", file=sys.stderr)
        return 2
    from practicaldeepstereo_nips2018_tpu_torch.ops import kernels

    kernels.build()
    marks.append(("kernels", time.perf_counter()))
    print(json.dumps({"card": _card(torch), "torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)
    torch.zeros(1, device="cuda")
    marks.append(("context", time.perf_counter()))
    outcome = measure(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", PROCESS_START, marks)
    found = forbidden_modules()
    if found:
        print(f"pds_bench: modules of JAX or the JAX package were "
              f"imported: {found}", file=sys.stderr)
        return 3
    print(json.dumps(outcome["info"]), flush=True)
    for name, check in outcome["result"]["checks"].items():
        print(f"check {name} {check['value']!r} limit {check['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(outcome["result"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
