"""Finds a cell's configuration, traffic, metrics and limits by name.

Everything is read from ``BENCHMARK.json`` at the root of the checkout and
from files under ``pds_bench/`` named after the entries there:

* the configuration: the ``file`` of its ``configs`` entry;
* the traffic: ``pds_bench/traffic/<traffic>.json``;
* the limits that decide ``correct``: ``pds_bench/limits/<workload>.json``;
* a per-layer metric's reader: ``pds_bench/metrics/<base>.py``, ``<base>``
  being the metric's name up to its first dot.

A cell reports the end-to-end metrics that list it, or list no cells, and
the per-layer metrics that list it, or list no cells and move an
end-to-end metric that it reports.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]
    readers: dict[str, types.ModuleType]


def _load_json(path: Path) -> dict:
    with open(path) as handle:
        return json.load(handle)


def _lists(metric: dict, workload: str) -> bool:
    return workload in metric.get("workloads", [workload])


def reader(base: str) -> types.ModuleType:
    """The reader module ``pds_bench/metrics/<base>.py``."""
    path = PACKAGE / "metrics" / f"{base}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader {path} for metric {base!r}")
    spec = importlib.util.spec_from_file_location(
        f"pds_bench.metrics.{base}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell(workload: str, benchmark: dict | None = None,
         root: Path = ROOT) -> Cell:
    if benchmark is None:
        benchmark = _load_json(root / "BENCHMARK.json")
    entries = {entry["name"]: entry for entry in benchmark["workloads"]}
    if workload not in entries:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; it has "
                       f"{sorted(entries)}")
    entry = entries[workload]
    configs = {config["name"]: config for config in benchmark["configs"]}
    config = _load_json(root / configs[entry["config"]]["file"])
    traffic = _load_json(PACKAGE / "traffic" / f"{entry['traffic']}.json")
    limits = _load_json(PACKAGE / "limits" / f"{workload}.json")
    end_to_end = [metric for metric in benchmark["end_to_end"]
                  if _lists(metric, workload)]
    reported = {metric["name"] for metric in end_to_end}
    per_layer = [metric for metric in benchmark["per_layer"]
                 if (workload in metric["workloads"] if "workloads" in metric
                     else metric["moves"] in reported)]
    readers = {}
    for metric in per_layer:
        base = metric["name"].split(".")[0]
        if base not in readers:
            readers[base] = reader(base)
    return Cell(workload, entry["chips"], config, traffic, limits,
                end_to_end, per_layer, readers)
