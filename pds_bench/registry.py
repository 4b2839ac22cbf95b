"""Finds a cell's configuration, traffic, limits, metric readers and
architecture by name.

Everything is read from ``BENCHMARK.json`` at the root of the checkout and
from files named after the entries there:

* the configuration: the ``file`` of its ``configs`` entry, under the
  root; its optional ``"architecture"`` key names the architecture, and
  without it the architecture is ``"pds"``;
* the traffic: ``traffic/<traffic>.json``;
* the limits that decide ``correct``: ``limits/<workload>.json``;
* a per-layer metric's reader: ``metrics/<base>.py``, ``<base>`` being
  the metric's name up to its first dot;
* the architecture's yardstick, ``architectures/<architecture>.py``, and
  its driver of the port, ``drivers/<architecture>.py``
  (``architectures/__init__.py`` says what each provides).

All but the configuration are looked for in ``directories`` in order, by
default ``pds_bench/`` alone, and the first found is taken.

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
DIRECTORIES = (PACKAGE,)
DEFAULT_ARCHITECTURE = "pds"


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
    yardstick: types.ModuleType
    driver: types.ModuleType


def _load_json(path: Path) -> dict:
    with open(path) as handle:
        return json.load(handle)


def _lists(metric: dict, workload: str) -> bool:
    return workload in metric.get("workloads", [workload])


def _find(kind: str, file: str, directories, what: str) -> Path:
    paths = [Path(directory) / kind / file for directory in directories]
    for path in paths:
        if path.is_file():
            return path
    raise FileNotFoundError(
        f"no {what}: none of {', '.join(map(str, paths))} exists")


def _module(kind: str, name: str, directories, what: str
            ) -> types.ModuleType:
    path = _find(kind, f"{name}.py", directories, what)
    spec = importlib.util.spec_from_file_location(
        f"pds_bench.{kind}.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(base: str, directories=DIRECTORIES) -> types.ModuleType:
    """The reader module ``metrics/<base>.py``."""
    return _module("metrics", base, directories, f"reader for metric "
                   f"{base!r}")


def cell(workload: str, benchmark: dict | None = None, root: Path = ROOT,
         directories=DIRECTORIES) -> Cell:
    if benchmark is None:
        benchmark = _load_json(Path(root) / "BENCHMARK.json")
    entries = {entry["name"]: entry for entry in benchmark["workloads"]}
    if workload not in entries:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; it has "
                       f"{sorted(entries)}")
    entry = entries[workload]
    configs = {config["name"]: config for config in benchmark["configs"]}
    config = _load_json(Path(root) / configs[entry["config"]]["file"])
    traffic = _load_json(_find("traffic", f"{entry['traffic']}.json",
                               directories, f"traffic {entry['traffic']!r}"))
    limits = _load_json(_find("limits", f"{workload}.json", directories,
                              f"limits for {workload!r}"))
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
            readers[base] = reader(base, directories)
    architecture = config.get("architecture", DEFAULT_ARCHITECTURE)
    yardstick = _module("architectures", architecture, directories,
                        f"yardstick of architecture {architecture!r}")
    driver = _module("drivers", architecture, directories,
                     f"driver of architecture {architecture!r}")
    return Cell(workload, entry["chips"], config, traffic, limits,
                end_to_end, per_layer, readers, yardstick, driver)
