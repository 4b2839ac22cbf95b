"""The harness finds every cell's configuration, traffic, limits, metric
readers and architecture by the names in ``BENCHMARK.json``, and the file
keeps to the shape the benchmark's contract gives it."""

import json
import re

import pytest

from pds_bench import registry

BENCHMARK = json.loads((registry.ROOT / "BENCHMARK.json").read_text())
WORKLOADS = [entry["name"] for entry in BENCHMARK["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_found_by_name(workload):
    cell = registry.cell(workload)
    assert cell.traffic["kind"] in ("serve", "train")
    assert cell.limits["numbers"]
    assert {metric["name"] for metric in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2
    assert cell.per_layer
    for metric in cell.per_layer:
        base = metric["name"].split(".")[0]
        assert callable(cell.readers[base].read)
    # A configuration that names no architecture runs PDS.
    assert "architecture" not in cell.config
    assert cell.yardstick.__file__ == str(
        registry.PACKAGE / "architectures" / "pds.py")
    assert cell.driver.__file__ == str(registry.PACKAGE / "drivers" /
                                       "pds.py")


def test_unknown_workload_raises():
    with pytest.raises(KeyError):
        registry.cell("no-such-cell")


def test_unknown_reader_raises():
    with pytest.raises(FileNotFoundError):
        registry.reader("no_such_metric")


@pytest.mark.parametrize("present, missing", [
    ((), "architectures/solo.py"), (("architectures",), "drivers/solo.py")])
def test_a_missing_architecture_module_is_named(tmp_path, present, missing):
    benchmark = dict(BENCHMARK, configs=[dict(
        BENCHMARK["configs"][0], file="solo.json")])
    config = json.loads((registry.ROOT / BENCHMARK["configs"][0]["file"]
                         ).read_text())
    (tmp_path / "solo.json").write_text(json.dumps(dict(
        config, architecture="solo")))
    for kind in present:
        (tmp_path / kind).mkdir()
        (tmp_path / kind / "solo.py").write_text("")
    workload = BENCHMARK["workloads"][0]["name"]
    with pytest.raises(FileNotFoundError, match=missing):
        registry.cell(workload, benchmark, root=tmp_path,
                      directories=(registry.PACKAGE, tmp_path))


def test_benchmark_keys_and_names():
    assert set(BENCHMARK) == {"command", "paths", "run_seconds", "configs",
                              "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCHMARK["run_seconds"] <= 51
    names = []
    for config in BENCHMARK["configs"]:
        assert set(config) == {"name", "source", "file", "reduced", "why"}
        assert config["file"].startswith("pds_bench/")
        names.append(config["name"])
    for entry in BENCHMARK["workloads"]:
        assert set(entry) == {"name", "config", "traffic", "chips", "why"}
        assert entry["chips"] == 1 and len(entry["why"]) <= 200
        names += [entry["name"], entry["traffic"]]
    layers = set()
    for metric in BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]:
        assert UNIT.match(metric["unit"]) and metric["better"] in (
            "lower", "higher")
        names.append(metric["name"])
        if "layer" in metric:
            layers.add(metric["layer"])
            assert metric["moves"] in {m["name"] for m in
                                       BENCHMARK["end_to_end"]}
    assert all(NAME.match(name) for name in names)
    assert layers == {"serving", "embedding", "matching", "regularization",
                      "trainer", "kernels", "device"}
    for metric in BENCHMARK["end_to_end"]:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")


def test_per_layer_metrics_report_what_they_move():
    """A per-layer metric lists only cells that report the end-to-end
    metric it moves."""
    reports = {workload: {metric["name"] for metric in
                          registry.cell(workload).end_to_end}
               for workload in WORKLOADS}
    for metric in BENCHMARK["per_layer"]:
        for workload in metric["workloads"]:
            assert metric["moves"] in reports[workload], metric["name"]


def test_configuration_files_hold_the_port_widths():
    from practicaldeepstereo_nips2018_tpu_torch.models import network
    defaults = network.PDSConfig()
    for config in BENCHMARK["configs"]:
        values = json.loads((registry.ROOT / config["file"]).read_text())
        for field in ("number_of_embedding_features",
                      "number_of_matching_features",
                      "number_of_regularization_features",
                      "number_of_signature_features",
                      "number_of_shortcut_features"):
            assert values[field] == getattr(defaults, field)
        assert values["assumed"]
