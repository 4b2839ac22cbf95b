"""A second architecture comes in from new files only: a toy stereo
regressor (``tests/toy/``: its configuration, yardstick, driver, traffic
and limits) with BatchNorm's ``running_var`` and integer
``num_batches_tracked``, trained with Adam, runs a serving and a training
cell through ``registry.cell`` and ``run.measure`` on the CPU, judged by
its own reference. The harness reaches the toy's files only through the
directories ``registry`` is given, and reads a ``BENCHMARK.json`` that
holds one more configuration and two more cells than the checkout's."""

import json
import pathlib
import shutil
import time

import pytest
import torch

from pds_bench import cells, registry, run

TOY = pathlib.Path(__file__).resolve().parent / "toy"
DIRECTORIES = (registry.PACKAGE, TOY)
CONFIG = "pds_bench/tests/toy/configs/toy-regressor.json"
SEED = 2 ** 31 + 31
REPORTED = {"toy-serve": ("serve_images_per_s", "mfu_pct.serve_batch"),
            "toy-train": ("train_images_per_s", "mfu_pct.train")}


@pytest.fixture
def checkout(tmp_path):
    """A checkout's root: ``BENCHMARK.json`` with the toy's configuration
    and cells, and the toy's configuration file."""
    benchmark = json.loads((registry.ROOT / "BENCHMARK.json").read_text())
    benchmark["configs"].append({
        "name": "toy-regressor", "source": "pds_bench/tests/toy",
        "file": CONFIG, "reduced": [],
        "why": "a second architecture from new files only"})
    for workload in REPORTED:
        benchmark["workloads"].append({
            "name": workload, "config": "toy-regressor", "traffic": workload,
            "chips": 1, "why": "the harness's own test"})
    for metric in benchmark["end_to_end"] + benchmark["per_layer"]:
        for workload, names in REPORTED.items():
            if metric["name"] in names:
                metric["workloads"].append(workload)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(benchmark))
    (tmp_path / CONFIG).parent.mkdir(parents=True)
    shutil.copy(registry.ROOT / CONFIG, tmp_path / CONFIG)
    return tmp_path


def _cell(workload, root):
    return registry.cell(workload, root=root, directories=DIRECTORIES)


def test_the_toy_lives_only_under_tests():
    assert not (registry.PACKAGE / "architectures" / "toy.py").exists()
    assert not (registry.PACKAGE / "drivers" / "toy.py").exists()
    with pytest.raises(KeyError):
        registry.cell("toy-serve")


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("workload", sorted(REPORTED))
def test_a_second_architecture_runs_and_is_correct(checkout, workload,
                                                   traced):
    cell = _cell(workload, checkout)
    assert cell.yardstick.__file__ == str(TOY / "architectures" / "toy.py")
    assert cell.driver.__file__ == str(TOY / "drivers" / "toy.py")
    outcome = run.measure(cell, SEED, 0.3, traced, "cpu",
                          time.perf_counter())
    result = outcome["result"]
    assert result["correct"] is True, outcome["info"]["numbers"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["checks"]) == set(cell.limits["numbers"])
    if not traced:
        assert set(result["metrics"]) == {"setup_s", REPORTED[workload][0]}


@pytest.mark.parametrize("workload, fault", [("toy-serve", "altered_answer"),
                                             ("toy-train", "unchanged")])
def test_a_fault_in_the_second_architecture_is_not_correct(checkout,
                                                           workload, fault):
    cell = _cell(workload, checkout)
    with cell.driver.planted(fault):
        outcome = run.measure(cell, SEED, 0.3, False, "cpu",
                              time.perf_counter())
    assert outcome["result"]["correct"] is False, outcome["info"]["numbers"]


def test_batch_norm_buffers_follow_the_yardstick(checkout):
    """The rule the harness once applied to every key (1 for a key ending
    in ``weight``, float 0 for the rest) gets a BatchNorm's running
    variance and step count wrong; the toy's layout gets them right."""
    cell = _cell("toy-serve", checkout)
    weights = cells.make_weights(cell.yardstick, cell.config, SEED, "cpu")
    assert torch.equal(weights["tower.1.running_var"], torch.ones(8))
    assert torch.equal(weights["tower.1.running_mean"], torch.zeros(8))
    steps = weights["tower.1.num_batches_tracked"]
    assert steps.dtype == torch.int64 and int(steps) == 0
    _, network = cell.driver.serving(cell.config, cell.traffic, weights,
                                     "cpu")
    state = network.state_dict()
    assert state.keys() == weights.keys()
    assert all(torch.equal(state[key], weights[key]) for key in weights)
