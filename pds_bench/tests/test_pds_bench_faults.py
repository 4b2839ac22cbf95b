"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card skipped, the rest of a run driven at a size the
CPU holds (float32, so that a sound run reads next to nothing), the cell's
own limits. One case for each fault the cell can have, planted by the
architecture's driver (``drivers/pds.py``)."""

import time

import pytest

from pds_bench import registry, run
from pds_bench.tests.tiny import tiny_cell

SEED = 2 ** 31 + 4242
driver = registry.cell("ft3d-serve-b1").driver
CASES = [("ft3d-serve-b1", name) for name in driver.SERVE_FAULTS] + [
    ("kitti-serve-b4", name) for name in driver.SERVE_FAULTS] + [
    ("ft3d-train-b1", name) for name in driver.TRAIN_FAULTS
    if name != "half_batch"] + [
    ("kitti-train-b4", name) for name in driver.TRAIN_FAULTS]


def _run(workload):
    cell = tiny_cell(workload)
    return run.measure(cell, SEED, 0.3, False, "cpu", time.perf_counter())


@pytest.mark.parametrize("workload, fault", CASES)
def test_fault_is_not_correct(workload, fault):
    with driver.planted(fault):
        outcome = _run(workload)
    assert outcome["result"]["correct"] is False, outcome["info"]["numbers"]


@pytest.mark.parametrize("workload", ["ft3d-serve-b1", "kitti-train-b4"])
def test_sound_run_is_correct(workload):
    outcome = _run(workload)
    result = outcome["result"]
    assert result["correct"] is True, outcome["info"]["numbers"]
    assert list(result)[-1] == "checks"
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) >= {"setup_s"}


def test_unknown_fault():
    with pytest.raises(ValueError):
        driver.planted("no_such_fault")
