"""The control comes out not correct: the nearest precision below the one
the configuration states, in the program's place. For serving, the port's
own int8 path (the driver's ``CONTROLS["int8"]``, ``matching_tail_int8``);
for training, the reference computed in float8 e4m3, forward and backward
(the yardstick's ``LOWERED["fp8"]``). On the card at each cell's
own size (``chip``) against the cell's limits; on the CPU at a small size,
where the limits set for the cell's size do not apply, against a sound run
of the port (float32) at that size: the control reads at least three
times as much on one of the compared numbers."""

import pytest

from pds_bench import calibrate, cells, registry
from pds_bench.tests.tiny import tiny_cell

WORKLOADS = ["ft3d-serve-b1", "kitti-serve-b4", "ft3d-train-b1",
             "kitti-train-b4"]
SEED = 2 ** 31 + 999


def _control(cell, device):
    if cell.traffic["kind"] == "serve":
        numbers, _, _ = calibrate.program_reading(
            cell, SEED, 0.5, device, **cell.driver.CONTROLS["int8"])
        return numbers
    numbers, _ = calibrate.reference_reading(cell, SEED, device,
                                             cell.yardstick.LOWERED["fp8"])
    return numbers


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_separates_at_a_small_size(workload):
    cell = tiny_cell(workload)
    sound, _, _ = calibrate.program_reading(cell, SEED, 0.3, "cpu")
    control = _control(cell, "cpu")
    ratios = {name: control[name] / max(sound[name], 1e-12)
              for name in cell.limits["numbers"]}
    assert max(ratios.values()) >= 3, ratios


@pytest.mark.chip
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_at_the_cells_size(workload, cuda_card):
    cell = registry.cell(workload)
    correct, checks = cells.compare(_control(cell, cuda_card), cell.limits)
    assert not correct, checks
