"""The benchmark's frozen accounting equals the port's counts today, at
the four cells' shapes: the useful MACs of ``utils/flops.py`` and the
bounds of ``chip_smoke.py``. The port may change later; these copies may
not."""

import sys

import pytest
import torch

from pds_bench import accounting, registry

sys.path.insert(0, str(registry.ROOT))
import chip_smoke  # noqa: E402
from practicaldeepstereo_nips2018_tpu_torch.ops import (  # noqa: E402
    conv_transpose3d)
from practicaldeepstereo_nips2018_tpu_torch.utils import flops  # noqa: E402

# (padded height, padded width, maximum disparity) of each cell.
SHAPES = {"ft3d-serve-b1": (576, 960, 191), "ft3d-train-b1": (576, 960, 255),
          "kitti-serve-b4": (384, 1280, 255),
          "kitti-train-b4": (384, 1280, 255)}


@pytest.mark.parametrize("workload", sorted(SHAPES))
def test_cell_shapes(workload):
    cell = registry.cell(workload)
    kind = cell.traffic["kind"]
    assert (*cell.yardstick.padded_size(cell.config),
            cell.config[f"{kind}_maximum_disparity"]) == SHAPES[workload]


@pytest.mark.parametrize("workload", sorted(SHAPES))
def test_useful_macs_equal_the_port(workload):
    height, width, disparity = SHAPES[workload]
    port = sum(stage.useful for stage in
               flops.forward_macs(height, width, disparity))
    assert accounting.forward_useful_macs(height, width, disparity) == port
    train = flops.training_macs(height, width, disparity)["useful_gmacs"]
    assert round(accounting.train_useful_macs(height, width, disparity)
                 / 1e9, 2) == train
    cell = registry.cell(workload)
    kind = cell.traffic["kind"]
    assert cell.yardstick.useful_macs(cell.config, kind) == (
        port if kind == "serve" else
        accounting.train_useful_macs(height, width, disparity))


def test_peak_equals_the_port():
    for name in ("NVIDIA H100 80GB HBM3", "NVIDIA H200", "NVIDIA A100"):
        assert (accounting.peak_bf16_flops(name)
                == flops.peak_bf16_flops(name))
    assert accounting.MEMORY_BYTES_PER_S == chip_smoke.MEMORY_BYTES_PER_S
    assert accounting.PEAK_OPS_PER_S["bfloat16"] == \
        chip_smoke.PEAK_OPS_PER_S[torch.bfloat16]
    assert accounting.PEAK_OPS_PER_S["float32"] == \
        chip_smoke.PEAK_OPS_PER_S[torch.float32]


def _levels(depth, height, width):
    """(channels, depth, height, width) of the hourglass's levels."""
    return [(8 * 2 ** level, -(-depth // 2 ** level),
             -(-height // 2 ** level), -(-width // 2 ** level))
            for level in range(5)]


@pytest.mark.parametrize("workload", sorted(SHAPES))
def test_k1_bounds_equal_chip_smoke(workload):
    height, width, disparity = SHAPES[workload]
    batch = registry.cell(workload).traffic["batch"]
    for channels, depth, rows, columns in _levels((disparity + 1) // 4,
                                                  height // 4, width // 4):
        shape = (batch, channels, depth, rows, columns)
        voxels = batch * depth * rows * columns
        expected = chip_smoke.bound(
            2 * (2 * channels * voxels + 27 * channels * channels)
            + 4 * channels, 2.0 * voxels * channels * channels * 27,
            torch.bfloat16)["bound_ms"]
        got = accounting.conv_bound_ms(shape, (channels, channels, 3, 3, 3),
                                       shape, (1, 1, 1), (1, 1, 1), False,
                                       "bfloat16")
        assert got == pytest.approx(expected, rel=1e-12)


@pytest.mark.parametrize("workload", sorted(SHAPES))
def test_transposed_bounds_equal_chip_smoke(workload):
    height, width, disparity = SHAPES[workload]
    batch = registry.cell(workload).traffic["batch"]
    levels = _levels((disparity + 1) // 4, height // 4, width // 4)
    cases = [((batch, c, d, h, w), (c, c // 2, 4, 4, 4), (2, 2, 2),
              (1, 1, 1)) for c, d, h, w in levels[1:]]
    cases.append(((batch, 8) + levels[0][1:], (8, 4, 4, 4, 4), (2, 2, 2),
                  (1, 1, 1)))
    cases.append(((batch, 4, 2 * levels[0][1], 2 * levels[0][2],
                   2 * levels[0][3]), (4, 1, 3, 4, 4), (1, 2, 2),
                  (1, 1, 1)))
    for input_shape, weight_shape, stride, padding in cases:
        x = torch.empty(input_shape, dtype=torch.bfloat16, device="meta")
        weight = torch.empty(weight_shape, dtype=torch.bfloat16,
                             device="meta")
        expected = chip_smoke._k3_bound(x, weight, stride, padding)
        output = conv_transpose3d.output_shape(input_shape, weight_shape,
                                               stride, padding)
        got = accounting.conv_bound_ms(input_shape, weight_shape, output,
                                       stride, padding, True, "bfloat16")
        assert got == pytest.approx(expected["bound_ms"], rel=1e-12)
        assert accounting.transposed_macs(
            input_shape, weight_shape, stride, padding) == \
            chip_smoke.transposed_macs(input_shape, weight_shape, stride,
                                       padding)
