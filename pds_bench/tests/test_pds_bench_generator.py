"""The general generator gives the same weights and traffic for the same
seed, other values for another seed, and the same sizes for every seed."""

import pytest
import torch

from pds_bench import cells, generator, reference
from pds_bench.tests.tiny import tiny_cell

SEEDS = (0, 7, 2 ** 31 + 12345, 2 ** 40 + 3)


@pytest.mark.parametrize("workload", ["ft3d-serve-b1", "kitti-train-b4"])
@pytest.mark.parametrize("seed", SEEDS)
def test_deterministic_per_seed(workload, seed):
    cell = tiny_cell(workload)
    config, traffic = cell.config, cell.traffic
    first = cells.make_weights(cell.yardstick, config, seed, "cpu")
    again = cells.make_weights(cell.yardstick, config, seed, "cpu")
    assert first.keys() == again.keys() == reference.parameter_shapes(
        config).keys()
    assert all(torch.equal(first[key], again[key]) for key in first)
    pairs = generator.make_pairs(config, traffic, seed, "cpu", 3)
    pairs_again = generator.make_pairs(config, traffic, seed, "cpu", 3)
    assert torch.equal(pairs.left, pairs_again.left)
    assert torch.equal(pairs.right, pairs_again.right)
    assert pairs.left.shape == (3, traffic["batch"], 70, 90, 3)
    assert 0 <= float(pairs.right.min()) and float(pairs.right.max()) <= 255
    truth = generator.make_ground_truth(config, traffic, seed, "cpu", 3)
    assert torch.equal(truth, generator.make_ground_truth(
        config, traffic, seed, "cpu", 3))


def test_other_seed_other_values_same_sizes():
    cell = tiny_cell("kitti-train-b4")
    config, traffic = cell.config, cell.traffic
    one = cells.make_weights(cell.yardstick, config, 1, "cpu")
    two = cells.make_weights(cell.yardstick, config, 2, "cpu")
    key = "_matching._operation._matching_operation_modules.0.weight"
    assert not torch.equal(one[key], two[key])
    assert {k: v.shape for k, v in one.items()} == {
        k: v.shape for k, v in two.items()}
    truth = generator.make_ground_truth(config, traffic, 1, "cpu", 2)
    unknown = float((~torch.isfinite(truth)).float().mean())
    assert abs(unknown - config["ground_truth"]["unknown_share"]) < 0.05
    assert float(truth[torch.isfinite(truth)].max()) < 60.0


def test_weights_follow_default_bounds():
    cell = tiny_cell("ft3d-serve-b1")
    weights = cells.make_weights(cell.yardstick, cell.config, 3, "cpu")
    head = weights["_matching._operation._matching_operation_modules.0"
                   ".weight"]
    assert float(head.abs().max()) <= 1 / (128 * 9) ** 0.5
    norm = weights["_regularization._smoothing.2.weight"]
    assert torch.equal(norm, torch.ones_like(norm))
