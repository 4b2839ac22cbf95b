"""PDS's inputs, weights, ground truth and compared numbers are those of
the harness before architectures were found by name.

The digests and numbers were recorded at commit a38636e (the last before
``architectures/`` and ``drivers/``) with torch 2.13.0+cpu on the CPU:
``generator.make_weights(config, seed, "cpu")``, and
``make_pairs``/``make_ground_truth`` of the configuration's training
traffic with ``count=2``, hashed by :func:`_digest`; and ``runner.check()``
of each tiny cell at seed ``2**31 + 5`` with one CPU thread (the CPU's
convolutions sum in another order on more threads), every pair of a
serving cell served once, as the tests below drive them.
"""

import hashlib

import pytest
import torch

from pds_bench import cells, generator, reference, registry
from pds_bench.tests.tiny import tiny_cell

# (configuration, seed): (weights, pairs, ground truth).
DIGESTS = {
    ("pds-ft3d", 0): ("e238933835026fbd0e1caf097459aebe",
                      "e1304859958fc2e475dadb1c15745810",
                      "707fcb0bd826a2bb2065d6c01a47f904"),
    ("pds-ft3d", 1): ("10d52347d0739d57e1db34544d42d85e",
                      "781f9d795fb8a36d7a04c1dda440bfd5",
                      "8d000139364aab38ad4629d9c2ed308d"),
    ("pds-ft3d", 2): ("065e3ad3a72419c6232d7f1fc6620ebc",
                      "5ed863e9550e6f41d0e31a0f66954feb",
                      "ff26764943e9bfa90408dedbc1ae2ddd"),
    ("pds-kitti", 0): ("e238933835026fbd0e1caf097459aebe",
                       "8e72ba7a90f92b7f30379100b89cc863",
                       "3bfd03a34e941c60a8bcc0d2c9527bfe"),
    ("pds-kitti", 1): ("10d52347d0739d57e1db34544d42d85e",
                       "fe49d2065db7b13a19c66d720f832646",
                       "e7e3489923769ec58ca4abd068cc1f1a"),
    ("pds-kitti", 2): ("065e3ad3a72419c6232d7f1fc6620ebc",
                       "d6bc94853dc4337ea5d0d32f8166eb82",
                       "d412621f5280cac47db116eb0e0a265b"),
}
TRAIN_CELLS = {"pds-ft3d": "ft3d-train-b1", "pds-kitti": "kitti-train-b4"}
NUMBERS = {
    "ft3d-serve-b1": {"gap_square_mean": 0.0, "share_over_0.1": 0.0,
                      "offset_mean_px": 0.00010336705734805456,
                      "offset_share_over_0.25": 3.968253968253968e-05},
    "ft3d-train-b1": {"loss_gap_first": 1.1258642992704963e-07,
                      "gradient_gap_median": 0.0013981356153006347,
                      "gradient_gap": 0.011931156603818606,
                      "change_gap_median": 0.04701460159573871},
    "kitti-serve-b4": {"gap_square_mean": 0.0, "share_over_0.1": 0.0,
                       "offset_mean_px": 7.61100933665321e-06,
                       "offset_share_over_0.25": 0.0},
    "kitti-train-b4": {"loss_gap_first": 7.905038867814345e-08,
                       "gradient_gap_median": 0.001019555275053317,
                       "gradient_gap": 0.0022891774803807338,
                       "change_gap_median": 0.029314046415233542},
}


def _digest(tensors) -> str:
    """SHA-256 over each tensor's shape, dtype and bytes, in order."""
    digest = hashlib.sha256()
    for tensor in tensors:
        digest.update(str(tuple(tensor.shape)).encode())
        digest.update(str(tensor.dtype).encode())
        digest.update(tensor.detach().contiguous().cpu().numpy().tobytes())
    return digest.hexdigest()[:32]


@pytest.mark.parametrize("config, seed", sorted(DIGESTS))
def test_generator_digests(config, seed):
    cell = registry.cell(TRAIN_CELLS[config])
    weights = cells.make_weights(cell.yardstick, cell.config, seed, "cpu")
    assert list(weights) == list(reference.parameter_shapes(cell.config))
    pairs = generator.make_pairs(cell.config, cell.traffic, seed, "cpu", 2)
    truth = generator.make_ground_truth(cell.config, cell.traffic, seed,
                                        "cpu", 2)
    assert (_digest(weights.values()), _digest([pairs.left, pairs.right]),
            _digest([truth])) == DIGESTS[config, seed]


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("workload", sorted(NUMBERS))
def test_tiny_check_numbers(workload, one_thread):
    cell = tiny_cell(workload)
    runner = cells.KINDS[cell.traffic["kind"]](cell, 2 ** 31 + 5, "cpu")
    if runner.kind == "serve":
        runner.kept = {index: runner.iteration(index)
                       for index in range(len(runner.left))}
    runner.free()
    assert runner.check() == NUMBERS[workload]
