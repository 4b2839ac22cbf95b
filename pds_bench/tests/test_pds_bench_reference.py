"""The plain reference agrees with the port's CPU path at a small size in
float32: similarities, served maps, the loss, the first gradient and three
RMSprop steps; and PDS's yardstick (``architectures/pds.py``) judges a
served map by the reference's scores."""

import pytest
import torch

from pds_bench import cells, generator, reference, registry
from pds_bench.tests.tiny import tiny_cell

SEED = 2 ** 31 + 77
PDS = registry.cell("kitti-serve-b4")
yardstick, driver = PDS.yardstick, PDS.driver


@pytest.fixture(scope="module")
def serving():
    from practicaldeepstereo_nips2018_tpu_torch.models import network
    cell = tiny_cell("kitti-serve-b4")
    config = cell.config
    weights = cells.make_weights(yardstick, config, SEED, "cpu")
    pairs = generator.make_pairs(config, cell.traffic, SEED, "cpu", 1)
    program = network.PdsNetwork(driver.program_config(config, 63))
    program.load_state_dict(weights)
    return config, weights, pairs.left[0], pairs.right[0], program


def test_similarities_and_maps(serving):
    from practicaldeepstereo_nips2018_tpu_torch.models import network
    config, weights, left, right, program = serving
    program_config = driver.program_config(config, 63)
    with torch.no_grad():
        ours = reference.Network(weights, config).similarities(left, right,
                                                               63)
        theirs = network.apply(program, left, right, program_config,
                               device="cpu").permute(0, 3, 1, 2)
    assert ours.shape == (4, 32, 70, 90)
    assert float((ours - theirs).abs().max()) <= 1e-3 * float(
        theirs.abs().max())
    served = network.infer(program, left, right, program_config,
                           device="cpu")
    # A near tie of two levels may go either way under rounding, so the
    # served map is judged by the reference's scores, not against its map.
    gaps = yardstick.served_gaps(ours, served, 4, 2)
    assert float(gaps.max()) < 1e-3
    # Where the best levels agree, so do the sub-pixel estimates, but for
    # the rare near tie that rounding settles the other way.
    offsets = (served - reference.subpixel_map(ours, 4, 2)).abs()[gaps == 0]
    assert float(offsets.mean()) < 1e-3
    assert float((offsets > 0.25).double().mean()) < 1e-3


def test_served_gaps_flag_wrong_and_missing_answers(serving):
    config, weights, left, right, _ = serving
    with torch.no_grad():
        scores = reference.Network(weights, config).similarities(
            left[:1], right[:1], 63)
    best = reference.subpixel_map(scores, 4, 2)
    assert float(yardstick.served_gaps(scores, best, 4, 2).max()) == 0.0
    moved = best + 20.0
    assert float(yardstick.served_gaps(scores, moved, 4, 2).mean()) > 0.0
    missing = best.clone()
    missing[0, 0, 0] = float("nan")
    assert yardstick.served_gaps(scores, missing, 4, 2).max() == float(
        "inf")


def test_serve_numbers_judge_the_sub_pixel_step(serving):
    config, weights, left, right, _ = serving
    with torch.no_grad():
        scores = reference.Network(weights, config).similarities(
            left[:1], right[:1], 63)
    best = reference.subpixel_map(scores, 4, 2)

    def numbers(served):
        return yardstick.serve_numbers({
            "gap": yardstick.served_gaps(scores, served, 4, 2).flatten(),
            "offset": (served - best).abs().flatten().double()})

    assert numbers(best) == {"gap_square_mean": 0.0, "share_over_0.1": 0.0,
                             "offset_mean_px": 0.0,
                             "offset_share_over_0.25": 0.0}
    # Moved inside the estimator's window: the best level still agrees, the
    # sub-pixel step does not.
    moved = numbers(best + 1.0)
    assert moved["offset_mean_px"] == pytest.approx(1.0, abs=1e-5)
    assert moved["offset_share_over_0.25"] == 1.0
    level = 2.0 * scores.argmax(dim=1).float()
    assert numbers(level)["offset_mean_px"] > 0.05


def test_train_steps():
    from practicaldeepstereo_nips2018_tpu_torch.models import network
    from practicaldeepstereo_nips2018_tpu_torch.training import (
        optimizer, trainer)
    cell = tiny_cell("kitti-train-b4")
    config = cell.config
    weights = cells.make_weights(yardstick, config, SEED, "cpu")
    pairs = generator.make_pairs(config, cell.traffic, SEED, "cpu", 3)
    truth = generator.make_ground_truth(config, cell.traffic, SEED, "cpu",
                                        3)
    batches = [(pairs.left[i], pairs.right[i], truth[i]) for i in range(3)]
    losses, gradients, changes = reference.steps(
        weights, config, batches, 63, 1e-3, 0.99, 1e-8, 1.0)
    program_config = driver.program_config(config, 63)
    program = network.PdsNetwork(program_config)
    program.load_state_dict(weights)
    rmsprop = optimizer.rmsprop(program.parameters(), 1e-3)
    theirs = []
    for step, (left, right, ground_truth) in enumerate(batches):
        theirs.append(float(trainer.train_step(
            program, rmsprop, left, right, ground_truth, 1e-3,
            program_config, None, 1.0, "cpu")))
        if step == 0:
            first = {name: value.grad.clone()
                     for name, value in program.named_parameters()}
    # RMSprop's first step is lr * sign(g) per weight, so weights whose
    # gradient is round-off take either sign: later losses part slightly.
    assert losses[0] == pytest.approx(theirs[0], rel=1e-5)
    assert losses == pytest.approx(theirs, rel=5e-3)
    norms = {key: float(value.norm()) for key, value in gradients.items()}
    median = sorted(norms.values())[len(norms) // 2]
    # A LeakyReLU input within rounding of 0 takes either branch, so even
    # two float32 gradients part by about a percent of a leaf's norm.
    for key, gradient in gradients.items():
        assert float((gradient - first[key]).norm()) <= 3e-2 * max(
            norms[key], median), key
    # After the first step each weight whose gradient is round-off moves
    # by a random share of lr, so a leaf whose gradient is mostly such
    # weights (a norm's bias before a conv and a norm) parts by some
    # tens of percent at this size: 25 % of the larger of its norm and the
    # median leaf's.
    moved = {name: float((value.detach() - weights[name]).norm())
             for name, value in program.named_parameters()}
    change_norms = {key: float(value.norm()) for key, value in
                    changes.items()}
    median = sorted(change_norms.values())[len(change_norms) // 2]
    for key, norm in change_norms.items():
        if norms[key] >= 1e-3 * sorted(norms.values())[len(norms) // 2]:
            assert abs(norm - moved[key]) <= 0.25 * max(norm, median), key
