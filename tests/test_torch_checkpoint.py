"""PyTorch port, checkpoint writing (``training/checkpoint.py``) in the JAX
package's ``.npz`` contract, both ways: a checkpoint the port writes after
two train steps loads in the JAX package (``training/checkpoint.py::
load_checkpoint`` with templates ``params`` and ``rmsprop().init(params)``,
and ``PDSTrainer.load_checkpoint``) leaf for leaf, and the port resumes from
one the JAX package wrote, network and RMSprop state, and steps on. Narrow
widths, 40x56 images, D=63, float32 on the CPU; leaves compared exactly."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from practicaldeepstereo_nips2018_tpu import models as jax_models
from practicaldeepstereo_nips2018_tpu.training import (
    PDSTrainer, checkpoint as jax_checkpoint, rmsprop as jax_rmsprop)
from practicaldeepstereo_nips2018_tpu_torch import models
from practicaldeepstereo_nips2018_tpu_torch.training import (
    checkpoint, optimizer, trainer, weights)

torch.set_num_threads(1)

NARROW = dict(maximum_disparity=63, number_of_embedding_features=16,
              number_of_matching_features=16,
              number_of_embedding_residual_blocks=1,
              number_of_matching_residual_blocks=1)
CONFIG = models.PDSConfig(**NARROW)


def _trained(seed=3, steps=2):
    network = models.PdsNetwork(CONFIG)
    network.load_state_dict(weights.state_dict_from_jax_params(
        weights.random_jax_params(CONFIG, seed)))
    rmsprop = optimizer.rmsprop(network.parameters())
    rng = np.random.RandomState(seed)
    losses = []
    for _ in range(steps):
        left = rng.uniform(0, 255, (1, 40, 56, 3)).astype(np.float32)
        right = rng.uniform(0, 255, (1, 40, 56, 3)).astype(np.float32)
        ground_truth = rng.uniform(0, 60, (1, 40, 56)).astype(np.float32)
        losses.append(float(trainer.train_step(
            network, rmsprop, left, right, ground_truth, 1e-2, CONFIG,
            device="cpu")))
    return network, rmsprop, losses


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    network, rmsprop, losses = _trained()
    path = str(tmp_path_factory.mktemp("port") / "001_checkpoint.npz")
    checkpoint.save_training_state(
        path, network, rmsprop,
        trainer.checkpoint_metadata(CONFIG, [np.mean(losses)],
                                    [{"three_pixels_error": 50.0,
                                      "mean_absolute_error": 9.0}]))
    return path, network, rmsprop


def test_jax_package_reads_what_the_port_writes(written):
    path, network, rmsprop = written
    assert not os.path.exists(path + ".tmp")
    params = weights.jax_tree_of_parameters(network,
                                            lambda _, parameter: parameter)
    templates = {"params": params,
                 "opt_state": jax_rmsprop().init(params)}
    trees, metadata = jax_checkpoint.load_checkpoint(path, templates)
    expected = checkpoint.training_trees(network, rmsprop)
    for name in ("params", "opt_state"):
        got, want = jax.tree.leaves(trees[name]), checkpoint.tree_leaves(
            expected[name])
        assert len(got) == len(want) == len(jax.tree.leaves(params))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(np.asarray(a), b)
    assert np.count_nonzero(jax.tree.leaves(trees["opt_state"])[0])
    assert metadata["rmsprop_step"] == 2
    assert metadata["network_config"]["number_of_embedding_features"] == 16
    assert set(metadata) >= {"training_losses", "test_errors",
                             "learning_rate_scheduler", "network_config",
                             "loss_diversity"}


def test_jax_trainer_resumes_from_the_port(written):
    path, network, _ = written
    jax_config = jax_models.PDSConfig(**NARROW)
    reader = PDSTrainer(network_config=jax_config,
                        params=weights.random_jax_params(CONFIG, 9))
    reader.load_checkpoint(path)
    assert reader.current_epoch == 1
    for a, b in zip(jax.tree.leaves(reader.params), checkpoint.tree_leaves(
            weights.jax_tree_of_parameters(network, lambda _, p: p))):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_port_round_trip(written):
    path, network, rmsprop = written
    other = models.PdsNetwork(CONFIG)
    other_rmsprop = optimizer.rmsprop(other.parameters())
    metadata = checkpoint.load_training_state(path, other, other_rmsprop)
    assert metadata["training_losses"] and metadata["rmsprop_step"] == 2
    for (name, a), b in zip(network.state_dict().items(),
                            other.state_dict().values()):
        assert torch.equal(a, b), name
    for parameter, restored in zip(network.parameters(),
                                   other.parameters()):
        assert torch.equal(rmsprop.state[parameter]["square_avg"],
                           other_rmsprop.state[restored]["square_avg"])
        assert int(other_rmsprop.state[restored]["step"]) == 2
    network_only = models.PdsNetwork(CONFIG)
    checkpoint.load_training_state(path, network_only)
    assert all(torch.equal(a, b) for a, b in zip(
        network.state_dict().values(), network_only.state_dict().values()))


def test_port_resumes_from_the_jax_package(tmp_path):
    params = weights.random_jax_params(CONFIG, seed=4)
    state = jax_rmsprop().init(params)
    rng = np.random.RandomState(4)
    state = jax.tree.map(lambda leaf: jnp.asarray(rng.uniform(
        1e-6, 1e-2, leaf.shape).astype(np.float32)), state)
    path = str(tmp_path / "002_checkpoint.npz")
    jax_checkpoint.save_checkpoint(
        path, {"params": params, "opt_state": state},
        {"training_losses": [3.0, 2.5], "test_errors": [{}, {}]})

    network = models.PdsNetwork(CONFIG)
    rmsprop = optimizer.rmsprop(network.parameters())
    metadata = checkpoint.load_training_state(path, network, rmsprop)
    assert metadata["training_losses"] == [3.0, 2.5]
    trees = checkpoint.training_trees(network, rmsprop)
    for a, b in zip(checkpoint.tree_leaves(trees["params"]),
                    jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    for a, b in zip(checkpoint.tree_leaves(trees["opt_state"]),
                    jax.tree.leaves(state)):
        np.testing.assert_array_equal(a, np.asarray(b))
    # No step count in a JAX checkpoint: RMSprop restarts it at 0, which
    # its update does not read, and steps on from the restored averages.
    assert all(int(entry["step"]) == 0 for entry in rmsprop.state.values())
    rng = np.random.RandomState(5)
    value = trainer.train_step(
        network, rmsprop, rng.uniform(0, 255, (1, 40, 56, 3)),
        rng.uniform(0, 255, (1, 40, 56, 3)),
        rng.uniform(0, 60, (1, 40, 56)), 1e-2, CONFIG, device="cpu")
    assert torch.isfinite(value)
    assert all(int(entry["step"]) == 1 for entry in rmsprop.state.values())


def test_metadata_is_json_with_the_jax_trainer_keys():
    metadata = trainer.checkpoint_metadata(CONFIG, [np.float32(2.5)])
    assert json.loads(json.dumps(metadata)) == metadata
    jax_config = jax_models.PDSConfig(**NARROW)
    import dataclasses
    assert metadata["network_config"] == dataclasses.asdict(jax_config)
