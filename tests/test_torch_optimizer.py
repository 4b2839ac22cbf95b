"""PyTorch port, the optimizer (``training/optimizer.py``) against the JAX
package's ``training/optimizer.py``: five RMSprop steps over a whole
(narrow) ``PdsNetwork``, transposed convs included, against optax's
``rmsprop()`` on the same numpy-seeded gradients, with ``square_avg``
bridged into optax's ``nu`` (float32, 1e-6 absolute on parameters, 1e-6
relative on square averages); and ``multistep_lr`` equal to the JAX
schedule at epochs 0-12."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from practicaldeepstereo_nips2018_tpu.training import (
    optimizer as jax_optimizer)
from practicaldeepstereo_nips2018_tpu_torch import models
from practicaldeepstereo_nips2018_tpu_torch.training import (
    checkpoint, optimizer, weights)

NARROW = models.PDSConfig(maximum_disparity=63,
                          number_of_embedding_features=16,
                          number_of_matching_features=16,
                          number_of_embedding_residual_blocks=1,
                          number_of_matching_residual_blocks=1)
LEARNING_RATE = 1e-2


def test_rmsprop_matches_optax_over_five_steps():
    params = weights.random_jax_params(NARROW, seed=2)
    network = models.PdsNetwork(NARROW)
    network.load_state_dict(weights.state_dict_from_jax_params(params))
    assert any("upsample" in name for name, _ in network.named_parameters())
    rmsprop = optimizer.rmsprop(network.parameters(), LEARNING_RATE)
    transform = jax_optimizer.rmsprop()

    @jax.jit
    def step(params, state, gradients):
        updates, state = transform.update(gradients, state)
        return jax.tree.map(lambda p, u: p - LEARNING_RATE * u, params,
                            updates), state

    state = transform.init(params)
    rng = np.random.RandomState(0)
    for _ in range(5):
        gradients = {name: torch.from_numpy(rng.normal(
            scale=rng.choice([1e-4, 1e-2, 1.0]),
            size=parameter.shape).astype(np.float32))
            for name, parameter in network.named_parameters()}
        for name, parameter in network.named_parameters():
            parameter.grad = gradients[name].clone()
        rmsprop.step()
        params, state = step(params, state, weights.jax_tree_of_parameters(
            network, lambda name, _: gradients[name]))
    trees = checkpoint.training_trees(network, rmsprop)
    for got, want in zip(checkpoint.tree_leaves(trees["params"]),
                         jax.tree.leaves(params)):
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)
    for got, want in zip(checkpoint.tree_leaves(trees["opt_state"]),
                         jax.tree.leaves(state)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6,
                                   atol=1e-20)
    assert all(int(entry["step"]) == 5
               for entry in rmsprop.state.values())


@pytest.mark.parametrize("milestones,gamma", [((6, 7, 8, 9, 10), 0.5),
                                              ((2, 5), 0.1), ((), 0.5)])
def test_multistep_lr_matches_jax(milestones, gamma):
    port = optimizer.multistep_lr(1e-2, milestones, gamma)
    reference = jax_optimizer.multistep_lr(1e-2, milestones, gamma)
    for epoch in range(13):
        assert port(epoch) == reference(epoch), epoch


def test_set_learning_rate_reaches_every_group():
    parameters = [torch.nn.Parameter(torch.ones(2)),
                  torch.nn.Parameter(torch.ones(3))]
    rmsprop = torch.optim.RMSprop([{"params": parameters[:1]},
                                   {"params": parameters[1:]}], lr=1.0)
    optimizer.set_learning_rate(rmsprop, 0.25)
    assert [group["lr"] for group in rmsprop.param_groups] == [0.25, 0.25]
    assert jnp.isclose(optimizer.multistep_lr(1e-2)(12), 1e-2 * 0.5 ** 5)
