"""PyTorch port, the train and eval steps: ``training/trainer.py`` on the
CPU against the JAX package on the same numpy-seeded weights (with the
bounds of the JAX ``models.init``), images and ground truth (a band of
unknown rows), at narrow widths (embedding and matching 16 features, one
residual block each), 40x120 images (padded to 64x128), D=63.

A float32 gradient of this network can miss the float64 one by far more
than float32 rounding: LeakyReLU's derivative jumps from 0.1 to 1 at 0, and
a pre-activation within rounding of 0 that falls on the other side in
float32 changes its element's gradient tenfold (the JAX package's float32
gradient misses its float64 one by up to 1.5 % of a tensor's largest
element here). The gradients are therefore checked twice:

* in float64, port against JAX (``jax.enable_x64``), every tensor within
  1e-6 of its largest element (the weight bridge rounds to float32);
* in float32, the loss within 1e-5 relative, and the port's gradient as
  close to the float64 gradient as three times the JAX package's float32
  gradient is (:func:`_worst_relative_error`).

``test_float32_noise_floor_of_the_train_path`` holds the port's float32
gradient at the full-width case of ``chip_smoke.py``'s train path to the
float64 one through the same LeakyReLU branches, within the tolerance the
card is held to there.

Also: RMSprop's step on the port's gradients against optax's update on the
same gradients, within 1e-6; ``eval_step`` against JAX ``infer`` and the
``vmap``ped metrics at batch 2; every parameter reached, in float32 and
bfloat16 compute; K1's autograd Function against autograd of ``F.conv3d``
at every hourglass channel count; the K1 calls a train step makes."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from practicaldeepstereo_nips2018_tpu import models as jax_models
from practicaldeepstereo_nips2018_tpu import ops as jax_ops
from practicaldeepstereo_nips2018_tpu.training import (
    optimizer as jax_optimizer)
from practicaldeepstereo_nips2018_tpu_torch import models
from practicaldeepstereo_nips2018_tpu_torch.ops import conv3d
from practicaldeepstereo_nips2018_tpu_torch.training import (
    checkpoint, optimizer, trainer, weights)

torch.set_num_threads(1)

HEIGHT, WIDTH = 40, 120
NARROW = dict(maximum_disparity=63, number_of_embedding_features=16,
              number_of_matching_features=16,
              number_of_embedding_residual_blocks=1,
              number_of_matching_residual_blocks=1)
LEARNING_RATE = 1e-2


def _batch(seed, batch=1):
    rng = np.random.RandomState(seed)
    left = rng.uniform(0, 255, (batch, HEIGHT, WIDTH, 3)).astype(np.float32)
    right = rng.uniform(0, 255, (batch, HEIGHT, WIDTH, 3)).astype(np.float32)
    ground_truth = rng.uniform(0, 60, (batch, HEIGHT, WIDTH)).astype(
        np.float32)
    ground_truth[:, :6] = np.inf
    return left, right, ground_truth


def _network(params, config):
    network = models.PdsNetwork(config)
    network.load_state_dict(weights.state_dict_from_jax_params(params))
    return network


def _leaves(tree):
    return [np.asarray(leaf, dtype=np.float64)
            for leaf in checkpoint.tree_leaves(tree)]


def _gradient_leaves(network):
    return _leaves(weights.jax_tree_of_parameters(
        network, lambda _, parameter: parameter.grad))


def _jax_loss_function(batch, dtype):
    """The JAX package's loss of ``params`` on ``batch`` in ``dtype``."""
    left, right, ground_truth = (jnp.asarray(array, dtype) for array in batch)
    config = jax_models.PDSConfig(**NARROW)

    def loss_fn(p):
        return jax_ops.subpixel_cross_entropy(
            jax_models.apply(p, left, right, config), ground_truth,
            disparity_step=config.disparity_step)

    return loss_fn


def _jax_rmsprop_update(transform):
    """The JAX trainer's step on given gradients: optax RMSprop, then
    ``p - lr * u``; returns (params, state)."""
    def update(params, state, gradients):
        updates, state = transform.update(gradients, state)
        return jax.tree.map(lambda p, u: p - LEARNING_RATE * u, params,
                            updates), state

    return update


def _jax_loss_and_gradients(params, batch, dtype):
    loss_fn = _jax_loss_function(batch, dtype)
    params = jax.tree.map(lambda leaf: jnp.asarray(leaf, dtype), params)
    value, gradients = jax.jit(jax.value_and_grad(loss_fn))(params)
    return float(value), [np.asarray(leaf, dtype=np.float64)
                          for leaf in jax.tree.leaves(gradients)]


@pytest.fixture(scope="module")
def setup():
    params = weights.random_jax_params(models.PDSConfig(**NARROW), seed=5)
    batch = _batch(0)
    loss32, gradients32 = _jax_loss_and_gradients(params, batch, jnp.float32)
    with jax.enable_x64(True):
        loss64, gradients64 = _jax_loss_and_gradients(params, batch,
                                                      jnp.float64)
    return {"params": params, "config": models.PDSConfig(**NARROW),
            "batch": batch, "loss": loss32, "gradients": gradients32,
            "loss64": loss64, "gradients64": gradients64}


def _worst_relative_error(got, exact):
    """max over tensors of max |got - exact| / max |exact|. Tensors whose
    exact gradient is below 1e-6 of the largest are left out: they are
    zero in exact arithmetic (the bias of the last transposed conv shifts
    every similarity of a pixel alike, which the softmax does not see) and
    hold rounding noise."""
    floor = 1e-6 * max(np.abs(leaf).max() for leaf in exact)
    assert [leaf.shape for leaf in got] == [leaf.shape for leaf in exact]
    return max(np.abs(a - b).max() / np.abs(b).max()
               for a, b in zip(got, exact) if np.abs(b).max() >= floor)


def test_gradients_match_jax_in_float64(setup):
    network = _network(setup["params"], setup["config"]).double()
    value = trainer.loss_and_gradients(network, *setup["batch"],
                                       setup["config"], torch.float64,
                                       device="cpu")
    assert value.dtype == torch.float64
    assert abs(float(value) - setup["loss64"]) <= 1e-12 * setup["loss64"]
    assert _worst_relative_error(_gradient_leaves(network),
                                 setup["gradients64"]) <= 1e-6


def test_gradients_match_jax_in_float32(setup):
    network = _network(setup["params"], setup["config"])
    value = trainer.loss_and_gradients(network, *setup["batch"],
                                       setup["config"], device="cpu")
    assert abs(float(value) - setup["loss"]) <= 1e-5 * abs(setup["loss"])
    jax_error = _worst_relative_error(setup["gradients"],
                                      setup["gradients64"])
    port_error = _worst_relative_error(_gradient_leaves(network),
                                       setup["gradients64"])
    assert port_error <= 3 * jax_error, (port_error, jax_error)


@pytest.mark.parametrize("onednn", [True, False])
def test_float32_noise_floor_of_the_train_path(onednn):
    """``chip_smoke.py``'s train path (70x90, D=63, full width) on the CPU:
    the float32 gradient against the float64 one through the float32 run's
    LeakyReLU branches is within the tolerance the card is held to, and
    those branches differ from float64's own only within rounding of 0.
    Without oneDNN the CPU's convs round differently, and other branches
    flip; ``pytest -s`` prints the errors against float64 with and without
    the float32 run's branches."""
    import chip_smoke
    config, params, left, right, ground_truth = chip_smoke.train_path_case()

    def gradients(dtype, branches=None):
        network = _network(params, config).to(dtype)
        record = chip_smoke.follow_leaky_relu_branches(network, branches)
        trainer.loss_and_gradients(network, left, right, ground_truth,
                                   config, dtype, device="cpu")
        return record, {name: parameter.grad.double()
                        for name, parameter in network.named_parameters()}

    with torch.backends.mkldnn.flags(enabled=onednn):
        branches, float32 = gradients(torch.float32)
    flips, through_branches = gradients(torch.float64, branches)
    own_branches = gradients(torch.float64)[1]
    matched = chip_smoke.gradient_errors(float32, through_branches)
    unmatched = chip_smoke.gradient_errors(float32, own_branches)
    counts = [(count, share) for calls in flips.values()
              for count, share in calls if count]
    flipped = [share for _, share in counts]
    print(f"oneDNN {onednn}: {sum(count for count, _ in counts)} branches "
          f"flipped; float32 against float64 through its branches "
          f"{matched['worst']:.4g} worst, {matched['median_l2']:.4g} median "
          f"L2; through float64's own {unmatched['worst']:.4g} "
          f"({unmatched['worst_tensors'][0][1]}), "
          f"{unmatched['median_l2']:.4g}")
    assert all(share <= chip_smoke.BRANCH_FLIP_TOLERANCE
               for share in flipped)
    assert matched["worst"] <= chip_smoke.TRAIN_PATH_GRADIENT_TOLERANCE


@pytest.mark.parametrize("compute_dtype", [None, torch.bfloat16])
def test_apply_reaches_every_parameter(setup, compute_dtype):
    """Every parameter gets a finite float32 gradient, in bfloat16 compute
    too, where the weights reach the convs through a cast."""
    network = _network(setup["params"], setup["config"])
    value = trainer.loss_and_gradients(network, *setup["batch"],
                                       setup["config"], compute_dtype,
                                       device="cpu")
    assert torch.isfinite(value)
    for name, parameter in network.named_parameters():
        assert parameter.grad is not None, name
        assert parameter.grad.dtype == torch.float32, name
        assert torch.isfinite(parameter.grad).all(), name
    assert sum(1 for _ in network.parameters()) == len(
        jax.tree.leaves(setup["params"]))


def test_train_step_matches_jax_update(setup):
    """``train_step`` = the port's gradients + one RMSprop step; the step
    is held against optax's update (the JAX trainer's) on the same
    gradients, with square averages bridged to optax's ``nu``."""
    params, config = setup["params"], setup["config"]
    network = _network(params, config)
    rmsprop = optimizer.rmsprop(network.parameters(), LEARNING_RATE)
    value = trainer.train_step(network, rmsprop, *setup["batch"],
                               LEARNING_RATE, config, device="cpu")
    assert abs(float(value) - setup["loss"]) <= 1e-5 * abs(setup["loss"])
    gradients = weights.jax_tree_of_parameters(
        network, lambda _, parameter: parameter.grad)
    transform = jax_optimizer.rmsprop()

    @jax.jit
    def step(params, gradients):
        updates, state = transform.update(gradients, transform.init(params))
        return jax.tree.map(lambda p, u: p - LEARNING_RATE * u, params,
                            updates), state

    expected, state = step(params, gradients)
    trees = checkpoint.training_trees(network, rmsprop)
    for got, want in zip(_leaves(trees["opt_state"]),
                         jax.tree.leaves(state.nu)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6,
                                   atol=1e-12)
    for got, want in zip(_leaves(trees["params"]),
                         jax.tree.leaves(expected)):
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("batch", [1, 2])
def test_two_train_steps_are_two_jax_steps(setup, batch):
    """Two ``train_step``s with RMSprop's state carried: at each step the
    loss within 1e-5 relative of the JAX package's at the same weights,
    then the square averages and the weights equal to optax's update on
    the step's gradients from the carried state. (With JAX's own float32
    gradients the weights cannot agree to 1e-6: RMSprop's first step moves
    a weight by about 0.1 times the sign of its gradient, and a gradient
    that is zero up to rounding, a conv bias ahead of an instance norm,
    takes either sign.)"""
    params, config = setup["params"], setup["config"]
    arrays = _batch(0, batch)
    network = _network(params, config)
    rmsprop = optimizer.rmsprop(network.parameters(), LEARNING_RATE)
    transform = jax_optimizer.rmsprop()
    loss_fn = jax.jit(_jax_loss_function(arrays, jnp.float32))
    update = jax.jit(_jax_rmsprop_update(transform))
    state = transform.init(params)
    for _ in range(2):
        expected_loss = float(loss_fn(params))
        value = trainer.train_step(network, rmsprop, *arrays, LEARNING_RATE,
                                   config, device="cpu")
        assert abs(float(value) - expected_loss) <= 1e-5 * abs(expected_loss)
        params, state = update(params, state, weights.jax_tree_of_parameters(
            network, lambda _, parameter: parameter.grad))
        trees = checkpoint.training_trees(network, rmsprop)
        for got, want in zip(_leaves(trees["opt_state"]),
                             jax.tree.leaves(state.nu)):
            np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6,
                                       atol=1e-12)
        for got, want in zip(_leaves(trees["params"]),
                             jax.tree.leaves(params)):
            np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)


def test_train_step_in_float64_is_the_jax_step(setup):
    """One float64 step at batch 2 from the same weights, each package
    with its own gradients: the loss within 1e-5 relative, the weights
    within 1e-6."""
    arrays = _batch(0, batch=2)
    network = _network(setup["params"], setup["config"]).double()
    rmsprop = optimizer.rmsprop(network.parameters(), LEARNING_RATE)
    with jax.enable_x64(True):
        transform = jax_optimizer.rmsprop()
        params = jax.tree.map(lambda leaf: jnp.asarray(leaf, jnp.float64),
                              setup["params"])
        expected_loss, gradients = jax.jit(jax.value_and_grad(
            _jax_loss_function(arrays, jnp.float64)))(params)
        expected, _ = jax.jit(_jax_rmsprop_update(transform))(
            params, transform.init(params), gradients)
        expected = [np.asarray(leaf) for leaf in jax.tree.leaves(expected)]
    value = trainer.train_step(network, rmsprop, *arrays, LEARNING_RATE,
                               setup["config"], torch.float64, device="cpu")
    assert abs(float(value) - float(expected_loss)) <= 1e-5 * abs(
        float(expected_loss))
    got = _leaves(checkpoint.training_trees(network, rmsprop)["params"])
    assert len(got) == len(expected)
    for a, b in zip(got, expected):
        np.testing.assert_allclose(a, b, atol=1e-6)


@pytest.mark.parametrize("batch", [1, 2, 4])
def test_bfloat16_train_step(setup, batch):
    """A bfloat16 ``train_step`` on the CPU: a finite loss, every
    parameter moved, every RMSprop square average finite and >= 0."""
    network = _network(setup["params"], setup["config"])
    rmsprop = optimizer.rmsprop(network.parameters(), LEARNING_RATE)
    before = {name: parameter.detach().clone()
              for name, parameter in network.named_parameters()}
    value = trainer.train_step(network, rmsprop, *_batch(0, batch),
                               LEARNING_RATE, setup["config"], torch.bfloat16,
                               device="cpu")
    assert torch.isfinite(value)
    for name, parameter in network.named_parameters():
        assert not torch.equal(parameter, before[name]), name
        square_average = rmsprop.state[parameter]["square_avg"]
        assert torch.isfinite(square_average).all(), name
        assert (square_average >= 0).all(), name


@pytest.mark.parametrize("channels", [8, 16, 32, 64, 128])
def test_k1_function_gradients_match_conv3d(channels):
    rng = np.random.RandomState(channels)
    x = torch.from_numpy(rng.randn(2, channels, 4, 5, 6).astype(np.float32))
    weight = torch.from_numpy(rng.uniform(
        -0.1, 0.1, (channels, channels, 3, 3, 3)).astype(np.float32))
    bias = torch.from_numpy(rng.uniform(-0.1, 0.1, channels).astype(
        np.float32))
    grad_output = torch.from_numpy(rng.randn(2, channels, 4, 5, 6).astype(
        np.float32))

    def gradients(function):
        inputs = [tensor.clone().requires_grad_() for tensor in
                  (x, weight, bias)]
        output = function(*inputs)
        output.backward(grad_output)
        return [output.detach()] + [tensor.grad for tensor in inputs]

    got = gradients(conv3d.Conv3dK3S1.apply)
    expected = gradients(lambda a, w, b: F.conv3d(a, w, b, padding=1))
    for a, b in zip(got, expected):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-4)


def _count_k1_calls(monkeypatch):
    calls = []
    original = conv3d.conv3d_k3s1

    def counted(*args, input_gradient=False):
        calls.append((args[0].shape, input_gradient))
        return original(*args, input_gradient=input_gradient)

    monkeypatch.setattr(conv3d, "conv3d_k3s1", counted)
    return calls


def test_train_step_calls_k1_18_times_and_infer_9(setup, monkeypatch):
    """Nine smooths forward and nine input gradients per step, each at the
    forward's shape; inference calls the nine forwards only."""
    calls = _count_k1_calls(monkeypatch)
    network = _network(setup["params"], setup["config"])
    rmsprop = optimizer.rmsprop(network.parameters())
    trainer.train_step(network, rmsprop, *setup["batch"], LEARNING_RATE,
                       setup["config"], device="cpu")
    assert len(calls) == 18
    assert [kind for _, kind in calls] == [False] * 9 + [True] * 9
    assert sorted(shape for shape, _ in calls[:9]) == sorted(
        shape for shape, _ in calls[9:])
    calls.clear()
    models.infer(network, *setup["batch"][:2], setup["config"],
                 device="cpu")
    assert len(calls) == 9


def test_eval_step_matches_jax(setup):
    params, config = setup["params"], setup["config"]
    jax_config = jax_models.PDSConfig(**NARROW)
    left, right, ground_truth = _batch(1, batch=2)
    ground_truth[1, :, :10] = np.inf
    disparity = jax.jit(lambda p, a, b: jax_models.infer(p, a, b, jax_config))(
        params, jnp.asarray(left), jnp.asarray(right))
    error_map, three_pixels_error = jax.vmap(jax_ops.n_pixels_error)(
        disparity, jnp.asarray(ground_truth))
    _, mean_absolute_error = jax.vmap(jax_ops.absolute_error)(
        disparity, jnp.asarray(ground_truth))

    got = trainer.eval_step(_network(params, config), left, right,
                            ground_truth, config, device="cpu")
    assert [tuple(tensor.shape) for tensor in got] == [
        (2, HEIGHT, WIDTH), (2, HEIGHT, WIDTH), (2,), (2,)]
    np.testing.assert_allclose(got[0].numpy(), np.asarray(disparity),
                               atol=1e-2)
    # The metrics of the port's own disparity, by the JAX functions.
    port_error_map, port_three_pixels_error = jax.vmap(
        jax_ops.n_pixels_error)(jnp.asarray(got[0].numpy()),
                                jnp.asarray(ground_truth))
    _, port_mean_absolute_error = jax.vmap(jax_ops.absolute_error)(
        jnp.asarray(got[0].numpy()), jnp.asarray(ground_truth))
    np.testing.assert_array_equal(got[1].numpy(),
                                  np.asarray(port_error_map))
    np.testing.assert_allclose(got[2].numpy(),
                               np.asarray(port_three_pixels_error),
                               rtol=1e-5)
    np.testing.assert_allclose(got[3].numpy(),
                               np.asarray(port_mean_absolute_error),
                               rtol=1e-5)
    # And against the JAX step end to end.
    np.testing.assert_allclose(got[3].numpy(),
                               np.asarray(mean_absolute_error), atol=1e-2)
    assert np.abs(got[2].numpy() - np.asarray(three_pixels_error)).max() \
        <= 100.0 * 0.01 + 1e-4
    assert np.mean(got[1].numpy() != np.asarray(error_map)) <= 0.01
