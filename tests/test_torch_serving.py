"""PyTorch port, serving and weights: ``InferenceSession`` on the CPU
against the JAX session, batch > 1 against per-image calls, a checkpoint
written by the JAX trainer, and the weight bridge both ways."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from practicaldeepstereo_nips2018_tpu import models as jax_models
from practicaldeepstereo_nips2018_tpu.serving import (
    InferenceSession as JaxInferenceSession)
from practicaldeepstereo_nips2018_tpu.training import checkpoint as jax_ckpt
from practicaldeepstereo_nips2018_tpu.training import torch_import
from practicaldeepstereo_nips2018_tpu_torch import models
from practicaldeepstereo_nips2018_tpu_torch.serving import InferenceSession
from practicaldeepstereo_nips2018_tpu_torch.training import checkpoint
from practicaldeepstereo_nips2018_tpu_torch.training import weights

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    jax_config = jax_models.PDSConfig(maximum_disparity=63)
    params = jax.tree.map(np.asarray,
                          jax_models.init(jax.random.PRNGKey(0), jax_config))
    config = models.PDSConfig(maximum_disparity=63)
    rng = np.random.RandomState(2)
    left = rng.uniform(0, 255, (2, 32, 48, 3)).astype(np.float32)
    right = rng.uniform(0, 255, (2, 32, 48, 3)).astype(np.float32)
    session = InferenceSession(weights.state_dict_from_jax_params(params),
                               config, compute_dtype=torch.float32,
                               device="cpu")
    return jax_config, params, config, session, left, right


def _session(params, config, mode):
    return InferenceSession(weights.state_dict_from_jax_params(params),
                            config, compute_dtype=torch.float32,
                            device="cpu", batched_mode=mode)


@pytest.mark.parametrize("batch", [2, 4])
@pytest.mark.parametrize("mode", ["unroll", "direct"])
def test_batch_equals_per_image(setup, mode, batch):
    """Each image of a batch gets its batch-1 map: bit for bit under
    ``"unroll"`` (one batch-1 forward per image), within 1e-4 px under
    ``"direct"`` (one batched forward, whose float32 convs may round
    otherwise)."""
    _, params, config, _, left, right = setup
    if batch > 2:
        rng = np.random.RandomState(4)
        left, right = (np.concatenate([image, rng.uniform(
            0, 255, image.shape).astype(np.float32)]) for image in (left,
                                                                     right))
    session = _session(params, config, mode)
    batched = session.predict(left, right)
    assert batched.shape == (batch, 32, 48) and batched.dtype == np.float32
    for i in range(batch):
        single = session.predict(left[i:i + 1], right[i:i + 1])[0]
        if mode == "unroll":
            np.testing.assert_array_equal(batched[i], single)
        else:
            np.testing.assert_allclose(batched[i], single, rtol=0, atol=1e-4)


@pytest.mark.parametrize("mode", ["unroll", "direct"])
def test_warmup_leaves_the_maps_as_they_were(setup, mode):
    """``warmup`` runs a zero request of the served shape and batch; a
    warmed session then serves the map of one never warmed."""
    _, params, config, _, left, right = setup
    warmed = _session(params, config, mode)
    assert warmed.warmup(32, 48, batch=2) is None
    np.testing.assert_array_equal(
        warmed.predict(left, right),
        _session(params, config, mode).predict(left, right))


def test_matches_jax_session(setup):
    """<= 1e-2 px wherever the best similarity wins by more than the
    similarity tolerance (1e-3). On random weights a few pixels hold two
    near-equal maxima, and there a 1e-4 difference in the scores may move
    the argmax to the other one (the JAX suite notes the same between its
    own compiled programs); those pixels are counted, not compared."""
    jax_config, params, _, session, left, right = setup
    expected = JaxInferenceSession(params, jax_config,
                                   compute_dtype=jnp.float32).predict(
                                       left, right)
    scores = np.sort(np.asarray(jax.jit(
        lambda p, l, r: jax_models.apply(p, l, r, jax_config))(
            params, jnp.asarray(left), jnp.asarray(right))), axis=-1)
    near_tie = scores[..., -1] - scores[..., -2] < 2e-3
    assert near_tie.mean() < 0.01
    got = session.predict(left, right)
    np.testing.assert_allclose(got[~near_tie], expected[~near_tie],
                               atol=1e-2)


def test_from_checkpoint_reads_jax_npz(setup, tmp_path):
    _, params, config, session, left, right = setup
    path = str(tmp_path / "010_checkpoint.npz")
    jax_ckpt.save_checkpoint(
        path, {"params": params, "opt_state": {"ignored": jnp.zeros(3)}},
        {"training_losses": [1.0]})
    restored = InferenceSession.from_checkpoint(
        path, config, compute_dtype=torch.float32, device="cpu")
    np.testing.assert_array_equal(restored.predict(left, right),
                                  session.predict(left, right))
    assert restored.config == config


def test_checkpoint_leaf_order_is_jax_tree_order(setup):
    _, params, _, _, _, _ = setup
    ours = checkpoint.tree_leaves(params)
    theirs = jax.tree.leaves(params)
    assert len(ours) == len(theirs)
    assert all(a is b for a, b in zip(ours, theirs))
    rebuilt = checkpoint.tree_unflatten(params, ours)
    assert jax.tree.structure(rebuilt) == jax.tree.structure(params)


def test_checkpoint_of_another_configuration_rejected(setup, tmp_path):
    _, params, config, _, _, _ = setup
    path = str(tmp_path / "001_checkpoint.npz")
    smaller = dict(params, matching={
        key: value for key, value in params["matching"].items()
        if key != "residual2"})
    jax_ckpt.save_checkpoint(path, {"params": smaller}, {})
    with pytest.raises(ValueError, match="arrays but the template"):
        InferenceSession.from_checkpoint(path, config, device="cpu")


def test_weight_bridge_round_trips_through_torch_import(setup):
    """The JAX package's own reference-checkpoint importer reads the port's
    state_dict back into the original JAX params."""
    _, params, config, _, _, _ = setup
    network = models.PdsNetwork(config)
    network.load_state_dict(weights.state_dict_from_jax_params(params))
    state = {key: value.numpy() for key, value in
             network.state_dict().items()}
    imported = torch_import.params_from_torch_state_dict(state)
    assert jax.tree.structure(imported) == jax.tree.structure(params)
    for got, expected in zip(jax.tree.leaves(imported),
                             jax.tree.leaves(params)):
        np.testing.assert_array_equal(got, expected)
    ours = weights.jax_params_from_state_dict(state)
    for got, expected in zip(jax.tree.leaves(ours), jax.tree.leaves(params)):
        np.testing.assert_array_equal(got, expected)


def test_random_jax_params_follow_init_bounds():
    """U(±1/sqrt(fan_in)) per conv with PyTorch's fan_in, norms 1 and 0,
    the same numbers from the same seed."""
    config = models.PDSConfig()
    params = weights.random_jax_params(config, seed=0)
    template = jax_models.init(jax.random.PRNGKey(0), jax_models.PDSConfig())
    assert jax.tree.structure(params) == jax.tree.structure(template)
    network = models.PdsNetwork(config)
    network.load_state_dict(weights.state_dict_from_jax_params(params))
    for module in network.modules():
        module.requires_grad_(False)
        if isinstance(module, torch.nn.modules.conv._ConvNd):
            fan_in, _ = torch.nn.init._calculate_fan_in_and_fan_out(
                module.weight)
            bound = 1.0 / np.sqrt(fan_in)
            assert float(module.weight.abs().max()) <= bound
            assert float(module.weight.abs().max()) > 0.9 * bound
            assert float(module.bias.abs().max()) <= bound
        elif hasattr(module, "weight") and module.weight is not None:
            assert bool((module.weight == 1).all())
            assert bool((module.bias == 0).all())
    again = weights.random_jax_params(config, seed=0)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(again)):
        np.testing.assert_array_equal(a, b)


def test_only_unroll_batching(setup):
    """The JAX session's batching modes, and no other, are accepted."""
    _, params, config, _, _, _ = setup
    state = weights.state_dict_from_jax_params(params)
    for mode in ("unroll", "map", "direct"):
        InferenceSession(state, config, device="cpu", batched_mode=mode)
    with pytest.raises(ValueError, match='"unroll", "map" or "direct"'):
        InferenceSession(state, config, device="cpu",
                         batched_mode="vectorized")


def test_default_device_raises_without_a_card(setup):
    _, params, config, _, _, _ = setup
    if torch.cuda.is_available():
        pytest.skip("a card is present; the CPU-only refusal is not "
                    "observable")
    with pytest.raises(RuntimeError, match="cuda"):
        InferenceSession(weights.state_dict_from_jax_params(params), config)


@pytest.mark.parametrize("mode", ["unroll", "direct"])
def test_infer_on_tensors_equals_predict(setup, mode):
    """``infer`` takes tensors and returns the map as a tensor on the
    session's device, the map ``predict`` returns as numpy."""
    _, params, config, _, left, right = setup
    session = _session(params, config, mode)
    disparity = session.infer(torch.from_numpy(left),
                              torch.from_numpy(right))
    assert isinstance(disparity, torch.Tensor)
    assert disparity.device.type == "cpu" and disparity.dtype == torch.float32
    np.testing.assert_array_equal(disparity.numpy(),
                                  session.predict(left, right))
    with pytest.raises(ValueError, match="one shape"):
        session.infer(torch.from_numpy(left), torch.from_numpy(right[:1]))
