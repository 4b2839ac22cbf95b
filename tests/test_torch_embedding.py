"""PyTorch port, first stages: config, padding, blocks and the embedding
tower, held against the JAX package on the same seeded inputs and weights
(float32 on the CPU, atol 1e-4)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from practicaldeepstereo_nips2018_tpu import models as jax_models
from practicaldeepstereo_nips2018_tpu.models import blocks as jax_blocks
from practicaldeepstereo_nips2018_tpu.models import embedding as jax_embedding
from practicaldeepstereo_nips2018_tpu.ops import pad as jax_pad
from practicaldeepstereo_nips2018_tpu_torch import models
from practicaldeepstereo_nips2018_tpu_torch.models import blocks
from practicaldeepstereo_nips2018_tpu_torch.ops import pad
from practicaldeepstereo_nips2018_tpu_torch.training import weights

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def network_and_params():
    config = jax_models.PDSConfig(maximum_disparity=63)
    params = jax.tree.map(np.asarray,
                          jax_models.init(jax.random.PRNGKey(0), config))
    network = models.PdsNetwork(models.PDSConfig(maximum_disparity=63))
    network.load_state_dict(weights.state_dict_from_jax_params(params))
    return network, params


def test_config_rules_match_jax():
    for maximum_disparity in (63, 191, 255):
        config = models.PDSConfig(maximum_disparity=maximum_disparity)
        reference = jax_models.PDSConfig(maximum_disparity=maximum_disparity)
        assert (config.matching_maximum_disparity
                == reference.matching_maximum_disparity)
        assert (config.number_of_similarity_levels
                == reference.number_of_similarity_levels)
    with pytest.raises(ValueError, match="multiple of 64"):
        models.PDSConfig(maximum_disparity=100)
    with pytest.raises(ValueError, match="folded_conv_impl"):
        models.PDSConfig(maximum_disparity=63, folded_conv_impl="slab")
    for impl in ("dense", "banded_slab", "banded_pallas"):
        models.PDSConfig(maximum_disparity=63, folded_conv_impl=impl)


@pytest.mark.parametrize("option,value", [
    ("remat", "selective"), ("factor_tail_conv1", True),
    ("embedding_s2d", True), ("matching_tail_int8", True)])
def test_unported_options_rejected(option, value):
    """Each opt-in of the JAX ``PDSConfig`` is accepted, and ``apply``
    under it equals the JAX package's under the same option (float64,
    within 1e-9 of the largest similarity; ``tests/test_torch_options.py``
    holds each option in detail)."""
    narrow = dict(maximum_disparity=63, number_of_embedding_features=16,
                  number_of_matching_features=16,
                  number_of_embedding_residual_blocks=1,
                  number_of_matching_residual_blocks=1)
    config = models.PDSConfig(**narrow, **{option: value})
    assert getattr(config, option) == value
    params = weights.random_jax_params(config, seed=9)
    network = models.PdsNetwork(config)
    network.load_state_dict(weights.state_dict_from_jax_params(params))
    rng = np.random.RandomState(10)
    left, right = (rng.uniform(0, 255, (1, 40, 70, 3)).astype(np.float32)
                   for _ in range(2))
    with jax.enable_x64(True):
        expected = np.asarray(jax_models.apply(
            jax.tree.map(lambda leaf: np.asarray(leaf, np.float64), params),
            jnp.asarray(left, jnp.float64), jnp.asarray(right, jnp.float64),
            jax_models.PDSConfig(**narrow, **{option: value})))
    got = models.apply(network.double(), left, right, config, torch.float64,
                       device="cpu").detach().numpy()
    np.testing.assert_allclose(got, expected,
                               atol=1e-9 * np.abs(expected).max(), rtol=0)


def test_pad_and_unpad_match_jax():
    image = np.random.RandomState(0).uniform(
        0, 255, (2, 62, 49, 3)).astype(np.float32)
    expected = np.asarray(jax_pad.pad_to_multiple(jnp.asarray(image), 64))
    padded = pad.pad_to_multiple(torch.from_numpy(image).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(padded.permute(0, 2, 3, 1).numpy(),
                                  expected)
    assert pad.pad_amounts(62, 49) == jax_pad.pad_amounts(62, 49)
    cropped = pad.unpad(padded, 62, 49)
    np.testing.assert_array_equal(cropped.permute(0, 2, 3, 1).numpy(), image)


def test_instance_norm_matches_jax():
    rng = np.random.RandomState(1)
    x = rng.normal(2.0, 3.0, (2, 5, 7, 6, 4)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 5).astype(np.float32)
    bias = rng.uniform(-0.2, 0.2, 5).astype(np.float32)
    expected = np.asarray(jax_blocks.instance_norm(
        jnp.asarray(np.moveaxis(x, 1, -1)),
        {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}))
    got = blocks.instance_norm(torch.from_numpy(x), torch.from_numpy(scale),
                               torch.from_numpy(bias))
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 1, -1), expected,
                               atol=1e-5)


def test_instance_norm_bfloat16_takes_float32_moments():
    x = torch.from_numpy(np.random.RandomState(2).normal(
        5.0, 1.0, (1, 3, 64, 64)).astype(np.float32))
    got = blocks.instance_norm(x.bfloat16())
    assert got.dtype == torch.bfloat16
    expected = blocks.instance_norm(x.bfloat16().float())
    np.testing.assert_allclose(got.float().numpy(), expected.numpy(),
                               atol=2 ** -6)


def test_embedding_matches_jax(network_and_params):
    """Descriptor and shortcut of a padded 62x49 image: the input instance
    norm's moments include the pad zeros."""
    network, params = network_and_params
    image = np.random.RandomState(3).uniform(
        0, 255, (1, 62, 49, 3)).astype(np.float32)
    padded = np.array(jax_pad.pad_to_multiple(jnp.asarray(image), 64))
    descriptor_ref, shortcut_ref = jax_embedding.apply(
        params["embedding"], jnp.asarray(padded))
    with torch.no_grad():
        descriptor, shortcut = network._embedding(
            torch.from_numpy(padded).permute(0, 3, 1, 2))
    assert descriptor.shape == (1, 64, 16, 16)
    assert shortcut.shape == (1, 8, 16, 16)
    np.testing.assert_allclose(descriptor.permute(0, 2, 3, 1).numpy(),
                               np.asarray(descriptor_ref), atol=1e-4)
    np.testing.assert_allclose(shortcut.permute(0, 2, 3, 1).numpy(),
                               np.asarray(shortcut_ref), atol=1e-4)


def test_residual_block_matches_jax(network_and_params):
    network, params = network_and_params
    x = np.random.RandomState(4).normal(size=(2, 9, 11, 64)).astype(
        np.float32)
    expected = jax_blocks.residual_block(params["embedding"]["residual1"],
                                         jnp.asarray(x))
    with torch.no_grad():
        got = network._embedding._embedding_modules[3](
            torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(expected), atol=1e-4)
