"""PyTorch port, 3-D hourglass: ``Regularization`` against the JAX
package's ``regularization.apply`` on the same seeded volume, shortcut and
weights (float32 on the CPU, atol 1e-3), plus its shape contract."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from practicaldeepstereo_nips2018_tpu import models as jax_models
from practicaldeepstereo_nips2018_tpu.models import (
    regularization as jax_regularization)
from practicaldeepstereo_nips2018_tpu_torch.models.regularization import (
    Regularization)
from practicaldeepstereo_nips2018_tpu_torch.training import weights

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def hourglass():
    params = jax.tree.map(np.asarray, jax_models.init(
        jax.random.PRNGKey(5), jax_models.PDSConfig(maximum_disparity=63)))
    state = weights.state_dict_from_jax_params(params)
    module = Regularization()
    module.load_state_dict({key[len("_regularization."):]: value
                            for key, value in state.items()
                            if key.startswith("_regularization.")})
    return module, params["regularization"]


@pytest.mark.parametrize("depth,height,width", [(16, 16, 16), (32, 16, 32)])
def test_hourglass_matches_jax(hourglass, depth, height, width):
    module, params = hourglass
    rng = np.random.RandomState(depth)
    signatures = rng.normal(size=(1, depth, height, width, 8)).astype(
        np.float32)
    shortcut = rng.normal(size=(1, height, width, 8)).astype(np.float32)
    expected = np.asarray(jax_regularization.apply(
        params, jnp.asarray(signatures), jnp.asarray(shortcut)))
    with torch.no_grad():
        similarities = module(
            torch.from_numpy(np.ascontiguousarray(
                np.moveaxis(signatures, -1, 1))),
            torch.from_numpy(np.ascontiguousarray(
                np.moveaxis(shortcut, -1, 1))))
    assert similarities.shape == (1, 4 * height, 4 * width, 2 * depth)
    assert expected.shape == similarities.shape
    np.testing.assert_allclose(similarities.numpy(), expected, atol=1e-3)


def test_contraction_halves_odd_sizes(hourglass):
    """Stride-2 blocks ceil-halve odd sizes (10, 14, 16 -> 5, 7, 8), the
    reference's ``test_regularization.py`` contract."""
    module, _ = hourglass
    with torch.no_grad():
        down, smoothed = module._contraction_blocks[0](
            torch.zeros(1, 8, 10, 14, 16))
    assert down.shape == smoothed.shape == (1, 16, 5, 7, 8)
