"""PyTorch port, matching stage: the factored cost volume and the
disparity-batched tail against ``matching.apply`` and, as a second oracle,
``costvolume.cost_volume_direct`` (float32 on the CPU, atol 1e-4),
including disparity ranges past the descriptor width."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from practicaldeepstereo_nips2018_tpu import models as jax_models
from practicaldeepstereo_nips2018_tpu.models import matching as jax_matching
from practicaldeepstereo_nips2018_tpu.ops import costvolume as jax_costvolume
from practicaldeepstereo_nips2018_tpu_torch.models.matching import Matching
from practicaldeepstereo_nips2018_tpu_torch.ops import costvolume
from practicaldeepstereo_nips2018_tpu_torch.training import weights

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def matching_setup():
    params = jax.tree.map(np.asarray, jax_models.init(
        jax.random.PRNGKey(0), jax_models.PDSConfig(maximum_disparity=63)))
    state = weights.state_dict_from_jax_params(params)
    module = Matching()
    module.load_state_dict({key[len("_matching."):]: value
                            for key, value in state.items()
                            if key.startswith("_matching.")})
    rng = np.random.RandomState(1)
    left = rng.normal(size=(2, 6, 20, 64)).astype(np.float32)
    right = rng.normal(size=(2, 6, 20, 64)).astype(np.float32)
    return module, params["matching"], left, right


def _nchw(array):
    return torch.from_numpy(array).permute(0, 3, 1, 2)


@pytest.mark.parametrize("maximum_disparity", [0, 3, 15, 19, 20, 25])
def test_factored_volume_matches_direct_loop(matching_setup,
                                             maximum_disparity):
    module, params, left, right = matching_setup
    head = module._operation._matching_operation_modules[0]
    expected = np.asarray(jax_costvolume.cost_volume_direct(
        params["head"], jnp.asarray(left), jnp.asarray(right),
        maximum_disparity))  # [B, D+1, H, W, C]
    with torch.no_grad():
        volume = costvolume.build_cost_volume(
            head.weight, head.bias, _nchw(left), _nchw(right),
            maximum_disparity)  # [B, D+1, C, H, W]
    assert volume.shape == (2, maximum_disparity + 1, 64, 6, 20)
    np.testing.assert_allclose(volume.permute(0, 1, 3, 4, 2).numpy(),
                               expected, atol=1e-4)


@pytest.mark.parametrize("maximum_disparity", [7, 25])
def test_matching_matches_jax_apply(matching_setup, maximum_disparity):
    """25 > W/4 = 20: the far disparities see only zero fill."""
    module, params, left, right = matching_setup
    expected = np.asarray(jax_matching.apply(
        params, jnp.asarray(left), jnp.asarray(right), maximum_disparity))
    with torch.no_grad():
        signatures = module(_nchw(left), _nchw(right), maximum_disparity)
    assert signatures.shape == (2, maximum_disparity + 1, 8, 6, 20)
    np.testing.assert_allclose(signatures.permute(0, 1, 3, 4, 2).numpy(),
                               expected, atol=1e-4)


def test_shift_golden():
    """The shift of the reference's golden (``test/test_matching.py``):
    with a head that passes only the right map's centre tap, volume[d] is
    the right row shifted by d, zero-filled and truncated to the width."""
    right = torch.tensor([3.0, 4.0, 2.0, 4.0]).view(1, 1, 1, 4)
    left = torch.zeros(1, 1, 1, 4)
    weight = torch.zeros(1, 2, 3, 3)
    weight[0, 1, 1, 1] = 1.0  # centre tap of the right half
    volume = costvolume.build_cost_volume(weight, torch.zeros(1), left,
                                          right, 2)
    expected = torch.tensor([[3.0, 4, 2, 4], [0, 3, 4, 2], [0, 0, 3, 4]])
    torch.testing.assert_close(volume[0, :, 0, 0], expected)
