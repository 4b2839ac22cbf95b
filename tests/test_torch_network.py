"""PyTorch port, whole slice: ``apply`` and ``infer`` on the CPU against
the JAX package's ``models.apply`` / ``models.infer`` with the same seeded
weights and images, at 70x90 and D=63 (padded to 128x128). Tolerances are
those of the reference parity suite: similarities <= 1e-3, disparity
<= 1e-2 px. Also the 62x49 shape contracts of ``tests/test_models.py``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from practicaldeepstereo_nips2018_tpu import models as jax_models
from practicaldeepstereo_nips2018_tpu_torch import models
from practicaldeepstereo_nips2018_tpu_torch.training import weights

torch.set_num_threads(1)

HEIGHT, WIDTH = 70, 90


@pytest.fixture(scope="module")
def setup():
    jax_config = jax_models.PDSConfig(maximum_disparity=63)
    params = jax.tree.map(np.asarray,
                          jax_models.init(jax.random.PRNGKey(7), jax_config))
    config = models.PDSConfig(maximum_disparity=63)
    network = models.PdsNetwork(config)
    network.load_state_dict(weights.state_dict_from_jax_params(params))
    rng = np.random.RandomState(3)
    left = rng.uniform(0, 255, (1, HEIGHT, WIDTH, 3)).astype(np.float32)
    right = rng.uniform(0, 255, (1, HEIGHT, WIDTH, 3)).astype(np.float32)
    return jax_config, params, config, network, left, right


def test_similarities_match_jax(setup):
    jax_config, params, config, network, left, right = setup
    expected = np.asarray(jax_models.apply(params, jnp.asarray(left),
                                           jnp.asarray(right), jax_config))
    got = models.apply(network, left, right, config, device="cpu")
    assert got.shape == (1, HEIGHT, WIDTH, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), expected, atol=1e-3)


def test_disparity_matches_jax(setup):
    jax_config, params, config, network, left, right = setup
    expected = np.asarray(jax_models.infer(params, jnp.asarray(left),
                                           jnp.asarray(right), jax_config))
    got = models.infer(network, left, right, config, device="cpu")
    assert got.shape == (1, HEIGHT, WIDTH) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), expected, atol=1e-2)


def test_shape_contracts(setup):
    """62x49 input: D=63 gives 32 similarity levels, D=255 gives 128 with
    the same weights, and inference gives a [B, 62, 49] map."""
    _, _, _, network, _, _ = setup
    rng = np.random.RandomState(4)
    image = rng.uniform(0, 255, (2, 62, 49, 3)).astype(np.float32)
    small = models.PDSConfig(maximum_disparity=63)
    large = models.PDSConfig(maximum_disparity=255)
    assert models.apply(network, image, image, small,
                        device="cpu").shape == (2, 62, 49, 32)
    assert models.apply(network, image[:1], image[:1], large,
                        device="cpu").shape == (1, 62, 49, 128)
    disparity = models.infer(network, image, image, small, device="cpu")
    assert disparity.shape == (2, 62, 49)
    assert torch.isfinite(disparity).all()
    assert 0.0 <= float(disparity.min()) and float(disparity.max()) <= 62.0


def test_bfloat16_compute_keeps_shapes(setup):
    _, _, config, network, left, right = setup
    similarities = models.apply(network, left, right, config,
                                compute_dtype=torch.bfloat16, device="cpu")
    assert similarities.dtype == torch.float32
    assert similarities.shape == (1, HEIGHT, WIDTH, 32)
    disparity = models.infer(network, left, right, config,
                             compute_dtype=torch.bfloat16, device="cpu")
    assert torch.isfinite(disparity).all()


def test_images_enter_in_one_layout(setup):
    """A strided batch slice, a contiguous array and a channels-last view
    all enter as one contiguous NCHW tensor (on the card, cuDNN picks its
    algorithms, and so its roundings, by layout)."""
    _, _, config, network, left, right = setup
    batch = np.stack([left[0], right[0]])[None].repeat(2, axis=0)
    strided = batch[:, 0]  # [2, H, W, 3] with a gap between images
    channels_last = torch.from_numpy(np.ascontiguousarray(
        left.transpose(0, 3, 1, 2))).permute(0, 2, 3, 1)
    for image in (left, strided, channels_last):
        tensor = models.network._as_images(image, torch.device("cpu"))
        assert tensor.is_contiguous()
        assert tensor.shape == (len(image), 3, HEIGHT, WIDTH)
    torch.testing.assert_close(
        models.infer(network, strided[:1], strided[:1], config,
                     device="cpu"),
        models.infer(network, left, left, config, device="cpu"))


def test_cuda_without_a_card_raises(setup):
    _, _, config, network, left, right = setup
    if torch.cuda.is_available():
        pytest.skip("a card is present; the CPU-only refusal is not "
                    "observable")
    with pytest.raises(RuntimeError, match="cuda"):
        models.infer(network, left, right, config)


def test_network_on_another_device_rejected(setup):
    _, _, config, _, left, right = setup
    with torch.device("meta"):
        network = models.PdsNetwork(config)
    with pytest.raises(ValueError, match="network.to"):
        models.infer(network, left, right, config, device="cpu")
