"""PyTorch port, K1 (the stride-1 3x3x3 conv): its plain version against
the JAX package's dense folded conv at all five hourglass (D, C) levels and
against the Pallas kernel in interpret mode (float32 on the CPU, atol
1e-5). At (D, C) = (3, 128) the Pallas kernel drops a depth tap; a test
records that it differs there while the port equals the dense conv."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from practicaldeepstereo_nips2018_tpu.models import blocks as jax_blocks
from practicaldeepstereo_nips2018_tpu.ops import folded3d, folded_banded
from practicaldeepstereo_nips2018_tpu_torch.ops import conv3d

torch.set_num_threads(1)

HOURGLASS_LEVELS = [(48, 8), (24, 16), (12, 32), (6, 64), (3, 128)]


def _setup(depth, channels, height=8, width=16, seed=0):
    params = jax.tree.map(np.asarray, jax_blocks.init_conv(
        jax.random.PRNGKey(seed), 3, channels, channels, spatial_dims=3))
    folded = np.random.RandomState(seed + 1).uniform(
        size=(1, height, width, depth * channels)).astype(np.float32)
    return params, folded


def _port(params, folded, depth):
    """The port's conv on the same values, returned folded."""
    volume = np.asarray(folded3d.unfold(jnp.asarray(folded), depth))
    x = torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(volume, -1, 1)))  # [B, C, D, H, W]
    weight = torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(params["w"], (-1, -2), (0, 1))))
    y = conv3d.conv3d_k3s1(x, weight, torch.tensor(params["b"]))
    return np.asarray(folded3d.fold(jnp.asarray(
        np.moveaxis(y.numpy(), 1, -1))))


@pytest.mark.parametrize("depth,channels", HOURGLASS_LEVELS)
def test_plain_matches_dense_folded(depth, channels):
    params, folded = _setup(depth, channels)
    dense, depth_out = folded3d.conv3d_folded(params, jnp.asarray(folded),
                                              depth)
    assert depth_out == depth
    np.testing.assert_allclose(_port(params, folded, depth),
                               np.asarray(dense), atol=1e-5)


@pytest.mark.parametrize("depth,channels", HOURGLASS_LEVELS[:4])
def test_plain_matches_pallas_interpret(depth, channels):
    params, folded = _setup(depth, channels)
    kernel = folded_banded.conv3d_folded_pallas(
        params, jnp.asarray(folded), depth, stride=1, interpret=True)
    np.testing.assert_allclose(_port(params, folded, depth),
                               np.asarray(kernel), atol=1e-5)


def test_jax_pallas_kernel_drops_a_tap_at_cin_128():
    """The JAX kernel's slab guard checks ``group_depths * cin`` (256) where
    one output depth needs ``slab_depths * cin`` = 384 lanes, so at cin=128
    it reads 2 of the 3 depths. The port computes the true conv."""
    depth, channels = 3, 128
    params, folded = _setup(depth, channels)
    dense, _ = folded3d.conv3d_folded(params, jnp.asarray(folded), depth)
    kernel = folded_banded.conv3d_folded_pallas(
        params, jnp.asarray(folded), depth, stride=1, interpret=True)
    assert np.abs(np.asarray(kernel) - np.asarray(dense)).max() > 0.1
    np.testing.assert_allclose(_port(params, folded, depth),
                               np.asarray(dense), atol=1e-5)


def test_plain_output_keeps_input_dtype():
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.normal(size=(1, 4, 3, 5, 6)).astype(np.float32))
    weight = torch.from_numpy(rng.normal(size=(4, 4, 3, 3, 3)).astype(
        np.float32)) * 0.1
    bias = torch.zeros(4)
    y = conv3d.conv3d_k3s1(x.bfloat16(), weight.bfloat16(), bias)
    assert y.dtype == torch.bfloat16
    expected = torch.nn.functional.conv3d(x.bfloat16().float(),
                                          weight.bfloat16().float(), bias,
                                          padding=1)
    torch.testing.assert_close(y, expected.bfloat16())


def test_wrapper_refuses_other_devices():
    x = torch.empty(1, 4, 3, 5, 6, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        conv3d.conv3d_k3s1(x, torch.empty(4, 4, 3, 3, 3, device="meta"),
                           torch.empty(4, device="meta"))
