"""PyTorch port, K1 (the stride-1 3x3x3 conv): its plain version against
the JAX package's dense folded conv at all five hourglass (D, C) levels and
against the Pallas kernel in interpret mode (float32 on the CPU, atol
1e-5). At (D, C) = (3, 128) the Pallas kernel drops a depth tap; a test
records that it differs there while the port equals the dense conv.

The CUDA kernel's scheme is modelled in torch and held to the same
references: the tap-major weight layout and an implicit GEMM over 27
shifted taps in K steps of 16 channels of one tap (8 at cin = 8), on a
channels-last zero-padded input, with output tiles of the kernel's sizes
cut back to the volume."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

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


# The CUDA kernel's output tile (rows, columns) at each hourglass width.
KERNEL_TILES = {8: (4, 64), 16: (2, 64), 32: (1, 64), 64: (1, 32),
                128: (1, 16)}


def _implicit_gemm(x, weight, bias, tile_h, tile_w):
    """The kernel's arithmetic in torch: ``[B, cin, D, H, W]`` float32 ->
    ``[B, cout, D, H, W]``, K ordered ``tap * cin + ci`` in steps of 16
    channels of one tap (8 at cin = 8)."""
    batch, cin, depth, height, width = x.shape
    cout = weight.shape[0]
    b_matrix = conv3d.tap_major_weight(weight)  # [N, K]
    tiled_h = -(-height // tile_h) * tile_h
    tiled_w = -(-width // tile_w) * tile_w
    staged = torch.zeros(batch, depth + 2, tiled_h + 2, tiled_w + 2, cin)
    staged[:, 1:depth + 1, 1:height + 1, 1:width + 1] = x.permute(
        0, 2, 3, 4, 1)
    out = torch.zeros(batch, depth, tiled_h, tiled_w, cout)
    step = min(cin, 16)
    for k in range(0, 27 * cin, step):
        tap, channel = divmod(k, cin)
        kd, kh, kw = tap // 9, tap // 3 % 3, tap % 3
        a_matrix = staged[:, kd:kd + depth, kh:kh + tiled_h, kw:kw + tiled_w,
                          channel:channel + step]
        out += a_matrix @ b_matrix[:, k:k + step].T
    out = out[:, :, :height, :width] + bias
    return out.permute(0, 4, 1, 2, 3).contiguous()


def test_tap_major_weight_layout():
    weight = torch.from_numpy(np.random.RandomState(3).normal(
        size=(16, 8, 3, 3, 3)).astype(np.float32))
    taps = conv3d.tap_major_weight(weight)
    assert taps.shape == (16, 27 * 8) and taps.is_contiguous()
    for co, ci, kd, kh, kw in [(0, 0, 0, 0, 0), (5, 7, 2, 1, 0),
                               (15, 3, 1, 2, 2), (9, 1, 2, 2, 2)]:
        tap = kd * 9 + kh * 3 + kw
        assert taps[co, tap * 8 + ci] == weight[co, ci, kd, kh, kw]


def test_input_gradient_taps_are_the_flipped_transposed_weight():
    weight = torch.from_numpy(np.random.RandomState(4).normal(
        size=(16, 8, 3, 3, 3)).astype(np.float32))
    taps = conv3d.tap_major_weight(weight, input_gradient=True)
    assert taps.shape == (8, 27 * 16) and taps.is_contiguous()
    assert torch.equal(taps, conv3d.tap_major_weight(
        weight.flip(2, 3, 4).transpose(0, 1).contiguous()))


def test_input_gradient_conv_is_the_input_gradient():
    """``conv3d_k3s1(g, w, 0, input_gradient=True)`` on the CPU (the plain
    version) equals autograd's input gradient of the conv by ``w``, with
    cin != cout."""
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(2, 8, 4, 5, 6).astype(np.float32))
    weight = torch.from_numpy(rng.uniform(-0.1, 0.1, (16, 8, 3, 3, 3)
                                          ).astype(np.float32))
    grad_output = torch.from_numpy(rng.randn(2, 16, 4, 5, 6).astype(
        np.float32))
    x.requires_grad_()
    F.conv3d(x, weight, padding=1).backward(grad_output)
    got = conv3d.conv3d_k3s1(grad_output, weight, torch.zeros(8),
                             input_gradient=True)
    torch.testing.assert_close(got, x.grad, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("depth,channels", HOURGLASS_LEVELS + [(3, 8)])
def test_kernel_scheme_matches_plain_and_dense(depth, channels):
    """Implicit GEMM with the kernel's tiles at a width that is not a
    multiple of the tile (one tile plus 3 columns) and a height that is not
    a multiple of the tile rows."""
    tile_h, tile_w = KERNEL_TILES[channels]
    height, width = 2 * tile_h + 1, tile_w + 3
    params, folded = _setup(depth, channels, height=height, width=width)
    volume = np.asarray(folded3d.unfold(jnp.asarray(folded), depth))
    x = torch.from_numpy(np.ascontiguousarray(np.moveaxis(volume, -1, 1)))
    weight = torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(params["w"], (-1, -2), (0, 1))))
    bias = torch.tensor(params["b"])
    got = _implicit_gemm(x, weight, bias, tile_h, tile_w)
    torch.testing.assert_close(got, conv3d.conv3d_k3s1_plain(x, weight, bias),
                               atol=1e-5, rtol=0)
    dense, _ = folded3d.conv3d_folded(params, jnp.asarray(folded), depth)
    folded_got = np.asarray(folded3d.fold(jnp.asarray(
        np.moveaxis(got.numpy(), 1, -1))))
    np.testing.assert_allclose(folded_got, np.asarray(dense), atol=1e-5)
