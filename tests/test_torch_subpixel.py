"""PyTorch port, K2 (the sub-pixel MAP estimator): its plain version
against ``subpixel.subpixel_map`` and the Pallas kernel in interpret mode
(float32 on the CPU), with the reference goldens, ties and a pixel count
that is not a multiple of the TPU tile.

Tolerance: atol 1e-5 plus rtol 5e-7. Disparities reach 2 * (D - 1) px
(190 at D = 96), where one float32 ulp is 1.5e-5; the JAX functions sum
``step * i`` directly, the port sums small offsets from the best index,
so the two differ by the rounding of the JAX sums (measured up to 2 ulps;
rtol 5e-7 allows about 4)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from practicaldeepstereo_nips2018_tpu.ops import subpixel as jax_subpixel
from practicaldeepstereo_nips2018_tpu.ops import subpixel_pallas
from practicaldeepstereo_nips2018_tpu_torch.ops import subpixel

torch.set_num_threads(1)

TOLERANCE = {"atol": 1e-5, "rtol": 5e-7}


@pytest.mark.parametrize("shape", [(2, 6, 40, 96), (997, 48), (3, 5, 128)])
def test_plain_matches_jax(shape):
    scores = np.random.RandomState(0).normal(size=shape).astype(np.float32)
    expected = np.asarray(jax_subpixel.subpixel_map(jnp.asarray(scores), 4,
                                                    2))
    kernel = np.asarray(subpixel_pallas.subpixel_map_pallas(
        jnp.asarray(scores), 4, 2, interpret=True))
    got = subpixel.subpixel_map(torch.from_numpy(scores), 4, 2)
    assert got.shape == shape[:-1] and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), expected, **TOLERANCE)
    np.testing.assert_allclose(got.numpy(), kernel, **TOLERANCE)


@pytest.mark.parametrize("window,step,golden", [(2, 1, 1.52), (2, 2, 2.124)])
def test_goldens(window, step, golden):
    scores = torch.tensor([0.1, 0.4, 0.3, 0.2, 0.3]).view(1, 1, 1, 5)
    got = subpixel.subpixel_map(scores, half_support_window=window,
                                disparity_step=step)
    assert abs(float(got[0, 0, 0]) - golden) < 1e-4


def test_ties_take_the_first_maximum():
    scores = np.full((4, 20), -3.0, np.float32)
    scores[0, [3, 12]] = 1.0   # far apart: the window sits on index 3
    scores[1, [3, 5]] = 1.0    # inside one window
    scores[2, :] = 0.0         # all equal: best index 0
    scores[3, [19, 0]] = 2.0   # first occurrence at the start
    expected = np.asarray(jax_subpixel.subpixel_map(jnp.asarray(scores), 4,
                                                    2))
    kernel = np.asarray(subpixel_pallas.subpixel_map_pallas(
        jnp.asarray(scores), 4, 2, interpret=True))
    got = subpixel.subpixel_map(torch.from_numpy(scores), 4, 2).numpy()
    np.testing.assert_allclose(got, expected, **TOLERANCE)
    np.testing.assert_allclose(got, kernel, **TOLERANCE)
    assert got[0] < 8.0  # index 3 (6 px) and its window, not index 12


def test_disparity_major_view_matches_contiguous():
    """The hourglass hands over a [B, H, W, D] view of a [B, D, H, W]
    tensor; the estimator reads it as it is."""
    volume = torch.from_numpy(np.random.RandomState(1).normal(
        size=(2, 32, 6, 7)).astype(np.float32))
    view = volume.permute(0, 2, 3, 1)
    assert subpixel._pixel_layout(view) == (2, 42, 32 * 42, 1)
    assert subpixel._pixel_layout(view.contiguous()) == (1, 84, 0, 32)
    torch.testing.assert_close(subpixel.subpixel_map(view),
                               subpixel.subpixel_map(view.contiguous()))


def test_invalid_configuration_rejected():
    scores = torch.zeros(3, 8)
    with pytest.raises(ValueError):
        subpixel.subpixel_map(scores, half_support_window=3,
                              disparity_step=2)
    with pytest.raises(ValueError):
        subpixel.subpixel_map(scores, half_support_window=0)
