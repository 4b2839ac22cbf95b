"""PyTorch port, the disparity error metrics (``ops/errors.py``) against the
JAX package's ``ops.absolute_error`` / ``ops.n_pixels_error``: the
reference's goldens (``tests/test_ops.py``), the median of an even number
of known pixels (``jnp.nanmedian`` averages the two middle values, where
``torch.median`` takes the lower), all-unknown ground truth, and
numpy-seeded maps (float32; maps equal, averages within 1e-6 relative)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from practicaldeepstereo_nips2018_tpu import ops as jax_ops
from practicaldeepstereo_nips2018_tpu_torch.ops import errors

ESTIMATED = torch.tensor([[1.0, 2.0], [3.0, 4.0]])
GROUND_TRUTH = torch.tensor([[2.0, 2.0], [np.inf, 1.0]])


def test_absolute_error_golden():
    pixelwise, mean = errors.absolute_error(ESTIMATED, GROUND_TRUTH)
    np.testing.assert_allclose(pixelwise.numpy(), [[1.0, 0.0], [0.0, 3.0]])
    assert np.isclose(float(mean), 4.0 / 3.0, rtol=1e-6)
    _, median = errors.absolute_error(ESTIMATED, GROUND_TRUTH,
                                      use_mean=False)
    assert float(median) == 1.0


def test_n_pixels_error_golden():
    pixelwise, percentage = errors.n_pixels_error(ESTIMATED, GROUND_TRUTH,
                                                  n=1.0)
    np.testing.assert_allclose(pixelwise.numpy(), [[0.0, 0.0], [0.0, 1.0]])
    assert np.isclose(float(percentage), 100.0 / 3.0, rtol=1e-6)
    # Strictly greater: an error of exactly n is not counted.
    _, none = errors.n_pixels_error(ESTIMATED, GROUND_TRUTH, n=3.0)
    assert float(none) == 0.0


def test_median_of_an_even_count_averages_the_middle_values():
    estimated = torch.tensor([1.0, 2.0, 4.0, 10.0, 7.0])
    ground_truth = torch.tensor([0.0, 0.0, 0.0, 0.0, np.inf])
    _, median = errors.absolute_error(estimated, ground_truth,
                                      use_mean=False)
    expected = jax_ops.absolute_error(jnp.asarray(estimated.numpy()),
                                      jnp.asarray(ground_truth.numpy()),
                                      use_mean=False)[1]
    assert float(median) == float(expected) == 3.0
    assert float(torch.tensor([1.0, 2.0, 4.0, 10.0]).median()) == 2.0


@pytest.mark.parametrize("use_mean", [True, False])
def test_all_unknown_gives_zero(use_mean):
    ground_truth = torch.full((2, 2), np.inf)
    pixelwise, average = errors.absolute_error(ESTIMATED, ground_truth,
                                               use_mean)
    assert float(average) == 0.0 and float(pixelwise.abs().sum()) == 0.0
    pixelwise, percentage = errors.n_pixels_error(ESTIMATED, ground_truth)
    assert float(percentage) == 0.0 and float(pixelwise.sum()) == 0.0


@pytest.mark.parametrize("shape,unknown", [((17, 23), 0.3), ((16, 24), 0.5),
                                           ((1, 9, 9), 0.0)])
def test_matches_jax(shape, unknown):
    rng = np.random.RandomState(shape[0])
    ground_truth = rng.uniform(0, 100, shape).astype(np.float32)
    estimated = (ground_truth + rng.normal(scale=4, size=shape)).astype(
        np.float32)
    ground_truth[rng.uniform(size=shape) < unknown] = np.inf
    for use_mean in (True, False):
        expected_map, expected = jax_ops.absolute_error(
            jnp.asarray(estimated), jnp.asarray(ground_truth), use_mean)
        got_map, got = errors.absolute_error(
            torch.from_numpy(estimated), torch.from_numpy(ground_truth),
            use_mean)
        np.testing.assert_array_equal(got_map.numpy(),
                                      np.asarray(expected_map))
        assert np.isclose(float(got), float(expected), rtol=1e-6)
    for n in (1.0, 3.0):
        expected_map, expected = jax_ops.n_pixels_error(
            jnp.asarray(estimated), jnp.asarray(ground_truth), n)
        got_map, got = errors.n_pixels_error(
            torch.from_numpy(estimated), torch.from_numpy(ground_truth), n)
        np.testing.assert_array_equal(got_map.numpy(),
                                      np.asarray(expected_map))
        assert np.isclose(float(got), float(expected), rtol=1e-6)
