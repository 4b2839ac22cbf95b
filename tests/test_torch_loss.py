"""PyTorch port, the sub-pixel cross-entropy (``ops/loss.py``) against the
JAX package's ``ops.subpixel_cross_entropy``: the reference's golden
(1.3654 and its gradient, ``tests/test_ops.py``), exact zero gradient at
pixels without ground truth, and value and gradient on numpy-seeded cases
against ``jax.value_and_grad`` (float32, 1e-6 relative on the value, 1e-6
absolute on the gradient)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from practicaldeepstereo_nips2018_tpu import ops as jax_ops
from practicaldeepstereo_nips2018_tpu_torch.ops import loss

torch.set_num_threads(1)


def _value_and_grad(similarities, *args, **kwargs):
    similarities = torch.tensor(similarities, requires_grad=True)
    value = loss.subpixel_cross_entropy(similarities, *args, **kwargs)
    value.backward()
    return float(value.detach()), similarities.grad.numpy()


def test_golden():
    similarities = np.array([[0.1, 0.3, 0.2, 0.05],
                             [0.2, 0.1, 0.4, 0.0],
                             [0.2, 0.1, 0.4, 0.0]],
                            np.float32).reshape(1, 3, 1, 4)
    ground_truth = torch.tensor([1.3, np.inf, 1.9]).reshape(1, 3, 1)
    weights = torch.tensor([0.9, 0.0, 0.01]).reshape(1, 3, 1)
    value, gradient = _value_and_grad(similarities, ground_truth, weights,
                                      diversity=2.0, disparity_step=1)
    assert np.isclose(value, 1.3654, atol=1e-3)
    expected_gradient = np.array([
        [0.0262, -0.0567, -0.0219, 0.0524],
        [0.0, 0.0, 0.0, 0.0],
        [0.0011, -0.0002, -0.0007, -0.0002]]).reshape(1, 3, 1, 4)
    np.testing.assert_allclose(gradient, expected_gradient, atol=1e-3)


def test_unknown_pixels_get_exactly_zero_gradient():
    similarities = np.zeros((1, 2, 1, 4), np.float32)
    ground_truth = torch.tensor([2.0, np.inf]).reshape(1, 2, 1)
    value, gradient = _value_and_grad(similarities, ground_truth,
                                      diversity=1.0, disparity_step=1)
    # Uniform similarities: -log(1/4) whatever the target.
    assert np.isclose(value, np.log(4.0), atol=1e-6)
    assert np.all(gradient[0, 1] == 0.0)
    assert np.all(gradient[0, 0] != 0.0)


@pytest.mark.parametrize("weighted,diversity,step", [
    (False, 1.0, 2), (True, 1.0, 2), (False, 2.0, 1), (True, 0.5, 1)])
def test_matches_jax(weighted, diversity, step):
    rng = np.random.RandomState(int(10 * diversity) + step)
    similarities = rng.normal(size=(2, 5, 7, 16)).astype(np.float32) * 3
    ground_truth = rng.uniform(0, 16 * step, (2, 5, 7)).astype(np.float32)
    ground_truth[rng.uniform(size=ground_truth.shape) < 0.2] = np.inf
    weights = (rng.uniform(size=ground_truth.shape).astype(np.float32)
               if weighted else None)

    def jax_loss(s):
        return jax_ops.subpixel_cross_entropy(
            s, jnp.asarray(ground_truth),
            None if weights is None else jnp.asarray(weights),
            diversity=diversity, disparity_step=step)

    expected_value, expected_gradient = jax.value_and_grad(jax_loss)(
        jnp.asarray(similarities))
    value, gradient = _value_and_grad(
        similarities, torch.from_numpy(ground_truth),
        None if weights is None else torch.from_numpy(weights),
        diversity=diversity, disparity_step=step)
    assert np.isclose(value, float(expected_value), rtol=1e-6)
    np.testing.assert_allclose(gradient, np.asarray(expected_gradient),
                               atol=1e-6)


def test_all_unknown_is_nan_without_weights_and_zero_with():
    """As in the JAX package: 0 / 0 without weights, 0 / 1e-15 with."""
    similarities = np.zeros((1, 2, 2, 4), np.float32)
    ground_truth = np.full((1, 2, 2), np.inf, np.float32)
    got = {}
    for weighted in (False, True):
        weights = np.ones((1, 2, 2), np.float32) if weighted else None
        expected = float(jax_ops.subpixel_cross_entropy(
            jnp.asarray(similarities), jnp.asarray(ground_truth),
            None if weights is None else jnp.asarray(weights)))
        got[weighted] = float(loss.subpixel_cross_entropy(
            torch.from_numpy(similarities), torch.from_numpy(ground_truth),
            None if weights is None else torch.from_numpy(weights)))
        np.testing.assert_equal(got[weighted], expected)
    assert np.isnan(got[False]) and got[True] == 0.0
