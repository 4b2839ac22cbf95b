"""PyTorch port, K2 (the sub-pixel MAP estimator): its plain version
against ``subpixel.subpixel_map`` and the Pallas kernel in interpret mode
(float32 on the CPU), with the reference goldens, ties and a pixel count
that is not a multiple of the TPU tile.

Tolerance: atol 1e-5 plus rtol 5e-7. Disparities reach 2 * (D - 1) px
(190 at D = 96), where one float32 ulp is 1.5e-5; the JAX functions sum
``step * i`` directly, the port sums small offsets from the best index,
so the two differ by the rounding of the JAX sums (measured up to 2 ulps;
rtol 5e-7 allows about 4).

The CUDA kernel's staged scheme is modelled in torch and held to the same
references: blocks of up to 256 neighbouring pixels with all their D rows
staged, a running strict-greater maximum from -inf over the rows (the
first occurrence), then the window sums over the staged rows around it in
ascending order."""

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


def _staged(scores: torch.Tensor, half_taps: int, step: int,
            block_pixels: int = 256):
    """The kernel's two passes over staged blocks in torch: ``[P, D]`` ->
    ``[P]``, one block of pixels at a time (the last may be partial)."""
    results = []
    for start in range(0, scores.shape[0], block_pixels):
        staged = scores[start:start + block_pixels].float().T  # [D, pixels]
        maximum = torch.full((staged.shape[1],), -float("inf"))
        best = torch.zeros(staged.shape[1], dtype=torch.long)
        for d, row in enumerate(staged):
            larger = row > maximum
            maximum = torch.where(larger, row, maximum)
            best = torch.where(larger, torch.full_like(best, d), best)
        weight_sum = torch.zeros(staged.shape[1])
        weighted_offset = torch.zeros(staged.shape[1])
        for offset in range(-half_taps, half_taps + 1):
            index = best + offset
            inside = (index >= 0) & (index < staged.shape[0])
            value = staged.gather(0, index.clamp(0, staged.shape[0] - 1)[None])[0]
            weight = torch.where(inside, torch.exp(value - maximum),
                                 torch.zeros(()))
            weight_sum += weight
            weighted_offset += weight * offset
        results.append(step * (best + weighted_offset / weight_sum))
    return torch.cat(results)


def _hold_staged(scores: np.ndarray, window: int, step: int):
    got = _staged(torch.from_numpy(scores), window // step, step)
    plain = subpixel.subpixel_map_plain(torch.from_numpy(scores), window,
                                        step)
    expected = np.asarray(jax_subpixel.subpixel_map(jnp.asarray(scores),
                                                    window, step))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOLERANCE)
    np.testing.assert_allclose(got.numpy(), expected, **TOLERANCE)
    return got.numpy()


@pytest.mark.parametrize("window,step,golden", [(2, 1, 1.52), (2, 2, 2.124)])
def test_staged_scheme_goldens(window, step, golden):
    scores = np.array([[0.1, 0.4, 0.3, 0.2, 0.3]], np.float32)
    got = _hold_staged(scores, window, step)
    assert abs(float(got[0]) - golden) < 1e-4


def test_staged_scheme_ties_and_edges():
    scores = np.full((7, 20), -3.0, np.float32)
    scores[0, [3, 12]] = 1.0   # far apart: the window sits on index 3
    scores[1, [3, 5]] = 1.0    # inside one window
    scores[2, :] = 0.0         # all equal: best index 0
    scores[3, [19, 0]] = 2.0   # first occurrence at the start
    scores[4, 0] = 5.0         # best at index 0, window cut at the left
    scores[5, 19] = 5.0        # best at D - 1, window cut at the right
    scores[6, [17, 19]] = [4.0, 5.0]  # a second peak inside the window
    got = _hold_staged(scores, 4, 2)
    assert got[0] < 8.0 and got[4] < 1.0 and got[5] > 36.0


@pytest.mark.parametrize("half_taps", [1, 2, 3, 4])
def test_staged_scheme_half_taps(half_taps):
    """Random scores and a slowly rising ramp, over a pixel count that
    leaves a partial last block (300 = 256 + 44)."""
    rng = np.random.RandomState(half_taps)
    scores = rng.normal(size=(300, 48)).astype(np.float32)
    scores[:8] = np.linspace(0, 1, 48, dtype=np.float32) + rng.normal(
        scale=0.01, size=(8, 48)).astype(np.float32)
    _hold_staged(scores, 2 * half_taps, 2)
    _hold_staged(scores, half_taps, 1)
