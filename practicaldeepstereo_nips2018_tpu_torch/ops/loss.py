"""Sub-pixel cross-entropy loss.

Port of ``practicaldeepstereo_nips2018_tpu/ops/loss.py::
subpixel_cross_entropy`` (the reference's ``SubpixelCrossEntropy``,
``loss.py:16-78``). The target distribution over disparity indices is an
unnormalised Laplace ``exp(-|gt - d| / diversity) / (2 * diversity)``
centred at the float ground truth, and the loss is

    - sum_d log_softmax(similarities)_d * P_target(d) / sum_d P_target(d)

averaged over pixels with finite ground truth. With per-pixel ``weights``
the average is ``sum(w * ce) / (sum(w) + 1e-15)`` over those pixels. As in
the JAX package, ground truth that is infinite everywhere gives 0 / 0 (NaN)
without weights and 0 with them.

Golden (the reference's ``test_loss.py``): similarities over 4 disparities,
gt [1.3, inf, 1.9], weights [0.9, 0, 0.01], diversity 2, step 1 -> 1.3654.
"""

from __future__ import annotations

import torch


def _cross_entropy_per_pixel(similarities: torch.Tensor,
                             ground_truth_disparities: torch.Tensor,
                             diversity: float, disparity_step: int):
    """(cross-entropy ``[...]``, 1 where the ground truth is finite else 0
    ``[...]``), both in the similarities' dtype."""
    valid = torch.isfinite(ground_truth_disparities)
    # Masked pixels take 0, so no inf or NaN enters the graph.
    safe_ground_truth = torch.where(
        valid, ground_truth_disparities,
        torch.zeros((), dtype=ground_truth_disparities.dtype,
                    device=ground_truth_disparities.device))
    disparities = torch.arange(similarities.shape[-1],
                               dtype=similarities.dtype,
                               device=similarities.device) * disparity_step
    target = torch.exp(
        -torch.abs(safe_ground_truth[..., None] - disparities) / diversity
    ) / (2.0 * diversity)
    log_predicted = torch.log_softmax(similarities, dim=-1)
    cross_entropy = -(target * log_predicted).sum(dim=-1) / target.sum(dim=-1)
    return cross_entropy, valid.to(cross_entropy.dtype)


def cross_entropy_sum_and_count(similarities: torch.Tensor,
                                ground_truth_disparities: torch.Tensor,
                                diversity: float = 1.0,
                                disparity_step: int = 2):
    """(sum of the cross-entropy over the pixels with finite ground truth,
    their number): the unweighted loss is the first over the second. A
    batch split over processes sums the count before it divides
    (``training/trainer.py::loss_and_gradients``)."""
    cross_entropy, valid = _cross_entropy_per_pixel(
        similarities, ground_truth_disparities, diversity, disparity_step)
    return (cross_entropy * valid).sum(), valid.sum()


def subpixel_cross_entropy(similarities: torch.Tensor,
                           ground_truth_disparities: torch.Tensor,
                           weights: torch.Tensor | None = None,
                           diversity: float = 1.0,
                           disparity_step: int = 2) -> torch.Tensor:
    """Returns the scalar sub-pixel cross-entropy loss.

    Args:
        similarities: ``[..., D]`` scores, disparity index last; index ``i``
            scores disparity ``i * disparity_step``.
        ground_truth_disparities: ``[...]`` disparities in pixels, unknown
            ones ``inf``.
        weights: optional ``[...]`` per-pixel weights.
        diversity: Laplace diversity of the target distribution.
        disparity_step: pixels between adjacent disparity indices.
    """
    if weights is None:
        total, count = cross_entropy_sum_and_count(
            similarities, ground_truth_disparities, diversity,
            disparity_step)
        return total / count
    cross_entropy, valid = _cross_entropy_per_pixel(
        similarities, ground_truth_disparities, diversity, disparity_step)
    masked_weights = weights * valid
    return (masked_weights * cross_entropy).sum() / (masked_weights.sum()
                                                     + 1e-15)
