"""Cost-volume construction: linearity-factored shift-and-concat matching.

Port of ``practicaldeepstereo_nips2018_tpu/ops/costvolume.py``
(``matching_head_planes`` + ``shift_accumulate_volume``), channels-first.
The function is the reference's per-disparity head conv
(``matching.py:52-63``):

    volume[d] = conv_128(concat(L, shift_d(R)))

where ``shift_d`` moves R right by ``d`` columns, fills with zeros and
TRUNCATES R's last ``d`` columns. Convolution is linear, so this is

    conv_L(L) + conv_R(shift_d(R))

and ``conv_R(shift_d(R))`` is a column shift of ONE convolution of R taken
on one extra left column (the ``x = d - 1`` window straddles the zero fill),
except at the last column, where the truncated input sees zero padding but
the shifted plane saw ``R[W - d]`` through the kernel's right tap. A
width-1 conv of R with that tap gives the term to subtract. Two 64-input
convs and one width-1 conv then replace ``D + 1`` 128-input convs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def matching_head_planes(weight: torch.Tensor, bias: torch.Tensor,
                         left_descriptor: torch.Tensor,
                         right_descriptor: torch.Tensor):
    """The factored planes of the matching head conv.

    Args:
        weight, bias: the head conv, ``[64, 128, 3, 3]`` and ``[64]``
            (input channels: left descriptor first, right second).
        left_descriptor, right_descriptor: ``[B, 64, H, W]``.

    Returns:
        ``left_plane [B, C, H, W]`` (bias included), ``right_plane_wide
        [B, C, H, W + 1]`` (column ``j`` is the right-half conv at column
        ``j - 1``) and ``edge_plane [B, C, H, W]`` (column ``j``'s
        contribution through the rightmost kernel column).
    """
    dtype = left_descriptor.dtype
    features = left_descriptor.shape[1]
    weight = weight.to(dtype)
    w_left, w_right = weight[:, :features], weight[:, features:]
    left_plane = F.conv2d(left_descriptor, w_left, bias.to(dtype), padding=1)
    right_plane_wide = F.conv2d(F.pad(right_descriptor, (2, 1, 1, 1)),
                                w_right)
    edge_plane = F.conv2d(F.pad(right_descriptor, (0, 0, 1, 1)),
                          w_right[:, :, :, 2:])
    return left_plane, right_plane_wide, edge_plane


def shift_accumulate_volume(left_plane: torch.Tensor,
                            right_plane_wide: torch.Tensor,
                            edge_plane: torch.Tensor,
                            maximum_disparity: int) -> torch.Tensor:
    """Assembles ``[B, D+1, C, H, W]`` head-conv outputs for d = 0 .. D.

    ``volume[d][x] = left_plane[x] + right_plane_wide[x - d + 1]`` (zero
    where ``x - d + 1 < 0``), minus ``edge_plane[W - d]`` at ``x = W - 1``
    for ``1 <= d <= W``. Disparities past the width see only zero fill.
    """
    width = left_plane.shape[-1]
    # padded[..., k] = right_plane_wide[k - D]; a width-W window starting at
    # s = D + 1 - d is disparity d's shifted plane.
    padded = F.pad(right_plane_wide, (maximum_disparity, 0))
    windows = padded.unfold(-1, width, 1)  # [B, C, H, D + 2, W]
    # Gathered in disparity order into a new contiguous [B, D+1, C, H, W]
    # tensor, which takes the left plane in place: autograd follows both
    # steps (it does not follow an ``out=`` add).
    starts = torch.arange(maximum_disparity + 1, 0, -1,
                          device=left_plane.device)
    volume = windows.permute(0, 3, 1, 2, 4).index_select(1, starts)
    volume += left_plane[:, None]
    corrected = min(maximum_disparity, width)
    if corrected:
        # d = 1 .. corrected subtract edge_plane[..., W - d] at column W - 1.
        edge = edge_plane.flip(-1)[..., :corrected]  # [B, C, H, corrected]
        volume[:, 1:corrected + 1, :, :, width - 1] -= edge.permute(0, 3, 1,
                                                                    2)
    return volume


def build_cost_volume(weight: torch.Tensor, bias: torch.Tensor,
                      left_descriptor: torch.Tensor,
                      right_descriptor: torch.Tensor,
                      maximum_disparity: int) -> torch.Tensor:
    """Planes + shift-accumulate: ``[B, D+1, C, H, W]``."""
    planes = matching_head_planes(weight, bias, left_descriptor,
                                  right_descriptor)
    return shift_accumulate_volume(*planes, maximum_disparity)


# The first conv of the matching tail (residual block 1's conv1) is linear
# in the volume too, so it factors through the shift-assembly the same way.


def conv1_volume_planes(weight: torch.Tensor, left_plane: torch.Tensor,
                        right_plane_wide: torch.Tensor,
                        edge_plane: torch.Tensor):
    """The factored planes of ``conv1(volume)`` (the JAX
    ``conv1_volume_planes``), channels-first.

    With ``volume[d] = L + S_d`` (:func:`shift_accumulate_volume`),
    ``conv1(volume[d]) = conv1(L) + conv1(S_d) + b1``, and ``conv1(S_d)`` is
    a column shift of ONE conv of the wide right plane ``P``, taken on two
    extra left columns, plus boundary terms.

    Args:
        weight: conv1's ``[C1, C, 3, 3]`` weight (its bias is added at
            assembly).
        left_plane, right_plane_wide, edge_plane: the head's planes
            (:func:`matching_head_planes`).

    Returns:
        ``(t_left [B, C1, H, W]``, ``t_right_wide [B, C1, H, W + 2]``
        (column ``j`` is the conv of ``P`` at column ``j - 2``),
        ``edge2 [B, C1, H, W + 1]`` (conv1's right seam: one column of
        ``P`` through its rightmost tap), ``smears``, three ``[B, C1, H,
        W]`` planes (the head's edge plane through each column tap of
        conv1), ``left_seam [B, C1, H, 1]`` (``P``'s first column through
        conv1's left tap)).
    """
    weight = weight.to(left_plane.dtype)
    t_left = F.conv2d(left_plane, weight, padding=1)
    t_right_wide = F.conv2d(F.pad(right_plane_wide, (2, 1, 1, 1)), weight)
    edge2 = F.conv2d(F.pad(right_plane_wide, (0, 0, 1, 1)),
                     weight[..., 2:])
    rows_padded_edge = F.pad(edge_plane, (0, 0, 1, 1))
    smears = [F.conv2d(rows_padded_edge, weight[..., k:k + 1])
              for k in range(3)]
    left_seam = F.conv2d(F.pad(right_plane_wide[..., :1], (0, 0, 1, 1)),
                         weight[..., :1])
    return t_left, t_right_wide, edge2, smears, left_seam


def assemble_conv1_volume(planes, bias: torch.Tensor,
                          maximum_disparity: int) -> torch.Tensor:
    """``conv1(volume)`` as ``[B, D+1, C1, H, W]`` from
    :func:`conv1_volume_planes` and conv1's bias; the JAX
    ``assemble_conv1_volume_paired`` without the disparity pairing.

    ``out[d][x] = t_left[x] + t_right_wide[x - d + 2] + b1`` (zero where the
    index falls before the plane), corrected:

    * at ``x = W - 1`` for ``1 <= d <= W + 1``: minus ``edge2[W - d + 1]``
      (the true conv pads zero where the plane saw a real column);
    * at ``x = W - 2`` and ``x = W - 1`` for ``1 <= d <= W``: minus
      ``smears[2][W - d]`` and ``smears[1][W - d]`` (conv1 smearing the
      head's own right-edge correction);
    * at ``x = 0`` for ``d = 0``: minus ``left_seam``.

    Built like :func:`shift_accumulate_volume` (a gather into a new tensor,
    then in-place adds), so autograd follows it.
    """
    t_left, t_right_wide, edge2, smears, left_seam = planes
    width = t_left.shape[-1]
    padded = F.pad(t_right_wide, (maximum_disparity, 0))
    windows = padded.unfold(-1, width, 1)  # [B, C1, H, D + 3, W]
    starts = torch.arange(maximum_disparity + 2, 1, -1,
                          device=t_left.device)
    volume = windows.permute(0, 3, 1, 2, 4).index_select(1, starts)
    volume += (t_left + bias.to(t_left.dtype)[:, None, None])[:, None]
    seam = min(maximum_disparity, width + 1)
    if seam:
        volume[:, 1:seam + 1, :, :, width - 1] -= edge2.flip(-1)[
            ..., :seam].permute(0, 3, 1, 2)
    smeared = min(maximum_disparity, width)
    if smeared:
        for column, tap in ((width - 1, 1), (width - 2, 2)):
            if column >= 0:
                volume[:, 1:smeared + 1, :, :, column] -= smears[tap].flip(
                    -1)[..., :smeared].permute(0, 3, 1, 2)
    volume[:, 0, :, :, :1] -= left_seam
    return volume
