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

Each process assembles the volume's columns of its slice (``columns``,
``parallel/sharding.py``; an unsliced width is one slice). The shifted
planes read the right descriptor up to D + 4 columns left of the slice and
2 to its right (one halo, multi-neighbour under the mesh's ``volume``
axis, zeros past the image), and the edge and seam terms apply at the
GLOBAL columns ``W - 1``, ``W - 2`` and ``0``, on the processes that hold
them. With P the right-half conv's plane, ``P[j]`` the conv centred on
column ``j - 1`` for ``0 <= j <= W`` and zero elsewhere,
``volume[d][x] = L[x] + P[x - d + 1]``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from practicaldeepstereo_nips2018_tpu_torch.parallel import sharding


def matching_head_planes(weight: torch.Tensor, bias: torch.Tensor,
                         left_descriptor: torch.Tensor,
                         right_descriptor: torch.Tensor,
                         maximum_disparity: int,
                         columns: sharding.ColumnSlice | None = None):
    """The factored planes of the matching head conv, for this process's
    columns.

    Args:
        weight, bias: the head conv, ``[64, 128, 3, 3]`` and ``[64]``
            (input channels: left descriptor first, right second).
        left_descriptor, right_descriptor: ``[B, 64, H, w]``, the columns
            of ``columns`` (the whole width without it).
        maximum_disparity: D, the volume's last disparity.

    Returns:
        ``left_plane [B, C, H, w]`` (bias included); ``right_window [B, C,
        H, w + D + 4]``, column ``i`` holding ``P[start - D - 2 + i]``; and
        ``edge [B, C, H, min(D, W)]``, the right descriptor's last
        ``min(D, W)`` columns through the kernel's rightmost column, on
        the process that holds column ``W - 1`` (None on the others, and
        for D = 0).
    """
    if columns is None:
        columns = sharding.whole(left_descriptor.shape[-1])
    dtype = left_descriptor.dtype
    features = left_descriptor.shape[1]
    weight = weight.to(dtype)
    w_left, w_right = weight[:, :features], weight[:, features:]
    start, end, width = columns.span(left_descriptor.shape[-1])
    left_plane = F.conv2d(sharding.halo(left_descriptor, 1, 1, columns),
                          w_left, bias.to(dtype), padding=(1, 0))
    # Columns start - D - 4 .. end + 1 of the right descriptor, zero past
    # the image; the conv centred on column j - 1 is P[j].
    first = start - maximum_disparity - 4
    right = sharding.halo(right_descriptor, maximum_disparity + 4, 2,
                          columns)
    right_window = F.conv2d(right, w_right, padding=(1, 0))
    edge = None
    if end == width:
        # P[W + 1] is zero, not the conv centred on column W.
        right_window = F.pad(right_window[..., :-1], (0, 1))
    corrected = min(maximum_disparity, width)
    if end == width and corrected:
        edge = F.conv2d(
            F.pad(right[..., width - corrected - first:width - first],
                  (0, 0, 1, 1)), w_right[..., 2:])
    return left_plane, right_window, edge


def shift_accumulate_volume(left_plane: torch.Tensor,
                            right_window: torch.Tensor,
                            edge: torch.Tensor | None,
                            maximum_disparity: int) -> torch.Tensor:
    """Assembles ``[B, D+1, C, H, w]`` head-conv outputs for d = 0 .. D
    from :func:`matching_head_planes`.

    ``volume[d][x] = left_plane[x] + P[x - d + 1]``, minus the edge plane's
    column ``W - d`` at ``x = W - 1`` for ``1 <= d <= W``. Disparities past
    the width see only zero fill.
    """
    width = left_plane.shape[-1]
    # P[x - d + 1] is right_window's column x_local - d + D + 3.
    volume = _shifted_planes(right_window, width, maximum_disparity + 3,
                             maximum_disparity)
    volume += left_plane[:, None]
    if edge is not None:
        _subtract_at_column(volume, edge, width - 1)
    return volume


def _shifted_planes(padded: torch.Tensor, width: int, first_start: int,
                    maximum_disparity: int) -> torch.Tensor:
    """``[B, D+1, C, H, width]``, disparity ``d``'s entry the width-wide
    window of ``padded [B, C, H, *]`` that starts at ``first_start - d``.

    Gathered in disparity order into a new contiguous tensor, which the
    caller then adds to in place: autograd follows both steps (it does not
    follow an ``out=`` add)."""
    windows = padded.unfold(-1, width, 1)  # [B, C, H, starts, width]
    starts = torch.arange(first_start, first_start - maximum_disparity - 1,
                          -1, device=padded.device)
    return windows.permute(0, 3, 1, 2, 4).index_select(1, starts)


def _subtract_at_column(volume: torch.Tensor, plane: torch.Tensor,
                        column: int) -> None:
    """Disparities ``1 .. n`` of ``volume [B, D+1, C, H, W]`` at
    ``column`` take away the columns of ``plane [B, C, H, n]``, the last
    column from disparity 1."""
    count = plane.shape[-1]
    if count:
        volume[:, 1:count + 1, :, :, column] -= plane.flip(-1).permute(
            0, 3, 1, 2)


def build_cost_volume(weight: torch.Tensor, bias: torch.Tensor,
                      left_descriptor: torch.Tensor,
                      right_descriptor: torch.Tensor,
                      maximum_disparity: int,
                      columns: sharding.ColumnSlice | None = None
                      ) -> torch.Tensor:
    """Planes + shift-accumulate: ``[B, D+1, C, H, w]``."""
    planes = matching_head_planes(weight, bias, left_descriptor,
                                  right_descriptor, maximum_disparity,
                                  columns)
    return shift_accumulate_volume(*planes, maximum_disparity)


# The first conv of the matching tail (residual block 1's conv1) is linear
# in the volume too, so it factors through the shift-assembly the same way.


def conv1_volume(weight: torch.Tensor, bias: torch.Tensor, planes,
                 maximum_disparity: int,
                 columns: sharding.ColumnSlice | None = None
                 ) -> torch.Tensor:
    """``conv1(volume)`` of this process's columns, ``[B, D+1, C1, H,
    w]``, from :func:`matching_head_planes`' ``planes`` and conv1's weight
    and bias (the JAX ``conv1_volume_planes`` and
    ``assemble_conv1_volume_paired`` without the disparity pairing).

    With ``volume[d] = L + S_d``, ``conv1(volume[d]) = conv1(L) + conv1(S_d)
    + b1``, and ``conv1(S_d)`` is a column shift of ONE conv of P,
    ``T[x - d + 2]`` (T's column ``j`` the conv centred on ``P[j - 1]``),
    corrected at global columns:

    * ``x = W - 1``, for ``1 <= d <= W + 1``: minus ``P[W - d + 1]``
      through conv1's rightmost tap (the true conv pads zero where the
      plane saw a real column);
    * ``x = W - 2`` and ``x = W - 1``, for ``1 <= d <= W``: minus the
      head's edge plane at ``W - d`` through conv1's right and centre taps
      (conv1 smearing the head's own right-edge correction);
    * ``x = 0``, for ``d = 0``: minus ``P[0]`` through conv1's left tap.

    Built like :func:`shift_accumulate_volume` (a gather into a new tensor,
    then in-place adds), so autograd follows it.
    """
    left_plane, right_window, edge = planes
    if columns is None:
        columns = sharding.whole(left_plane.shape[-1])
    weight = weight.to(left_plane.dtype)
    start, end, width = columns.span(left_plane.shape[-1])
    local = end - start
    t_left = F.conv2d(sharding.halo(left_plane, 1, 1, columns), weight,
                      padding=(1, 0))
    # conv1 of P centred on P[x - d + 1]: t_right's column
    # x_local - d + D + 2.
    t_right = F.conv2d(right_window, weight, padding=(1, 0))
    volume = _shifted_planes(t_right, local, maximum_disparity + 2,
                             maximum_disparity)
    volume += (t_left + bias.to(t_left.dtype)[:, None, None])[:, None]
    first = start - maximum_disparity - 2  # right_window's first P index
    if edge is not None:
        seam = min(maximum_disparity, width + 1)
        edge2 = F.conv2d(F.pad(
            right_window[..., width + 1 - seam - first:width + 1 - first],
            (0, 0, 1, 1)), weight[..., 2:])
        _subtract_at_column(volume, edge2, local - 1)
        rows_padded_edge = F.pad(edge, (0, 0, 1, 1))
        for column, tap in ((local - 1, 1), (local - 2, 2)):
            if column >= 0:
                _subtract_at_column(volume, F.conv2d(
                    rows_padded_edge, weight[..., tap:tap + 1]), column)
    if start == 0:
        volume[:, 0, :, :, :1] -= F.conv2d(
            F.pad(right_window[..., -first:1 - first], (0, 0, 1, 1)),
            weight[..., :1])
    return volume
