"""W-slicing over the mesh's ``volume`` axis: column ranges, halos, gathers.

Port of ``practicaldeepstereo_nips2018_tpu/parallel/sharding.py`` for a
``volume`` axis over processes. In the JAX package the images, the
descriptors, the cost volume, every hourglass level and the similarities
are W-sharded over ``volume`` (disparity unsharded, parameters replicated),
and GSPMD inserts the halo exchanges of the spatial convs and the
cross-shard sums of the norms. Here each process of a volume group runs the
network on its own columns of the padded image (:class:`ColumnSlice`), and
every exchange is written out:

* :func:`column_bounds`: slices at multiples of 64 full-resolution columns,
  so that every level down to W/64 (the deepest hourglass level) splits
  into whole columns; uneven where the blocks do not divide (960 columns
  over 2: 512 + 448);
* :func:`halo`: an autograd Function; forward it fetches the border columns
  of the neighbouring slices (zeros past the image's edges), backward it
  sends the halo's gradient back to the slice that owns the columns, which
  adds it to its own. A halo may span several slices (the cost volume's
  reaches D' + 4 columns to the left);
* :func:`conv_halo` and :func:`transposed_conv_halo`: the halo a conv
  needs, and the output columns a transposed conv then drops (as extra W
  padding);
* :func:`moments`: instance-norm moments over the whole width, all-reduced
  over the group, an autograd Function that keeps what ``torch.var_mean``
  keeps;
* :func:`gather_columns`: a full-width map on every process (``infer``).

Every process of a group calls each of them in the same order; their
backward passes then also run in the same order on every process.
"""

from __future__ import annotations

import dataclasses
import itertools
import math

import torch
import torch.nn.functional as F

from practicaldeepstereo_nips2018_tpu_torch.parallel import runtime

# Full-resolution columns per block: slices hold whole blocks, so the
# deepest level (W/64) still splits into whole columns.
BLOCK = 64


def column_bounds(width: int, parts: int) -> tuple[int, ...]:
    """The ``parts + 1`` boundaries of ``parts`` slices of a padded width
    (a multiple of :data:`BLOCK`): whole blocks, the first ``blocks %
    parts`` slices one block wider."""
    if width % BLOCK:
        raise ValueError(f"the padded width {width} is not a multiple of "
                         f"{BLOCK}")
    blocks = width // BLOCK
    if parts > blocks:
        raise ValueError(
            f"a volume axis of {parts} needs an image at least "
            f"{parts * BLOCK} columns wide once padded (one {BLOCK}-column "
            f"block per process), but it is {width} wide")
    sizes = [blocks // parts + (index < blocks % parts)
             for index in range(parts)]
    return tuple(BLOCK * bound for bound in itertools.accumulate([0] + sizes))


@dataclasses.dataclass(frozen=True)
class ColumnSlice:
    """This process's columns of a padded image in its volume group.

    ``bounds`` are the full-resolution boundaries of every process's slice
    (:func:`column_bounds`), ``index`` this process's position, ``ranks``
    the group's processes (world ranks) and ``group`` its process group.
    """

    bounds: tuple[int, ...]
    index: int
    ranks: tuple[int, ...]
    group: object = dataclasses.field(default=None, compare=False,
                                      repr=False)

    def level(self, width: int) -> tuple[int, ...]:
        """The boundaries at the level where this slice is ``width``
        columns wide (full resolution divided by a power of two)."""
        full = self.bounds[self.index + 1] - self.bounds[self.index]
        scale, rest = divmod(full, width)
        if rest or scale & (scale - 1) or scale > BLOCK:
            raise ValueError(f"a slice of {full} columns has no level "
                             f"{width} columns wide")
        return tuple(bound // scale for bound in self.bounds)

    def span(self, width: int) -> tuple[int, int, int]:
        """(first column, end, global width) of this slice at the level
        where it is ``width`` columns wide."""
        bounds = self.level(width)
        return bounds[self.index], bounds[self.index + 1], bounds[-1]


def column_slice(mesh, width: int) -> ColumnSlice:
    """This process's slice of a padded width over ``mesh``'s volume
    axis; raises where the width has fewer blocks than the axis has
    processes."""
    return ColumnSlice(column_bounds(width, mesh.volume), mesh.volume_index,
                       mesh.volume_ranks, mesh.volume_group)


def whole(width: int) -> ColumnSlice:
    """An unsliced width as one slice: its halos are zeros, and nothing is
    exchanged."""
    return ColumnSlice((0, width), 0, (0,))


def slice_columns(tensor: torch.Tensor, columns: ColumnSlice
                  ) -> torch.Tensor:
    """This process's columns (last axis) of a full-width tensor (a
    view)."""
    if tensor.shape[-1] != columns.bounds[-1]:
        raise ValueError(f"expected {columns.bounds[-1]} columns, got "
                         f"{tensor.shape[-1]}")
    return tensor[..., columns.bounds[columns.index]:
                  columns.bounds[columns.index + 1]]


def conv_halo(kernel: int, stride: int, padding: int) -> tuple[int, int]:
    """(left, right) halo columns of a conv along W: output column ``o``
    reads inputs ``stride * o - padding`` to ``stride * o - padding +
    kernel - 1``, so a slice's outputs read ``padding`` columns before it
    and ``kernel - stride - padding`` after it."""
    return padding, kernel - stride - padding


def transposed_conv_halo(kernel: int, stride: int,
                         padding: int) -> tuple[int, int, int]:
    """(left, right) halo columns of a transposed conv along W, and the
    output columns to drop on each side when it runs on the haloed input
    with its own padding. Output ``o`` takes input ``i`` through tap ``o +
    padding - stride * i``, so a slice's outputs need ``(kernel - 1 -
    padding) // stride`` inputs before it and ``(padding - 1) // stride +
    1`` after it. The two sides drop as many columns for every transposed
    conv of the network (4x4x4 and (3, 4, 4), stride 2, padding 1: 2), so
    the drop adds to the conv's W padding and the output stays contiguous
    (a crop would leave a strided view, which K2 does not take)."""
    left = (kernel - 1 - padding) // stride
    right = (padding - 1) // stride + 1
    drop, drop_right = stride * left, stride * (right - 1) - 2 * padding + (
        kernel)
    if drop != drop_right:
        raise ValueError(f"a transposed conv of kernel {kernel}, stride "
                         f"{stride}, padding {padding} drops {drop} and "
                         f"{drop_right} columns")
    return left, right, drop


def _needs(bounds, index: int, left: int, right: int):
    """The global columns a slice's halo takes: before it and after it."""
    return ((bounds[index] - left, bounds[index]),
            (bounds[index + 1], bounds[index + 1] + right))


def _overlap(ranges, first: int, end: int):
    for low, high in ranges:
        low, high = max(low, first), min(high, end)
        if low < high:
            return low, high
    return None


def halo_plan(bounds, index: int, left: int, right: int):
    """(sends, receives): for each other slice of ``bounds``, the columns
    of this slice its halo takes, ``(first, end)`` in this slice's
    coordinates, and the columns of this slice's haloed tensor that slice
    fills, in the haloed tensor's coordinates."""
    first, end = bounds[index], bounds[index + 1]
    sends, receives = {}, {}
    for other in range(len(bounds) - 1):
        if other == index:
            continue
        taken = _overlap(_needs(bounds, other, left, right), first, end)
        if taken:
            sends[other] = (taken[0] - first, taken[1] - first)
        given = _overlap(_needs(bounds, index, left, right), bounds[other],
                         bounds[other + 1])
        if given:
            receives[other] = (given[0] - first + left,
                               given[1] - first + left)
    return sends, receives


class _Halo(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, left, right, columns):
        width = x.shape[-1]
        sends, receives = halo_plan(columns.level(width), columns.index,
                                    left, right)
        ctx.plan = sends, receives, left, width, columns
        out = x.new_zeros(x.shape[:-1] + (left + width + right,))
        out[..., left:left + width] = x
        received = runtime.exchange(
            {columns.ranks[other]: x[..., first:end]
             for other, (first, end) in sends.items()},
            {columns.ranks[other]: x.shape[:-1] + (end - first,)
             for other, (first, end) in receives.items()}, x)
        for other, (first, end) in receives.items():
            out[..., first:end] = received[columns.ranks[other]]
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_output):
        sends, receives, left, width, columns = ctx.plan
        grad_x = grad_output[..., left:left + width].clone()
        returned = runtime.exchange(
            {columns.ranks[other]: grad_output[..., first:end]
             for other, (first, end) in receives.items()},
            {columns.ranks[other]: grad_output.shape[:-1] + (end - first,)
             for other, (first, end) in sends.items()}, grad_output)
        for other, (first, end) in sends.items():
            grad_x[..., first:end] += returned[columns.ranks[other]]
        return grad_x, None, None, None


def halo(x: torch.Tensor, left: int, right: int,
         columns: ColumnSlice) -> torch.Tensor:
    """``x [..., w]``, this process's columns of a W-sliced tensor ->
    ``[..., left + w + right]``: ``left`` columns of the slices before it
    and ``right`` of those after it, zeros past the image's edges. The
    gradient of a halo column goes back to the process that owns it."""
    return _Halo.apply(x, left, right, columns)


class _Moments(torch.autograd.Function):
    """(mean, biased variance) over the group, as ``torch.var_mean``'s
    autograd node: it keeps ``x`` and the mean, not the deviations, and
    its backward recomputes ``x - mean``. The gradient of ``x`` is that of
    the group's moments, ``(sum g_mean + 2 (x - mean) sum g_var) / n``,
    the sums over the group (every process's moments depend on every
    ``x``); the mean's share through the deviations sums to zero, as
    ``var_mean``'s backward leaves it out.

    Not ``torch.distributed.nn.functional.all_reduce``: under gloo the
    sums go through the host, and an autograd node on a host tensor would
    run in autograd's CPU thread beside the card's, so that two processes
    could run the backward's collectives in different orders. This node
    lies on ``x``'s device, the host copies inside it."""

    @staticmethod
    def forward(ctx, x, dims, group):
        sums = x.sum(dims, keepdim=True)
        count = sums.new_full(sums.shape,
                              math.prod(x.shape[d] for d in dims))
        sums, count = runtime.all_reduce_sum(torch.stack([sums, count]),
                                             group).unbind(0)
        mean = sums / count
        squares = runtime.all_reduce_sum(
            (x - mean).square().sum(dims, keepdim=True), group)
        ctx.save_for_backward(x, mean, count)
        ctx.group = group
        return mean, squares / count

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_mean, grad_variance):
        x, mean, count = ctx.saved_tensors
        grad_mean, grad_variance = (runtime.all_reduce_sum(
            torch.stack([grad_mean, grad_variance]), ctx.group)
            / count).unbind(0)
        return grad_mean + 2 * grad_variance * (x - mean), None, None


def moments(x: torch.Tensor, dims: tuple[int, ...], columns: ColumnSlice):
    """(mean, biased variance) of a W-sliced ``x`` over ``dims`` of the
    whole width, keepdim, in ``x``'s dtype. Two passes, each all-reduced
    over the group: the sums and the count give the mean, then the sums of
    squared deviations the variance, as ``torch.var_mean`` computes them;
    the one-pass E[x^2] - E[x]^2 would lose bits in float32 over the ~8M
    elements per channel of the first volume. Backward all-reduces the
    moments' gradients once."""
    return _Moments.apply(x, dims, columns.group)


def gather_columns(x: torch.Tensor, columns: ColumnSlice) -> torch.Tensor:
    """``[..., w]`` this process's columns -> ``[..., W]``, the whole width
    on every process of the group; no gradient."""
    bounds = columns.level(x.shape[-1])
    widest = max(end - first for first, end in zip(bounds, bounds[1:]))
    parts = runtime.all_gather(F.pad(x, (0, widest - x.shape[-1])),
                               columns.group)
    return torch.cat([part[..., :end - first] for part, first, end
                      in zip(parts, bounds, bounds[1:])], dim=-1)
