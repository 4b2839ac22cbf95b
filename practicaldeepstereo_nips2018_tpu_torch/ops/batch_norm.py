"""K6: PSMNet's BatchNorm, forward and backward.

Replaces no TPU kernel: the JAX package has no PSMNet. PyTorch's own
BatchNorm kernels for contiguous NC(D)HW input launch one block per channel,
which fills 32 to 128 of the card's SMs at PSMNet's widths; the CUDA source
``csrc/batch_norm.cu`` splits each channel over ``(row, chunk)`` blocks
across the whole card: the chunks' moments, then each channel's merged
moments and the output (eval mode: the output alone, from the running
statistics). Its gradient (:func:`batch_norm_backward`, counted and spanned
as ``batch_norm_backward``) takes two launches over the same grid: the
chunks' sums of ``dy`` and ``dy * x_hat``, then the input gradient and the
affine map's. Both are bound by memory bytes; the source says what their
design does about that.

:func:`batch_norm` is what the modules call (``models/psmnet.py``'s
``BatchNorm2d``, ``BatchNorm3d``): where autograd records, through
:class:`BatchNorm`, which keeps ``x`` and each channel's ``(mean, rstd)``
for the backward; elsewhere the direct call. A CPU tensor takes the plain
version, which repeats the kernels' arithmetic (chunked moments merged with
Chan's formula); a CUDA tensor launches the kernels or raises.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from practicaldeepstereo_nips2018_tpu_torch.ops import kernels
from practicaldeepstereo_nips2018_tpu_torch.utils import profiling

NAME = "batch_norm"
BACKWARD_NAME = "batch_norm_backward"
SPAN, BACKWARD_SPAN = f"pds.kernel.{NAME}", f"pds.kernel.{BACKWARD_NAME}"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURE = ([ctypes.c_void_p] * 9
              + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong]
              + [ctypes.c_int] * 4 + [ctypes.c_float] * 2
              + [ctypes.c_int, ctypes.c_void_p])
_BACKWARD_SIGNATURE = ([ctypes.c_void_p] * 8
                       + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong]
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p])
# The kernels' block: 256 threads holding 128 bytes of a tensor each, so a
# chunk holds at most 32 KB of elements.
THREADS, BYTES_PER_THREAD = 256, 128


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def plan(length: int, element_size: int, vector: int) -> tuple[int, int]:
    """(chunk, chunks) for rows of ``length`` elements of ``element_size``
    bytes: as few chunks of at most ``THREADS * BYTES_PER_THREAD`` bytes as
    cover a row, their length evened out and rounded up to a whole number
    of ``vector``-element loads per thread."""
    largest = THREADS * BYTES_PER_THREAD // element_size
    step = THREADS * vector
    chunk = _ceil_div(_ceil_div(length, _ceil_div(length, largest)),
                      step) * step
    return chunk, _ceil_div(length, chunk)


def _length(x: torch.Tensor) -> int:
    """The elements of one of ``x``'s rows (a sample's channel)."""
    return math.prod(x.shape[2:])


def _vector(x: torch.Tensor, *others: torch.Tensor) -> int:
    """The kernels' vector width for ``x``'s rows: 16 bytes of elements
    where the row length and every tensor's address allow it, else 1."""
    vector = 16 // x.element_size()
    length = _length(x)
    aligned = length % vector == 0 and all(
        tensor.data_ptr() % 16 == 0 for tensor in (x, *others))
    return vector if aligned else 1


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    """float32, or float64 for float64 ``x`` (which the kernels do not
    take)."""
    return torch.promote_types(x.dtype, torch.float32)


def _chunks(t: torch.Tensor, chunk: int, chunks: int) -> torch.Tensor:
    """``t`` ``[N, C, *spatial]`` as ``[N, C, chunks, chunk]``, each row's
    tail after its last element zero."""
    rows = t.reshape(t.shape[0], t.shape[1], -1)
    return F.pad(rows, (0, chunks * chunk - rows.shape[2])).view(
        t.shape[0], t.shape[1], chunks, chunk)


def _chunk_counts(length: int, chunk: int, chunks: int, like: torch.Tensor
                  ) -> torch.Tensor:
    """The elements of each of a row's chunks, ``like``'s dtype and
    device."""
    first = torch.arange(chunks, dtype=like.dtype, device=like.device) * chunk
    return (length - first).clamp(max=chunk)


def _plain_plan(x: torch.Tensor) -> tuple[int, int]:
    length = _length(x)
    vector = 16 // x.element_size()
    return plan(length, x.element_size(), vector if length % vector == 0
                else 1)


def batch_moments_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Each channel's ``(mean, biased variance)`` as the kernels take them,
    in float32 (float64 for float64 ``x``): pass 1's chunk means and M2
    (two passes over the chunk), then the ``N x chunks`` parts of a channel
    merged with Chan's formula, here in its closed form over all parts at
    once: ``mean = sum(n_k mean_k) / M``, ``M2 = sum(M2_k) + sum(n_k
    (mean_k - mean)^2)``, ``var = M2 / M``."""
    dtype = _compute_dtype(x)
    length = _length(x)
    chunk, chunks = _plain_plan(x)
    parts = _chunks(x.to(dtype), chunk, chunks)
    counts = _chunk_counts(length, chunk, chunks, parts)
    inside = (torch.arange(chunks * chunk, device=x.device) < length).view(
        chunks, chunk)
    means = parts.sum(dim=3) / counts
    m2 = (((parts - means[..., None]) * inside) ** 2).sum(dim=3)
    total = x.shape[0] * length
    mean = (means * counts).sum(dim=(0, 2)) / total
    m2 = m2.sum(dim=(0, 2)) + (counts * (means - mean[:, None]) ** 2).sum(
        dim=(0, 2))
    return mean, m2 / total


def batch_norm_plain(x: torch.Tensor, weight: torch.Tensor | None,
                     bias: torch.Tensor | None,
                     running_mean: torch.Tensor | None,
                     running_var: torch.Tensor | None,
                     num_batches_tracked: torch.Tensor | None,
                     training: bool, momentum: float, eps: float):
    """Plain PyTorch version of the kernels: ``(y, saved)``.

    In training mode each channel's moments over the batch
    (:func:`batch_moments_plain`), and the running statistics (where given)
    updated in place to ``momentum * batch + (1 - momentum) * running``,
    the variance unbiased, ``num_batches_tracked`` (where given) plus one;
    in eval mode the running statistics. Then, in float32 (float64 for
    float64 ``x``), ``y = (x - mean) * (weight * rstd) + bias`` with ``rstd
    = 1 / sqrt(var + eps)`` (no affine map for a None ``weight``), rounded
    once to ``x``'s dtype. ``saved`` is ``[C, 2]``: each channel's ``(mean,
    rstd)`` in that dtype, what the backward reads."""
    dtype = _compute_dtype(x)
    if training:
        mean, var = batch_moments_plain(x)
        if running_mean is not None:
            total = x.numel() // x.shape[1]
            with torch.no_grad():
                running_mean.copy_(mean * momentum
                                   + (1 - momentum) * running_mean)
                running_var.copy_(var * (total / (total - 1)) * momentum
                                  + (1 - momentum) * running_var)
        if num_batches_tracked is not None:
            num_batches_tracked.add_(1)
    else:
        mean, var = running_mean.to(dtype), running_var.to(dtype)
    rstd = 1 / torch.sqrt(var + eps)
    scale = rstd if weight is None else weight.to(dtype) * rstd
    shape = (1, -1) + (1,) * (x.ndim - 2)
    y = (x.to(dtype) - mean.view(shape)) * scale.view(shape)
    if bias is not None:
        y = y + bias.to(dtype).view(shape)
    return y.to(x.dtype), torch.stack([mean, rstd], dim=1)


def batch_norm_backward_plain(grad: torch.Tensor, x: torch.Tensor,
                              weight: torch.Tensor | None,
                              saved: torch.Tensor, training: bool):
    """Plain PyTorch version of the backward kernels: ``(dx, dweight,
    dbias)`` for the output gradient ``grad`` of :func:`batch_norm_plain`
    at ``x``, from its ``saved`` ``(mean, rstd)``, in float32 (float64 for
    float64 ``x``): with ``x_hat = (x - mean) * rstd`` and ``M`` the
    elements of a channel, the chunks' sums of ``dy`` and ``dy * x_hat``
    summed over each channel's parts, then

        dx = weight * rstd * (dy - sum(dy) / M - x_hat * sum(dy x_hat) / M)

    (eval mode: ``weight * rstd * dy``) rounded once to ``x``'s dtype;
    ``dweight = sum(dy * x_hat)`` and ``dbias = sum(dy)`` in ``weight``'s
    dtype (both None without ``weight``)."""
    dtype = _compute_dtype(x)
    shape = (1, -1) + (1,) * (x.ndim - 2)
    mean, rstd = (saved[:, 0].to(dtype).view(shape),
                  saved[:, 1].to(dtype).view(shape))
    x_hat = (x.to(dtype) - mean) * rstd
    dy = grad.to(dtype)
    chunk, chunks = _plain_plan(x)
    dy_sum = _chunks(dy, chunk, chunks).sum(dim=3).sum(dim=(0, 2))
    product_sum = _chunks(dy * x_hat, chunk, chunks).sum(dim=3).sum(
        dim=(0, 2))
    scale = rstd if weight is None else rstd * weight.to(dtype).view(shape)
    if training:
        total = x.numel() // x.shape[1]
        dx = scale * (dy - (dy_sum / total).view(shape)
                      - x_hat * (product_sum / total).view(shape))
    else:
        dx = scale * dy
    if weight is None:
        return dx.to(x.dtype), None, None
    return (dx.to(x.dtype), product_sum.to(weight.dtype),
            dy_sum.to(weight.dtype))


def _check_training_size(x: torch.Tensor) -> None:
    """nn.BatchNorm's refusal of a channel of one value in training."""
    if x.numel() // x.shape[1] <= 1:
        raise ValueError(f"{NAME}: expected more than 1 value per channel "
                         f"when training, got input {tuple(x.shape)}")


def _forward(x, weight, bias, running_mean, running_var, num_batches_tracked,
             training, momentum, eps):
    """:func:`batch_norm`'s ``(y, saved)``."""
    if x.ndim < 2:
        raise ValueError(f"{NAME}: expected x [N, C, *spatial], got "
                         f"{tuple(x.shape)}")
    if training:
        _check_training_size(x)
    elif running_mean is None or running_var is None:
        raise ValueError(f"{NAME}: eval mode needs the running statistics")
    if x.device.type == "cpu":
        return batch_norm_plain(x, weight, bias, running_mean, running_var,
                                num_batches_tracked, training, momentum, eps)
    if x.device.type != "cuda":
        raise ValueError(f"{NAME}: unsupported device {x.device}")
    with profiling.span(SPAN, lambda: kernels.launch_args(x, weight)):
        return _launch(x, weight, bias, running_mean, running_var,
                       num_batches_tracked, training, momentum, eps)


def _check_on(x, tensors: dict, what: str) -> None:
    device = x.device
    for name, tensor in tensors.items():
        if tensor.device != device:
            raise ValueError(f"{what}: {name} is on {tensor.device}, x on "
                             f"{device}")
        if not tensor.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def _pointer(tensor: torch.Tensor | None) -> int | None:
    return None if tensor is None else tensor.data_ptr()


def _stream(x: torch.Tensor) -> int:
    """The current CUDA stream of ``x``'s device, as a raw handle: without
    building a ``torch.cuda.Stream`` (~5 us of host a call, twice a norm
    of a train step)."""
    return torch._C._cuda_getCurrentRawStream(x.device.index)


def _launch(x, weight, bias, running_mean, running_var, num_batches_tracked,
            training, momentum, eps):
    """:func:`_forward` on CUDA tensors: the checks, the outputs, the
    scratch and the launches."""
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{NAME}: x must be float32 or bfloat16, got "
                        f"{x.dtype}")
    if (weight is None) != (bias is None):
        raise ValueError(f"{NAME}: weight and bias go together")
    if (running_mean is None) != (running_var is None):
        raise ValueError(f"{NAME}: running_mean and running_var go "
                         "together")
    channels = x.shape[1]
    tensors = {"x": x}
    for name, tensor in (("weight", weight), ("bias", bias),
                         ("running_mean", running_mean),
                         ("running_var", running_var)):
        if tensor is None:
            continue
        if tensor.dtype != torch.float32 or tensor.shape != (channels,):
            raise ValueError(f"{NAME}: {name} must be float32 "
                             f"[{channels}], got {tensor.dtype} "
                             f"{tuple(tensor.shape)}")
        tensors[name] = tensor
    if num_batches_tracked is not None:
        if num_batches_tracked.dtype != torch.int64 or (
                num_batches_tracked.numel() != 1):
            raise ValueError(f"{NAME}: num_batches_tracked must be one "
                             "int64")
        tensors["num_batches_tracked"] = num_batches_tracked
    _check_on(x, tensors, NAME)
    out = torch.empty_like(x)
    saved = torch.empty((channels, 2), dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return out, saved.zero_()
    samples, length = x.shape[0], _length(x)
    vector = _vector(x, out)
    chunk, chunks = plan(length, x.element_size(), vector)
    if samples * channels * chunks > 2 ** 31 - 1:
        raise ValueError(f"{NAME}: {samples * channels} rows of {chunks} "
                         "chunks exceed the grid")
    partials = (torch.empty((samples * channels, chunks, 2),
                            dtype=torch.float32, device=x.device)
                if training else None)
    library = kernels.library(NAME, _SIGNATURE)
    status = library.batch_norm(
        x.data_ptr(), out.data_ptr(), _pointer(partials), _pointer(weight),
        _pointer(bias), _pointer(running_mean), _pointer(running_var),
        _pointer(num_batches_tracked if training else None),
        saved.data_ptr(), samples, channels, length, chunk, chunks,
        int(vector > 1), int(training), momentum, eps, _DTYPE_CODES[x.dtype],
        _stream(x))
    kernels.check(NAME, status)
    kernels.launch_counts[NAME] += 1
    return out, saved


def batch_norm_backward(grad: torch.Tensor, x: torch.Tensor,
                        weight: torch.Tensor | None, saved: torch.Tensor,
                        training: bool):
    """The gradients ``(dx, dweight, dbias)`` of :func:`batch_norm` at
    ``x`` for the output gradient ``grad`` (``x``'s shape and dtype,
    contiguous), from the forward's ``saved``, as
    :func:`batch_norm_backward_plain` computes them. A CPU tensor takes the
    plain version; a CUDA tensor launches the kernels or raises."""
    if x.device.type == "cpu":
        return batch_norm_backward_plain(grad, x, weight, saved, training)
    if x.device.type != "cuda":
        raise ValueError(f"{BACKWARD_NAME}: unsupported device {x.device}")
    with profiling.span(BACKWARD_SPAN,
                        lambda: kernels.launch_args(x, weight)):
        return _launch_backward(grad, x, weight, saved, training)


def _launch_backward(grad, x, weight, saved, training):
    """:func:`batch_norm_backward` on CUDA tensors: the checks, the
    outputs, the scratch and the launches."""
    if grad.shape != x.shape or grad.dtype != x.dtype:
        raise ValueError(f"{BACKWARD_NAME}: gradient {tuple(grad.shape)} "
                         f"{grad.dtype}, x {tuple(x.shape)} {x.dtype}")
    _check_on(x, {"grad": grad, "x": x}, BACKWARD_NAME)
    dx = torch.empty_like(x)
    dweight = dbias = None
    if weight is not None:
        dweight, dbias = torch.empty_like(weight), torch.empty_like(weight)
    if x.numel() == 0:
        return dx, *(None if g is None else g.zero_()
                     for g in (dweight, dbias))
    samples, channels, length = x.shape[0], x.shape[1], _length(x)
    vector = _vector(x, grad, dx)
    chunk, chunks = plan(length, x.element_size(), vector)
    sums = torch.empty((samples * channels, chunks, 2), dtype=torch.float32,
                       device=x.device)
    library = kernels.library(NAME, _BACKWARD_SIGNATURE, BACKWARD_NAME)
    status = library.batch_norm_backward(
        x.data_ptr(), grad.data_ptr(), dx.data_ptr(), saved.data_ptr(),
        sums.data_ptr(), _pointer(weight), _pointer(dweight),
        _pointer(dbias), samples, channels,
        length, chunk, chunks, int(vector > 1), int(training),
        _DTYPE_CODES[x.dtype],
        _stream(x))
    kernels.check(NAME, status)
    kernels.launch_counts[BACKWARD_NAME] += 1
    return dx, dweight, dbias


class BatchNorm(torch.autograd.Function):
    """:func:`batch_norm` with a gradient; call ``BatchNorm.apply(x,
    weight, bias, running_mean, running_var, num_batches_tracked, training,
    momentum, eps)``.

    The forward makes :func:`batch_norm`'s launches (updating the running
    statistics in place, as nn.BatchNorm's does) and keeps ``x`` and each
    channel's ``(mean, rstd)``; the backward launches
    :func:`batch_norm_backward` (the plain versions for CPU tensors).
    """

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var,
                num_batches_tracked, training, momentum, eps):
        y, saved = _forward(x, weight, bias, running_mean, running_var,
                            num_batches_tracked, training, momentum, eps)
        ctx.save_for_backward(x, weight, saved)
        ctx.training = training
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        x, weight, saved = ctx.saved_tensors
        dx, dweight, dbias = batch_norm_backward(grad.contiguous(), x,
                                                 weight, saved, ctx.training)
        return dx, dweight, dbias, None, None, None, None, None, None


def batch_norm(x: torch.Tensor, weight: torch.Tensor | None,
               bias: torch.Tensor | None, running_mean: torch.Tensor | None,
               running_var: torch.Tensor | None,
               num_batches_tracked: torch.Tensor | None, training: bool,
               momentum: float = 0.1, eps: float = 1e-5) -> torch.Tensor:
    """BatchNorm of ``x`` over its batch and spatial dims, per channel.

    Args:
        x: ``[N, C, *spatial]`` float32 or bfloat16 (the plain version
            also float64), contiguous.
        weight, bias: the affine map, float32 ``[C]``, or both None.
        running_mean, running_var: float32 ``[C]``, updated in place in
            training mode (where given), used in eval mode.
        num_batches_tracked: one int64, plus one in training mode, or None.
        training: normalise by the batch's statistics (True) or the
            running ones.
        momentum: the running statistics' update factor.
        eps: added to the variance.

    Returns:
        ``x``'s shape and dtype: :func:`batch_norm_plain`'s ``y``. Where
        autograd records, through :class:`BatchNorm`.
    """
    arguments = (x, weight, bias, running_mean, running_var,
                 num_batches_tracked, training, momentum, eps)
    if torch.is_grad_enabled() and any(
            tensor is not None and tensor.requires_grad
            for tensor in (x, weight, bias)):
        return BatchNorm.apply(*arguments)
    return _forward(*arguments)[0]
