"""K5: the tail of a conv block, LeakyReLU, instance norm and residual add.

Replaces no TPU kernel: the JAX package left the instance norm
(``practicaldeepstereo_nips2018_tpu/models/blocks.py::instance_norm``) and
the activation and residual add around it to XLA. In PyTorch the
composition of ``models/blocks.py`` takes ~14 launches per norm; the CUDA
source ``csrc/block_norm.cu`` computes the same function, with the same
rounding points, in two launches over ``(row, chunk)`` blocks: the chunks'
moments, then the merged moments and the output. Its gradient
(:func:`block_norm_backward`, counted and spanned as
``block_norm_backward``) takes three launches over the same grid, from the
forward's partials: the chunks' sums of ``dy`` and ``dy * x_hat``, then the
input gradient, then the affine map's gradient. Both are bound by memory
bytes; the source says what their design does about that.

``models/blocks.py::runs_block_norm`` decides where it runs: on CUDA
tensors, over the whole width. Where autograd records, the call goes
through :class:`BlockNorm`, which keeps ``x`` and the forward's partials
for the backward; elsewhere it is the direct :func:`block_norm` call.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from practicaldeepstereo_nips2018_tpu_torch.ops import kernels
from practicaldeepstereo_nips2018_tpu_torch.utils import profiling

NAME = "block_norm"
BACKWARD_NAME = "block_norm_backward"
SPAN, BACKWARD_SPAN = f"pds.kernel.{NAME}", f"pds.kernel.{BACKWARD_NAME}"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURE = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 2
              + [ctypes.c_int] * 4 + [ctypes.c_float] * 2
              + [ctypes.c_int, ctypes.c_void_p])
_BACKWARD_SIGNATURE = ([ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 2
                       + [ctypes.c_int] * 4 + [ctypes.c_float] * 2
                       + [ctypes.c_int, ctypes.c_void_p])
# The kernels' block: 256 threads holding 128 bytes of a tensor each, so a
# chunk holds at most 32 KB of elements.
THREADS, BYTES_PER_THREAD = 256, 128


def block_norm_plain(x: torch.Tensor, weight: torch.Tensor | None = None,
                     bias: torch.Tensor | None = None,
                     negative_slope: float | None = 0.1,
                     residual: torch.Tensor | None = None,
                     eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``LeakyReLU(negative_slope)``
    (none for None) in ``x``'s dtype; the per-(sample, channel) norm over
    the dims after the second, biased variance, moments and the affine map
    ``weight``, ``bias`` (or none) in float32 (float64 for float64 ``x``,
    which the kernel does not take), rounded to ``x``'s dtype; then plus
    ``residual`` in that dtype."""
    if negative_slope is not None:
        x = F.leaky_relu(x, negative_slope)
    x32 = x.to(torch.promote_types(x.dtype, torch.float32))
    variance, mean = torch.var_mean(x32, dim=tuple(range(2, x.ndim)),
                                    correction=0, keepdim=True)
    scale = torch.rsqrt(variance + eps)
    offset = -mean * scale
    if weight is not None:
        shape = (1, -1) + (1,) * (x.ndim - 2)
        weight, bias = weight.to(x32.dtype), bias.to(x32.dtype)
        scale = scale * weight.view(shape)
        offset = offset * weight.view(shape) + bias.view(shape)
    y = (x32 * scale + offset).to(x.dtype)
    return y if residual is None else y + residual


def _normalized(grad: torch.Tensor, x: torch.Tensor,
                negative_slope: float | None, eps: float) -> tuple:
    """``(a, rstd, x_hat, dy, dims)`` of the backward: ``a`` the LeakyReLU
    of ``x`` in ``x``'s dtype (rounded as the kernels round it), then in
    float32, or float64 where ``grad`` or ``x`` is float64; each row's
    ``rstd`` and ``x_hat = (a - mean) * rstd`` over the dims after the
    second; ``dy`` the output gradient in that dtype."""
    a = x if negative_slope is None else F.leaky_relu(x, negative_slope)
    a = a.to(torch.promote_types(torch.promote_types(x.dtype, grad.dtype),
                                 torch.float32))
    dims = tuple(range(2, x.ndim))
    variance, mean = torch.var_mean(a, dim=dims, correction=0, keepdim=True)
    rstd = torch.rsqrt(variance + eps)
    return a, rstd, (a - mean) * rstd, grad.to(a.dtype), dims


def _row_scale(weight, rstd, dims):
    """``rstd`` times the affine map's ``weight`` (none for None)."""
    if weight is None:
        return rstd
    return rstd * weight.to(rstd.dtype).view((1, -1) + (1,) * len(dims))


def block_norm_backward_plain(grad: torch.Tensor, x: torch.Tensor,
                              weight: torch.Tensor | None = None,
                              negative_slope: float | None = 0.1,
                              eps: float = 1e-5):
    """Plain PyTorch version of the backward kernels: the gradients of
    :func:`block_norm_plain` at ``x`` for the output gradient ``grad``, in
    float32 (float64 where ``grad`` or ``x`` is float64): with ``a`` the
    LeakyReLU of ``x`` in ``x``'s dtype, ``x_hat = (a - mean) * rstd`` over
    a row,

        dx = leaky'(x) * rstd * gamma * (dy - mean(dy) - x_hat * mean(dy *
        x_hat))

    rounded once to the wider of ``grad``'s and ``x``'s dtypes (``leaky'``
    1 where ``x > 0``, else the slope), and the affine map's ``(sum(dy *
    x_hat), sum(dy))`` over each channel's rows in ``weight``'s dtype, or
    ``(None, None)`` without one. A float64 ``grad`` and ``weight`` give
    the exact gradients of the kernels' rounded LeakyReLU. The residual's
    gradient is ``grad`` itself."""
    a, rstd, x_hat, dy, dims = _normalized(grad, x, negative_slope, eps)
    dy_sum = dy.sum(dim=dims, keepdim=True)
    product_sum = (dy * x_hat).sum(dim=dims, keepdim=True)
    length = a[0, 0].numel()
    dx = _row_scale(weight, rstd, dims) * (
        dy - dy_sum / length - x_hat * (product_sum / length))
    if negative_slope is not None:
        dx = torch.where(x > 0, dx, dx * negative_slope)
    dx = dx.to(torch.promote_types(x.dtype, grad.dtype))
    if weight is None:
        return dx, None, None
    return (dx, product_sum.sum(dim=0).flatten().to(weight.dtype),
            dy_sum.sum(dim=0).flatten().to(weight.dtype))


def block_norm_backward_scale(grad: torch.Tensor, x: torch.Tensor,
                              weight: torch.Tensor | None = None,
                              negative_slope: float | None = 0.1,
                              eps: float = 1e-5) -> torch.Tensor:
    """The magnitude of the terms that :func:`block_norm_backward_plain`'s
    ``dx`` sums, element by element, in float64: ``rstd * |gamma| * (|dy|
    + mean|dy| + |x_hat| * mean|dy * x_hat|)``. A float32 computation of
    ``dx`` errs by a few float32 roundings of it."""
    _, rstd, x_hat, dy, dims = _normalized(grad.double(), x, negative_slope,
                                           eps)
    scale = _row_scale(None if weight is None else weight.abs(), rstd, dims)
    return scale * (dy.abs() + dy.abs().mean(dims, keepdim=True)
                    + x_hat.abs() * (dy * x_hat).abs().mean(dims,
                                                             keepdim=True))


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


def block_norm(x: torch.Tensor, weight: torch.Tensor | None = None,
               bias: torch.Tensor | None = None,
               negative_slope: float | None = 0.1,
               residual: torch.Tensor | None = None,
               eps: float = 1e-5) -> torch.Tensor:
    """LeakyReLU, instance norm and residual add of a conv block.

    Args:
        x: ``[N, C, *spatial]`` float32 or bfloat16, contiguous.
        weight, bias: the norm's affine map, float32 ``[C]``, or both None.
        negative_slope: the LeakyReLU's slope, or None for none.
        residual: added after the norm, ``x``'s shape and dtype, or None.
        eps: added to the variance.

    Returns:
        ``x``'s shape and dtype: :func:`block_norm_plain`'s function.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises.
    """
    return _forward(x, weight, bias, negative_slope, residual, eps)[0]


def _forward(x, weight, bias, negative_slope, residual, eps):
    """:func:`block_norm`'s output, and what its backward reads again of
    pass 1: ``(partials, chunk)``, the ``[rows, chunks, 2]`` float32
    (mean, M2) of each chunk and the chunk length; None on the CPU."""
    if x.device.type == "cpu":
        return block_norm_plain(x, weight, bias, negative_slope, residual,
                                eps), None
    if x.device.type != "cuda":
        raise ValueError(f"{NAME}: unsupported device {x.device}")
    with profiling.span(SPAN, lambda: kernels.launch_args(x, weight)):
        return _launch(x, weight, bias, negative_slope, residual, eps)


def _launch(x, weight, bias, negative_slope, residual, eps):
    """:func:`_forward` on CUDA tensors: the checks, the scratch and the
    launches."""
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{NAME}: x must be float32 or bfloat16, got "
                        f"{x.dtype}")
    if x.ndim < 3:
        raise ValueError(f"{NAME}: expected x [N, C, *spatial], got "
                         f"{tuple(x.shape)}")
    if (weight is None) != (bias is None):
        raise ValueError(f"{NAME}: weight and bias go together")
    channels = x.shape[1]
    tensors = {"x": x}
    if weight is not None:
        for name, tensor in (("weight", weight), ("bias", bias)):
            if tensor.dtype != torch.float32 or tuple(tensor.shape) != (
                    channels,):
                raise ValueError(f"{NAME}: {name} must be float32 "
                                 f"[{channels}], got {tensor.dtype} "
                                 f"{tuple(tensor.shape)}")
            tensors[name] = tensor
    if residual is not None:
        if residual.shape != x.shape or residual.dtype != x.dtype:
            raise ValueError(f"{NAME}: residual {tuple(residual.shape)} "
                             f"{residual.dtype}, x {tuple(x.shape)} "
                             f"{x.dtype}")
        tensors["residual"] = residual
    for name, tensor in tensors.items():
        if tensor.device != x.device:
            raise ValueError(f"{NAME}: {name} is on {tensor.device}, x on "
                             f"{x.device}")
        if not tensor.is_contiguous():
            raise ValueError(f"{NAME}: {name} must be contiguous")
    out = torch.empty_like(x)
    rows = x.shape[0] * channels
    length = x.numel() // rows if rows else 0
    if out.numel() == 0:
        return out, None
    vector = 16 // x.element_size()
    streams = [x, out] + ([] if residual is None else [residual])
    aligned = length % vector == 0 and all(
        tensor.data_ptr() % 16 == 0 for tensor in streams)
    chunk, chunks = plan(length, x.element_size(), vector if aligned else 1)
    if rows * chunks > 2 ** 31 - 1:
        raise ValueError(f"{NAME}: {rows} rows of {chunks} chunks exceed "
                         "the grid")
    partials = torch.empty((rows, chunks, 2), dtype=torch.float32,
                           device=x.device)
    library = kernels.library(NAME, _SIGNATURE)
    status = library.block_norm(
        x.data_ptr(), None if residual is None else residual.data_ptr(),
        out.data_ptr(), partials.data_ptr(),
        None if weight is None else weight.data_ptr(),
        None if bias is None else bias.data_ptr(), rows, length, channels,
        chunk, chunks, int(aligned),
        1.0 if negative_slope is None else negative_slope, eps,
        _DTYPE_CODES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(NAME, status)
    kernels.launch_counts[NAME] += 1
    return out, (partials, chunk)


def block_norm_backward(grad: torch.Tensor, x: torch.Tensor,
                        weight: torch.Tensor | None,
                        negative_slope: float | None, eps: float,
                        moments=None):
    """The gradients of :func:`block_norm` at ``x`` for the output gradient
    ``grad`` (``x``'s shape and dtype, contiguous): ``(dx, dweight,
    dbias)``, the last two None without an affine map, as
    :func:`block_norm_backward_plain` computes them. ``moments`` is what
    :func:`_forward` returned beside the output. A CPU tensor takes the
    plain version; a CUDA tensor launches the kernels or raises."""
    if x.device.type == "cpu":
        return block_norm_backward_plain(grad, x, weight, negative_slope,
                                         eps)
    if x.device.type != "cuda":
        raise ValueError(f"{BACKWARD_NAME}: unsupported device {x.device}")
    with profiling.span(BACKWARD_SPAN,
                        lambda: kernels.launch_args(x, weight)):
        return _launch_backward(grad, x, weight, negative_slope, eps,
                                moments)


def _launch_backward(grad, x, weight, negative_slope, eps, moments):
    """:func:`block_norm_backward` on CUDA tensors: the checks, the
    outputs, the scratch and the launches."""
    if grad.shape != x.shape or grad.dtype != x.dtype:
        raise ValueError(f"{BACKWARD_NAME}: gradient {tuple(grad.shape)} "
                         f"{grad.dtype}, x {tuple(x.shape)} {x.dtype}")
    for name, tensor in (("grad", grad), ("x", x)):
        if not tensor.is_contiguous():
            raise ValueError(f"{BACKWARD_NAME}: {name} must be contiguous")
    if grad.device != x.device:
        raise ValueError(f"{BACKWARD_NAME}: grad is on {grad.device}, x on "
                         f"{x.device}")
    dx = torch.empty_like(x)
    dweight = dbias = None
    if weight is not None:
        dweight, dbias = torch.empty_like(weight), torch.empty_like(weight)
    if x.numel() == 0:
        return dx, *(None if g is None else g.zero_()
                     for g in (dweight, dbias))
    partials, chunk = moments
    rows, chunks = partials.shape[:2]
    length = x.numel() // rows
    vector = 16 // x.element_size()
    aligned = length % vector == 0 and all(
        tensor.data_ptr() % 16 == 0 for tensor in (x, grad, dx))
    sums = torch.empty((rows, chunks, 2), dtype=torch.float32,
                       device=x.device)
    library = kernels.library(NAME, _BACKWARD_SIGNATURE, BACKWARD_NAME)
    status = library.block_norm_backward(
        x.data_ptr(), grad.data_ptr(), dx.data_ptr(), partials.data_ptr(),
        sums.data_ptr(), None if weight is None else weight.data_ptr(),
        None if dweight is None else dweight.data_ptr(),
        None if dbias is None else dbias.data_ptr(), rows, length,
        x.shape[1], chunk, chunks, int(aligned),
        1.0 if negative_slope is None else negative_slope, eps,
        _DTYPE_CODES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(NAME, status)
    kernels.launch_counts[BACKWARD_NAME] += 1
    return dx, dweight, dbias


class BlockNorm(torch.autograd.Function):
    """:func:`block_norm` with a gradient; call ``BlockNorm.apply(x,
    weight, bias, negative_slope, residual, eps)``.

    The forward makes :func:`block_norm`'s launches and keeps ``x`` and
    pass 1's partials; the backward launches :func:`block_norm_backward`
    (the plain versions for CPU tensors). The residual's gradient is the
    output's gradient itself, not a copy.
    """

    @staticmethod
    def forward(ctx, x, weight, bias, negative_slope, residual, eps):
        y, moments = _forward(x, weight, bias, negative_slope, residual, eps)
        partials, ctx.chunk = (None, None) if moments is None else moments
        ctx.save_for_backward(x, weight, partials)
        ctx.negative_slope, ctx.eps = negative_slope, eps
        ctx.has_residual = residual is not None
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        x, weight, partials = ctx.saved_tensors
        grad = grad.contiguous()
        dx, dweight, dbias = block_norm_backward(
            grad, x, weight, ctx.negative_slope, ctx.eps,
            None if partials is None else (partials, ctx.chunk))
        return (dx, dweight, dbias, None,
                grad if ctx.has_residual else None, None)
