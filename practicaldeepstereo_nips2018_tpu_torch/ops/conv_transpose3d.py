"""K3 and K4: the hourglass's transposed 3-D convs, forward and input
gradient.

Port of ``practicaldeepstereo_nips2018_tpu/ops/folded_banded.py::
conv_transpose3d_folded_phased`` (the 4x4x4, stride-2, pad-1 upsamplers) and
``::anisotropic_fullsize_transpose_phased`` (the final (3, 4, 4), stride
(1, 2, 2), pad-1 upsampler), which compute the function of ``ops/folded3d.py::
conv_transpose3d_folded`` and ``::anisotropic_fullsize_transpose``. No
Pallas kernel lies behind them; the JAX package lets XLA lower them. The
phase decomposition is a fact about the conv, not about the TPU: output
``o`` takes input ``i`` through tap ``t = o + pad - stride * i``, so along a
stride-2, kernel-4 axis each output phase uses 2 of the 4 taps, and the
dilated form's zeros need not be multiplied. The depth-folded layout is the
TPU's and is not carried over: volumes are ``[B, C, D, H, W]``, weights
PyTorch's ``ConvTranspose3d`` layout ``[cin, cout, kd, 4, 4]``.

The CUDA source is ``csrc/conv_transpose3d.cu``: K3 gathers, for each
output, only the taps of its phase; K4, the input gradient, is the strided
conv of the output gradient by the same weights. Both accumulate in float32
and round once, deterministically (one thread sums one output in a fixed
order). :class:`ConvTranspose3dK3` gives the pair a gradient; its weight
gradient is PyTorch's, its bias gradient a float32 sum.

Only H and W kernel 4, stride 2 are taken on the card, with depth kernel 4,
stride 2 or kernel 3, stride 1: the hourglass's two geometries. Padding is
per axis (the volume axis widens the W padding to drop a halo's outputs).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from practicaldeepstereo_nips2018_tpu_torch.ops import kernels
from practicaldeepstereo_nips2018_tpu_torch.utils import profiling

SOURCE = "conv_transpose3d"
NAME = "conv_transpose3d"  # K3, the forward
INPUT_GRAD_NAME = "conv_transpose3d_input_grad"  # K4
_SPANS = {name: f"pds.kernel.{name}" for name in (NAME, INPUT_GRAD_NAME)}
# (depth kernel, depth stride) pairs the kernels take; H and W are 4, 2.
GEOMETRIES = ((4, 2), (3, 1))
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_FORWARD_SIGNATURE = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 12 + [
    ctypes.c_void_p]
_INPUT_GRAD_SIGNATURE = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 12 + [
    ctypes.c_void_p]


def output_shape(input_shape, weight_shape, stride, padding) -> tuple:
    """``[B, cout, Do, Ho, Wo]`` of the transposed conv of an input of
    ``input_shape`` by weights of ``weight_shape``: ``(n - 1) * s - 2p + k``
    per axis."""
    batch, _, *sizes = input_shape
    return (batch, weight_shape[1], *(
        (size - 1) * s - 2 * p + k
        for size, s, p, k in zip(sizes, stride, padding, weight_shape[2:])))


def _phase(kernel: int, stride: int, padding: int, size_in: int,
           size_out: int, phase: int) -> tuple:
    """Along one axis, the outputs ``o = stride * q + phase``: (first tap,
    number of taps, (left, right) input padding, number of outputs). Output
    ``q`` takes input ``q + offset - j`` through tap ``first + stride * j``;
    as a stride-1 correlation over the reversed taps it reads the input
    padded by ``taps - 1 - offset`` on the left (a negative pad crops)."""
    first = (phase + padding) % stride
    taps = -(-(kernel - first) // stride)
    offset = (phase + padding - first) // stride
    outputs = -(-(size_out - phase) // stride)
    left = taps - 1 - offset
    right = outputs + taps - 1 - size_in - left
    return first, taps, (left, right), outputs


def conv_transpose3d_plain(x: torch.Tensor, weight: torch.Tensor,
                           bias: torch.Tensor, stride, padding
                           ) -> torch.Tensor:
    """Plain PyTorch version of K3 in the phase form of the JAX functions:
    for each output phase one stride-1 correlation over that phase's taps,
    then the interleave, then the bias. Float32 arithmetic on the given
    values (float64 for float64 ``x``, which the kernel does not take),
    rounded once to ``x``'s dtype."""
    result_dtype = x.dtype
    dtype = torch.promote_types(x.dtype, torch.float32)
    x, weight = x.to(dtype), weight.to(dtype)
    y = x.new_empty(output_shape(x.shape, weight.shape, stride, padding))
    sizes_in, sizes_out = x.shape[2:], y.shape[2:]
    axes = [[_phase(weight.shape[2 + axis], stride[axis], padding[axis],
                    sizes_in[axis], sizes_out[axis], phase)
             for phase in range(stride[axis])] for axis in range(3)]
    for rd, depth in enumerate(axes[0]):
        for rh, height in enumerate(axes[1]):
            for rw, width in enumerate(axes[2]):
                if min(depth[3], height[3], width[3]) <= 0:
                    continue
                taps = weight[:, :, depth[0]::stride[0],
                              height[0]::stride[1], width[0]::stride[2]]
                taps = taps.flip(2, 3, 4).transpose(0, 1)
                padded = F.pad(x, (*width[2], *height[2], *depth[2]))
                y[:, :, rd::stride[0], rh::stride[1], rw::stride[2]] = (
                    F.conv3d(padded, taps))
    y = y + bias.to(dtype).view(1, -1, 1, 1, 1)
    return y.to(result_dtype)


def conv_transpose3d_input_grad_plain(grad_y: torch.Tensor,
                                      weight: torch.Tensor, stride,
                                      padding) -> torch.Tensor:
    """Plain PyTorch version of K4: the strided conv of ``grad_y`` by the
    transposed conv's own weights (``[cin, cout, ...]`` read as a conv's
    ``[out, in, ...]``), float32 arithmetic, rounded once to ``grad_y``'s
    dtype."""
    dtype = torch.promote_types(grad_y.dtype, torch.float32)
    return F.conv3d(grad_y.to(dtype), weight.to(dtype), None, stride,
                    padding).to(grad_y.dtype)


def check_arguments(name: str, a: torch.Tensor, weight: torch.Tensor,
                    stride, padding, tensors: dict) -> None:
    """Raises on what the kernels do not take: shapes, geometry, padding,
    dtypes, devices that differ, strides."""
    if a.ndim != 5 or weight.ndim != 5 or tuple(weight.shape[3:]) != (4, 4):
        raise ValueError(f"{name}: expected a [B, C, D, H, W] volume and "
                         f"[cin, cout, kd, 4, 4] weights, got "
                         f"{tuple(a.shape)} and {tuple(weight.shape)}")
    if ((weight.shape[2], stride[0]) not in GEOMETRIES
            or tuple(stride[1:]) != (2, 2)):
        raise ValueError(f"{name}: takes depth kernel and stride in "
                         f"{GEOMETRIES} and H, W stride 2, got kernel "
                         f"{tuple(weight.shape[2:])}, stride {tuple(stride)}")
    if min(padding) < 0:
        raise ValueError(f"{name}: negative padding {tuple(padding)}")
    if a.dtype not in _DTYPE_CODES or weight.dtype != a.dtype:
        raise TypeError(f"{name}: the volume and weight must share float32 "
                        f"or bfloat16, got {a.dtype} and {weight.dtype}")
    for label, tensor in tensors.items():
        if tensor.device != a.device:
            raise ValueError(f"{name}: {label} is on {tensor.device}, the "
                             f"volume on {a.device}")
        if not tensor.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")


def _launch(entry: str, signature: list, volume: torch.Tensor,
            weight: torch.Tensor, *arguments) -> None:
    """Launches ``entry`` on ``arguments`` under its kernel span, which
    records the shapes of ``volume`` (its input) and ``weight``."""
    with profiling.span(_SPANS[entry],
                        lambda: kernels.launch_args(volume, weight)):
        library = kernels.library(SOURCE, signature, entry)
        kernels.check(SOURCE, getattr(library, entry)(*arguments))
        kernels.launch_counts[entry] += 1


def conv_transpose3d(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, stride, padding) -> torch.Tensor:
    """Transposed 3-D convolution plus bias (K3).

    Args:
        x: ``[B, cin, D, H, W]`` float32 or bfloat16.
        weight: ``[cin, cout, kd, 4, 4]`` in ``x``'s dtype.
        bias: ``[cout]`` float32.
        stride: ``(sd, 2, 2)`` with ``(kd, sd)`` in :data:`GEOMETRIES`.
        padding: ``(pd, ph, pw)``, each >= 0.

    Returns:
        ``[B, cout, Do, Ho, Wo]`` in ``x``'s dtype, accumulated in float32.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises.
    """
    stride, padding = tuple(stride), tuple(padding)
    if x.device.type == "cpu":
        return conv_transpose3d_plain(x, weight, bias, stride, padding)
    if x.device.type != "cuda":
        raise ValueError(f"{NAME}: unsupported device {x.device}")
    check_arguments(NAME, x, weight, stride, padding,
           {"x": x, "weight": weight, "bias": bias})
    batch, cin, depth, height, width = x.shape
    cout = weight.shape[1]
    if weight.shape[0] != cin or tuple(bias.shape) != (cout,):
        raise ValueError(f"{NAME}: channel mismatch: x {tuple(x.shape)}, "
                         f"weight {tuple(weight.shape)}, bias "
                         f"{tuple(bias.shape)}")
    if bias.dtype != torch.float32:
        raise TypeError(f"{NAME}: bias must be float32, got {bias.dtype}")
    shape = output_shape(x.shape, weight.shape, stride, padding)
    if min(shape[2:]) <= 0 or shape[2] > 65535 or batch * cout > 65535:
        raise ValueError(f"{NAME}: output {shape} is empty or its grid too "
                         "large")
    y = torch.empty(shape, dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    _launch(NAME, _FORWARD_SIGNATURE, x, weight, x.data_ptr(),
            weight.data_ptr(), bias.data_ptr(), y.data_ptr(), batch, cin,
            cout, depth, height, width, weight.shape[2], stride[0], *padding,
            _DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    return y


def conv_transpose3d_input_grad(grad_y: torch.Tensor, weight: torch.Tensor,
                                stride, padding, input_shape
                                ) -> torch.Tensor:
    """The input gradient of :func:`conv_transpose3d` (K4): ``[B, cin, D, H,
    W]`` (``input_shape``) for the output gradient ``grad_y`` in the weight
    dtype, accumulated in float32. A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel or raises."""
    stride, padding = tuple(stride), tuple(padding)
    input_shape = tuple(input_shape)
    if grad_y.device.type == "cpu":
        grad_x = conv_transpose3d_input_grad_plain(grad_y, weight, stride,
                                                   padding)
    elif grad_y.device.type != "cuda":
        raise ValueError(f"{INPUT_GRAD_NAME}: unsupported device "
                         f"{grad_y.device}")
    else:
        check_arguments(INPUT_GRAD_NAME, grad_y, weight, stride, padding,
               {"grad_y": grad_y, "weight": weight})
        batch, cin, depth, height, width = input_shape
        if (tuple(grad_y.shape) != output_shape(input_shape, weight.shape,
                                                stride, padding)
                or weight.shape[0] != cin):
            raise ValueError(f"{INPUT_GRAD_NAME}: grad_y "
                             f"{tuple(grad_y.shape)} and weight "
                             f"{tuple(weight.shape)} do not fit an input of "
                             f"{input_shape}")
        if depth > 65535 or batch * cin > 65535:
            raise ValueError(f"{INPUT_GRAD_NAME}: grid too large for "
                             f"{input_shape}")
        grad_x = torch.empty(input_shape, dtype=grad_y.dtype,
                             device=grad_y.device)
        if grad_x.numel() == 0:
            return grad_x
        _launch(INPUT_GRAD_NAME, _INPUT_GRAD_SIGNATURE, grad_y, weight,
                grad_y.data_ptr(), weight.data_ptr(), grad_x.data_ptr(),
                batch, cin, weight.shape[1], depth, height, width,
                weight.shape[2], stride[0], *padding,
                _DTYPE_CODES[grad_y.dtype],
                torch.cuda.current_stream(grad_y.device).cuda_stream)
    if tuple(grad_x.shape) != input_shape:
        raise ValueError(f"{INPUT_GRAD_NAME}: gradient {tuple(grad_x.shape)} "
                         f"for an input of {input_shape}")
    return grad_x


class ConvTranspose3dK3(torch.autograd.Function):
    """:func:`conv_transpose3d` with a gradient; call
    ``ConvTranspose3dK3.apply(x, weight, bias, stride, padding)``.

    The forward launches K3 and the input gradient K4 (the plain versions for
    CPU tensors); the weight gradient, in ``x``'s dtype, is PyTorch's
    (``convolution_backward`` with only the weight mask), the bias gradient a
    sum of the output gradient over everything but channels in the bias's
    dtype (float32).
    """

    @staticmethod
    def forward(ctx, x, weight, bias, stride, padding):
        x = x.contiguous()
        ctx.save_for_backward(x, weight)
        ctx.bias_dtype = bias.dtype
        ctx.stride, ctx.padding = tuple(stride), tuple(padding)
        return conv_transpose3d(x, weight, bias, stride, padding)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_output):
        x, weight = ctx.saved_tensors
        grad_output = grad_output.contiguous()  # K4 takes no strides
        grad_x = grad_weight = grad_bias = None
        if ctx.needs_input_grad[0]:
            grad_x = conv_transpose3d_input_grad(
                grad_output, weight, ctx.stride, ctx.padding, x.shape)
        if ctx.needs_input_grad[1]:
            grad_weight = torch.ops.aten.convolution_backward(
                grad_output, x, weight, None, list(ctx.stride),
                list(ctx.padding), [1, 1, 1], True, [0, 0, 0], 1,
                [False, True, False])[1]
        if ctx.needs_input_grad[2]:
            grad_bias = grad_output.to(ctx.bias_dtype).sum(dim=(0, 2, 3, 4))
        return grad_x, grad_weight, grad_bias, None, None
