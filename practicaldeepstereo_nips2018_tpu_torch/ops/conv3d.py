"""K1: the stride-1 3x3x3 convolution of the hourglass.

Port of the TPU kernel ``practicaldeepstereo_nips2018_tpu/ops/
folded_banded.py::_slab_kernel`` (called by ``conv3d_folded_pallas``), which
the JAX package runs for the hourglass's nine stride-1 3x3x3 convs under
``folded_conv_impl="banded_pallas"``. It computes the conv of
``folded3d.conv3d_folded``; the depth-folded layout and the 256-lane banded
slab belong to the TPU's matrix unit and are not carried over. The CUDA
source is ``csrc/conv3d_k3s1.cu``: in bfloat16 an implicit GEMM on the
tensor cores (M = output voxels, N = cout, K = 27 * cin in the tap-major
order of :func:`tap_major_weight`); in float32 a direct conv on the CUDA
cores in exact float32.

:class:`Conv3dK3S1` gives K1 a gradient, which the TPU kernel does not have
(the JAX package trains through XLA's conv instead). The input gradient of
a stride-1, pad-1 3x3x3 conv is the same conv of the output gradient with
the weights flipped in space and transposed in channels, so it runs on K1
itself; every hourglass smooth has cin = cout, so it does so at the shapes
and tiles of the forward. The weight gradient is PyTorch's conv weight
gradient and the bias gradient a float32 sum.

The JAX kernel is wrong at cin = 128 (its slab guard checks
``group_depths * cin`` where the slab needs ``slab_depths * cin`` lanes, so
it drops the +1 depth tap). This port computes the true conv at every
channel count; ``tests/test_torch_conv3d.py`` records the divergence.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from practicaldeepstereo_nips2018_tpu_torch.ops import kernels
from practicaldeepstereo_nips2018_tpu_torch.utils import profiling

NAME = "conv3d_k3s1"
SPAN = f"pds.kernel.{NAME}"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURE = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def conv3d_k3s1_plain(x: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same function, float32
    arithmetic on the given values (float64 for float64 ``x``, which the
    kernel does not take), output in ``x``'s dtype."""
    dtype = torch.promote_types(x.dtype, torch.float32)
    out = F.conv3d(x.to(dtype), weight.to(dtype), bias.to(dtype), padding=1)
    return out.to(x.dtype)


def tap_major_weight(weight: torch.Tensor,
                     input_gradient: bool = False) -> torch.Tensor:
    """``[cout, cin, 3, 3, 3]`` -> ``[cout, 27 * cin]``, element
    ``tap * cin + ci`` with ``tap = kd * 9 + kh * 3 + kw``: the K order of
    the kernel's implicit GEMM, in which one tap's channels are contiguous.

    With ``input_gradient``, the same layout of the weights flipped in space
    and transposed in channels: ``[cin, 27 * cout]``, element
    ``tap * cout + co`` = ``weight[co, ci]`` at tap ``26 - tap`` (flipping
    all three spatial axes reverses the tap order). Plain data movement,
    one copy, done before the launch."""
    cout, cin = weight.shape[:2]
    if not input_gradient:
        return weight.permute(0, 2, 3, 4, 1).reshape(cout, 27 * cin
                                                     ).contiguous()
    reversed_taps = torch.arange(26, -1, -1, device=weight.device)
    return weight.reshape(cout, cin, 27).permute(1, 2, 0).index_select(
        1, reversed_taps).reshape(cin, 27 * cout)


def conv3d_k3s1(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                input_gradient: bool = False) -> torch.Tensor:
    """3x3x3 convolution, stride 1, zero padding 1, plus bias.

    Args:
        x: ``[B, cin, D, H, W]`` float32 or bfloat16.
        weight: ``[cout, cin, 3, 3, 3]`` in ``x``'s dtype.
        bias: ``[cout]`` float32.
        input_gradient: convolve with ``weight`` flipped in space and
            transposed in channels (``x`` then has ``cout`` channels, the
            result ``cin``): the input gradient of the conv by ``weight``
            for the output gradient ``x``, when ``bias`` is zero.

    Returns:
        ``[B, cout, D, H, W]`` in ``x``'s dtype, accumulated in float32.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises.
    """
    if x.device.type == "cpu":
        if input_gradient:
            weight = weight.flip(2, 3, 4).transpose(0, 1)
        return conv3d_k3s1_plain(x, weight, bias)
    if x.device.type != "cuda":
        raise ValueError(f"{NAME}: unsupported device {x.device}")
    with profiling.span(SPAN, lambda: kernels.launch_args(x, weight)):
        return _launch(x, weight, bias, input_gradient)


def _launch(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
            input_gradient: bool) -> torch.Tensor:
    """:func:`conv3d_k3s1` on CUDA tensors: the checks, the weight's
    tap-major copy and the launch."""
    if x.ndim != 5 or weight.ndim != 5 or tuple(weight.shape[2:]) != (3, 3, 3):
        raise ValueError(f"{NAME}: expected x [B, C, D, H, W] and weight "
                         f"[cout, cin, 3, 3, 3], got {tuple(x.shape)} and "
                         f"{tuple(weight.shape)}")
    batch, cin, depth, height, width = x.shape
    cout, weight_cin = weight.shape[:2]
    if input_gradient:
        cout, weight_cin = weight_cin, cout
    if weight_cin != cin or tuple(bias.shape) != (cout,):
        raise ValueError(f"{NAME}: channel mismatch: x {tuple(x.shape)}, "
                         f"weight {tuple(weight.shape)}, bias "
                         f"{tuple(bias.shape)}")
    if x.dtype not in _DTYPE_CODES or weight.dtype != x.dtype:
        raise TypeError(f"{NAME}: x and weight must share float32 or "
                        f"bfloat16, got {x.dtype} and {weight.dtype}")
    if bias.dtype != torch.float32:
        raise TypeError(f"{NAME}: bias must be float32, got {bias.dtype}")
    for name, tensor in (("x", x), ("weight", weight), ("bias", bias)):
        if tensor.device != x.device:
            raise ValueError(f"{NAME}: {name} is on {tensor.device}, x on "
                             f"{x.device}")
        if not tensor.is_contiguous():
            raise ValueError(f"{NAME}: {name} must be contiguous")
    if depth > 65535 or batch * cout > 65535:
        raise ValueError(f"{NAME}: grid too large for D={depth}, "
                         f"B*cout={batch * cout}")
    y = torch.empty((batch, cout, depth, height, width), dtype=x.dtype,
                    device=x.device)
    if y.numel() == 0:
        return y
    taps = tap_major_weight(weight, input_gradient)
    library = kernels.library(NAME, _SIGNATURE)
    status = library.conv3d_k3s1(
        x.data_ptr(), taps.data_ptr(), bias.data_ptr(), y.data_ptr(),
        batch, cin, cout, depth, height, width, _DTYPE_CODES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(NAME, status)
    kernels.launch_counts[NAME] += 1
    return y


class Conv3dK3S1(torch.autograd.Function):
    """:func:`conv3d_k3s1` with a gradient; call ``Conv3dK3S1.apply(x,
    weight, bias)``.

    Forward and input gradient launch K1 (the plain version for CPU
    tensors); the weight gradient, in ``x``'s dtype, is PyTorch's conv
    weight gradient, the bias gradient a sum of the output gradient over
    everything but channels in the bias's dtype (float32).
    """

    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        ctx.bias_dtype = bias.dtype
        return conv3d_k3s1(x, weight, bias)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_output):
        x, weight = ctx.saved_tensors
        grad_output = grad_output.contiguous()  # K1 takes no strides
        grad_x = grad_weight = grad_bias = None
        if ctx.needs_input_grad[0]:
            grad_x = conv3d_k3s1(
                grad_output, weight,
                torch.zeros(weight.shape[1], dtype=ctx.bias_dtype,
                            device=weight.device), input_gradient=True)
        if ctx.needs_input_grad[1]:
            grad_weight = torch.nn.grad.conv3d_weight(
                x, weight.shape, grad_output, padding=1)
        if ctx.needs_input_grad[2]:
            grad_bias = grad_output.to(ctx.bias_dtype).sum(dim=(0, 2, 3, 4))
        return grad_x, grad_weight, grad_bias
