"""K5: the tail of a conv block, LeakyReLU, instance norm and residual add.

Replaces no TPU kernel: the JAX package left the instance norm
(``practicaldeepstereo_nips2018_tpu/models/blocks.py::instance_norm``) and
the activation and residual add around it to XLA. In PyTorch the
composition of ``models/blocks.py`` takes ~14 launches per norm; the CUDA
source ``csrc/block_norm.cu`` computes the same function, with the same
rounding points, in two launches over ``(row, chunk)`` blocks: the chunks'
moments, then the merged moments and the output. It is bound by memory
bytes; the source says what its design does about that.

``models/blocks.py::runs_block_norm`` decides where it runs: on CUDA
tensors, over the whole width, where autograd records nothing (K5 has no
backward).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from practicaldeepstereo_nips2018_tpu_torch.ops import kernels
from practicaldeepstereo_nips2018_tpu_torch.utils import profiling

NAME = "block_norm"
SPAN = f"pds.kernel.{NAME}"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURE = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 2
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
    if x.device.type == "cpu":
        return block_norm_plain(x, weight, bias, negative_slope, residual,
                                eps)
    if x.device.type != "cuda":
        raise ValueError(f"{NAME}: unsupported device {x.device}")
    with profiling.span(SPAN, lambda: kernels.launch_args(x, weight)):
        return _launch(x, weight, bias, negative_slope, residual, eps)


def _launch(x, weight, bias, negative_slope, residual, eps) -> torch.Tensor:
    """:func:`block_norm` on CUDA tensors: the checks, the scratch and the
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
        return out
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
    return out
