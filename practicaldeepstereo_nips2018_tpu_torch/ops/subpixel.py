"""K2: the sub-pixel MAP disparity estimator.

Port of ``practicaldeepstereo_nips2018_tpu/ops/subpixel.py::subpixel_map``
(plain version, :func:`subpixel_map_plain`) and of the TPU kernel
``ops/subpixel_pallas.py::_estimator_kernel`` (CUDA source
``csrc/subpixel_map.cu``). At each pixel: the first index of the maximum
similarity, a masked softmax over the ``±half_support_window /
disparity_step`` indices around it, and the mean disparity
``disparity_step * index`` under that softmax (reference
``estimator.py:10-91``). Goldens: [0.1, 0.4, 0.3, 0.2, 0.3] gives 1.52 with
step 1 and 2.124 with step 2, both with window 2.
"""

from __future__ import annotations

import ctypes

import torch

from practicaldeepstereo_nips2018_tpu_torch.ops import kernels
from practicaldeepstereo_nips2018_tpu_torch.utils import profiling

NAME = "subpixel_map"
SPAN = f"pds.kernel.{NAME}"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURE = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 2
              + [ctypes.c_int] + [ctypes.c_longlong] * 3
              + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def _validate(half_support_window: int, disparity_step: int) -> None:
    if disparity_step < 1:
        raise ValueError('"disparity_step" should be a positive integer.')
    if half_support_window < 1:
        raise ValueError('"half_support_window" should be a positive integer.')
    if half_support_window % disparity_step != 0:
        raise ValueError('"half_support_window" should be a multiple of '
                         '"disparity_step".')


def subpixel_map_plain(similarities: torch.Tensor,
                       half_support_window: int = 4,
                       disparity_step: int = 2) -> torch.Tensor:
    """Plain PyTorch version: ``[..., D]`` scores -> ``[...]`` float32
    disparities, computed in float32.

    The mean index is taken as ``best + mean(i - best)``, as the kernel
    does: the offsets are small integers, so the sums do not round the
    large disparity values. (The JAX package sums ``step * i`` directly;
    the two agree to a few float32 ulps of the disparity.)
    """
    _validate(half_support_window, disparity_step)
    scores = similarities.float()
    half_taps = half_support_window // disparity_step
    best = scores.argmax(dim=-1, keepdim=True)  # first occurrence
    maximum = scores.gather(-1, best)
    offset = torch.arange(scores.shape[-1], device=scores.device) - best
    weights = torch.where(offset.abs() <= half_taps,
                          torch.exp(scores - maximum),
                          torch.zeros((), device=scores.device))
    mean_offset = (weights * offset).sum(dim=-1) / weights.sum(dim=-1)
    return disparity_step * (best[..., 0] + mean_offset)


def _pixel_layout(similarities: torch.Tensor):
    """(outer, inner, outer_stride, inner_stride) such that pixel
    ``o * inner + i`` of the leading dims starts at
    ``o * outer_stride + i * inner_stride``; None if the leading dims do
    not collapse that way."""
    dims = [(size, stride) for size, stride in
            zip(similarities.shape[:-1], similarities.stride()[:-1])
            if size != 1]
    if not dims:
        return 1, 1, 0, 0
    # Merge dims into the inner block from the right while they nest.
    split = len(dims) - 1
    while split > 0 and dims[split - 1][1] == dims[split][0] * dims[split][1]:
        split -= 1
    inner = 1
    for size, _ in dims[split:]:
        inner *= size
    if split == 0:
        return 1, inner, 0, dims[-1][1]
    if split == 1:
        return dims[0][0], inner, dims[0][1], dims[-1][1]
    return None


def subpixel_map(similarities: torch.Tensor,
                 half_support_window: int = 4,
                 disparity_step: int = 2) -> torch.Tensor:
    """Sub-pixel MAP disparities: ``[..., D]`` scores -> ``[...]`` float32.

    Scores may be float32 or bfloat16 and are read in float32. A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel or raises.
    Besides contiguous tensors the kernel takes ``[B, H, W, D]`` views of
    disparity-major ``[B, D, H, W]`` tensors, the hourglass's output,
    without a copy.
    """
    _validate(half_support_window, disparity_step)
    if similarities.device.type == "cpu":
        return subpixel_map_plain(similarities, half_support_window,
                                  disparity_step)
    if similarities.device.type != "cuda":
        raise ValueError(f"{NAME}: unsupported device {similarities.device}")
    with profiling.span(SPAN, lambda: kernels.launch_args(similarities)):
        return _launch(similarities, half_support_window, disparity_step)


def _launch(similarities: torch.Tensor, half_support_window: int,
            disparity_step: int) -> torch.Tensor:
    """:func:`subpixel_map` on a CUDA tensor: the checks and the launch."""
    if similarities.dtype not in _DTYPE_CODES:
        raise TypeError(f"{NAME}: scores must be float32 or bfloat16, got "
                        f"{similarities.dtype}")
    if similarities.ndim < 1 or similarities.shape[-1] < 1:
        raise ValueError(f"{NAME}: expected [..., D] scores with D >= 1, got "
                         f"{tuple(similarities.shape)}")
    layout = _pixel_layout(similarities)
    if layout is None:
        raise ValueError(f"{NAME}: unsupported strides "
                         f"{similarities.stride()} for shape "
                         f"{tuple(similarities.shape)}; pass a contiguous "
                         "tensor")
    outer, inner, outer_stride, inner_stride = layout
    out = torch.empty(similarities.shape[:-1], dtype=torch.float32,
                      device=similarities.device)
    if out.numel() == 0:
        return out
    library = kernels.library(NAME, _SIGNATURE)
    status = library.subpixel_map(
        similarities.data_ptr(), out.data_ptr(), outer, inner,
        similarities.shape[-1], outer_stride, inner_stride,
        similarities.stride(-1), half_support_window // disparity_step,
        disparity_step, _DTYPE_CODES[similarities.dtype],
        torch.cuda.current_stream(similarities.device).cuda_stream)
    kernels.check(NAME, status)
    kernels.launch_counts[NAME] += 1
    return out
