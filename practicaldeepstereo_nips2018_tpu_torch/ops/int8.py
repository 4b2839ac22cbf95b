"""int8 execution of the matching tail's 3x3 convs (inference only).

Port of ``practicaldeepstereo_nips2018_tpu/models/matching.py::
_quantized_conv``. Quantization is symmetric:

* weights: one scale per output channel, ``max |w| / 127``;
* activations: one dynamic scale, ``max |x| / 127``, per DISPARITY PAIR of
  one example. The JAX package runs the tail on disparity pairs (two
  disparities side by side in its 128-wide lanes) and takes one max per
  pair; the port runs one disparity per batch entry, so it takes the max
  over entries ``(2p, 2p + 1)``, which keeps its numbers those of the JAX
  package and keeps the examples of a batch independent;
* the conv multiplies int8 by int8 and sums in int32; the scales and the
  bias are applied in float32, then the result is cast back to the
  activation dtype (the JAX package's order of operations).

The conv is an im2col (9 taps x cin, channels last) into ``torch._int_mm``,
PyTorch's int8 GEMM with int32 output, which reaches the card's int8 tensor
cores through cuBLASLt and runs exactly on the CPU. The JAX package left
this conv to XLA, not to a Pallas kernel, so it is a library call here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

LEVELS = 127.0
_TINY = 1e-30  # keeps an all-zero tensor's scale away from 0


def quantize_weight(weight: torch.Tensor):
    """``[cout, cin, 3, 3]`` -> (int8 weight, float32 scale ``[cout]``)."""
    scale = weight.abs().amax(dim=(1, 2, 3)).float() / LEVELS + _TINY
    quantized = torch.round(weight.float() / scale[:, None, None, None])
    return quantized.to(torch.int8), scale


def quantize_activation(x: torch.Tensor):
    """``[N, C, H, W]`` contiguous, entries in disparity pairs (N even) ->
    (int8 activation, float32 scale ``[N]``, one value per pair)."""
    entries = x.shape[0]
    if entries % 2:
        raise ValueError(f"int8 activation scales are per disparity pair; "
                         f"got {entries} batch entries")
    pair_max = x.abs().reshape(entries // 2, -1).amax(dim=1)
    scale = (pair_max.float() / LEVELS + _TINY)[:, None].expand(
        -1, 2).reshape(entries)
    quantized = torch.round(x.float() / scale[:, None, None, None])
    return quantized.to(torch.int8), scale


def int8_conv3x3(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Stride-1 pad-1 3x3 conv of int8 ``x [N, cin, H, W]`` with int8
    ``weight [cout, cin, 3, 3]``: exact int32 sums, channels last
    ``[N, H, W, cout]``. ``cin`` and ``cout`` must be multiples of 8 and
    ``N * H * W`` above 16 (``torch._int_mm`` on the card)."""
    batch, channels, height, width = x.shape
    padded = F.pad(x.permute(0, 2, 3, 1), (0, 0, 1, 1, 1, 1))
    columns = torch.stack([padded[:, ky:ky + height, kx:kx + width]
                           for ky in range(3) for kx in range(3)], dim=3)
    taps = weight.permute(2, 3, 1, 0).reshape(9 * channels, -1)
    product = torch._int_mm(columns.reshape(-1, 9 * channels), taps)
    return product.view(batch, height, width, -1)


def quantized_conv(weight: torch.Tensor, bias: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """The 3x3 conv ``(weight, bias)`` of ``x [N, C, H, W]`` on int8
    operands; contiguous NCHW in ``x``'s dtype."""
    weight_q, weight_scale = quantize_weight(weight)
    x_q, x_scale = quantize_activation(x)
    sums = int8_conv3x3(x_q, weight_q).float()
    out = sums * (weight_scale * x_scale[:, None, None, None]) + bias.float()
    return out.to(x.dtype).permute(0, 3, 1, 2).contiguous()

