"""The benchmark's frozen arithmetic: useful work, kernel bounds, peaks.

Copied from the port when the benchmark was defined, so that a later change
to the port cannot move the yardstick (``pds_bench/tests`` holds the copies
equal to the port's counts at the cells' shapes):

* :func:`forward_useful_macs` -- the useful multiply-adds of one forward
  pass, from ``utils/flops.py``'s ``useful`` count (true 3-D conv
  semantics, the matching head factored, transposed convs at the taps that
  touch the input);
* :func:`conv_bound_ms` -- a conv's least time on the card, from
  ``chip_smoke.py``'s ``bound`` and ``_k3_bound``: each input, weight and
  output element read or written once, the float32 bias, two operations
  per multiply-add; a stride-1 3x3x3 conv counts all 27 taps of every
  output, a transposed conv the taps that touch the input
  (:func:`transposed_macs`).

The peaks are NVIDIA's H100 SXM data sheet's, dense, at the 700 W limit.
"""

from __future__ import annotations

import math

MEMORY_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}
# Dense bfloat16 peaks by a substring of ``torch.cuda.get_device_name()``.
PEAK_BF16_BY_CARD = {"H100 80GB HBM3": 989e12, "H100 SXM": 989e12,
                     "H200": 989e12}


def peak_bf16_flops(device_name: str) -> float | None:
    """The card's dense bfloat16 peak, or None for a card not listed."""
    for key, peak in PEAK_BF16_BY_CARD.items():
        if key in device_name:
            return peak
    return None


def _conv2d(pixels: int, k: int, cin: int, cout: int) -> int:
    return pixels * k * k * cin * cout


def _conv3d(pixels: int, spatial_taps: int, depth_taps: int, depth: int,
            cin: int, cout: int) -> int:
    return pixels * spatial_taps * depth_taps * depth * cin * cout


def forward_useful_macs(height: int, width: int, maximum_disparity: int,
                        features: int = 8) -> int:
    """Useful multiply-adds of one forward pass of one image at the PADDED
    size ``height`` x ``width`` (multiples of 64)."""
    quarter_h, quarter_w = height // 4, width // 4
    quarter = quarter_h * quarter_w
    half = (height // 2) * (width // 2)
    depth = (maximum_disparity + 1) // 4
    embedding = 2 * (_conv2d(half, 5, 3, 64) + _conv2d(quarter, 5, 64, 64)
                     + 4 * _conv2d(quarter, 3, 64, 64))
    shortcut = _conv2d(quarter, 3, 64, 8)
    head = 2 * _conv2d(quarter, 3, 64, 64) + quarter * 3 * 64 * 64
    tail = depth * (4 * _conv2d(quarter, 3, 64, 64)
                    + _conv2d(quarter, 3, 64, 8))
    core = _conv3d(quarter, 9, 3, depth, features, features)
    level = (depth, quarter_h, quarter_w, features)
    skips = []
    for _ in range(4):
        level_depth, level_h, level_w, channels = level
        down = ((level_depth - 1) // 2 + 1, (level_h + 1) // 2,
                (level_w + 1) // 2, 2 * channels)
        pixels = down[1] * down[2]
        core += (_conv3d(pixels, 9, 3, down[0], channels, 2 * channels)
                 + _conv3d(pixels, 9, 3, down[0], 2 * channels,
                           2 * channels))
        skips.append(level)
        level = down
    for _ in range(4):
        up_depth, up_h, up_w, _ = skips.pop()
        channels = level[3]
        core += (_conv3d(up_h * up_w, 4, 2, up_depth, channels,
                         channels // 2)
                 + _conv3d(up_h * up_w, 9, 3, up_depth, channels // 2,
                           channels // 2))
        level = (up_depth, up_h, up_w, channels // 2)
    level_depth, level_h, level_w, channels = level
    half_h, half_w, half_depth = 2 * level_h, 2 * level_w, 2 * level_depth
    upsamplers = (_conv3d(half_h * half_w, 4, 2, half_depth, channels,
                          channels // 2)
                  + _conv3d(4 * half_h * half_w, 4, 3, half_depth,
                            channels // 2, 1))
    return embedding + shortcut + head + tail + core + upsamplers


def train_useful_macs(height: int, width: int, maximum_disparity: int,
                      features: int = 8) -> int:
    """Useful multiply-adds of one train step of one image: the forward
    pass and its two gradient passes (input and weight), three times the
    forward's, with no recompute."""
    return 3 * forward_useful_macs(height, width, maximum_disparity,
                                   features)


def transposed_macs(input_shape, weight_shape, stride, padding) -> int:
    """Multiply-adds of a transposed conv that touch the input: per axis,
    the (input, tap) pairs whose output ``stride * i - pad + t`` lies
    inside."""
    batch, cin, *sizes = input_shape
    total = batch * cin * weight_shape[1]
    for size, s, p, k in zip(sizes, stride, padding, weight_shape[2:]):
        out = (size - 1) * s - 2 * p + k
        total *= sum(1 for i in range(size) for t in range(k)
                     if 0 <= s * i - p + t < out)
    return total


def conv_macs(weight_shape, output_shape) -> int:
    """Multiply-adds of a conv with weights ``[cout, cin, *k]``: every tap
    of every output."""
    cout, cin, *kernel = weight_shape
    return (output_shape[0] * math.prod(output_shape[2:]) * cout * cin
            * math.prod(kernel))


def bound_ms(bytes_moved: float, operations: float, dtype: str) -> float:
    """The least time the card takes for the work: the larger of its bytes
    over the memory bandwidth and its operations over the peak."""
    return max(bytes_moved / MEMORY_BYTES_PER_S,
               operations / PEAK_OPS_PER_S[dtype]) * 1e3


def conv_bound_ms(input_shape, weight_shape, output_shape, stride, padding,
                  transposed: bool, dtype: str, passes: int = 1) -> float:
    """Least time of ``passes`` passes of one conv call: 1 for a forward,
    3 for a train step's forward, input gradient and weight gradient, each
    of which moves the same tensors' sizes and does the same
    multiply-adds. ``dtype`` is ``"bfloat16"`` or ``"float32"``."""
    element = 2 if dtype == "bfloat16" else 4
    cout = weight_shape[1] if transposed else weight_shape[0]
    moved = element * (math.prod(input_shape) + math.prod(weight_shape)
                       + math.prod(output_shape)) + 4 * cout
    if transposed:
        macs = transposed_macs(input_shape, weight_shape, stride, padding)
    else:
        macs = conv_macs(weight_shape, output_shape)
    return passes * bound_ms(moved, 2.0 * macs, dtype)
