"""Share of their roofline that PSMNet's disparity heads reach: the least
time at the card's memory bandwidth (3.35 TB/s) for the heads' unavoidable
bytes, over the time between CUDA events at the forward and full backward
hooks of their ``regression`` module.

The unavoidable bytes of one head, in float32, counted here from the
calls' shapes so that they read the same work whatever implements the
heads: forward, read the ``[B, 1, D/4, H/4, W/4]`` cost and write the
``[B, H, W]`` map; backward (train cells), read the map's gradient and the
cost and write the cost's gradient. The upsampled ``[B, D, H, W]`` volume
and its softmax need never leave the chip."""

import math

from pds_bench import accounting

BACKWARD = True
FLOAT32_BYTES = 4


def _select(path, module):
    return path == "regression"


SPANS = {"regression_pass": _select}


def head_bytes(cost_shape, map_shape, train: bool) -> int:
    """Bytes one head has to move: forward, and backward where ``train``."""
    cost, disparity = math.prod(cost_shape), math.prod(map_shape)
    moved = cost + disparity
    if train:
        moved += disparity + 2 * cost
    return FLOAT32_BYTES * moved


def read(record):
    calls = record.spans.get("regression_pass")
    if not calls:
        return None
    train = record.kind == "train"
    least = spent = 0.0
    for call in calls:
        if train and "backward_ms" not in call:
            return None
        least += 1e3 * head_bytes(call["input_shape"], call["output_shape"],
                                  train) / accounting.MEMORY_BYTES_PER_S
        spent += call["forward_ms"] + call.get("backward_ms", 0.0)
    return 100.0 * least / spent if spent > 0 else None
