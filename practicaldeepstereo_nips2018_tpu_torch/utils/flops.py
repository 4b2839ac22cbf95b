"""Analytic MAC accounting for the PDS forward pass and train step.

Port of ``practicaldeepstereo_nips2018_tpu/utils/flops.py``. Two numbers
per stage, in multiply-accumulates (MACs), for one image at the PADDED
resolution:

* ``useful``: the MACs the network's math needs (true 3-D conv semantics,
  the matching head factored as in ``ops/costvolume.py``). They do not
  depend on the framework and equal the JAX package's stage by stage.
* ``executed``: the MACs the port issues. The port runs no depth-folded
  hourglass and no disparity pairing, so most stages execute exactly their
  useful MACs. The differences: the head's right plane is one column wider
  (``ops/costvolume.py``); ``embedding_s2d`` runs the first conv as a 3x3
  conv over 12 phase channels (108 taps x channels per output against 75);
  ``factor_tail_conv1`` replaces the tail's first conv by its plane convs;
  and in a train step no gradient is taken for the image, so the first
  conv's input gradient is not executed.

Transposed convs (cuDNN's) are counted at their useful taps, as if the
zeros of the dilated input were skipped: which algorithm cuDNN picks, and
what it executes, is not visible to this count, so there the executed
count is a lower bound. K1 executes all 27 taps of every output, which is
its useful count. ``matching_tail_int8`` changes the type of the tail's
MACs, not their number.

Each MAC is two FLOPs against :func:`peak_bf16_flops`.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class StageMacs:
    name: str
    useful: int
    executed: int


# Dense bfloat16 peaks (no sparsity) by a substring of
# ``torch.cuda.get_device_name``. Source: NVIDIA's H100 and H200 SXM data
# sheets: 989 TFLOP/s at the 700 W limit (int8: 1,979 TOP/s).
_PEAK_BF16_FLOPS = {"H100 80GB HBM3": 989e12, "H100 SXM": 989e12,
                    "H200": 989e12}


def peak_bf16_flops(device_name: str) -> float | None:
    """The card's dense bfloat16 peak, or None for a card not listed."""
    for key, peak in _PEAK_BF16_FLOPS.items():
        if key in device_name:
            return peak
    return None


def _conv2d(pixels: int, k: int, cin: int, cout: int) -> int:
    return pixels * k * k * cin * cout


def _conv3d(pixels: int, spatial_taps: int, depth_taps: int, depth: int,
            cin: int, cout: int) -> int:
    return pixels * spatial_taps * depth_taps * depth * cin * cout


def forward_macs(height: int, width: int, maximum_disparity: int,
                 number_of_features: int = 8, embedding_s2d: bool = False,
                 factor_tail_conv1: bool = False) -> list[StageMacs]:
    """Per-stage MACs of one forward pass (batch 1).

    Args:
        height, width: padded image size (multiples of 64).
        maximum_disparity: image-space maximum disparity (the 64 rule).
        number_of_features: hourglass base width (8).
        embedding_s2d, factor_tail_conv1: the ``PDSConfig`` options, which
            change the executed MACs only.
    """
    stages, _ = _forward_detail(height, width, maximum_disparity,
                                number_of_features, embedding_s2d,
                                factor_tail_conv1)
    return stages


def _forward_detail(height: int, width: int, maximum_disparity: int,
                    number_of_features: int = 8, embedding_s2d: bool = False,
                    factor_tail_conv1: bool = False):
    """Returns (stages, hourglass blocks as name -> (useful, executed)):
    the blocks are the stages the remat policies checkpoint
    (``models/regularization.py::run_stage``)."""
    stages: list[StageMacs] = []
    quarter_h, quarter_w = height // 4, width // 4
    quarter_pixels = quarter_h * quarter_w
    half_pixels = (height // 2) * (width // 2)
    depth = (maximum_disparity + 1) // 4  # cost-volume disparities

    # Embedding, both images: two strided 5x5 convs, 2 residual blocks.
    first_conv = _conv2d(half_pixels, 5, 3, 64)
    rest = _conv2d(quarter_pixels, 5, 64, 64) + 4 * _conv2d(quarter_pixels,
                                                            3, 64, 64)
    executed_first = (_conv2d(half_pixels, 3, 12, 64) if embedding_s2d
                      else first_conv)
    stages.append(StageMacs("embedding (x2 images)", 2 * (first_conv + rest),
                            2 * (executed_first + rest)))
    shortcut = _conv2d(quarter_pixels, 3, 64, 8)
    stages.append(StageMacs("left shortcut", shortcut, shortcut))

    # Matching head, factored: left plane, right plane one column wider,
    # and the 3x1 edge conv.
    edge = quarter_pixels * 3 * 64 * 64
    head = 2 * _conv2d(quarter_pixels, 3, 64, 64) + edge
    head_executed = (_conv2d(quarter_pixels, 3, 64, 64)
                     + _conv2d(quarter_h * (quarter_w + 1), 3, 64, 64) + edge)
    stages.append(StageMacs("matching head (factored)", head, head_executed))

    # Matching tail, one disparity per batch entry: 4 convs 64 -> 64 and
    # the 64 -> 8 tail conv.
    conv1 = _conv2d(quarter_pixels, 3, 64, 64)
    tail = depth * (4 * conv1 + _conv2d(quarter_pixels, 3, 64, 8))
    tail_executed = tail
    if factor_tail_conv1:
        planes = (conv1 + _conv2d(quarter_h * (quarter_w + 2), 3, 64, 64)
                  + quarter_h * (quarter_w + 1) * 3 * 64 * 64  # edge2
                  + 3 * quarter_pixels * 3 * 64 * 64  # smears
                  + quarter_h * 3 * 64 * 64)  # left seam
        tail_executed = tail - depth * conv1 + planes
    stages.append(StageMacs("matching tail", tail, tail_executed))

    # Hourglass: 3x3x3 convs (K1 and the stride-2 downs), 4x4x4 stride-2
    # transposed convs at their 2x2x2 useful taps.
    features = number_of_features
    blocks: dict[str, tuple[int, int]] = {}
    smoothing = _conv3d(quarter_pixels, 9, 3, depth, features, features)
    blocks["smoothing"] = (smoothing, smoothing)
    level_depth, level_h, level_w, level_c = (depth, quarter_h, quarter_w,
                                              features)
    skips = []
    for index in range(4):
        down_depth = (level_depth + 2 - 3) // 2 + 1
        down_h, down_w = (level_h + 1) // 2, (level_w + 1) // 2
        macs = (_conv3d(down_h * down_w, 9, 3, down_depth, level_c,
                        2 * level_c)
                + _conv3d(down_h * down_w, 9, 3, down_depth, 2 * level_c,
                          2 * level_c))
        blocks[f"contraction{index + 1}"] = (macs, macs)
        skips.append((level_depth, level_h, level_w, level_c))
        level_depth, level_h, level_w, level_c = (down_depth, down_h,
                                                  down_w, 2 * level_c)
    for index in range(4):
        up_depth, up_h, up_w, _ = skips.pop()
        macs = (_conv3d(up_h * up_w, 4, 2, up_depth, level_c, level_c // 2)
                + _conv3d(up_h * up_w, 9, 3, up_depth, level_c // 2,
                          level_c // 2))
        blocks[f"expansion{index + 1}"] = (macs, macs)
        level_depth, level_h, level_w, level_c = (up_depth, up_h, up_w,
                                                  level_c // 2)
    core = sum(useful for useful, _ in blocks.values())
    stages.append(StageMacs("hourglass core", core, core))

    # Upsamplers: 4x4x4 stride-2 to half size (C -> C/2, depth doubles),
    # then the (3,4,4) stride-(1,2,2) transposed conv C/2 -> 1.
    half_h, half_w, half_depth = 2 * level_h, 2 * level_w, 2 * level_depth
    upsamplers = (_conv3d(half_h * half_w, 4, 2, half_depth, level_c,
                          level_c // 2)
                  + _conv3d(4 * half_h * half_w, 4, 3, half_depth,
                            level_c // 2, 1))
    stages.append(StageMacs("upsamplers", upsamplers, upsamplers))
    return stages, blocks


# What each remat policy recomputes in the backward pass (the matching
# stage under both; ``models/regularization.py::run_stage``); the embedding
# is never checkpointed.
_HOURGLASS_BLOCKS = (("smoothing",) + tuple(f"contraction{i}"
                                            for i in range(1, 5))
                     + tuple(f"expansion{i}" for i in range(1, 5)))
_MATCHING_AND_UPSAMPLERS = ("matching head (factored)", "matching tail",
                            "upsamplers")
REMAT_RECOMPUTED = {
    False: (),
    True: _MATCHING_AND_UPSAMPLERS + _HOURGLASS_BLOCKS,
    "selective": _MATCHING_AND_UPSAMPLERS + ("smoothing", "contraction1",
                                             "expansion4"),
}


def training_macs(height: int, width: int, maximum_disparity: int,
                  number_of_features: int = 8, remat=False,
                  embedding_s2d: bool = False,
                  factor_tail_conv1: bool = False) -> dict:
    """MACs of ONE train step (one image; linear in the batch), in GMACs.

    * forward: one :func:`forward_macs` pass;
    * backward: two passes of every conv (input and weight gradients); the
      executed count leaves out the input gradient of the first conv,
      which no one needs (the images take no gradient);
    * recompute: the forward MACs of the stages the ``remat`` policy
      checkpoints, run once more in the backward pass.

    Useful MACs are 3x the forward's whatever the policy, as in the JAX
    package: recompute is an execution choice, not network math. The loss
    and RMSprop are elementwise.
    """
    stages, blocks = _forward_detail(height, width, maximum_disparity,
                                     number_of_features, embedding_s2d,
                                     factor_tail_conv1)
    by_name = {stage.name: (stage.useful, stage.executed)
               for stage in stages}
    by_name.update(blocks)
    recompute = sum(by_name[name][1] for name in REMAT_RECOMPUTED[remat])
    forward_useful = sum(stage.useful for stage in stages)
    forward = sum(stage.executed for stage in stages)
    half_pixels = (height // 2) * (width // 2)
    first_conv = 2 * (_conv2d(half_pixels, 3, 12, 64) if embedding_s2d
                      else _conv2d(half_pixels, 5, 3, 64))
    backward = 2 * forward - first_conv
    return {
        "remat": remat,
        "forward_gmacs": round(forward / 1e9, 2),
        "backward_gmacs": round(backward / 1e9, 2),
        "recompute_gmacs": round(recompute / 1e9, 2),
        "executed_gmacs": round((forward + backward + recompute) / 1e9, 2),
        "useful_gmacs": round(3 * forward_useful / 1e9, 2),
        "recompute_overhead_pct": round(
            100 * recompute / (forward + backward), 1),
    }


def summarize(stages: list[StageMacs]) -> dict:
    useful = sum(stage.useful for stage in stages)
    executed = sum(stage.executed for stage in stages)
    return {
        "useful_gmacs": round(useful / 1e9, 2),
        "executed_gmacs": round(executed / 1e9, 2),
        "structural_overhead": round(executed / useful, 2),
        "stages": {stage.name: {"useful_gmacs": round(stage.useful / 1e9, 2),
                                "executed_gmacs": round(stage.executed / 1e9,
                                                        2)}
                   for stage in stages},
    }
