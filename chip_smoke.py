"""Drives the PyTorch port on one NVIDIA GPU and checks what comes out.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device   -- the card (``nvidia-smi`` name and power limit) and the build
               of the CUDA kernels from ``practicaldeepstereo_nips2018_tpu_
               torch/csrc`` (one ``nvcc`` per source, all at once).
2. kernels  -- each kernel at every shape the main path gives it, in
               float32 (TF32 off) and bfloat16, against its plain PyTorch
               version on the same inputs; kernel, plain and library device
               times (CUDA events around replays of a CUDA graph of 10
               calls, median of 25 replays).
               K1 also at batch 2 (each image equal to its batch-1 result),
               twice on the same input (bit-equal), and at (48, 8) with a
               cold L2 (a 128 MB write between launches). K2 also on the
               contiguous [P, D] layout at the same size, and on ties and
               maxima at the first and last disparity in both layouts for
               half_taps 1 to 4.
               K1 also at the training shapes (D=255): forward against its
               plain version, and its autograd Function's gradients (input
               gradient through K1 itself in bfloat16 within one ulp;
               weight and bias gradients in float32 within 1e-4 of their
               largest) against autograd of the plain version; the input
               gradient's time against cuDNN's (``convolution_backward``).
               K2 also at D=128, the eval step's size. K1 also at the
               haloed W-slices of phase 13 (c) and (d) (each level's 2
               slices with one halo column on either side, D=255 and
               D=191), K2 at (d)'s two slices, float32 and bfloat16.
3. path     -- ``infer`` at 70x90, D=63, float32, on the card against the
               same seeded weights on the CPU (plain versions).
4. train_path -- one ``train_step`` at 70x90, D=63, float32, on the card
               (loss against the CPU's) with its gradients held against
               the CPU's float64 ones taken through the same LeakyReLU
               branches as the card (:func:`follow_leaky_relu_branches`);
               18 K1 launches (9 forward + 9 input gradients).
5. serving  -- an ``InferenceSession`` at 540x960, D=191, bfloat16 (the
               published protocol) answering 17 requests, one of batch 2;
               checks the outputs and that every image went through 9 K1
               and 1 K2 launches; ms per image and peak device memory.
6. training -- the reference training configuration: 540x960, D=255,
               bfloat16 compute, batch 1, RMSprop at lr 1e-2; 1 warm-up and
               6 timed train steps (finite loss and gradients, 18 K1
               launches each), ms per step, peak memory, the top device
               kernels of one step (``torch.profiler``); then one
               ``eval_step`` (1 K2 + 9 K1 launches, finite metrics) and a
               checkpoint written and read back leaf for leaf.

7. dataset  -- writes a FlyingThings3D tree (960x540: 4 clean TRAIN
               examples, one in an artifact frame, one with disparities
               above 255, 2 TEST examples, one with 30 % of its pixels at
               350 px) and a KITTI tree (1242x375: 2 KITTI 2012 and 2 KITTI
               2015 training examples, 16-bit ground truth, a reflective
               map, 2 KITTI 2015 testing pairs) with the port's own PNG
               (Paeth-filtered rows) and PFM writers under
               ``build/chip_smoke/``; checks the split sizes and that an
               example reads back as written; PNG decode ms by decoder
               (numpy's, and OpenCV's where it imports) and filter.
8. trainer  -- ``cli.train_flyingthings3d.main`` at 540x960, D=255,
               bfloat16, 1 validation example: one epoch, then resumed
               from ``001_checkpoint.npz`` into a second; checks the
               checkpoints, log lines, plot and dumps, finite losses, 18 K1
               per train step and 9 K1 + 1 K2 per validation image (with
               its untimed warm-up), and that the first step's loss equals
               a direct ``train_step`` on the arrays that were written, in
               the Loader's order, within 1e-5 relative. Prints the loop's
               ms per step (device timeline) beside phase 6's bare step,
               the loader's wait, the validation time per image, (from
               a third, profiled run of epoch 2) the device-busy share of
               the training loop, and (from a fourth, with ``cv2`` made
               unimportable) the loop and the loader's wait with numpy's
               PNG decoder.
9. benchmark -- ``cli.benchmark_flyingthings3d.main`` on the epoch-2
               checkpoint at D=191, bfloat16, under PSM (2 examples) and
               CRL (1): finite MAE and 3PE, 9 K1 + 1 K2 per image and
               warm-up; time per image beside phase 5's median.
10. kitti   -- ``cli.finetune_kitti.main`` (1 epoch, network from the
               epoch-2 checkpoint, padded to 384x1280, D=255, bfloat16),
               then ``cli.export_kitti_submission.main`` on the KITTI 2015
               testing pairs at 375x1242: each uint16 PNG decodes to
               ``clip(disparity * 256)`` of a direct ``models.infer`` of
               the fine-tuned weights on the written images.

11. options -- the ``PDSConfig`` opt-ins. The int8 conv of the matching
               tail (``ops/int8.py``: im2col into ``torch._int_mm``) at its
               540x960 D=191 shapes against a float32 cuDNN conv of the same
               int8 values with TF32 off, which is exact (every sum is an
               integer below 2^24), bit for bit, with the int8 conv's, the
               GEMM's, the whole quantized conv's and the bfloat16 conv's
               times. An ``InferenceSession`` at 540x960, D=191, bfloat16,
               16 requests, under the default configuration,
               ``embedding_s2d``, ``factor_tail_conv1``,
               ``matching_tail_int8`` and all three: ms per image, peak
               memory, 9 K1 + 1 K2 per image, the mean |difference| from
               the default's maps, and for the two exact options the 70x90
               card-vs-CPU comparison of phase 3. Train steps at 540x960,
               D=255, bfloat16, batch 1 under ``remat`` off,
               ``"selective"`` and ``True``: one step's gradients from the
               same weights (cuDNN's deterministic algorithms) equal to
               remat off's bit for bit, remat off run twice as the
               control; then 1 warm-up and 6 timed steps each: ms per
               step, peak memory, 18/21/27 K1 launches per step.
12. parallel -- the ``data`` axis over processes and the native scanner.
               (a) ``cli.train_flyingthings3d.main`` with ``--mesh_data 1``
               on phase 7's tree under ``torchrun``'s variables for a world
               of 1 (an NCCL group): 18 K1 per train step, 9 K1 + 1 K2 per
               validation image, the first step's loss within 1e-5 of
               phase 8's direct ``train_step``, the loop's ms per step
               beside phase 8's; and on phase 6's example, with cuDNN's
               deterministic algorithms, one ``train_step`` in that group
               (its count, gradients and loss summed through NCCL) against
               one with no group: loss, gradients and updated weights bit
               for bit. (b) and (c) in two processes that share
               the card over gloo (this script with ``--parallel-rank``,
               killed after ``PARALLEL_TIMEOUT_S``): (b) float32 (TF32
               off), 70x90, D=63, one example each with 720 and 2700
               unknown pixels, one step through ``PDSTrainer``'s
               data-parallel step: the loss within 1e-5 of the CPU's
               float64 batch-2 loss, each gradient within 1e-3 of its
               largest element of the CPU's float64 gradient through the
               processes' LeakyReLU branches, gradients and updated
               weights bit-equal on both; (c) 540x960, D=255, bfloat16,
               batch 1 each: 1 + 6 steps (ms per step, the gradient
               all-reduce's ms, peak memory, 18 K1 per step; the two
               contend for one card, so no scaling number), then a
               validation pass over shards of 2 + 1 examples whose metrics
               are the same on both and within 1e-5 of the same examples
               evaluated here one after another. (d) 256 960x540 PFMs:
               seconds per PFM of the Python statistics and of the C++
               scanner (``data/native.py``), minimum and maximum equal,
               distributions within 1e-3.
13. volume -- the ``volume`` mesh axis, in processes that share the card
               over gloo (this script with ``--volume-rank``, killed after
               ``VOLUME_TIMEOUT_S``). (a) 2 processes, volume=2, 128x512,
               D=63, float32 (TF32 off), batch 2: the stitched
               similarities within 1e-3 of the CPU's float64 unsharded
               ``apply``, each process's whole ``infer`` map equal and
               >= 99.9 % of its pixels within 1e-2 px, one ``train_step``:
               the loss within 1e-5 of the CPU's float64 loss, each
               gradient within 1e-3 of its largest element of the CPU's
               float64 gradient through the processes' LeakyReLU branches,
               gradients and updated weights bit-equal on both; 18 K1 per
               step and 9 K1 + 1 K2 per ``infer`` on each. (b) the same
               checks in 4 processes at volume=4, 64x320, D=127 (quarter
               slices of 32, 16, 16, 16 columns, narrower than the cost
               volume's halo). (c) the training cell at volume=2 (phase
               6's example and first weights): 1 + 6 steps per process,
               ms per step, the halo exchanges' and the norm all-reduces'
               ms per step (two more steps, each call fenced by
               ``torch.cuda.synchronize()``), peak memory, 18 K1 per
               step, the losses equal on both and the first within 1e-3
               relative of phase 6's; no scaling number (one card). (d)
               ``infer`` at 540x960, D=191, bfloat16, volume=2: the whole
               map equal on both and over the images, finite, in [0,
               190], 9 K1 + 1 K2 per image on each; ms per image.
    mfu     -- useful FLOPs (``utils/flops.py``, the JAX package's count)
               over time over the card's bfloat16 peak, for the serving
               median (phase 5), the train step (phase 6) and each
               configuration of phase 11.

Then the ``kernels`` summary line (launch counts from phases 5, 6, 8 to
13), the ``nvidia-smi`` line, and last ``{"ok": true, "device":
{...}}``.
Any failed check makes the script exit 1 without that last line; so does a
host without a card or a directory without the port. ``build/chip_smoke``
is removed at the end.
"""

from __future__ import annotations

import functools
import json
import os
import pathlib
import shutil
import socket
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from practicaldeepstereo_nips2018_tpu_torch import models, parallel
from practicaldeepstereo_nips2018_tpu_torch.cli import (
    benchmark_flyingthings3d, common, export_kitti_submission,
    finetune_kitti, train_flyingthings3d)
from practicaldeepstereo_nips2018_tpu_torch.data import (
    FlyingThings3D, Kitti, Loader, native, pfm, png)
from practicaldeepstereo_nips2018_tpu_torch.data.flyingthings3d import (
    compute_disparity_statistic)
from practicaldeepstereo_nips2018_tpu_torch.ops import (
    conv3d, int8, kernels, loss, subpixel)
from practicaldeepstereo_nips2018_tpu_torch.parallel import runtime
from practicaldeepstereo_nips2018_tpu_torch.serving import InferenceSession
from practicaldeepstereo_nips2018_tpu_torch.training import (
    checkpoint, optimizer, trainer, weights)
from practicaldeepstereo_nips2018_tpu_torch.utils import flops

# Published H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit).
MEMORY_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12,
                  torch.int8: 1979e12}

HEIGHT, WIDTH, MAXIMUM_DISPARITY = 540, 960, 191
# K1 on the main path at 540x960, D=191: (D, C, H, W) of each hourglass
# level and its stride-1 3x3x3 convs per image (smoothing and
# expansion4.smooth; contraction1/expansion3; contraction2/expansion2;
# contraction3/expansion1; contraction4).
K1_LEVELS = [((48, 8, 144, 240), 2), ((24, 16, 72, 120), 2),
             ((12, 32, 36, 60), 2), ((6, 64, 18, 30), 2),
             ((3, 128, 9, 15), 1)]
# K2 on the main path: [1, 96, 576, 960] similarities, one launch per image.
K2_SHAPE = (1, 96, 576, 960)
# K1 on the train path at 540x960, D=255: the same nine convs, each run
# forward and again for its input gradient.
K1_TRAIN_LEVELS = [((64, 8, 144, 240), 2), ((32, 16, 72, 120), 2),
                   ((16, 32, 36, 60), 2), ((8, 64, 18, 30), 2),
                   ((4, 128, 9, 15), 1)]
# K2 in the eval step at 540x960, D=255.
K2_EVAL_SHAPE = (1, 128, 576, 960)
TRAIN_MAXIMUM_DISPARITY, TRAIN_STEPS, LEARNING_RATE = 255, 6, 1e-2
K1_COLD_SHAPE = (48, 8, 144, 240)  # 26.5 MB in bfloat16: fits the L2 warm
K1_SOURCE = "practicaldeepstereo_nips2018_tpu_torch/csrc/conv3d_k3s1.cu"
K2_SOURCE = "practicaldeepstereo_nips2018_tpu_torch/csrc/subpixel_map.cu"
K1_REPLACES = "practicaldeepstereo_nips2018_tpu/ops/folded_banded.py:242"
K2_REPLACES = "practicaldeepstereo_nips2018_tpu/ops/subpixel_pallas.py:35"
SERVING_REQUESTS = 16  # batch-1 requests, plus one batch-2 request
SCRATCH = pathlib.Path(__file__).resolve().parent / "build" / "chip_smoke"
PACKAGE = "practicaldeepstereo_nips2018_tpu_torch"
# The train path: every gradient tensor within this share of its largest
# element of the float64 gradient through the card's LeakyReLU branches;
# and those branches differ from float64's own only where the float64
# input lies within this share of the call's largest |input| of zero.
TRAIN_PATH_GRADIENT_TOLERANCE, BRANCH_FLIP_TOLERANCE = 1e-3, 1e-4
# Phases 7-10: the datasets' real image sizes, and the trees' layout.
KITTI_HEIGHT, KITTI_WIDTH = 375, 1242
# FlyingThings3D examples: (scene, frame, ground truth kind).
FLYINGTHINGS3D_EXAMPLES = [
    ("TRAIN/A/0000", "0006", "clean"), ("TRAIN/A/0000", "0007", "clean"),
    ("TRAIN/B/0001", "0006", "clean"), ("TRAIN/C/0002", "0010", "clean"),
    ("TRAIN/A/0011", "0012", "clean"),  # an artifact frame: dropped
    ("TRAIN/B/0003", "0008", "above 255"),  # dropped by the range filter
    ("TEST/A/0000", "0006", "clean"),
    ("TEST/B/0001", "0007", "30 % at 350"),  # dropped by CRL
]
FIRST_LOSS_TOLERANCE = 1e-5  # relative, trainer's first step vs direct
# Phase 11: serving configurations (PDSConfig overrides), the exact ones,
# the remat policies with their K1 launches per train step (9 forward, 9
# input gradients, and the recomputed smooths), the int8 tail's shape at
# 540x960, D=191 (48 disparities of [64, 144, 240]) and its output widths.
OPTION_CONFIGS = {
    "default": {}, "embedding_s2d": {"embedding_s2d": True},
    "factor_tail_conv1": {"factor_tail_conv1": True},
    "matching_tail_int8": {"matching_tail_int8": True},
    "all_three": {"embedding_s2d": True, "factor_tail_conv1": True,
                  "matching_tail_int8": True}}
EXACT_OPTIONS = ("embedding_s2d", "factor_tail_conv1")
REMAT_POLICIES = {"off": (False, 18), "selective": ("selective", 21),
                  "all": (True, 27)}
INT8_SHAPE, INT8_OUTPUTS = (48, 64, 144, 240), (64, 8)
PADDED_HEIGHT = 576  # 540 padded to a multiple of 64
# Phase 12: each group of processes is killed after this long (a process
# that fails or is killed fails the run); the PFMs the scanners read.
PARALLEL_TIMEOUT_S = 300
PARALLEL_SCAN_FILES = 256
# The two gloo processes share the one card.
PARALLEL_DEVICE = "cuda:0"
# Phase 13: (a) and (b) as (processes, (batch, height, width, maximum
# disparity)); each group is killed after VOLUME_TIMEOUT_S; (d)'s timed
# images; (c)'s loss against phase 6's, relative.
VOLUME_CASES = {"a": (2, (2, 128, 512, 63)), "b": (4, (1, 64, 320, 127))}
VOLUME_TIMEOUT_S = 420
VOLUME_SERVING_IMAGES = 4
VOLUME_LOSS_TOLERANCE = 1e-3
# K1 on (c)'s and (d)'s paths: 540x960 over volume=2 gives
# quarter-resolution slices of 128 and 112 columns (512 + 448
# full-resolution), halved at each level; K1 takes each slice with one
# halo column on either side. K2 on (d)'s path: each process's
# similarities, [1, 96, 576, 512] and [1, 96, 576, 448].
VOLUME_QUARTER_SLICES = (128, 112)


def _haloed_slices(levels) -> list:
    return [(depth, channels, height, width // 2 ** level + 2)
            for level, ((depth, channels, height, _), _) in enumerate(levels)
            for width in VOLUME_QUARTER_SLICES]


K1_VOLUME_SHAPES = {"phase 13 (c): D=255 training": _haloed_slices(
                        K1_TRAIN_LEVELS),
                    "phase 13 (d): D=191 serving": _haloed_slices(K1_LEVELS)}
K2_VOLUME_SHAPES = [(1, K2_SHAPE[1], PADDED_HEIGHT, 4 * width)
                    for width in VOLUME_QUARTER_SLICES]

failures: list[str] = []


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def check(condition: bool, message: str) -> None:
    if not condition:
        failures.append(message)
        print(f"CHECK FAILED: {message}", file=sys.stderr, flush=True)


def _graph(function, calls: int) -> torch.cuda.CUDAGraph:
    """``calls`` back-to-back calls of ``function`` captured in one CUDA
    graph, after one call outside it (builds, library plans)."""
    function()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            function()
    return graph


def time_ms(function, runs: int = 25, calls: int = 10) -> float:
    """Median device time of one call: replays of a CUDA graph of ``calls``
    calls, CUDA events around each replay, so that the host's time between
    launches (the wrappers' checks, Python) leaves no gap on the card."""
    graph = _graph(function, calls)
    graph.replay()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def time_cold_ms(function, runs: int = 10) -> float:
    """Median device time of one call (a one-call graph) after writing a
    buffer larger than the 50 MB L2, so that its inputs come from memory."""
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    graph = _graph(function, 1)
    times = []
    for run in range(runs):
        flush.fill_(run)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(bytes_moved: float, operations: float, dtype) -> dict:
    bytes_ms = bytes_moved / MEMORY_BYTES_PER_S * 1e3
    operations_ms = operations / PEAK_OPS_PER_S[dtype] * 1e3
    return {"bound_ms": max(bytes_ms, operations_ms),
            "bound_by": "bytes" if bytes_ms >= operations_ms
            else "operations"}


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    check(smi.returncode == 0 and bool(card),
          f"nvidia-smi failed: {smi.stderr.strip()}")
    build_s = kernels.build()
    registers = {name: [line.split(":", 1)[-1].strip()
                        for line in report.splitlines()
                        if "entry function" in line or "registers" in line
                        or "spill" in line]
                 for name, report in kernels.build_reports.items()}
    emit({"phase": "device", "nvidia_smi": card,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": build_s,
          "ptxas": registers})
    return card


def check_k1(shape, dtype, generator) -> dict:
    depth, channels, height, width = shape
    x = torch.randn((1, channels, depth, height, width), device="cuda",
                    generator=generator).to(dtype)
    limit = 1.0 / np.sqrt(27 * channels)
    weight = ((torch.rand((channels, channels, 3, 3, 3), device="cuda",
                          generator=generator) * 2 - 1) * limit).to(dtype)
    bias = (torch.rand(channels, device="cuda", generator=generator) * 2
            - 1) * limit
    got = conv3d.conv3d_k3s1(x, weight, bias)
    plain = conv3d.conv3d_k3s1_plain(x, weight, bias)
    torch.cuda.synchronize()
    error = (got.float() - plain.float()).abs()
    if dtype == torch.float32:
        tolerance = "abs <= 1e-4"
        ok = float(error.max()) <= 1e-4
    else:
        tolerance = "abs <= 2^-7 * |value| + 1e-6 (one bfloat16 ulp)"
        ok = one_ulp(got, plain)
    check(ok, f"K1 {shape} {dtype}: max abs err {float(error.max())}")
    again = conv3d.conv3d_k3s1(x, weight, bias)
    check(torch.equal(again, got), f"K1 {shape} {dtype}: two launches on "
          "the same input differ")
    other = torch.randn(x.shape, device="cuda", generator=generator).to(dtype)
    pair = conv3d.conv3d_k3s1(torch.cat([x, other]), weight, bias)
    check(torch.equal(pair[:1], got) and torch.equal(
        pair[1:], conv3d.conv3d_k3s1(other, weight, bias)),
        f"K1 {shape} {dtype}: batch 2 differs from its batch-1 results")
    library_bias = bias.to(dtype)
    element = x.element_size()
    voxels = depth * height * width
    record = {
        "kernel": conv3d.NAME, "shape": list(shape), "dtype": str(dtype),
        "max_abs_err": float(error.max()), "tolerance": tolerance,
        "ms": time_ms(lambda: conv3d.conv3d_k3s1(x, weight, bias)),
        "plain_ms": time_ms(
            lambda: conv3d.conv3d_k3s1_plain(x, weight, bias)),
        "library_ms": time_ms(lambda: F.conv3d(x, weight, library_bias,
                                               padding=1)),
    }
    if shape == K1_COLD_SHAPE:
        record["cold_ms"] = time_cold_ms(
            lambda: conv3d.conv3d_k3s1(x, weight, bias))
        record["library_cold_ms"] = time_cold_ms(
            lambda: F.conv3d(x, weight, library_bias, padding=1))
    record.update(bound(
        element * (2 * channels * voxels + 27 * channels * channels)
        + 4 * channels,
        2.0 * voxels * channels * channels * 27, dtype))
    return record


def one_ulp(got: torch.Tensor, plain: torch.Tensor) -> bool:
    """Two bfloat16 results that accumulated in float32 from the same
    values and rounded once agree or differ by one bfloat16 ulp, <= 2^-7
    |value|."""
    error = (got.float() - plain.float()).abs()
    scale = torch.maximum(got.float().abs(), plain.float().abs())
    return bool((error <= scale * 2 ** -7 + 1e-6).all())


def _gradients(function, inputs, grad_output) -> list:
    """[output, d x, d weight, d bias] of ``function(*inputs)`` under
    autograd for the output gradient ``grad_output``."""
    leaves = [tensor.detach().clone().requires_grad_() for tensor in inputs]
    output = function(*leaves)
    output.backward(grad_output)
    return [output.detach()] + [leaf.grad for leaf in leaves]


def _relative_error(got: torch.Tensor, expected: torch.Tensor) -> float:
    return float((got.float() - expected.float()).abs().max()
                 / expected.float().abs().max())


def check_k1_gradient(shape, generator) -> dict:
    """K1 at a training level: forward against its plain version, and the
    autograd Function's gradients against autograd of the plain version;
    times of the forward and of the input gradient through K1, against
    cuDNN's forward and input gradient (``convolution_backward``)."""
    depth, channels, height, width = shape
    limit = 1.0 / np.sqrt(27 * channels)
    x32 = torch.randn((1, channels, depth, height, width), device="cuda",
                      generator=generator)
    weight32 = (torch.rand((channels, channels, 3, 3, 3), device="cuda",
                           generator=generator) * 2 - 1) * limit
    bias = (torch.rand(channels, device="cuda", generator=generator) * 2
            - 1) * limit
    grad32 = torch.randn(x32.shape, device="cuda", generator=generator)
    x, weight, grad = (tensor.bfloat16() for tensor in (x32, weight32,
                                                        grad32))
    forward = conv3d.conv3d_k3s1(x, weight, bias)
    forward_plain = conv3d.conv3d_k3s1_plain(x, weight, bias)
    forward_error = float((forward.float() - forward_plain.float()).abs(
    ).max())
    check(one_ulp(forward, forward_plain),
          f"K1 {shape} bfloat16 forward: max abs err {forward_error}")

    got = _gradients(conv3d.Conv3dK3S1.apply, (x, weight, bias), grad)
    plain = _gradients(conv3d.conv3d_k3s1_plain, (x, weight, bias), grad)
    dgrad_error = float((got[1].float() - plain[1].float()).abs().max())
    check(one_ulp(got[1], plain[1]), f"K1 {shape} bfloat16 input gradient: "
          f"max abs err {dgrad_error}")
    got32 = _gradients(conv3d.Conv3dK3S1.apply, (x32, weight32, bias),
                       grad32)
    plain32 = _gradients(conv3d.conv3d_k3s1_plain, (x32, weight32, bias),
                         grad32)
    errors32 = [_relative_error(a, b) for a, b in zip(got32[1:],
                                                      plain32[1:])]
    check(max(errors32[1:]) <= 1e-4, f"K1 {shape} float32 weight/bias "
          f"gradients: relative errors {errors32[1:]}")
    check(errors32[0] <= 1e-4, f"K1 {shape} float32 input gradient: "
          f"relative error {errors32[0]}")

    flipped = weight.flip(2, 3, 4).transpose(0, 1)
    zero = torch.zeros(channels, device="cuda")
    library_bias = bias.bfloat16()
    voxels = depth * height * width
    one_conv = bound(2 * (2 * channels * voxels + 27 * channels * channels)
                     + 4 * channels, 2.0 * voxels * channels * channels * 27,
                     torch.bfloat16)
    return {
        "kernel": conv3d.NAME, "shape": list(shape), "dtype": "bfloat16",
        "forward_max_abs_err": forward_error,
        "input_gradient_max_abs_err": dgrad_error,
        "weight_gradient_bf16_relative_err": _relative_error(got[2],
                                                             plain[2]),
        "float32_relative_err": dict(zip(("input", "weight", "bias"),
                                         errors32)),
        "tolerance": "bfloat16 forward and input gradient: one ulp; float32 "
                     "gradients: 1e-4 of the largest",
        "ms": time_ms(lambda: conv3d.conv3d_k3s1(x, weight, bias)),
        "plain_ms": time_ms(
            lambda: conv3d.conv3d_k3s1_plain(x, weight, bias)),
        "library_ms": time_ms(lambda: F.conv3d(x, weight, library_bias,
                                               padding=1)),
        # What the Function's backward launches for the input gradient:
        # the flipped tap-major weight copy and K1.
        "dgrad_ms": time_ms(lambda: conv3d.conv3d_k3s1(
            grad, weight, zero, input_gradient=True)),
        "dgrad_plain_ms": time_ms(
            lambda: conv3d.conv3d_k3s1_plain(grad, flipped, zero)),
        "dgrad_library_ms": time_ms(
            lambda: torch.ops.aten.convolution_backward(
                grad, x, weight, None, [1, 1, 1], [1, 1, 1], [1, 1, 1],
                False, [0, 0, 0], 1, [True, False, False])),
        "wgrad_library_ms": time_ms(lambda: torch.nn.grad.conv3d_weight(
            x, weight.shape, grad, padding=1)),
        **one_conv,
    }


def check_k2(dtype, generator, shape=K2_SHAPE) -> dict:
    volume = torch.randn(shape, device="cuda", generator=generator).to(
        dtype)
    view = volume.permute(0, 2, 3, 1)  # the hourglass's disparity-last view
    got = subpixel.subpixel_map(view)
    plain = subpixel.subpixel_map_plain(view)
    torch.cuda.synchronize()
    error = float((got - plain).abs().max())
    # Both compute in float32 from the same values.
    check(error <= 1e-4, f"K2 {dtype}: max abs err {error} px")
    disparities = shape[1]
    pixels = volume.numel() // disparities
    best = view.float().argmax(dim=-1)
    half_taps = 2  # half_support_window 4 / disparity_step 2
    taps = (torch.clamp(best + half_taps, max=disparities - 1)
            - torch.clamp(best - half_taps, min=0) + 1)
    # Per pixel: D-1 compares, then per window tap a subtract, exp, two
    # adds and a multiply, then a divide, add and multiply.
    operations = pixels * (disparities - 1 + 3) + 5 * float(taps.sum())
    # The same scores disparity-last and contiguous: the scalar kernel.
    rows = view.contiguous()
    rows_error = float((subpixel.subpixel_map(rows) - plain).abs().max())
    check(rows_error <= 1e-4,
          f"K2 {dtype} contiguous [P, D]: max abs err {rows_error} px")
    record = {
        "kernel": subpixel.NAME, "shape": list(shape), "dtype": str(dtype),
        "max_abs_err": max(error, rows_error), "tolerance": "abs <= 1e-4 px",
        "ms": time_ms(lambda: subpixel.subpixel_map(view)),
        "plain_ms": time_ms(lambda: subpixel.subpixel_map_plain(view)),
        "library_ms": None,
        "contiguous_rows_ms": time_ms(lambda: subpixel.subpixel_map(rows)),
        "edge_cases_max_abs_err": check_k2_edges(dtype),
    }
    record.update(bound(volume.element_size() * volume.numel() + 4 * pixels,
                        operations, torch.float32))
    return record


def check_k1_other_shapes(generator) -> float:
    """K1 at shapes off the main path, against its plain version: channel
    counts the tiled kernels do not take (the direct kernel), a float32
    cin that leaves a partial chunk of 4, odd sizes, batch 2."""
    worst = 0.0
    for cin, cout, dtype in ((4, 6, torch.bfloat16), (12, 8, torch.bfloat16),
                             (4, 6, torch.float32), (6, 16, torch.float32),
                             (40, 8, torch.float32)):
        x = torch.randn((2, cin, 5, 7, 9), device="cuda",
                        generator=generator).to(dtype)
        weight = (torch.randn((cout, cin, 3, 3, 3), device="cuda",
                              generator=generator) * 0.1).to(dtype)
        bias = torch.randn(cout, device="cuda", generator=generator) * 0.1
        got = conv3d.conv3d_k3s1(x, weight, bias).float()
        plain = conv3d.conv3d_k3s1_plain(x, weight, bias).float()
        error = (got - plain).abs()
        if dtype == torch.float32:
            ok = float(error.max()) <= 1e-4
        else:
            ok = one_ulp(got, plain)
        check(ok, f"K1 cin={cin} cout={cout} {dtype}: max abs err "
              f"{float(error.max())}")
        worst = max(worst, float(error.max()))
    return worst


def check_k2_edges(dtype) -> float:
    """Ties, maxima at the first and last disparity and a new maximum
    inside the window, for half_taps 1 to 4, in the disparity-major view
    (vector kernel) and contiguous [P, D] (scalar kernel)."""
    disparities = 20
    scores = torch.full((64, disparities), -3.0)
    scores[0, [3, 12]] = 1.0
    scores[1, [3, 5]] = 1.0
    scores[2, :] = 0.0
    scores[3, [19, 0]] = 2.0
    scores[4, 0] = 5.0
    scores[5, 19] = 5.0
    scores[6, [17, 19]] = torch.tensor([4.0, 5.0])
    scores[7:] = torch.randn((57, disparities), generator=torch.Generator(
    ).manual_seed(3))
    scores = scores.to(dtype).cuda()
    volume = scores.T.reshape(1, disparities, 8, 8).contiguous()
    layouts = {"disparity_major": volume.permute(0, 2, 3, 1),
               "rows": scores.view(1, 8, 8, disparities)}
    worst = 0.0
    for half_taps in (1, 2, 3, 4):
        for name, layout in layouts.items():
            got = subpixel.subpixel_map(layout, 2 * half_taps, 2)
            plain = subpixel.subpixel_map_plain(layout, 2 * half_taps, 2)
            error = float((got - plain).abs().max())
            check(error <= 1e-4, f"K2 {dtype} edge cases, half_taps "
                  f"{half_taps}, {name}: max abs err {error} px")
            worst = max(worst, error)
    return worst


def phase_kernels() -> dict:
    generator = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for shape, launches in K1_LEVELS:
        for dtype in (torch.float32, torch.bfloat16):
            record = check_k1(shape, dtype, generator)
            record["launches_per_image"] = launches
            emit({"phase": "kernel_check", **record})
            results[(conv3d.NAME, shape, dtype)] = record
    emit({"phase": "kernel_check", "kernel": conv3d.NAME,
          "shapes": "off the main path: (cin, cout) = (4, 6), (12, 8) "
                    "bfloat16; (4, 6), (6, 16), (40, 8) float32; "
                    "[2, cin, 5, 7, 9]",
          "max_abs_err": check_k1_other_shapes(generator)})
    for dtype in (torch.float32, torch.bfloat16):
        for shape in (K2_SHAPE, K2_EVAL_SHAPE):
            record = check_k2(dtype, generator, shape)
            record["launches_per_image"] = 1
            emit({"phase": "kernel_check", **record})
            results[(subpixel.NAME, shape, dtype)] = record
    for path, shapes in K1_VOLUME_SHAPES.items():
        for shape in shapes:
            for dtype in (torch.float32, torch.bfloat16):
                record = check_k1(shape, dtype, generator)
                record["on"] = f"{path}: a haloed W-slice of one process"
                emit({"phase": "kernel_check", **record})
                results[(conv3d.NAME, shape, dtype)] = record
    for shape in K2_VOLUME_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            record = check_k2(dtype, generator, shape)
            record["on"] = "phase 13 (d): the W-slice of one process"
            emit({"phase": "kernel_check", **record})
            results[(subpixel.NAME, shape, dtype)] = record
    for shape, convs in K1_TRAIN_LEVELS:
        record = check_k1_gradient(shape, generator)
        record["launches_per_train_step"] = 2 * convs
        emit({"phase": "kernel_gradient_check", **record})
        results[("train", shape)] = record
    return results


def phase_path() -> None:
    emit({"phase": "path", **path_errors(
        models.PDSConfig(maximum_disparity=63), "path")})


def path_errors(config, what: str) -> dict:
    """``apply`` and ``infer`` of ``config`` at 70x90, float32, on the card
    against the same seeded weights on the CPU (plain versions)."""
    state = weights.state_dict_from_jax_params(
        weights.random_jax_params(config, seed=1))
    rng = np.random.RandomState(2)
    left = rng.uniform(0, 255, (1, 70, 90, 3)).astype(np.float32)
    right = rng.uniform(0, 255, (1, 70, 90, 3)).astype(np.float32)
    outputs = {}
    for device in ("cpu", "cuda"):
        network = models.PdsNetwork(config)
        network.load_state_dict(state)
        network.to(device)
        similarities = models.apply(network, left, right, config,
                                    device=device)
        disparity = models.infer(network, left, right, config, device=device)
        outputs[device] = (similarities.detach().cpu().numpy(),
                           disparity.cpu().numpy())
    similarity_error = float(np.abs(outputs["cuda"][0]
                                    - outputs["cpu"][0]).max())
    disparity_error = np.abs(outputs["cuda"][1] - outputs["cpu"][1])
    outside = int((disparity_error > 1e-2).sum())
    check(outside <= 0.001 * disparity_error.size,
          f"{what}: {outside} of {disparity_error.size} pixels differ by "
          "more than 1e-2 px")
    check(similarity_error <= 1e-3,
          f"{what}: similarities differ by {similarity_error}")
    return {"size": [70, 90], "maximum_disparity": 63, "dtype": "float32",
            "similarity_max_abs_err": similarity_error,
            "disparity_max_abs_err": float(disparity_error.max()),
            "pixels_outside_1e-2": outside, "pixels": disparity_error.size}


def train_path_case():
    """The train path's case: config, JAX-layout weights (numpy, seed 1),
    a 70x90 image pair and ground truth with a band of unknown rows."""
    config = models.PDSConfig(maximum_disparity=63)
    params = weights.random_jax_params(config, seed=1)
    rng = np.random.RandomState(2)
    left = rng.uniform(0, 255, (1, 70, 90, 3)).astype(np.float32)
    right = rng.uniform(0, 255, (1, 70, 90, 3)).astype(np.float32)
    ground_truth = rng.uniform(0, 60, (1, 70, 90)).astype(np.float32)
    ground_truth[:, :8] = np.inf
    return config, params, left, right, ground_truth


def gradient_errors(got: dict, exact: dict) -> dict:
    """Per tensor, r = max |got - exact| / max |exact|: the worst r, the
    five worst tensors, and the median of ||got - exact|| / ||exact||.
    Tensors whose exact gradient is below 1e-6 of the largest are left
    out: they are zero in exact arithmetic (the last transposed conv's bias
    shifts every similarity of a pixel alike, which the softmax does not
    see) and hold rounding noise."""
    floor = 1e-6 * max(float(value.abs().max()) for value in exact.values())
    kept = {name: value for name, value in exact.items()
            if float(value.abs().max()) >= floor}
    worst = sorted(((float((got[name] - value).abs().max()
                           / value.abs().max()), name)
                    for name, value in kept.items()), reverse=True)
    return {"worst": worst[0][0], "worst_tensors": worst[:5],
            "median_l2": statistics.median(
                float((got[name] - value).norm() / value.norm())
                for name, value in kept.items())}


def follow_leaky_relu_branches(network, branches=None) -> dict:
    """Forward hooks on every ``nn.LeakyReLU`` of ``network``. Without
    ``branches`` they record, per module and call, where the input is > 0
    (the branch of slope 1), and that record is returned. With
    ``branches``, such a record of another run on the same inputs, each
    call takes the recorded branches instead of its own, and the returned
    record holds per call the number of elements whose own branch differs
    and the largest |input| among them over the call's largest |input|."""
    record = {}

    def hook(module, inputs, output, name):
        x = inputs[0]
        calls = record.setdefault(name, [])
        if branches is None:
            calls.append((x > 0).cpu())
            return None
        taken = branches[name][len(calls)].to(x.device)
        flipped = (x > 0) != taken
        magnitude = x.detach().abs()
        calls.append((int(flipped.sum()), float(
            torch.where(flipped, magnitude, 0).max() / magnitude.max())))
        return torch.where(taken, x, module.negative_slope * x)

    for name, module in network.named_modules():
        if isinstance(module, torch.nn.LeakyReLU):
            module.register_forward_hook(functools.partial(hook, name=name))
    return record


def phase_train_path() -> None:
    """One ``train_step`` at 70x90, D=63, float32 (TF32 off) on the card;
    its loss against the CPU's, its gradients against the CPU's float64
    ones through the same LeakyReLU branches.

    LeakyReLU's derivative jumps from 0.1 to 1 at 0. A pre-activation
    within float32 rounding of 0 (a few of this case's 6.5 million) may
    fall on the other side in float32 than in float64, and its element
    then passes back ten times, or a tenth of, the gradient. At the deep
    levels (256 voxels per channel) one such element moves a weight
    gradient by up to 12 % of its largest element; which elements flip
    depends on each implementation's rounding. Through the card's own
    branches, the float64 gradient is what the card's float32 computes
    without rounding, and each tensor must match it within 1e-3 of its
    largest element; the branches may differ from float64's own only
    within rounding of 0."""
    config, params, left, right, ground_truth = train_path_case()
    state = weights.state_dict_from_jax_params(params)

    def run(device, dtype, branches=None):
        network = models.PdsNetwork(config)
        network.load_state_dict(state)
        network.to(device=device, dtype=dtype)
        record = follow_leaky_relu_branches(network, branches)
        rmsprop = optimizer.rmsprop(network.parameters(), LEARNING_RATE)
        kernels.launch_counts.clear()
        loss = trainer.train_step(network, rmsprop, left, right,
                                  ground_truth, LEARNING_RATE, config,
                                  compute_dtype=dtype, device=device)
        return float(loss), {
            name: None if parameter.grad is None
            else parameter.grad.detach().double().cpu()
            for name, parameter in network.named_parameters()}, dict(
                kernels.launch_counts), record

    card_loss, card, counts, branches = run("cuda", torch.float32)
    cpu_loss = run("cpu", torch.float32)[0]
    exact_loss, exact, _, flips = run("cpu", torch.float64, branches)
    own_branches = run("cpu", torch.float64)[1]
    missing = [name for name, value in card.items() if value is None]
    check(not missing, f"train_path: no gradient on the card for {missing}")
    check(all(bool(torch.isfinite(value).all()) for value in card.values()
              if value is not None), "train_path: non-finite gradient")
    check(counts.get(conv3d.NAME, 0) == 18 and not counts.get(subpixel.NAME),
          f"train_path: launches {counts}, expected 18 {conv3d.NAME}")
    loss_error = abs(card_loss - cpu_loss) / abs(cpu_loss)
    check(loss_error <= 1e-5, f"train_path: loss {card_loss} on the card, "
          f"{cpu_loss} on the CPU")
    flipped = {f"{name}#{call}": share
               for name, calls in flips.items()
               for call, (count, share) in enumerate(calls) if count}
    check(all(share <= BRANCH_FLIP_TOLERANCE for share in flipped.values()),
          f"train_path: LeakyReLU branches differ from float64's away from "
          f"0: {flipped}")
    result = {"phase": "train_path", "size": [70, 90],
              "maximum_disparity": 63, "dtype": "float32",
              "loss": {"card": card_loss, "cpu": cpu_loss,
                       "cpu_float64": exact_loss},
              "loss_relative_err": loss_error, "launches": counts,
              "leaky_relu_elements": sum(
                  int(mask.numel()) for calls in branches.values()
                  for mask in calls),
              "branches_flipped": sum(count for calls in flips.values()
                                      for count, _ in calls),
              "flipped_input_share": flipped,
              "tolerance": f"loss 1e-5 relative to the CPU's; each gradient "
                           f"tensor within {TRAIN_PATH_GRADIENT_TOLERANCE} "
                           f"of its largest element of the CPU's float64 "
                           f"one through the card's LeakyReLU branches; "
                           f"branches flipped only where |input| <= "
                           f"{BRANCH_FLIP_TOLERANCE} of the call's largest"}
    if not missing:
        errors = gradient_errors(card, exact)
        check(errors["worst"] <= TRAIN_PATH_GRADIENT_TOLERANCE,
              f"train_path: card gradients against float64: {errors}")
        result["card_vs_cpu_float64"] = errors
        # For the record: against float64's own branches.
        result["card_vs_cpu_float64_own_branches"] = gradient_errors(
            card, own_branches)
    emit(result)


def phase_serving(card: str):
    """Returns the launch counts and the median ms per request."""
    config = models.PDSConfig(maximum_disparity=MAXIMUM_DISPARITY)
    state = weights.state_dict_from_jax_params(
        weights.random_jax_params(config, seed=0))
    session = InferenceSession(state, config, compute_dtype=torch.bfloat16,
                               device="cuda")
    session.warmup(HEIGHT, WIDTH)
    rng = np.random.RandomState(0)
    images = rng.uniform(0, 255, (SERVING_REQUESTS, 2, HEIGHT, WIDTH, 3)
                         ).astype(np.float32)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.launch_counts.clear()
    request_ms, outputs = [], []
    for left, right in images:
        start = time.perf_counter()
        outputs.append(session.predict(left[None], right[None]))
        request_ms.append((time.perf_counter() - start) * 1e3)
    pair = session.predict(images[:2, 0], images[:2, 1])
    counts = dict(kernels.launch_counts)
    peak_bytes = torch.cuda.max_memory_allocated()

    served_images = SERVING_REQUESTS + 2
    for name, per_image in ((conv3d.NAME, 9), (subpixel.NAME, 1)):
        check(counts.get(name, 0) == per_image * served_images,
              f"serving: {counts.get(name, 0)} {name} launches for "
              f"{served_images} images, expected {per_image} per image")
    for output in outputs + [pair]:
        check(output.shape[1:] == (HEIGHT, WIDTH),
              f"serving: output shape {output.shape}")
        check(bool(np.isfinite(output).all()), "serving: non-finite output")
        check(float(output.min()) >= 0.0
              and float(output.max()) <= MAXIMUM_DISPARITY - 1,
              f"serving: values outside [0, {MAXIMUM_DISPARITY - 1}]")
    check(pair.shape[0] == 2, f"serving: batch-2 output shape {pair.shape}")
    batch_difference = float(np.abs(
        pair - np.concatenate(outputs[:2])).max())
    check(batch_difference == 0.0,
          f"serving: batch 2 differs from batch 1 by {batch_difference}")
    emit({"phase": "serving", "card": card,
          "size": [HEIGHT, WIDTH], "maximum_disparity": MAXIMUM_DISPARITY,
          "dtype": "bfloat16", "requests": SERVING_REQUESTS + 1,
          "images": served_images,
          "ms_per_image_median": statistics.median(request_ms),
          "ms_per_image_p90": float(np.percentile(request_ms, 90)),
          "request_ms": request_ms,
          "batch2_vs_batch1_max_abs_diff": batch_difference,
          "max_memory_allocated_bytes": peak_bytes,
          "launches": counts,
          "disparity_range": [float(min(o.min() for o in outputs)),
                              float(max(o.max() for o in outputs))]})
    return counts, statistics.median(request_ms)


def _top_kernels(profile, count: int = 10) -> list:
    """The ``count`` kernels with the most device time in ``profile``."""
    def device_us(event):
        return getattr(event, "self_device_time_total",
                       getattr(event, "self_cuda_time_total", 0.0))

    events = [event for event in profile.key_averages()
              if device_us(event) > 0]
    # The kernels themselves, not the operators that launched them.
    events = [event for event in events
              if "CUDA" in str(getattr(event, "device_type", ""))] or events
    events.sort(key=device_us, reverse=True)
    return ([{"name": event.key[:120], "calls": event.count,
              "device_ms": device_us(event) / 1e3}
             for event in events[:count]],
            sum(device_us(event) for event in events) / 1e3)


def training_arrays(seed: int = 3, device: str = "cuda"):
    """The training cell's example at 540x960: noise images and ground
    truth in [0, 200] with 40 rows unknown, as tensors on ``device``."""
    rng = np.random.RandomState(seed)
    left, right = (torch.from_numpy(rng.uniform(
        0, 255, (1, HEIGHT, WIDTH, 3)).astype(np.float32)).to(device)
        for _ in range(2))
    ground_truth = rng.uniform(0, 200, (1, HEIGHT, WIDTH)).astype(np.float32)
    ground_truth[:, 100:140] = np.inf
    return left, right, torch.from_numpy(ground_truth).to(device)


def saved_for_backward(function, top: int = 12):
    """Runs ``function`` (a train step) once and returns its result and
    what autograd saved on the card for backward, by the line of the
    package that saved it (the innermost frame in the package), each
    storage counted once: the ``top`` lines with the most bytes, and the
    total."""
    by_line, seen = {}, set()

    def pack(tensor):
        storage = tensor.untyped_storage()
        if tensor.device.type == "cuda" and storage.data_ptr() not in seen:
            seen.add(storage.data_ptr())
            frame = sys._getframe(1)
            while frame and PACKAGE not in frame.f_code.co_filename:
                frame = frame.f_back
            where = "outside the package" if frame is None else (
                f"{frame.f_code.co_filename.rsplit(PACKAGE + '/', 1)[-1]}:"
                f"{frame.f_lineno} {frame.f_code.co_name}")
            by_line[where] = by_line.get(where, 0) + storage.nbytes()
        return tensor

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        result = function()
    ranked = sorted(by_line.items(), key=lambda item: -item[1])
    return result, {"total_bytes": sum(by_line.values()),
                    "by_line_bytes": dict(ranked[:top]),
                    "other_lines_bytes": sum(size for _, size
                                             in ranked[top:])}


def phase_training(card: str):
    """The reference training configuration at full size; then the eval
    step and a checkpoint written and read back. Returns the launch counts,
    the median ms per step and the first (warm-up) step's loss."""
    config = models.PDSConfig(maximum_disparity=TRAIN_MAXIMUM_DISPARITY)
    network = models.PdsNetwork(config)
    network.load_state_dict(weights.state_dict_from_jax_params(
        weights.random_jax_params(config, seed=0)))
    network.cuda()
    rmsprop = optimizer.rmsprop(network.parameters(), LEARNING_RATE)
    left, right, ground_truth = training_arrays()

    def step():
        return trainer.train_step(network, rmsprop, left, right,
                                  ground_truth, LEARNING_RATE, config,
                                  compute_dtype=torch.bfloat16,
                                  device="cuda")

    first_loss, saved = saved_for_backward(step)
    first_loss = float(first_loss)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches = {"train": {}, "eval": {}}
    step_ms, losses = [], []
    for _ in range(TRAIN_STEPS):
        kernels.launch_counts.clear()
        start = time.perf_counter()
        loss = step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - start) * 1e3)
        counts = dict(kernels.launch_counts)
        for name, value in counts.items():
            launches["train"][name] = launches["train"].get(name, 0) + value
        check(counts.get(conv3d.NAME, 0) == 18,
              f"training: {counts} launches in one step, expected 18 "
              f"{conv3d.NAME}")
        losses.append(float(loss))
        check(np.isfinite(losses[-1]), f"training: loss {losses[-1]}")
        check(all(parameter.grad is not None
                  and parameter.grad.dtype == torch.float32
                  and bool(torch.isfinite(parameter.grad).all())
                  for parameter in network.parameters()),
              "training: a gradient is missing, not float32 or not finite")
    peak_bytes = torch.cuda.max_memory_allocated()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as profile:
        start = time.perf_counter()
        step()
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - start) * 1e3
    top_kernels, device_ms = _top_kernels(profile)
    emit({"phase": "training", "card": card, "size": [HEIGHT, WIDTH],
          "maximum_disparity": TRAIN_MAXIMUM_DISPARITY,
          "compute_dtype": "bfloat16", "batch": 1,
          "learning_rate": LEARNING_RATE, "steps": TRAIN_STEPS,
          "ms_per_step_median": statistics.median(step_ms),
          "step_ms": step_ms, "losses": losses,
          "max_memory_allocated_bytes": peak_bytes,
          "first_step_saved_for_backward": saved,
          "launches": launches["train"],
          "profiled_step": {"wall_ms": profiled_ms,
                            "kernel_ms": device_ms,
                            "top_kernels": top_kernels}})

    kernels.launch_counts.clear()
    torch.cuda.synchronize()
    start = time.perf_counter()
    disparity, error_map, three_pixels_error, mean_absolute_error = (
        trainer.eval_step(network, left, right, ground_truth, config,
                          compute_dtype=torch.bfloat16, device="cuda"))
    torch.cuda.synchronize()
    eval_ms = (time.perf_counter() - start) * 1e3
    launches["eval"] = dict(kernels.launch_counts)
    check(launches["eval"] == {conv3d.NAME: 9, subpixel.NAME: 1},
          f"eval: launches {launches['eval']}, expected 9 {conv3d.NAME} and "
          f"1 {subpixel.NAME}")
    check(tuple(disparity.shape) == (1, HEIGHT, WIDTH)
          and tuple(error_map.shape) == (1, HEIGHT, WIDTH),
          f"eval: shapes {tuple(disparity.shape)}, {tuple(error_map.shape)}")
    metrics = [float(three_pixels_error[0]), float(mean_absolute_error[0])]
    check(bool(torch.isfinite(disparity).all()) and all(
        np.isfinite(metrics)) and 0.0 <= metrics[0] <= 100.0
        and metrics[1] >= 0.0, f"eval: disparity or metrics {metrics}")
    emit({"phase": "eval", "size": [HEIGHT, WIDTH],
          "maximum_disparity": TRAIN_MAXIMUM_DISPARITY,
          "compute_dtype": "bfloat16", "ms": eval_ms,
          "three_pixels_error": metrics[0], "mean_absolute_error": metrics[1],
          "launches": launches["eval"]})

    SCRATCH.mkdir(parents=True, exist_ok=True)
    path = str(SCRATCH / f"{len(losses):03d}_checkpoint.npz")
    checkpoint.save_training_state(path, network, rmsprop,
                                   trainer.checkpoint_metadata(
                                       config, [np.mean(losses)]))
    restored = models.PdsNetwork(config).cuda()
    restored_rmsprop = optimizer.rmsprop(restored.parameters(),
                                         LEARNING_RATE)
    metadata = checkpoint.load_training_state(path, restored,
                                              restored_rmsprop)
    written = checkpoint.training_trees(network, rmsprop)
    read = checkpoint.training_trees(restored, restored_rmsprop)
    leaves = [(a, b) for name in ("params", "opt_state")
              for a, b in zip(checkpoint.tree_leaves(written[name]),
                              checkpoint.tree_leaves(read[name]))]
    check(len(leaves) == 2 * sum(1 for _ in network.parameters())
          and all(np.array_equal(a, b) for a, b in leaves),
          "checkpoint: a leaf read back differs from the one written")
    steps = {int(entry["step"]) for entry in restored_rmsprop.state.values()}
    check(steps == {TRAIN_STEPS + 2} and metadata["rmsprop_step"]
          == TRAIN_STEPS + 2, f"checkpoint: RMSprop steps {steps}")
    emit({"phase": "checkpoint", "file_bytes": pathlib.Path(path).stat(
          ).st_size, "leaves": len(leaves), "rmsprop_step": sorted(steps)})
    pathlib.Path(path).unlink()
    return launches, statistics.median(step_ms), first_loss


def write_flyingthings3d_tree(root: pathlib.Path) -> dict:
    """:data:`FLYINGTHINGS3D_EXAMPLES` at 960x540 under ``root``: noise
    images (Paeth-filtered PNG rows) and disparities in [0, 200] but for
    the kinds named. Returns left image path -> (left, right, disparity)
    as written."""
    written = {}
    for index, (scene, frame, kind) in enumerate(FLYINGTHINGS3D_EXAMPLES):
        rng = np.random.RandomState(100 + index)
        left, right = (rng.randint(0, 256, (HEIGHT, WIDTH, 3)).astype(
            np.uint8) for _ in range(2))
        disparity = rng.uniform(0, 200, (HEIGHT, WIDTH)).astype(np.float32)
        if kind == "above 255":
            disparity[:10] = 300.0
        elif kind == "30 % at 350":
            disparity[rng.uniform(size=disparity.shape) < 0.3] = 350.0
        images = root / "frames_cleanpass" / scene
        for side, image in (("left", left), ("right", right)):
            (images / side).mkdir(parents=True, exist_ok=True)
            png.write_png(str(images / side / f"{frame}.png"), image,
                          filter_type=4)
        disparities = root / "disparity" / scene / "left"
        disparities.mkdir(parents=True, exist_ok=True)
        pfm.write_pfm(str(disparities / f"{frame}.pfm"), disparity)
        written[str(images / "left" / f"{frame}.png")] = (left, right,
                                                          disparity)
    return written


def write_kitti_tree(root: pathlib.Path) -> dict:
    """2 KITTI 2012 and 2 KITTI 2015 training examples and 2 KITTI 2015
    testing pairs at 1242x375: noise images, 16-bit ground truth
    (disparity * 256, a third of it 0 = unknown), a reflective map with a
    band of values for 2012 example 0 (all unknown for example 1). Returns
    testing left image path -> (left, right)."""
    written = {}
    folders = {"2012": ("data_stereo_flow", "colored_0", "colored_1",
                        "disp_occ"),
               "2015": ("data_scene_flow", "image_2", "image_3",
                        "disp_occ_0")}
    for year, (top, left_folder, right_folder, truth) in folders.items():
        for split in ("training", "testing"):
            if year == "2012" and split == "testing":
                continue
            base = root / top / split
            for name in (left_folder, right_folder, truth,
                         "disp_refl_occ"):
                (base / name).mkdir(parents=True, exist_ok=True)
            for index in range(2):
                rng = np.random.RandomState(200 + 10 * index + len(written)
                                            + (year == "2015"))
                basename = f"{index:06d}_10.png"
                left, right = (rng.randint(0, 256, (
                    KITTI_HEIGHT, KITTI_WIDTH, 3)).astype(np.uint8)
                    for _ in range(2))
                png.write_png(str(base / left_folder / basename), left,
                              filter_type=4)
                png.write_png(str(base / right_folder / basename), right,
                              filter_type=4)
                if split == "testing":
                    written[str(base / left_folder / basename)] = (left,
                                                                   right)
                    continue
                encoded = (rng.uniform(1, 230, (KITTI_HEIGHT, KITTI_WIDTH))
                           * 256).astype(np.uint16)
                encoded[rng.uniform(size=encoded.shape) < 1 / 3] = 0
                png.write_png(str(base / truth / basename), encoded)
                if year == "2012":
                    reflective = np.zeros_like(encoded)
                    if index == 0:
                        reflective[100:140] = 77 * 256
                    png.write_png(str(base / "disp_refl_occ" / basename),
                                  reflective)
    return written


def phase_dataset() -> dict:
    """Writes the trees and checks the splits the port makes of them."""
    start = time.perf_counter()
    flyingthings3d = SCRATCH / "datasets" / "flyingthings3d"
    kitti = SCRATCH / "datasets" / "kitti"
    written = write_flyingthings3d_tree(flyingthings3d)
    kitti_written = write_kitti_tree(kitti)
    write_s = time.perf_counter() - start
    training, validation = FlyingThings3D.training_split(
        str(flyingthings3d), number_of_validation_examples=1,
        maximum_disparity=TRAIN_MAXIMUM_DISPARITY)
    psm = FlyingThings3D.benchmark_dataset(str(flyingthings3d), True)
    crl = FlyingThings3D.benchmark_dataset(str(flyingthings3d), False)
    kitti_training, kitti_validation = Kitti.training_split(
        str(kitti), number_of_validation_examples=1)
    sizes = {"training": len(training), "validation": len(validation),
             "psm": len(psm), "crl": len(crl),
             "kitti_training": len(kitti_training),
             "kitti_validation": len(kitti_validation),
             "kitti2015_testing": len(Kitti.kitti2015_benchmark(str(kitti)))}
    expected = {"training": 3, "validation": 1, "psm": 2, "crl": 1,
                "kitti_training": 3, "kitti_validation": 1,
                "kitti2015_testing": 2}
    check(sizes == expected, f"dataset: split sizes {sizes}, expected "
          f"{expected}")
    decode_ms = []
    for index in range(len(training)):
        begin = time.perf_counter()
        example = training.get_example(index)
        decode_ms.append((time.perf_counter() - begin) * 1e3)
        left, right, disparity = written[
            training.example_files(index)["left"]["image"]]
        check(np.array_equal(example["left"]["image"], left)
              and np.array_equal(example["right"]["image"], right)
              and np.array_equal(example["left"]["disparity_image"],
                                 disparity),
              f"dataset: training example {index} reads back otherwise "
              "than it was written")
    # One 960x540 RGB image, rows filtered with None and with Paeth, by
    # each decoder this machine has; and a whole example by numpy's.
    image = next(iter(written.values()))[0]
    decoders = sorted({"numpy", png.default_decoder()})
    filter_ms = {decoder: {} for decoder in decoders}
    for name, filter_type in (("none", 0), ("paeth", 4)):
        path = str(SCRATCH / f"decode_{name}.png")
        png.write_png(path, image, filter_type=filter_type)
        for decoder in decoders:
            begin = time.perf_counter()
            for _ in range(3):
                decoded = png.read_png(path, decoder=decoder)
            filter_ms[decoder][name] = (time.perf_counter() - begin) / 3 * 1e3
            check(np.array_equal(decoded, image), f"dataset: {name}-filtered "
                  f"PNG decodes otherwise than written ({decoder})")
    numpy_example_ms = []
    for index in range(len(training)):
        files = training.example_files(index)
        begin = time.perf_counter()
        for side in ("left", "right"):
            png.read_png(files[side]["image"], decoder="numpy")
        pfm.read_pfm(files["left"]["disparity_image"])
        numpy_example_ms.append((time.perf_counter() - begin) * 1e3)
    emit({"phase": "dataset", "seconds": time.perf_counter() - start,
          "write_s": write_s, "sizes": sizes,
          "flyingthings3d_size": [HEIGHT, WIDTH],
          "kitti_size": [KITTI_HEIGHT, KITTI_WIDTH],
          "png_decoder": png.default_decoder(),
          "decode_ms_per_example": decode_ms,
          "decode_ms_per_example_numpy_decoder": numpy_example_ms,
          "decode_ms_per_image_by_decoder_and_filter": filter_ms})
    return {"flyingthings3d": flyingthings3d, "kitti": kitti,
            "written": written, "kitti_written": kitti_written}


def without_opencv(function):
    """``function()`` as on a machine without OpenCV: ``cv2`` does not
    import, so the PNG decoder in use is numpy's."""
    saved = sys.modules.get("cv2")
    sys.modules["cv2"] = None  # ``import cv2`` raises ImportError
    png.default_decoder.cache_clear()
    try:
        check(png.default_decoder() == "numpy",
              "without OpenCV, the PNG decoder is not numpy's")
        return function()
    finally:
        if saved is None:
            del sys.modules["cv2"]
        else:
            sys.modules["cv2"] = saved
        png.default_decoder.cache_clear()


def _expect_launches(counts: dict, k1: int, k2: int, what: str) -> None:
    check(counts.get(conv3d.NAME, 0) == k1
          and counts.get(subpixel.NAME, 0) == k2,
          f"{what}: launches {counts}, expected {k1} {conv3d.NAME} and "
          f"{k2} {subpixel.NAME}")


def _decodes(path: pathlib.Path) -> bool:
    return path.is_file() and png.read_png(str(path)).ndim == 3


def busy_share(profile, range_name: str):
    """Share of the last ``range_name`` range's wall time in which the card
    ran something (kernels, copies), from the profiler's events: the union
    of the device intervals that start inside the range over its length.
    None when the trace has no such range."""
    events = profile.events()
    ranges = [event for event in events if event.name == range_name
              and event.device_type == torch.autograd.DeviceType.CPU]
    if not ranges:
        return None
    start, end = ranges[-1].time_range.start, ranges[-1].time_range.end
    intervals = sorted(
        (event.time_range.start, min(event.time_range.end, end))
        for event in events
        if event.device_type == torch.autograd.DeviceType.CUDA
        and event.name != range_name
        and start <= event.time_range.start < end)
    busy, reach = 0.0, start
    for first, last in intervals:
        busy += max(0.0, last - max(first, reach))
        reach = max(reach, last)
    return busy / (end - start)


def phase_trainer(dataset: dict, bare_step_ms: float):
    """The training CLI, one epoch and a resumed second. Returns the launch
    counts, the direct ``train_step``'s loss on the first batch and the
    loop's median ms per step in epoch 2."""
    start = time.perf_counter()
    experiment = SCRATCH / "experiments" / "flyingthings3d"
    arguments = ["--dataset_folder", str(dataset["flyingthings3d"]),
                 "--maximum_disparity", str(TRAIN_MAXIMUM_DISPARITY),
                 "--bfloat16", "--number_of_validation_examples", "1",
                 "--device", "cuda"]
    first_checkpoint = experiment / "001_checkpoint.npz"
    kernels.launch_counts.clear()
    first = train_flyingthings3d.main(arguments + [
        "--experiment_folder", str(experiment), "--end_epoch", "1"])
    launches = dict(kernels.launch_counts)
    kernels.launch_counts.clear()
    second = train_flyingthings3d.main(arguments + [
        "--experiment_folder", str(experiment), "--end_epoch", "2",
        "--checkpoint_file", str(first_checkpoint)])
    resumed = dict(kernels.launch_counts)
    for name, value in resumed.items():
        launches[name] = launches.get(name, 0) + value
    # Per run: 3 train steps (18 K1 each) and one validation image with
    # its untimed warm-up (9 K1 + 1 K2 each).
    _expect_launches(launches, 2 * (3 * 18 + 2 * 9), 2 * 2,
                     "trainer, both runs")
    losses = second.training_losses
    check(len(losses) == 2 and all(np.isfinite(losses))
          and second.current_epoch == 2,
          f"trainer: epoch losses {losses}, epoch {second.current_epoch}")
    check(first_checkpoint.is_file()
          and (experiment / "002_checkpoint.npz").is_file(),
          "trainer: a checkpoint is missing")
    log = (experiment / "log.txt").read_text()
    check(all(line in log for line in (
        "epoch 01 (01) : training loss = ", "epoch 02 (02) : training loss = ",
        "epoch 02 (02) : training: 00003 (00003)")),
        f"trainer: log.txt lacks an epoch line:\n{log}")
    dumps = [experiment / name for name in (
        "plot.png", "example_0001_image.png",
        "example_0001_disparity_ground_truth.png",
        "example_0001_disparity_epoch_002.png",
        "example_0001_error_map_epoch_002.png")]
    check(all(_decodes(path) for path in dumps),
          f"trainer: a dump is missing or does not decode: {dumps}")

    # The first step, taken directly on the arrays that were written.
    config = models.PDSConfig(maximum_disparity=TRAIN_MAXIMUM_DISPARITY)
    training, _ = FlyingThings3D.training_split(
        str(dataset["flyingthings3d"]), number_of_validation_examples=1,
        maximum_disparity=TRAIN_MAXIMUM_DISPARITY)
    order = Loader(training, shuffle=True).epoch_indices()
    left, right, disparity = dataset["written"][
        training.example_files(order[0])["left"]["image"]]
    network = common.initial_network(config).cuda()
    direct = float(trainer.train_step(
        network, optimizer.rmsprop(network.parameters(), LEARNING_RATE),
        left[None].astype(np.float32), right[None].astype(np.float32),
        disparity[None], LEARNING_RATE, config, torch.bfloat16, device="cuda"))
    first_loss_error = abs(first.step_losses[0] - direct) / abs(direct)
    check(first_loss_error <= FIRST_LOSS_TOLERANCE,
          f"trainer: first step loss {first.step_losses[0]}, direct "
          f"train_step {direct}")

    # Epoch 2 again, profiled, into another folder.
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as profile:
        profiled = train_flyingthings3d.main(arguments + [
            "--experiment_folder", str(experiment.with_name("profiled")),
            "--end_epoch", "2", "--checkpoint_file", str(first_checkpoint)])
    busy = busy_share(profile, "PDSTrainer.train_epoch")
    # Epoch 2 again with numpy's PNG decoder.
    numpy_folder = experiment.with_name("numpy_decoder")
    decoded_by_numpy = without_opencv(lambda: train_flyingthings3d.main(
        arguments + ["--experiment_folder", str(numpy_folder),
                     "--end_epoch", "2", "--checkpoint_file",
                     str(first_checkpoint)]))
    check("PNG decoder: numpy" in (numpy_folder / "log.txt").read_text(),
          "trainer: the run without OpenCV did not log the numpy decoder")
    emit({"phase": "trainer", "seconds": time.perf_counter() - start,
          "size": [HEIGHT, WIDTH],
          "maximum_disparity": TRAIN_MAXIMUM_DISPARITY,
          "compute_dtype": "bfloat16", "epoch_losses": losses,
          "first_step_loss": {"trainer": first.step_losses[0],
                              "direct_train_step": direct,
                              "relative_err": first_loss_error,
                              "tolerance": FIRST_LOSS_TOLERANCE},
          "step_ms_epoch2": second.step_ms,
          "loop_ms_per_step_median": statistics.median(
              second.step_ms[1:]),
          "bare_train_step_ms_median": bare_step_ms,
          "loader_wait_ms_epoch2": second.loader_wait_ms,
          "validation_ms_per_image": second.processing_time * 1e3,
          "png_decoder": png.default_decoder(),
          "profiled_epoch2": {"step_ms": profiled.step_ms,
                              "device_busy_share": busy},
          "numpy_decoder_epoch2": {
              "step_ms": decoded_by_numpy.step_ms,
              "loader_wait_ms": decoded_by_numpy.loader_wait_ms,
              "validation_ms_per_image":
                  decoded_by_numpy.processing_time * 1e3},
          "launches": launches})
    return launches, direct, statistics.median(second.step_ms[1:])


def phase_benchmark(dataset: dict, serving_ms: float):
    """The benchmark CLI under PSM and CRL at D=191."""
    start = time.perf_counter()
    launches, results = {}, {}
    for protocol, images in (("psm", 2), ("crl", 1)):
        kernels.launch_counts.clear()
        errors, seconds = benchmark_flyingthings3d.main(
            ["--dataset_folder", str(dataset["flyingthings3d"]),
             "--experiment_folder", str(SCRATCH / "experiments" / protocol),
             "--checkpoint_file", str(SCRATCH / "experiments"
                                      / "flyingthings3d"
                                      / "002_checkpoint.npz"),
             "--maximum_disparity", str(MAXIMUM_DISPARITY), "--bfloat16",
             "--device", "cuda"]
            + (["--is_psm_protocol"] if protocol == "psm" else []))
        counts = dict(kernels.launch_counts)
        _expect_launches(counts, 9 * (images + 1), images + 1,
                         f"benchmark {protocol}")
        for name, value in counts.items():
            launches[name] = launches.get(name, 0) + value
        check(np.isfinite(errors["mean_absolute_error"])
              and 0.0 <= errors["three_pixels_error"] <= 100.0,
              f"benchmark {protocol}: errors {errors}")
        results[protocol] = {"examples": images, **errors,
                             "ms_per_image": seconds * 1e3}
    emit({"phase": "benchmark", "seconds": time.perf_counter() - start,
          "size": [HEIGHT, WIDTH], "maximum_disparity": MAXIMUM_DISPARITY,
          "compute_dtype": "bfloat16", "results": results,
          "serving_ms_per_image_median": serving_ms, "launches": launches})
    return launches


def phase_kitti(dataset: dict):
    """The KITTI fine-tune and submission CLIs."""
    start = time.perf_counter()
    experiments = SCRATCH / "experiments"
    kernels.launch_counts.clear()
    finetuned = finetune_kitti.main(
        ["--dataset_folder", str(dataset["kitti"]),
         "--experiment_folder", str(experiments / "kitti"),
         "--checkpoint_file",
         str(experiments / "flyingthings3d" / "002_checkpoint.npz"),
         "--end_epoch", "1", "--maximum_disparity", "255", "--bfloat16",
         "--number_of_validation_examples", "1", "--device", "cuda"])
    launches = dict(kernels.launch_counts)
    _expect_launches(launches, 3 * 18 + 2 * 9, 2, "kitti fine-tune")
    finetuned_checkpoint = experiments / "kitti" / "001_checkpoint.npz"
    check(finetuned_checkpoint.is_file()
          and len(finetuned.training_losses) == 1
          and np.isfinite(finetuned.training_losses[0]),
          f"kitti: fine-tune losses {finetuned.training_losses}")
    kernels.launch_counts.clear()
    seconds = export_kitti_submission.main(
        ["--dataset_folder", str(dataset["kitti"]),
         "--experiment_folder", str(experiments / "submission"),
         "--checkpoint_file", str(finetuned_checkpoint),
         "--benchmark", "2015", "--bfloat16", "--device", "cuda"])
    exported = dict(kernels.launch_counts)
    _expect_launches(exported, 9 * 3, 3, "kitti export")
    for name, value in exported.items():
        launches[name] = launches.get(name, 0) + value

    config = models.PDSConfig(maximum_disparity=255)
    network = models.PdsNetwork(config)
    checkpoint.load_training_state(str(finetuned_checkpoint), network)
    network.cuda()
    differences = {}
    for path, (left, right) in dataset["kitti_written"].items():
        name = pathlib.Path(path).name
        decoded = png.read_png(
            str(experiments / "submission" / "submission" / name),
            "unchanged")
        disparity = models.infer(network, left[None].astype(np.float32),
                                 right[None].astype(np.float32), config,
                                 torch.bfloat16, "cuda")[0].cpu().numpy()
        expected = np.clip(disparity * 256.0, 0, 65535).astype(np.uint16)
        check(decoded.dtype == np.uint16
              and decoded.shape == (KITTI_HEIGHT, KITTI_WIDTH),
              f"kitti: {name} is {decoded.dtype} {decoded.shape}")
        differences[name] = int(np.abs(decoded.astype(np.int64)
                                       - expected).max())
        check(differences[name] == 0, f"kitti: {name} differs from a "
              f"direct infer by {differences[name]} / 256 px")
    emit({"phase": "kitti", "seconds": time.perf_counter() - start,
          "finetune": {"size": [384, 1280], "maximum_disparity": 255,
                       "loss": finetuned.training_losses,
                       "validation_ms_per_image":
                           finetuned.processing_time * 1e3},
          "export": {"size": [KITTI_HEIGHT, KITTI_WIDTH],
                     "ms_per_image": seconds * 1e3,
                     "max_difference_from_direct_infer": differences},
          "launches": launches})
    return launches


def check_int8_conv(generator) -> list:
    """The matching tail's int8 conv at 540x960, D=191, against the exact
    float32 emulation; times beside the bfloat16 conv it replaces."""
    entries, channels, height, width = INT8_SHAPE
    x = torch.randint(-127, 128, INT8_SHAPE, device="cuda",
                      generator=generator, dtype=torch.int8)
    activations = torch.randn(INT8_SHAPE, device="cuda", generator=generator
                              ).bfloat16()
    rows, depth = entries * height * width, 9 * channels
    columns = torch.randint(-127, 128, (rows, depth), device="cuda",
                            generator=generator, dtype=torch.int8)
    records = []
    for cout in INT8_OUTPUTS:
        weight = torch.randint(-127, 128, (cout, channels, 3, 3),
                               device="cuda", generator=generator,
                               dtype=torch.int8)
        got = int8.int8_conv3x3(x, weight)
        # int8 values and their products and sums (|sum| <= 127 * 127 *
        # 576 < 2^24) are exact in float32: with TF32 off this conv is the
        # int32 result. (A bfloat16 conv would round its output to 8 bits.)
        exact = F.conv2d(x.float(), weight.float(), padding=1).permute(
            0, 2, 3, 1)
        torch.cuda.synchronize()
        error = float((got.float() - exact).abs().max())
        check(got.dtype == torch.int32 and torch.equal(got.float(), exact),
              f"options: int8 conv 64 -> {cout} differs from the exact "
              f"float32 emulation by {error}")
        float_weight = weight.float() / 127.0 * 0.05
        bias = torch.zeros(cout, device="cuda")
        taps = weight.permute(2, 3, 1, 0).reshape(depth, cout).contiguous()
        records.append({
            "shape": list(INT8_SHAPE), "cout": cout, "max_abs_err": error,
            "tolerance": "bit-equal to the float32 emulation (TF32 off)",
            "int8_conv_ms": time_ms(lambda: int8.int8_conv3x3(x, weight),
                                    runs=10, calls=3),
            "int_mm_ms": time_ms(lambda: torch._int_mm(columns, taps),
                                 runs=10, calls=3),
            "quantized_conv_ms": time_ms(lambda: int8.quantized_conv(
                float_weight, bias, activations), runs=10, calls=3),
            "bfloat16_conv_ms": time_ms(lambda: F.conv2d(
                activations, float_weight.bfloat16(), bias.bfloat16(),
                padding=1), runs=10, calls=3),
            "emulation_ms": time_ms(lambda: F.conv2d(
                x.float(), weight.float(), padding=1), runs=10, calls=3),
            # The GEMM's: its int8 operands read once, int32 written once.
            "int_mm_bound": bound(rows * depth + depth * cout
                                  + 4 * rows * cout,
                                  2.0 * rows * depth * cout, torch.int8)})
    return records


def serve(session, images) -> tuple:
    """16 timed requests after a warm-up: (maps, ms per request, peak
    bytes, launch counts)."""
    session.warmup(HEIGHT, WIDTH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.launch_counts.clear()
    request_ms, outputs = [], []
    for left, right in images:
        start = time.perf_counter()
        outputs.append(session.predict(left[None], right[None]))
        request_ms.append((time.perf_counter() - start) * 1e3)
    return (np.concatenate(outputs), request_ms,
            torch.cuda.max_memory_allocated(), dict(kernels.launch_counts))


def phase_options(card: str):
    """Serving under each option and train steps under each remat policy.
    Returns the launch counts and the ms of each configuration."""
    start = time.perf_counter()
    launches, milliseconds = {}, {}

    def count(counts):
        for name, value in counts.items():
            launches[name] = launches.get(name, 0) + value

    int8_records = check_int8_conv(
        torch.Generator(device="cuda").manual_seed(11))
    config = models.PDSConfig(maximum_disparity=MAXIMUM_DISPARITY)
    state = weights.state_dict_from_jax_params(
        weights.random_jax_params(config, seed=0))
    images = np.random.RandomState(0).uniform(
        0, 255, (SERVING_REQUESTS, 2, HEIGHT, WIDTH, 3)).astype(np.float32)
    serving, reference = {}, None
    for name, overrides in OPTION_CONFIGS.items():
        config = models.PDSConfig(maximum_disparity=MAXIMUM_DISPARITY,
                                  **overrides)
        session = InferenceSession(state, config,
                                   compute_dtype=torch.bfloat16,
                                   device="cuda")
        maps, request_ms, peak_bytes, counts = serve(session, images)
        del session
        count(counts)
        _expect_launches(counts, 9 * SERVING_REQUESTS, SERVING_REQUESTS,
                         f"options serving {name}")
        check(bool(np.isfinite(maps).all()) and float(maps.min()) >= 0.0
              and float(maps.max()) <= MAXIMUM_DISPARITY - 1,
              f"options serving {name}: maps non-finite or out of range")
        reference = maps if reference is None else reference
        difference = np.abs(maps - reference)
        milliseconds[name] = statistics.median(request_ms)
        serving[name] = {
            "ms_per_image_median": milliseconds[name],
            "ms_per_image_p90": float(np.percentile(request_ms, 90)),
            "max_memory_allocated_bytes": peak_bytes, "launches": counts,
            "mean_abs_diff_from_default_px": float(difference.mean()),
            "share_above_3px_from_default": float((difference > 3).mean())}
        if name in EXACT_OPTIONS:
            serving[name]["path"] = path_errors(
                models.PDSConfig(maximum_disparity=63, **overrides),
                f"options {name} path")
    training, gradients = {}, {}
    left, right, ground_truth = training_arrays()
    initial = weights.state_dict_from_jax_params(weights.random_jax_params(
        models.PDSConfig(maximum_disparity=TRAIN_MAXIMUM_DISPARITY), seed=0))

    def network_for(config):
        network = models.PdsNetwork(config)
        network.load_state_dict(initial)
        return network.cuda()

    # One step's gradients from the same weights, with cuDNN's
    # deterministic algorithms: the recompute repeats the same forward.
    torch.backends.cudnn.deterministic = True
    for name in ("off", "off_again", "selective", "all"):
        config = models.PDSConfig(
            maximum_disparity=TRAIN_MAXIMUM_DISPARITY,
            remat=REMAT_POLICIES[name.replace("_again", "")][0])
        network = network_for(config)
        loss_value = trainer.loss_and_gradients(
            network, left, right, ground_truth, config, torch.bfloat16,
            device="cuda")
        gradients[name] = (float(loss_value), {
            key: parameter.grad for key, parameter
            in network.named_parameters()})
    torch.backends.cudnn.deterministic = False
    differences = {}
    for name in ("off_again", "selective", "all"):
        loss_value, tensors = gradients[name]
        differences[name] = {
            "loss_abs_diff": abs(loss_value - gradients["off"][0]),
            "max_abs_gradient_diff": max(
                float((tensor - gradients["off"][1][key]).abs().max())
                for key, tensor in tensors.items()),
            "bit_equal": loss_value == gradients["off"][0] and all(
                torch.equal(tensor, gradients["off"][1][key])
                for key, tensor in tensors.items())}
        check(differences[name]["bit_equal"], f"options remat {name}: loss "
              f"or gradients differ from remat off's: {differences[name]}")
    del gradients
    for name, (policy, k1_per_step) in REMAT_POLICIES.items():
        config = models.PDSConfig(maximum_disparity=TRAIN_MAXIMUM_DISPARITY,
                                  remat=policy)
        network = network_for(config)
        rmsprop = optimizer.rmsprop(network.parameters(), LEARNING_RATE)

        def step():
            return trainer.train_step(network, rmsprop, left, right,
                                      ground_truth, LEARNING_RATE, config,
                                      compute_dtype=torch.bfloat16,
                                      device="cuda")

        step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step_ms, losses = [], []
        for _ in range(TRAIN_STEPS):
            kernels.launch_counts.clear()
            begin = time.perf_counter()
            losses.append(float(step()))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - begin) * 1e3)
            counts = dict(kernels.launch_counts)
            count(counts)
            check(counts.get(conv3d.NAME, 0) == k1_per_step
                  and not counts.get(subpixel.NAME),
                  f"options remat {name}: launches {counts} in one step, "
                  f"expected {k1_per_step} {conv3d.NAME}")
        check(all(np.isfinite(losses)), f"options remat {name}: losses "
              f"{losses}")
        milliseconds[f"train_remat_{name}"] = statistics.median(step_ms)
        training[name] = {
            "ms_per_step_median": milliseconds[f"train_remat_{name}"],
            "step_ms": step_ms, "losses": losses,
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "k1_per_step": k1_per_step}
        del network, rmsprop
    emit({"phase": "options", "card": card,
          "seconds": time.perf_counter() - start,
          "int8_conv": int8_records,
          "serving": {"size": [HEIGHT, WIDTH],
                      "maximum_disparity": MAXIMUM_DISPARITY,
                      "dtype": "bfloat16", "requests": SERVING_REQUESTS,
                      "configurations": serving},
          "training": {"size": [HEIGHT, WIDTH],
                       "maximum_disparity": TRAIN_MAXIMUM_DISPARITY,
                       "compute_dtype": "bfloat16", "batch": 1,
                       "steps": TRAIN_STEPS, "remat": training,
                       "gradients_against_remat_off": differences},
          "launches": launches})
    return launches, milliseconds

def _free_port() -> int:
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        return probe.getsockname()[1]


def parallel_pair_case():
    """Phase 4's case with a second example, one per process: config,
    weights, and batches of 2 whose examples have 720 and 2700 unknown
    pixels."""
    config, params, left, right, ground_truth = train_path_case()
    rng = np.random.RandomState(4)
    second = [rng.uniform(0, 255, (1, 70, 90, 3)).astype(np.float32)
              for _ in range(2)]
    truth = rng.uniform(0, 60, (1, 70, 90)).astype(np.float32)
    truth[:, 40:] = np.inf
    return (config, params, np.concatenate([left, second[0]]),
            np.concatenate([right, second[1]]),
            np.concatenate([ground_truth, truth]))


def validation_examples() -> list:
    """Three 540x960 examples with 100 %, 60 % and 25 % of their ground
    truth known, for a ``Loader``."""
    rng = np.random.RandomState(20)
    examples = []
    for share in (1.0, 0.6, 0.25):
        disparity = rng.uniform(0, 200, (HEIGHT, WIDTH)).astype(np.float32)
        disparity[rng.uniform(size=disparity.shape) > share] = np.inf
        examples.append({
            "left": {"image": rng.uniform(0, 255, (HEIGHT, WIDTH, 3)).astype(
                np.float32), "disparity_image": disparity},
            "right": {"image": rng.uniform(0, 255, (HEIGHT, WIDTH, 3))
                      .astype(np.float32)}})
    return examples


def _parameters(network) -> dict:
    return {name: parameter.detach().clone()
            for name, parameter in network.named_parameters()}


def _gradients_of(network) -> dict:
    return {name: parameter.grad.detach().double().cpu()
            for name, parameter in network.named_parameters()}


def deterministic_step() -> tuple:
    """Phase 6's example, cuDNN's deterministic algorithms: one
    ``train_step`` from the first weights; (loss, ms, gradients, updated
    weights)."""
    config = models.PDSConfig(maximum_disparity=TRAIN_MAXIMUM_DISPARITY)
    left, right, ground_truth = training_arrays()
    torch.backends.cudnn.deterministic = True
    try:
        network = common.initial_network(config).cuda()
        rmsprop = optimizer.rmsprop(network.parameters(), LEARNING_RATE)
        torch.cuda.synchronize()
        begin = time.perf_counter()
        value = trainer.train_step(network, rmsprop, left, right,
                                   ground_truth, LEARNING_RATE, config,
                                   torch.bfloat16, device="cuda")
        torch.cuda.synchronize()
        return (float(value), (time.perf_counter() - begin) * 1e3,
                {key: parameter.grad.clone() for key, parameter
                 in network.named_parameters()}, _parameters(network))
    finally:
        torch.backends.cudnn.deterministic = False


def compare_steps(alone: tuple, in_group: tuple) -> dict:
    """``train_step`` in the world-1 NCCL group (its count, gradients and
    loss summed through NCCL) against ``train_step`` with no group (every
    collective the identity): loss, gradients and updated weights bit for
    bit."""
    (loss_a, ms_a, gradients_a, weights_a), (loss_b, ms_b, gradients_b,
                                             weights_b) = alone, in_group
    equal = (loss_a == loss_b
             and all(torch.equal(gradients_a[key], gradients_b[key])
                     for key in gradients_a)
             and all(torch.equal(weights_a[key], weights_b[key])
                     for key in weights_a))
    check(equal, f"parallel: train_step in the world-1 NCCL group differs "
          f"from train_step with no group (loss {loss_b} vs {loss_a})")
    return {"bit_equal": equal, "loss": loss_b, "no_group_step_ms": ms_a,
            "nccl_world_1_step_ms": ms_b}


def parallel_rank(output: str) -> int:
    """One process of phase 12's two gloo processes that share the card
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT`` set by
    :func:`phase_parallel`): (b) one float32 step at 70x90 through
    ``PDSTrainer``'s data-parallel step, one example each, recording its
    LeakyReLU branches; (c) 1 + 6 data-parallel steps at 540x960, D=255,
    bfloat16, the gradient all-reduce alone, then a validation pass over
    this process's shard of :func:`validation_examples`. Writes what it
    saw to ``output``."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    topology = runtime.initialize_distributed(device=PARALLEL_DEVICE,
                                              backend="gloo")
    rank = topology["process_index"]
    mesh = parallel.make_mesh(data=2)
    folder = SCRATCH / "parallel"
    result = {"topology": topology, "backend": dist.get_backend()}

    config, params, left, right, ground_truth = parallel_pair_case()
    network = models.PdsNetwork(config)
    network.load_state_dict(weights.state_dict_from_jax_params(params))
    branches = follow_leaky_relu_branches(network)
    pair = trainer.PDSTrainer(
        config, network, experiment_folder=str(folder / f"pair_{rank}"),
        initial_learning_rate=LEARNING_RATE, device=PARALLEL_DEVICE,
        mesh=mesh)
    shard = slice(rank, rank + 1)
    kernels.launch_counts.clear()
    value = pair._train_step(left[shard], right[shard], ground_truth[shard],
                             LEARNING_RATE)
    result["b"] = {"loss": float(value),
                   "launches": dict(kernels.launch_counts),
                   "branches": branches,
                   "gradients": _gradients_of(network),
                   "parameters": {key: tensor.cpu() for key, tensor
                                  in _parameters(network).items()}}
    del pair, network

    config = models.PDSConfig(maximum_disparity=TRAIN_MAXIMUM_DISPARITY)
    network = common.initial_network(config).to(PARALLEL_DEVICE)
    rmsprop = optimizer.rmsprop(network.parameters(), LEARNING_RATE)
    left, right, ground_truth = training_arrays(3 + rank, PARALLEL_DEVICE)

    def step():
        return trainer.train_step(network, rmsprop, left, right,
                                  ground_truth, LEARNING_RATE, config,
                                  torch.bfloat16, device=PARALLEL_DEVICE)

    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runtime.barrier()
    step_ms, losses, launches = [], [], {}
    k1_per_step = []
    for _ in range(TRAIN_STEPS):
        kernels.launch_counts.clear()
        begin = time.perf_counter()
        losses.append(float(step()))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - begin) * 1e3)
        k1_per_step.append(kernels.launch_counts.get(conv3d.NAME, 0))
        for name, count in kernels.launch_counts.items():
            launches[name] = launches.get(name, 0) + count
    peak_bytes = torch.cuda.max_memory_allocated()
    reduce_ms = []
    for _ in range(TRAIN_STEPS):
        runtime.barrier()
        torch.cuda.synchronize()
        begin = time.perf_counter()
        runtime.all_reduce_in_place(
            [parameter.grad for parameter in network.parameters()]
            + [torch.zeros(1, device=PARALLEL_DEVICE)])
        torch.cuda.synchronize()
        reduce_ms.append((time.perf_counter() - begin) * 1e3)
    gradient_bytes = sum(4 * parameter.numel()
                         for parameter in network.parameters())
    del network, rmsprop

    validator = trainer.PDSTrainer(
        config, common.initial_network(config),
        test_set_loader=Loader(validation_examples(), num_workers=1,
                               host_index=rank, host_count=2),
        experiment_folder=str(folder / f"validation_{rank}"),
        compute_dtype=torch.bfloat16, device=PARALLEL_DEVICE, mesh=mesh)
    kernels.launch_counts.clear()
    errors, seconds = validator.test()
    validation_launches = dict(kernels.launch_counts)
    for name, count in validation_launches.items():
        launches[name] = launches.get(name, 0) + count
    result["c"] = {"step_ms": step_ms, "losses": losses,
                   "k1_per_step": k1_per_step,
                   "max_memory_allocated_bytes": peak_bytes,
                   "all_reduce_ms": reduce_ms,
                   "gradient_bytes": gradient_bytes,
                   "validation": {"errors": errors, "seconds": seconds,
                                  "launches": validation_launches,
                                  "examples": len(validator._test_set_loader
                                                  .epoch_indices())},
                   "launches": launches}
    runtime.barrier()
    torch.save(result, output)
    runtime.destroy()
    return 0


def run_parallel_ranks() -> list:
    """:func:`parallel_rank` in two processes joined over gloo on this
    card; each one's result, or None for a process that failed."""
    return run_ranks(SCRATCH / "parallel", ["--parallel-rank"], 2,
                     PARALLEL_TIMEOUT_S)


def run_ranks(folder: pathlib.Path, arguments: list, processes: int,
              timeout: float) -> list:
    """Starts this script with ``arguments`` and an output path in
    ``processes`` processes joined over gloo on this card; kills them after
    ``timeout`` s. Returns each one's result, or None for a process that
    failed (the check fails)."""
    folder.mkdir(parents=True, exist_ok=True)
    torch.cuda.empty_cache()
    port = str(_free_port())
    started, logs = [], []
    for rank in range(processes):
        logs.append(open(folder / f"rank{rank}.log", "w+"))
        environment = dict(os.environ, RANK=str(rank),
                           WORLD_SIZE=str(processes), LOCAL_RANK=str(rank),
                           MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
        started.append(subprocess.Popen(
            [sys.executable, str(pathlib.Path(__file__).resolve()),
             *arguments, str(folder / f"rank{rank}.pt")],
            env=environment, stdout=logs[-1], stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    try:
        for process in started:
            process.wait(timeout=max(0.1, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for process in started:
            if process.poll() is None:
                process.kill()
                process.wait()
    results = []
    for rank, (process, log) in enumerate(zip(started, logs)):
        log.seek(0)
        text = log.read()
        log.close()
        ok = process.returncode == 0
        check(ok, f"{' '.join(arguments)}: process {rank} exited "
              f"{process.returncode} (killed after {timeout} s if "
              f"negative):\n{text[-3000:]}")
        results.append(torch.load(folder / f"rank{rank}.pt",
                                  weights_only=True) if ok else None)
    return results


def check_pair_step(results: list) -> dict:
    """(b): the two processes' step against the CPU's float64 batch of 2:
    the loss, and the gradient through each process's LeakyReLU branches
    (the per-example sums' gradients over the pooled count)."""
    config, params, left, right, ground_truth = parallel_pair_case()
    state = weights.state_dict_from_jax_params(params)
    pair = [result["b"] for result in results]

    def cpu_network():
        network = models.PdsNetwork(config)
        network.load_state_dict(state)
        return network.double()

    with torch.no_grad():
        batch_loss = float(loss.subpixel_cross_entropy(
            models.apply(cpu_network(), left, right, config, torch.float64,
                         "cpu"), torch.as_tensor(ground_truth),
            disparity_step=config.disparity_step))
    totals, counts, gradients, flipped = [], [], [], {}
    for rank in range(2):
        network = cpu_network()
        flips = follow_leaky_relu_branches(network, pair[rank]["branches"])
        total, count = loss.cross_entropy_sum_and_count(
            models.apply(network, left[rank:rank + 1], right[rank:rank + 1],
                         config, torch.float64, "cpu"),
            torch.as_tensor(ground_truth[rank:rank + 1]),
            disparity_step=config.disparity_step)
        total.backward()
        totals.append(float(total.detach()))
        counts.append(float(count))
        gradients.append(_gradients_of(network))
        flipped.update({f"{rank}:{name}#{call}": share
                        for name, calls in flips.items()
                        for call, (number, share) in enumerate(calls)
                        if number})
    exact = {name: (gradients[0][name] + gradients[1][name]) / sum(counts)
             for name in gradients[0]}
    card_loss = pair[0]["loss"]
    loss_error = abs(card_loss - batch_loss) / abs(batch_loss)
    check(pair[1]["loss"] == card_loss,
          f"parallel pair: losses {pair[0]['loss']}, {pair[1]['loss']}")
    check(loss_error <= 1e-5, f"parallel pair: loss {card_loss} on the "
          f"card, {batch_loss} on the CPU (float64, batch 2)")
    errors = gradient_errors(pair[0]["gradients"], exact)
    check(errors["worst"] <= TRAIN_PATH_GRADIENT_TOLERANCE,
          f"parallel pair: gradients against float64: {errors}")
    replicas_equal = all(torch.equal(pair[0][kind][name],
                                     pair[1][kind][name])
                         for kind in ("gradients", "parameters")
                         for name in pair[0][kind])
    check(replicas_equal, "parallel pair: gradients or parameters differ "
          "between the processes")
    check(all(share <= BRANCH_FLIP_TOLERANCE for share in flipped.values()),
          f"parallel pair: LeakyReLU branches differ from float64's away "
          f"from 0: {flipped}")
    for rank in range(2):
        _expect_launches(pair[rank]["launches"], 18, 0,
                         f"parallel pair, process {rank}")
    return {"size": [70, 90], "maximum_disparity": 63, "dtype": "float32",
            "unknown_pixels": [int(np.isinf(ground_truth[index]).sum())
                               for index in range(2)],
            "loss": {"card": card_loss, "cpu_float64_batch2": batch_loss,
                     "cpu_float64_through_branches": sum(totals)
                     / sum(counts),
                     "mean_of_per_process_means": float(np.mean(
                         np.asarray(totals) / np.asarray(counts)))},
            "loss_relative_err": loss_error,
            "gradients_against_float64": errors,
            "replicas_bit_equal": replicas_equal,
            "flipped_input_share": flipped,
            "launches": [pair[rank]["launches"] for rank in range(2)],
            "tolerance": f"loss 1e-5 relative to the CPU's float64 batch-2 "
                         f"loss; each gradient tensor within "
                         f"{TRAIN_PATH_GRADIENT_TOLERANCE} of its largest "
                         f"element of the CPU's float64 gradient through "
                         f"the processes' LeakyReLU branches; gradients "
                         f"and updated weights bit-equal across processes"}


def check_full_size(results: list, bare_step_ms: float) -> dict:
    """(c): the two processes' steps and validation at 540x960, D=255,
    bfloat16; the validation against the same examples in this process,
    one after another."""
    full = [result["c"] for result in results]
    for rank in range(2):
        check(full[rank]["k1_per_step"] == [18] * TRAIN_STEPS,
              f"parallel full size, process {rank}: K1 per step "
              f"{full[rank]['k1_per_step']}")
        check(all(np.isfinite(full[rank]["losses"])),
              f"parallel full size: losses {full[rank]['losses']}")
    check(full[0]["losses"] == full[1]["losses"],
          f"parallel full size: losses differ between the processes: "
          f"{full[0]['losses']}, {full[1]['losses']}")
    config = models.PDSConfig(maximum_disparity=TRAIN_MAXIMUM_DISPARITY)
    validator = trainer.PDSTrainer(
        config, common.initial_network(config),
        test_set_loader=Loader(validation_examples(), num_workers=1),
        experiment_folder=str(SCRATCH / "parallel" / "sequential"),
        compute_dtype=torch.bfloat16, device=PARALLEL_DEVICE)
    sequential, sequential_seconds = validator.test()
    metrics = [result["validation"]["errors"] for result in full]
    check(metrics[0] == metrics[1] and bool(metrics[0]),
          f"parallel validation: metrics differ between the processes: "
          f"{metrics}")
    relative = {key: abs(metrics[0].get(key, np.nan) - value) / abs(value)
                for key, value in sequential.items()}
    check(all(error <= FIRST_LOSS_TOLERANCE for error in relative.values()),
          f"parallel validation: {metrics[0]} against the sequential "
          f"{sequential}")
    check([result["validation"]["examples"] for result in full] == [2, 1],
          "parallel validation: shards are not 2 + 1 examples")
    # Per process: its images and the untimed warm-up, 9 K1 + 1 K2 each.
    for rank, images in ((0, 2), (1, 1)):
        _expect_launches(full[rank]["validation"]["launches"],
                         9 * (images + 1), images + 1,
                         f"parallel validation, process {rank}")
    check(not (SCRATCH / "parallel" / "validation_1").exists(),
          "parallel validation: process 1 wrote into its experiment folder")
    return {
        "size": [HEIGHT, WIDTH], "maximum_disparity": TRAIN_MAXIMUM_DISPARITY,
        "compute_dtype": "bfloat16", "batch_per_process": 1,
        "steps": TRAIN_STEPS,
        "note": "two processes contend for one card: no scaling number",
        "processes": [{
            "ms_per_step_median": statistics.median(result["step_ms"]),
            "step_ms": result["step_ms"],
            "all_reduce_ms_median": statistics.median(
                result["all_reduce_ms"]),
            "all_reduce_ms": result["all_reduce_ms"],
            "max_memory_allocated_bytes":
                result["max_memory_allocated_bytes"],
            "k1_per_step": result["k1_per_step"]} for result in full],
        "gradient_bytes": full[0]["gradient_bytes"],
        "bare_train_step_ms_median": bare_step_ms,
        "losses": full[0]["losses"],
        "validation": {"metrics": metrics[0], "sequential": sequential,
                       "relative_err": relative,
                       "seconds_per_image": [result["validation"]["seconds"]
                                             for result in full],
                       "sequential_seconds_per_image": sequential_seconds,
                       "tolerance": f"identical on both processes; "
                                    f"{FIRST_LOSS_TOLERANCE} relative to "
                                    f"the sequential pass"}}


def check_scanner() -> dict:
    """(d): :data:`PARALLEL_SCAN_FILES` 960x540 PFMs written with phase
    7's writer, scanned in Python one at a time and by the C++ scanner."""
    folder = SCRATCH / "scan"
    folder.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(30)
    paths = []
    for index in range(PARALLEL_SCAN_FILES):
        disparity = rng.uniform(-5, 100 + 2 * index, (HEIGHT, WIDTH))
        paths.append(str(folder / f"{index:04d}.pfm"))
        pfm.write_pfm(paths[-1], disparity.astype(np.float32))
    begin = time.perf_counter()
    native.build()
    build_s = time.perf_counter() - begin
    begin = time.perf_counter()
    minimums, maximums, cumulatives, status = (
        native.scan_disparity_statistics(paths))
    native_s = time.perf_counter() - begin
    begin = time.perf_counter()
    python = [compute_disparity_statistic(path) for path in paths]
    python_s = time.perf_counter() - begin
    check(bool((status == 0).all()), f"scanner: status {status}")
    extremes_equal = all(
        int(minimums[index]) == statistic["minimum_disparity"]
        and int(maximums[index]) == statistic["maximum_disparity"]
        for index, statistic in enumerate(python))
    check(extremes_equal, "scanner: minimum or maximum differs from Python's")
    cumulative_error = max(float(np.abs(
        cumulatives[index] - statistic["cumulative_distribution"]).max())
        for index, statistic in enumerate(python))
    check(cumulative_error <= 1e-3, f"scanner: cumulative distributions "
          f"differ from Python's by {cumulative_error}")
    shutil.rmtree(folder)
    return {"files": PARALLEL_SCAN_FILES, "size": [HEIGHT, WIDTH],
            "cpu_count": os.cpu_count(), "build_s": build_s,
            "native_s_per_pfm": native_s / len(paths),
            "python_s_per_pfm": python_s / len(paths),
            "min_max_equal": extremes_equal,
            "cumulative_max_abs_err": cumulative_error,
            "tolerance": "min and max equal, cumulative within 1e-3"}


def phase_parallel(card: str, dataset: dict, bare_step_ms: float,
                   loop_ms: float, direct_loss: float) -> dict:
    """(a) the training CLI with ``--mesh_data 1`` in a world-1 NCCL group,
    and ``train_step`` there against ``train_step`` with no group; (b) and
    (c) two gloo processes that share the card (:func:`parallel_rank`);
    (d) the native statistics scanner. Returns the launch counts of the
    paths: (a)'s CLI run, (b) and (c) summed over the processes."""
    start = time.perf_counter()
    alone = deterministic_step()
    saved = {name: os.environ.get(name) for name in runtime.CLUSTER_VARIABLES}
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()))
    try:
        kernels.launch_counts.clear()
        run = train_flyingthings3d.main([
            "--dataset_folder", str(dataset["flyingthings3d"]),
            "--experiment_folder",
            str(SCRATCH / "experiments" / "parallel_nccl"),
            "--maximum_disparity", str(TRAIN_MAXIMUM_DISPARITY), "--bfloat16",
            "--number_of_validation_examples", "1", "--end_epoch", "1",
            "--mesh_data", "1", "--device", "cuda"])
        launches = {"parallel_nccl": dict(kernels.launch_counts)}
        backend = dist.get_backend()
        topology = runtime.topology()
        against_train_step = compare_steps(alone, deterministic_step())
    finally:
        runtime.destroy()
        for name, value in saved.items():
            if value is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = value
    check(backend == "nccl" and topology["process_count"] == 1,
          f"parallel: the CLI ran under {backend}, {topology}")
    _expect_launches(launches["parallel_nccl"], 3 * 18 + 2 * 9, 2,
                     "parallel, the CLI under NCCL")
    first_loss_error = abs(run.step_losses[0] - direct_loss) / abs(
        direct_loss)
    check(first_loss_error <= FIRST_LOSS_TOLERANCE,
          f"parallel: first step loss {run.step_losses[0]} under NCCL, "
          f"direct train_step {direct_loss}")
    nccl = {"backend": backend, "topology": topology,
            "first_step_loss": {"cli": run.step_losses[0],
                                "direct_train_step": direct_loss,
                                "relative_err": first_loss_error,
                                "tolerance": FIRST_LOSS_TOLERANCE},
            "step_ms": run.step_ms,
            "loop_ms_per_step_median": statistics.median(run.step_ms[1:]),
            "phase8_loop_ms_per_step_median": loop_ms,
            "bare_train_step_ms_median": bare_step_ms,
            "against_train_step": against_train_step,
            "launches": launches["parallel_nccl"]}

    results = run_parallel_ranks()
    pair = full = None
    if all(result is not None for result in results):
        check(all(result["backend"] == "gloo"
                  and result["topology"]["process_count"] == 2
                  for result in results),
              f"parallel: processes' groups {[result['topology'] for result in results]}")
        pair = check_pair_step(results)
        full = check_full_size(results, bare_step_ms)
        gloo = {}
        for result in results:
            for counts in (result["b"]["launches"], result["c"]["launches"]):
                for name, count in counts.items():
                    gloo[name] = gloo.get(name, 0) + count
        launches["parallel_gloo"] = gloo
    emit({"phase": "parallel", "card": card,
          "seconds": time.perf_counter() - start,
          "nccl_world_1": nccl, "gloo_pair_check": pair,
          "gloo_full_size": full, "scanner": check_scanner()})
    return launches


def volume_case(name: str):
    """(a) or (b): config, weights (numpy seed 1), images and ground
    truth (8 rows unknown) from numpy seed 5."""
    batch, height, width, maximum_disparity = VOLUME_CASES[name][1]
    config = models.PDSConfig(maximum_disparity=maximum_disparity)
    rng = np.random.RandomState(5)
    left, right = (rng.uniform(0, 255, (batch, height, width, 3)).astype(
        np.float32) for _ in range(2))
    ground_truth = rng.uniform(0, 0.8 * maximum_disparity,
                               (batch, height, width)).astype(np.float32)
    ground_truth[:, :8] = np.inf
    return (config, weights.random_jax_params(config, seed=1), left, right,
            ground_truth)


def volume_check_rank(mesh, name: str) -> dict:
    """(a) or (b) in one process: its columns of the similarities, the
    whole ``infer`` map, and one ``train_step`` with its LeakyReLU
    branches, gradients and updated weights."""
    config, params, left, right, ground_truth = volume_case(name)
    network = models.PdsNetwork(config)
    network.load_state_dict(weights.state_dict_from_jax_params(params))
    network.to(PARALLEL_DEVICE)
    branches = follow_leaky_relu_branches(network)
    with torch.no_grad():
        similarities, columns = models.apply(
            network, left, right, config, device=PARALLEL_DEVICE, mesh=mesh)
    kernels.launch_counts.clear()
    disparity = models.infer(network, left, right, config,
                             device=PARALLEL_DEVICE, mesh=mesh)
    infer_launches = dict(kernels.launch_counts)
    branches.clear()
    rmsprop = optimizer.rmsprop(network.parameters(), LEARNING_RATE)
    kernels.launch_counts.clear()
    value = trainer.train_step(network, rmsprop, left, right, ground_truth,
                               LEARNING_RATE, config,
                               device=PARALLEL_DEVICE, mesh=mesh)
    return {"similarities": similarities.cpu(), "columns": columns,
            "disparity": disparity.cpu(), "loss": float(value),
            "infer_launches": infer_launches,
            "step_launches": dict(kernels.launch_counts),
            "branches": dict(branches),
            "gradients": _gradients_of(network),
            "parameters": {key: tensor.cpu() for key, tensor
                           in _parameters(network).items()}}


def volume_collectives_ms(step, steps: int = 2) -> list:
    """Per instrumented step, the host ms of the halo exchanges
    (``runtime.exchange``) and of the volume group's all-reduces (the
    norms' moments, forward and backward), each call fenced by
    ``torch.cuda.synchronize()`` on both sides, and their numbers of
    calls. Steps of their own: the fences cost time."""
    exchange, all_reduce_sum = runtime.exchange, runtime.all_reduce_sum
    per_step = []

    def fenced(function, kind):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            begin = time.perf_counter()
            result = function(*args, **kwargs)
            torch.cuda.synchronize()
            if kind == "halo" or len(args) > 1 and args[1] is not None:
                per_step[-1][f"{kind}_ms"] += (
                    time.perf_counter() - begin) * 1e3
                per_step[-1][f"{kind}_calls"] += 1
            return result
        return call

    runtime.exchange = fenced(exchange, "halo")
    runtime.all_reduce_sum = fenced(all_reduce_sum, "norm")
    try:
        for _ in range(steps):
            per_step.append({"halo_ms": 0.0, "halo_calls": 0,
                             "norm_ms": 0.0, "norm_calls": 0})
            begin = time.perf_counter()
            step()
            torch.cuda.synchronize()
            per_step[-1]["step_ms"] = (time.perf_counter() - begin) * 1e3
    finally:
        runtime.exchange, runtime.all_reduce_sum = exchange, all_reduce_sum
    return per_step


def volume_training_rank(mesh) -> dict:
    """(c) in one process: phase 6's example and first weights, 1 + 6
    steps on this process's columns, then the collectives' share."""
    config = models.PDSConfig(maximum_disparity=TRAIN_MAXIMUM_DISPARITY)
    network = common.initial_network(config).to(PARALLEL_DEVICE)
    rmsprop = optimizer.rmsprop(network.parameters(), LEARNING_RATE)
    left, right, ground_truth = training_arrays(device=PARALLEL_DEVICE)

    def step():
        return trainer.train_step(network, rmsprop, left, right,
                                  ground_truth, LEARNING_RATE, config,
                                  torch.bfloat16, device=PARALLEL_DEVICE,
                                  mesh=mesh)

    torch.cuda.reset_peak_memory_stats()
    first_loss, saved = saved_for_backward(step)
    first_loss = float(first_loss)
    torch.cuda.synchronize()
    runtime.barrier()
    step_ms, losses, k1_per_step, launches = [], [], [], {}
    for _ in range(TRAIN_STEPS):
        kernels.launch_counts.clear()
        begin = time.perf_counter()
        losses.append(float(step()))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - begin) * 1e3)
        k1_per_step.append(kernels.launch_counts.get(conv3d.NAME, 0))
        for name, count in kernels.launch_counts.items():
            launches[name] = launches.get(name, 0) + count
    peak_bytes = torch.cuda.max_memory_allocated()
    runtime.barrier()
    return {"first_loss": first_loss, "step_ms": step_ms, "losses": losses,
            "k1_per_step": k1_per_step, "launches": launches,
            "max_memory_allocated_bytes": peak_bytes,
            "first_step_saved_for_backward": saved,
            "collectives": volume_collectives_ms(step)}


def volume_serving_rank(mesh) -> dict:
    """(d) in one process: ``infer`` at 540x960, D=191, bfloat16, one
    untimed and :data:`VOLUME_SERVING_IMAGES` timed images."""
    config = models.PDSConfig(maximum_disparity=MAXIMUM_DISPARITY)
    network = common.initial_network(config).to(PARALLEL_DEVICE)
    rng = np.random.RandomState(7)
    left, right = (rng.uniform(0, 255, (1, HEIGHT, WIDTH, 3)).astype(
        np.float32) for _ in range(2))

    def serve():
        return models.infer(network, left, right, config, torch.bfloat16,
                            PARALLEL_DEVICE, mesh)

    serve()
    torch.cuda.synchronize()
    runtime.barrier()
    image_ms, per_image, maps = [], [], []
    for _ in range(VOLUME_SERVING_IMAGES):
        kernels.launch_counts.clear()
        begin = time.perf_counter()
        maps.append(serve())
        torch.cuda.synchronize()
        image_ms.append((time.perf_counter() - begin) * 1e3)
        per_image.append(dict(kernels.launch_counts))
    return {"image_ms": image_ms, "launches": per_image,
            "disparity": maps[-1].cpu(),
            "repeatable": all(torch.equal(disparity, maps[0])
                              for disparity in maps)}


def kernel_shapes(function):
    """Runs ``function`` and returns its result and the shapes its kernel
    launches took: K1's input as (D, C, H, W), K2's scores as (B, D, H,
    W)."""
    shapes = {"k1_shapes": set(), "k2_shapes": set()}
    k1, k2 = conv3d.conv3d_k3s1, subpixel.subpixel_map

    def k1_recorded(x, *args, **kwargs):
        _, channels, depth, height, width = x.shape
        shapes["k1_shapes"].add((depth, channels, height, width))
        return k1(x, *args, **kwargs)

    def k2_recorded(scores, *args, **kwargs):
        batch, height, width, disparities = scores.shape
        shapes["k2_shapes"].add((batch, disparities, height, width))
        return k2(scores, *args, **kwargs)

    conv3d.conv3d_k3s1, subpixel.subpixel_map = k1_recorded, k2_recorded
    try:
        result = function()
    finally:
        conv3d.conv3d_k3s1, subpixel.subpixel_map = k1, k2
    result.update({key: sorted(value) for key, value in shapes.items()})
    return result


def volume_rank(scenario: str, output: str) -> int:
    """One process of phase 13's groups, which share the card over gloo
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT`` set by
    :func:`run_ranks`): ``"pair"`` runs (a), (c) and (d) at volume=2,
    ``"quad"`` (b) at volume=4. Writes what it saw to ``output``."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    runtime.initialize_distributed(device=PARALLEL_DEVICE, backend="gloo")
    name = "a" if scenario == "pair" else "b"
    mesh = parallel.make_mesh(volume=VOLUME_CASES[name][0])
    result = {"topology": runtime.topology(), "backend": dist.get_backend(),
              name: volume_check_rank(mesh, name)}
    torch.cuda.empty_cache()
    if scenario == "pair":
        result["c"] = kernel_shapes(lambda: volume_training_rank(mesh))
        torch.cuda.empty_cache()
        result["d"] = kernel_shapes(lambda: volume_serving_rank(mesh))
    runtime.barrier()
    torch.save(result, output)
    runtime.destroy()
    return 0


def check_volume_case(results: list, name: str) -> dict:
    """(a) or (b) against the CPU's float64 unsharded network on the same
    weights and inputs: the stitched similarities within 1e-3; each
    process's whole ``infer`` map equal to the others' and >= 99.9 % of
    its pixels within 1e-2 px; the loss within 1e-5 relative; each gradient
    within 1e-3 of its largest element of the float64 gradient taken
    through the processes' LeakyReLU branches (stitched along W); the
    gradients and updated weights bit-equal on every process; 18 K1 per
    step and 9 K1 + 1 K2 per ``infer`` on each."""
    config, params, left, right, ground_truth = volume_case(name)
    ranks = [result[name] for result in results]
    state = weights.state_dict_from_jax_params(params)
    truth = torch.as_tensor(ground_truth, dtype=torch.float64)

    def cpu_network():
        network = models.PdsNetwork(config)
        network.load_state_dict(state)
        return network.double()

    with torch.no_grad():
        exact = models.apply(cpu_network(), left, right, config,
                             torch.float64, "cpu")
        exact_disparity = models.infer(cpu_network(), left, right, config,
                                       torch.float64, "cpu")
        exact_loss = float(loss.subpixel_cross_entropy(
            exact, truth, disparity_step=config.disparity_step))
    stitched = torch.cat([rank["similarities"] for rank in ranks], dim=2)
    similarity_error = float((stitched.double() - exact).abs().max())
    check(similarity_error <= 1e-3, f"volume ({name}): similarities differ "
          f"by {similarity_error}")
    check(all(torch.equal(rank["disparity"], ranks[0]["disparity"])
              for rank in ranks), f"volume ({name}): the processes' infer "
          "maps differ")
    disparity_error = (ranks[0]["disparity"].double()
                       - exact_disparity).abs()
    outside = int((disparity_error > 1e-2).sum())
    check(outside <= 0.001 * disparity_error.numel(),
          f"volume ({name}): {outside} of {disparity_error.numel()} pixels "
          "differ by more than 1e-2 px")
    card_loss = ranks[0]["loss"]
    loss_error = abs(card_loss - exact_loss) / abs(exact_loss)
    check(all(rank["loss"] == card_loss for rank in ranks)
          and loss_error <= 1e-5, f"volume ({name}): losses "
          f"{[rank['loss'] for rank in ranks]} on the card, {exact_loss} "
          "on the CPU (float64)")
    branches = {module: [torch.cat([rank["branches"][module][call]
                                    for rank in ranks], dim=-1)
                         for call in range(len(calls))]
                for module, calls in ranks[0]["branches"].items()}
    network = cpu_network()
    flips = follow_leaky_relu_branches(network, branches)
    loss.subpixel_cross_entropy(
        models.apply(network, left, right, config, torch.float64, "cpu"),
        truth, disparity_step=config.disparity_step).backward()
    errors = gradient_errors(ranks[0]["gradients"], _gradients_of(network))
    check(errors["worst"] <= TRAIN_PATH_GRADIENT_TOLERANCE,
          f"volume ({name}): gradients against float64: {errors}")
    flipped = {f"{module}#{call}": share for module, calls in flips.items()
               for call, (number, share) in enumerate(calls) if number}
    check(all(share <= BRANCH_FLIP_TOLERANCE for share in flipped.values()),
          f"volume ({name}): LeakyReLU branches differ from float64's away "
          f"from 0: {flipped}")
    replicas_equal = all(torch.equal(ranks[0][kind][key], rank[kind][key])
                         for rank in ranks
                         for kind in ("gradients", "parameters")
                         for key in ranks[0][kind])
    check(replicas_equal, f"volume ({name}): gradients or parameters differ "
          "between the processes")
    for index, rank in enumerate(ranks):
        _expect_launches(rank["step_launches"], 18, 0,
                         f"volume ({name}) step, process {index}")
        _expect_launches(rank["infer_launches"], 9, 1,
                         f"volume ({name}) infer, process {index}")
    batch, height, width, maximum_disparity = VOLUME_CASES[name][1]
    return {"processes": len(ranks), "batch": batch, "size": [height, width],
            "maximum_disparity": maximum_disparity, "dtype": "float32",
            "columns": [list(rank["columns"]) for rank in ranks],
            "similarity_max_abs_err": similarity_error,
            "disparity_max_abs_err": float(disparity_error.max()),
            "pixels_outside_1e-2": outside,
            "pixels": disparity_error.numel(),
            "loss": {"card": card_loss, "cpu_float64": exact_loss},
            "loss_relative_err": loss_error,
            "gradients_against_float64": errors,
            "flipped_input_share": flipped,
            "replicas_bit_equal": replicas_equal,
            "launches": [{"infer": rank["infer_launches"],
                          "step": rank["step_launches"]} for rank in ranks],
            "tolerance": f"similarities 1e-3; >= 99.9 % of pixels within "
                         f"1e-2 px; loss 1e-5 relative; each gradient "
                         f"tensor within {TRAIN_PATH_GRADIENT_TOLERANCE} of "
                         f"its largest element of the CPU's float64 one "
                         f"through the processes' LeakyReLU branches"}


def _expect_checked_shapes(runs: list, name: str, k1_shapes: list,
                           k2_shapes: list) -> None:
    """Each process of ``name`` launched K1 and K2 only at shapes that
    phase 2 held against their plain versions."""
    for rank, run in enumerate(runs):
        for key, checked in (("k1_shapes", k1_shapes),
                             ("k2_shapes", k2_shapes)):
            unchecked = [shape for shape in run[key]
                         if tuple(shape) not in checked]
            check(not unchecked, f"volume ({name}), process {rank}: "
                  f"{key} {unchecked} were not checked in phase 2")


def check_volume_training(results: list, bare_step_ms: float,
                          first_step_loss: float) -> dict:
    """(c): equal losses on both processes, the first within
    :data:`VOLUME_LOSS_TOLERANCE` relative of phase 6's unsharded first
    step (same example, same first weights), 18 K1 per step."""
    runs = [result["c"] for result in results]
    for rank, run in enumerate(runs):
        check(run["k1_per_step"] == [18] * TRAIN_STEPS,
              f"volume (c), process {rank}: K1 per step "
              f"{run['k1_per_step']}")
        check(all(np.isfinite(run["losses"] + [run["first_loss"]])),
              f"volume (c): losses {run['losses']}")
    _expect_checked_shapes(runs, "c", K1_VOLUME_SHAPES[
        "phase 13 (c): D=255 training"], [])
    check(all(run["losses"] == runs[0]["losses"]
              and run["first_loss"] == runs[0]["first_loss"]
              for run in runs), "volume (c): losses differ between the "
          "processes")
    relative = abs(runs[0]["first_loss"] - first_step_loss) / abs(
        first_step_loss)
    check(relative <= VOLUME_LOSS_TOLERANCE, f"volume (c): first loss "
          f"{runs[0]['first_loss']} sliced, {first_step_loss} in phase 6")
    return {
        "size": [HEIGHT, WIDTH], "maximum_disparity": TRAIN_MAXIMUM_DISPARITY,
        "compute_dtype": "bfloat16", "batch": 1, "steps": TRAIN_STEPS,
        "note": "two processes time-share one card: no scaling number",
        "first_loss": {"sliced": runs[0]["first_loss"],
                       "phase6_unsharded": first_step_loss,
                       "relative_err": relative,
                       "tolerance": VOLUME_LOSS_TOLERANCE},
        "losses": runs[0]["losses"],
        "bare_train_step_ms_median": bare_step_ms,
        "processes": [{
            "ms_per_step_median": statistics.median(run["step_ms"]),
            "step_ms": run["step_ms"],
            "collectives_per_instrumented_step": run["collectives"],
            "max_memory_allocated_bytes": run["max_memory_allocated_bytes"],
            "first_step_saved_for_backward": run[
                "first_step_saved_for_backward"],
            "k1_shapes": run["k1_shapes"],
            "k1_per_step": run["k1_per_step"]} for run in runs]}


def check_volume_serving(results: list, serving_ms: float) -> dict:
    """(d): the whole map equal on both processes and over the images,
    finite, in [0, 190]; 9 K1 + 1 K2 per image on each."""
    runs = [result["d"] for result in results]
    disparity = runs[0]["disparity"]
    check(all(torch.equal(run["disparity"], disparity) and run["repeatable"]
              for run in runs), "volume (d): the maps differ between the "
          "processes or the images")
    check(tuple(disparity.shape) == (1, HEIGHT, WIDTH)
          and bool(torch.isfinite(disparity).all())
          and float(disparity.min()) >= 0.0
          and float(disparity.max()) <= MAXIMUM_DISPARITY - 1,
          f"volume (d): map {tuple(disparity.shape)} in "
          f"[{float(disparity.min())}, {float(disparity.max())}]")
    for rank, run in enumerate(runs):
        for counts in run["launches"]:
            _expect_launches(counts, 9, 1, f"volume (d), process {rank}")
    _expect_checked_shapes(runs, "d", K1_VOLUME_SHAPES[
        "phase 13 (d): D=191 serving"], K2_VOLUME_SHAPES)
    return {"size": [HEIGHT, WIDTH], "maximum_disparity": MAXIMUM_DISPARITY,
            "compute_dtype": "bfloat16", "images": VOLUME_SERVING_IMAGES,
            "k1_shapes": [run["k1_shapes"] for run in runs],
            "k2_shapes": [run["k2_shapes"] for run in runs],
            "ms_per_image_median": [statistics.median(run["image_ms"])
                                    for run in runs],
            "image_ms": [run["image_ms"] for run in runs],
            "phase5_serving_ms_median": serving_ms,
            "disparity_range": [float(disparity.min()),
                                float(disparity.max())]}


def phase_volume(card: str, bare_step_ms: float, first_step_loss: float,
                 serving_ms: float) -> dict:
    """The ``volume`` mesh axis on processes that share the card over gloo
    (NCCL refuses two processes on one card): (a), (c) and (d) in two
    processes at volume=2, (b) in four at volume=4. Returns the launches
    of their paths, summed over the processes."""
    start = time.perf_counter()
    pair = run_ranks(SCRATCH / "volume_pair", ["--volume-rank", "pair"], 2,
                     VOLUME_TIMEOUT_S)
    quad = run_ranks(SCRATCH / "volume_quad", ["--volume-rank", "quad"], 4,
                     VOLUME_TIMEOUT_S)
    record = {"phase": "volume", "card": card}
    launches = {}

    def add(counts):
        for name, count in counts.items():
            launches[name] = launches.get(name, 0) + count

    if all(result is not None for result in pair):
        record["a"] = check_volume_case(pair, "a")
        record["c"] = check_volume_training(pair, bare_step_ms,
                                            first_step_loss)
        record["d"] = check_volume_serving(pair, serving_ms)
        for result in pair:
            add(result["a"]["infer_launches"])
            add(result["a"]["step_launches"])
            add(result["c"]["launches"])
            for counts in result["d"]["launches"]:
                add(counts)
    if all(result is not None for result in quad):
        record["b"] = check_volume_case(quad, "b")
        for result in quad:
            add(result["b"]["infer_launches"])
            add(result["b"]["step_launches"])
    check(all(result is not None and result["backend"] == "gloo"
              for result in pair + quad), "volume: a process failed or ran "
          "without gloo")
    record["seconds"] = time.perf_counter() - start
    emit(record)
    return launches


def phase_mfu(serving_ms: float, step_ms: float, options_ms: dict) -> None:
    """Useful FLOPs over time over the card's bfloat16 peak."""
    name = torch.cuda.get_device_name(0)
    peak = flops.peak_bf16_flops(name)
    serving_flop = 2.0 * sum(stage.useful for stage in flops.forward_macs(
        PADDED_HEIGHT, WIDTH, MAXIMUM_DISPARITY))
    train_flop = 2e9 * flops.training_macs(
        PADDED_HEIGHT, WIDTH, TRAIN_MAXIMUM_DISPARITY)["useful_gmacs"]

    def mfu(flop, milliseconds):
        return None if peak is None else flop / (milliseconds / 1e3) / peak

    emit({"phase": "mfu", "card": name, "peak_bf16_flops": peak,
          "peak_source": "NVIDIA H100 SXM data sheet, dense bfloat16 "
                         "(utils/flops.py)",
          "serving": {"useful_gflop_per_image": serving_flop / 1e9,
                      "ms_per_image": serving_ms,
                      "mfu": mfu(serving_flop, serving_ms)},
          "train_step": {"useful_gflop_per_step": train_flop / 1e9,
                         "ms_per_step": step_ms,
                         "mfu": mfu(train_flop, step_ms)},
          "options": {key: mfu(train_flop if key.startswith("train")
                               else serving_flop, value)
                      for key, value in options_ms.items()}})


def kernel_summary(results: dict, launches: dict) -> dict:
    """Per kernel: its launches on the main paths (serving, the timed train
    steps, the eval step, the CLIs, the options, the data-parallel paths
    of phase 12 and the volume paths of phase 13 summed over their
    processes; each counted from 0 just before it ran), and the
    serving path's bfloat16 work for one image, times and bounds summed
    over the launches one image makes at their shapes. K1 adds the same
    sums for one train step at D=255 (forward and input gradient), K2 for
    one eval image at D=128."""
    entries = []
    plans = [(conv3d.NAME, "cuda", K1_SOURCE, K1_REPLACES,
              [(shape, count) for shape, count in K1_LEVELS]),
             (subpixel.NAME, "cuda", K2_SOURCE, K2_REPLACES,
              [(K2_SHAPE, 1)])]
    for name, route, source, replaces, shapes in plans:
        records = [(results[(name, shape, torch.bfloat16)], count)
                   for shape, count in shapes]

        def total(key):
            values = [record[key] for record, _ in records]
            if any(value is None for value in values):
                return None
            return sum(record[key] * count for record, count in records)

        bytes_bound = sum(record["bound_ms"] * count for record, count
                          in records if record["bound_by"] == "bytes")
        operations_bound = total("bound_ms") - bytes_bound
        by_path = {path: counts.get(name, 0)
                   for path, counts in launches.items()}
        entries.append({
            "name": name, "route": route, "source": source,
            "replaces": replaces,
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(record["max_abs_err"] for record, _ in records),
            "ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"),
            "bound_by": ("bytes" if bytes_bound >= operations_bound
                         else "operations"),
            "library_ms": total("library_ms"),
            "per": "one 540x960 D=191 bfloat16 image",
        })
    training = [(results[("train", shape)], count)
                for shape, count in K1_TRAIN_LEVELS]
    entries[0]["per_train_step"] = {
        "per": "one 540x960 D=255 bfloat16 train step: forward + input "
               "gradient of the nine convs",
        "ms": sum((record["ms"] + record["dgrad_ms"]) * count
                  for record, count in training),
        "bound_ms": sum(2 * record["bound_ms"] * count
                        for record, count in training),
        "library_ms": sum((record["library_ms"] + record["dgrad_library_ms"])
                          * count for record, count in training),
        "dgrad_ms": sum(record["dgrad_ms"] * count
                        for record, count in training),
        "dgrad_library_ms": sum(record["dgrad_library_ms"] * count
                                for record, count in training)}
    evaluation = results[(subpixel.NAME, K2_EVAL_SHAPE, torch.bfloat16)]
    entries[1]["per_eval_image"] = {
        key: evaluation[key] for key in ("shape", "ms", "plain_ms",
                                         "bound_ms", "max_abs_err")}
    return {"kernels": entries}


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--parallel-rank":
        return parallel_rank(sys.argv[2])
    if len(sys.argv) == 4 and sys.argv[1] == "--volume-rank":
        return volume_rank(sys.argv[2], sys.argv[3])
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on a CUDA GPU only", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = phase_device()
    results = phase_kernels()
    phase_path()
    phase_train_path()
    launches = {}
    launches["serving"], serving_ms = phase_serving(card)
    training_launches, step_ms, first_step_loss = phase_training(card)
    launches.update(training_launches)
    try:
        dataset = phase_dataset()
        launches["trainer"], direct_loss, loop_ms = phase_trainer(dataset,
                                                                  step_ms)
        launches["benchmark"] = phase_benchmark(dataset, serving_ms)
        launches["kitti"] = phase_kitti(dataset)
        launches["options"], options_ms = phase_options(card)
        launches.update(phase_parallel(card, dataset, step_ms, loop_ms,
                                       direct_loss))
        launches["volume"] = phase_volume(card, step_ms, first_step_loss,
                                          serving_ms)
    finally:
        shutil.rmtree(SCRATCH, ignore_errors=True)
    phase_mfu(serving_ms, step_ms, options_ms)
    emit(kernel_summary(results, launches))
    print(card, flush=True)
    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed", file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
