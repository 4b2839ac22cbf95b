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
               At batch 2 and 4, the shapes phase 14 launches: K1 in
               bfloat16 at the D=191 levels (forward; each batch equal
               to its halves' results) and at the D=255 levels (forward
               and gradients, as above), K2 on [B, 96, 576, 960] in
               float32 and bfloat16.
               K3 (the transposed convs' forward) at the six D=191 shapes
               in float32 (TF32 off, 1e-4) and bfloat16 (one ulp), twice on
               one input (bit-equal) and at twice the batch (each half
               equal to its own result); at the six D=255 shapes with K4
               (their input gradient): the bfloat16 forward and input
               gradient of ``ConvTranspose3dK3`` within one ulp, its
               float32 input, weight and bias gradients within 1e-4 of
               their largest, against autograd of the plain version, K4
               alone within one ulp, bit-equal twice and over a batch;
               times of both beside their plain versions, cuDNN's
               transposed conv and input gradient with ``cudnn.benchmark``
               off and on, and cuDNN's weight gradient. Both also at even
               and mixed paddings and odd sizes. The same checks,
               timing the kernels alone, at the haloed W-slices of phase 13
               (c) (K3 and K4) and (d) (K3, both dtypes) with W padding 3,
               and at batch 2 and 4 (K3 at D=191, K3 and K4 at D=255).
               K5 (a conv block's LeakyReLU, norm and residual add) at each
               of a D=191 served image's 37 norms in bfloat16, at the
               KITTI cell's matching volume [256, 64, 96, 320] and at the
               main shapes in float32: the norm within one bfloat16 ulp
               (float32: 1e-4) of its plain version, the residual add
               exact, bit-equal twice and over a batch of two; its time,
               byte bound, plain time and PyTorch's own leaky_relu +
               instance_norm time. K5's backward (``BlockNorm``) at each
               norm of a D=255 train step, KITTI's matching volume and
               float32 and input-norm variants: its input, weight, bias and
               residual gradients against float64 ones on the card, two
               backward launches bit-equal; its time beside its byte bound
               and autograd's backward of the composition, K5's forward
               beside the composition's.
3. path     -- ``infer`` at 70x90, D=63, float32, on the card against the
               same seeded weights on the CPU (plain versions).
4. train_path -- one ``train_step`` at 70x90, D=63, float32, on the card
               (loss against the CPU's) with its gradients held against
               the CPU's float64 ones taken through the same LeakyReLU
               branches as the card (:func:`follow_leaky_relu_branches`);
               18 K1 (9 forward + 9 input gradients), 6 K3, 6 K4, 37 K5
               and 35 K5 backward launches (every norm's forward; the
               backward of each conv block's).
5. serving  -- an ``InferenceSession`` at 540x960, D=191, bfloat16 (the
               published protocol) answering 17 requests, one of batch 2;
               checks the outputs and that every image went through 9 K1,
               1 K2, 6 K3 and 37 K5 launches (one K5 per norm of the
               forward); ms per image and peak device memory;
               then 5 more requests under ``utils/profiling.trace``, one
               line per ``pds.*`` span of the port (calls, host and device
               ms per image), each kernel span once per launch counted.
6. training -- the reference training configuration: 540x960, D=255,
               bfloat16 compute, batch 1, RMSprop at lr 1e-2; 1 warm-up and
               6 timed train steps (finite loss and gradients, 18 K1, 6 K3,
               6 K4, 37 K5 and 35 K5 backward launches each), ms per
               step, peak memory, the top
               device kernels of one step (``torch.profiler``); then one
               ``eval_step`` (a served image's launches, finite metrics) and a
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
               checkpoints, log lines, plot and dumps, finite losses, a
               train step's launches per train step (18 K1, 6 K3, 6 K4,
               37 K5, 35 K5 backward) and
               a served image's per validation image (9 K1, 1 K2, 6 K3;
               with its untimed warm-up), and that the first step's loss equals
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
               CRL (1): finite MAE and 3PE, a served image's launches per
               image and warm-up; time per image beside phase 5's median.
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
               memory, a served image's launches per image, the mean
               |difference| from
               the default's maps, and for the two exact options the 70x90
               card-vs-CPU comparison of phase 3. Train steps at 540x960,
               D=255, bfloat16, batch 1 under ``remat`` off,
               ``"selective"`` and ``True``: one step's gradients from the
               same weights (cuDNN's deterministic algorithms) equal to
               remat off's bit for bit, remat off run twice as the
               control; then 1 warm-up and 6 timed steps each: ms per
               step, peak memory, 18/21/27 K1, 6/9/12 K3, 6 K4, 37/47/59
               K5 and 35 K5 backward launches per step.
12. parallel -- the ``data`` axis over processes and the native scanner.
               (a) ``cli.train_flyingthings3d.main`` with ``--mesh_data 1``
               on phase 7's tree under ``torchrun``'s variables for a world
               of 1 (an NCCL group): a train step's launches per train
               step, a served image's per validation image, the first
               step's loss within 1e-5 of
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
               all-reduce's ms, peak memory, a train step's launches per
               step; the two
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
               gradients and updated weights bit-equal on both; a train
               step's launches per step and a served image's per ``infer``
               on each. (b) the same
               checks in 4 processes at volume=4, 64x320, D=127 (quarter
               slices of 32, 16, 16, 16 columns, narrower than the cost
               volume's halo). (c) the training cell at volume=2 (phase
               6's example and first weights): 1 + 6 steps per process,
               ms per step, the halo exchanges' and the norm all-reduces'
               ms per step (two more steps, each call fenced by
               ``torch.cuda.synchronize()``), peak memory, a train step's
               launches per step, the losses equal on both and the first
               within 1e-3 relative of phase 6's; no scaling number (one
               card). (d)
               ``infer`` at 540x960, D=191, bfloat16, volume=2: the whole
               map equal on both and over the images, finite, in [0,
               190], a served image's launches per image on each; ms per
               image.
14. bench -- ``practicaldeepstereo_nips2018_tpu_torch.bench.run()`` at
               its published defaults (the JAX bench's protocol: batch-1
               ``infer`` at 540x960, D=191, bfloat16; batches of 2 and 4
               under "unroll" and "direct"; train steps at batch 1, 2
               and 4, D=255; each the median slope of 2 and 10 chained
               calls over 5 repeats). Prints its line, then checks it:
               every key of the JAX bench's line, finite positive
               times, finite last losses, one untimed call of each
               configuration launching a served image's kernels per image
               ("unroll") or per batch ("direct") and a train step's per
               train step, finite maps in [0, 190], only the K1 to K4
               shapes phase 2 held, and the headline within 0.7-1.3 of
               the card's busy ms per image in phase 5's profiled
               requests and the batch-1 step of phase 6's (printed,
               with the headline over phase 5's request median); then
               its wall time on a line of its own.
15. psmnet -- PSMNet (``models/psmnet.py``) at the published SceneFlow
               recipe. K1 at its stride-1 3x3x3 shapes (batch 12, D=192
               at 256x512, bfloat16), forward and input gradient within
               one ulp of the plain version, their times beside cuDNN's
               forward, input and weight gradients (the classifiers' last
               conv, 32 -> 1, and its input gradient, 1 -> 32, take K1's
               direct kernel, which beats cuDNN there). Train steps at
               batch 12 with Adam: ms a step, peak memory, K1 launches
               and ``kernels.fallback_counts`` per step, a finite loss.
               One 960x540 pair served in bfloat16 and in float32
               (padded to 960x544) against the benchmark's float32
               reference (``pds_bench/architectures/psmnet.py``) on the
               same weights, their BatchNorm running statistics those of
               a train-mode forward on the pair: the largest and mean gap
               in pixels, float32 within 0.05 px.
               ``python3 chip_smoke.py --psmnet`` runs phases 1 and 15
               alone.
    mfu     -- useful FLOPs (``utils/flops.py``, the JAX package's count)
               over time over the card's bfloat16 peak, for the serving
               median (phase 5), the train step (phase 6) and each
               configuration of phase 11.

Then the ``kernels`` summary line (K1 to K5; launch counts from phases 5,
6, 8 to 14), the ``nvidia-smi`` line, and last ``{"ok": true, "device":
{...}}``.
Any failed check makes the script exit 1 without that last line; so does a
host without a card or a directory without the port. ``build/chip_smoke``
is removed at the end.
"""

from __future__ import annotations

import collections
import contextlib
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

from practicaldeepstereo_nips2018_tpu_torch import (
    bench, models, parallel)
from practicaldeepstereo_nips2018_tpu_torch.cli import (
    benchmark_flyingthings3d, common, export_kitti_submission,
    finetune_kitti, train_flyingthings3d)
from practicaldeepstereo_nips2018_tpu_torch.data import (
    FlyingThings3D, Kitti, Loader, native, pfm, png)
from practicaldeepstereo_nips2018_tpu_torch.data.flyingthings3d import (
    compute_disparity_statistic)
from practicaldeepstereo_nips2018_tpu_torch.ops import (
    block_norm, conv3d, conv_transpose3d, int8, kernels, loss, subpixel)
from practicaldeepstereo_nips2018_tpu_torch.models import psmnet
from practicaldeepstereo_nips2018_tpu_torch.parallel import runtime
from practicaldeepstereo_nips2018_tpu_torch.serving import InferenceSession
from practicaldeepstereo_nips2018_tpu_torch.training import (
    checkpoint, optimizer, trainer, weights)
from practicaldeepstereo_nips2018_tpu_torch.utils import flops, profiling

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
# Phase 14, the bench (``practicaldeepstereo_nips2018_tpu_torch/bench.py``):
# batch 1 as above, and at batch 2 and 4 K1 forward at the D=191 levels and
# K2 on [B, 96, 576, 960] under "direct", K1 forward and input gradient at
# the D=255 levels in its train steps. Every shape it launches is one of
# these (K1 as (B, D, C, H, W), K2 as (B, D, H, W)).
BENCH_BATCHES = (2, 4)
K1_BENCH_SHAPES = [(batch, *shape) for batch in (1, *BENCH_BATCHES)
                   for shape, _ in K1_LEVELS + K1_TRAIN_LEVELS]
K2_BENCH_SHAPES = [(batch, *K2_SHAPE[1:]) for batch in (1, *BENCH_BATCHES)]
# The keys of the JAX bench's line (root ``bench.py:203-228``), a leaf
# None, a dict keyed by batch size under BATCH_KEY; phase 14's line must
# have every one.
BATCH_KEY = "<batch>"
_PER_BATCH = {BATCH_KEY: dict.fromkeys(("step_seconds", "images_per_second"))}
JAX_BENCH_LINE = {
    "metric": None, "value": None, "unit": None, "vs_baseline": None,
    "detail": {
        "shape": None, "maximum_disparity": None, "compute_dtype": None,
        "device": None, "frames_per_second": None,
        "eval_images_per_second": _PER_BATCH, "slope_samples_s": None,
        "baseline_seconds": None,
        "flops": dict.fromkeys((
            "folded_conv_impl", "useful_gmacs", "executed_gmacs",
            "structural_overhead", "peak_bf16_tflops", "mfu_executed_pct",
            "mfu_useful_pct")),
        "train_step_seconds": None,
        "train_images_per_second": _PER_BATCH,
        "train_step_config": dict.fromkeys((
            "shape", "batch", "maximum_disparity", "compute_dtype",
            "remat")),
        "train_flops": dict.fromkeys((
            "remat", "executed_gmacs", "useful_gmacs", "recompute_gmacs",
            "recompute_overhead_pct", "train_mfu_executed_pct",
            "train_mfu_useful_pct")),
    }}
# Phase 14's headline and batch-1 train step against phase 5's busy time of
# the card per image (the profiler's clock; a synchronous request's latency
# also holds host work that the bench's chained calls overlap) and phase
# 6's step, which time the same work by other clocks.
BENCH_RATIO_LIMITS = (0.7, 1.3)
TRAIN_MAXIMUM_DISPARITY, TRAIN_STEPS, LEARNING_RATE = 255, 6, 1e-2
K1_COLD_SHAPE = (48, 8, 144, 240)  # 26.5 MB in bfloat16: fits the L2 warm
K1_SOURCE = "practicaldeepstereo_nips2018_tpu_torch/csrc/conv3d_k3s1.cu"
K2_SOURCE = "practicaldeepstereo_nips2018_tpu_torch/csrc/subpixel_map.cu"
K3_SOURCE = ("practicaldeepstereo_nips2018_tpu_torch/csrc/"
             "conv_transpose3d.cu")
K1_REPLACES = "practicaldeepstereo_nips2018_tpu/ops/folded_banded.py:242"
K2_REPLACES = "practicaldeepstereo_nips2018_tpu/ops/subpixel_pallas.py:35"
# K3 and K4 replace no Pallas kernel: they port the JAX package's phased
# transposed convs (:176 the 4x4x4 ones, :209 the full-size one), which XLA
# lowers on the TPU.
K3_REPLACES = "practicaldeepstereo_nips2018_tpu/ops/folded_banded.py:176"
# Launches of one served image (9 K1 on the smooths, 1 K2 on its map, 6 K3
# on the transposed convs, 37 K5 pairs: one per norm of the forward, 15 in
# the embedding of both images, 4 in matching, 18 in the hourglass; a
# "direct" batch makes as many) and of one train step with remat off (each
# smooth and transposed conv forward and again for its input gradient: 18
# K1, 6 K3, 6 K4; no K2; K5's forward on all 37 norms and its backward on
# the 35 conv blocks' norms, autograd recording them: the embedding's two
# input norms need no gradient). On a W-slice of the volume axis every
# norm all-reduces its moments: no K5.
SERVED_IMAGE = {conv3d.NAME: 9, subpixel.NAME: 1, conv_transpose3d.NAME: 6,
                block_norm.NAME: 37}
TRAIN_STEP = {conv3d.NAME: 18, conv_transpose3d.NAME: 6,
              conv_transpose3d.INPUT_GRAD_NAME: 6, block_norm.NAME: 37,
              block_norm.BACKWARD_NAME: 35}
SLICED_IMAGE = {name: count for name, count in SERVED_IMAGE.items()
                if name != block_norm.NAME}
SLICED_STEP = {name: count for name, count in TRAIN_STEP.items()
               if name not in (block_norm.NAME, block_norm.BACKWARD_NAME)}
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
# the remat policies with their launches per train step (:data:`TRAIN_STEP`
# plus the recomputed stages: "selective" recomputes the smoothing,
# contraction 1, expansion 4 and both upsamplers, 3 K1, 3 K3 and 10 K5
# forwards, matching's 4 norms among them; True every block, 9 K1, 6 K3
# and 22 K5 forwards), the int8 tail's shape at 540x960, D=191 (48
# disparities of [64, 144, 240]) and its output widths.
OPTION_CONFIGS = {
    "default": {}, "embedding_s2d": {"embedding_s2d": True},
    "factor_tail_conv1": {"factor_tail_conv1": True},
    "matching_tail_int8": {"matching_tail_int8": True},
    "all_three": {"embedding_s2d": True, "factor_tail_conv1": True,
                  "matching_tail_int8": True}}
EXACT_OPTIONS = ("embedding_s2d", "factor_tail_conv1")
REMAT_POLICIES = {
    "off": (False, TRAIN_STEP),
    "selective": ("selective", {**TRAIN_STEP, conv3d.NAME: 21,
                                conv_transpose3d.NAME: 9,
                                block_norm.NAME: 47}),
    "all": (True, {**TRAIN_STEP, conv3d.NAME: 27,
                   conv_transpose3d.NAME: 12, block_norm.NAME: 59})}
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
# K3 on the main path at 540x960, D=191: (cin, cout, D, H, W) of each
# transposed conv's input, in the order the path runs them (expansion1-4's
# upsamplers, upsample_to_halfsize, upsample_to_fullsize), one launch each
# per image; on the train path at D=255 the same six, each with one K4.
K3_LEVELS = [(128, 64, 3, 9, 15), (64, 32, 6, 18, 30),
             (32, 16, 12, 36, 60), (16, 8, 24, 72, 120),
             (8, 4, 48, 144, 240), (4, 1, 96, 288, 480)]
K3_TRAIN_LEVELS = [(128, 64, 4, 9, 15), (64, 32, 8, 18, 30),
                   (32, 16, 16, 36, 60), (16, 8, 32, 72, 120),
                   (8, 4, 64, 144, 240), (4, 1, 128, 288, 480)]


def k3_geometry(cout: int, width_padding: int = 1) -> tuple:
    """(kernel, stride, padding) of the hourglass's transposed conv with
    ``cout`` outputs: the full-size upsampler (cout 1) or a 4x4x4 one; W
    padding 3 on a haloed W-slice (:func:`~practicaldeepstereo_nips2018_
    tpu_torch.parallel.sharding.transposed_conv_halo`)."""
    if cout == 1:
        return (3, 4, 4), (1, 2, 2), (1, 1, width_padding)
    return (4, 4, 4), (2, 2, 2), (1, 1, width_padding)


def _k3_key(batch: int, shape, width_padding: int = 1) -> tuple:
    """How :func:`kernel_shapes` records a K3 or K4 launch: the forward's
    input as (B, cin, D, H, W) and its W padding."""
    cin, _, depth, height, width = shape
    return (batch, cin, depth, height, width, width_padding)


# Phase 13 (c) and (d): each process's transposed convs take its slice
# (quarter-resolution widths of VOLUME_QUARTER_SLICES, scaled to the level)
# with one halo column on either side and W padding 3.
K3_VOLUME_PADDING = 3
K3_VOLUME_SHAPES = {
    path: [(cin, cout, depth, height,
            quarter * width // (WIDTH // 4) + 2)
           for cin, cout, depth, height, width in levels
           for quarter in VOLUME_QUARTER_SLICES]
    for path, levels in (("phase 13 (c): D=255 training", K3_TRAIN_LEVELS),
                         ("phase 13 (d): D=191 serving", K3_LEVELS))}
# Phase 14: K3 at the D=191 levels at batch 1, 2 and 4 ("direct") and at
# the D=255 levels with K4 in its train steps at batch 1, 2 and 4.
K3_BENCH_SHAPES = [_k3_key(batch, shape) for batch in (1, *BENCH_BATCHES)
                   for shape in K3_LEVELS + K3_TRAIN_LEVELS]
K4_BENCH_SHAPES = [_k3_key(batch, shape) for batch in (1, *BENCH_BATCHES)
                   for shape in K3_TRAIN_LEVELS]
# K5 on the main path at 540x960, D=191: each norm of one served image as
# ([N, C, *spatial], variant, norms per image). Variants: "input" (the
# embedding's input norm: no LeakyReLU, no affine map), "block" (LeakyReLU,
# affine norm), "residual" (the same plus a residual block's add). The
# embedding (both images): the input norm, the two 5x5 stride-2 blocks,
# the residual blocks' four first and four second blocks, the left image's
# shortcut; matching: two residual blocks over 48 disparities; the
# hourglass: smoothing and expansion 4 (3), contractions 1-4 and
# expansions 3-1 (4, 4, 4 at 16, 32 and 64 features, 2 at 128), the
# half-size upsampler. 37 in all.
K5_IMAGE = [((1, 3, 576, 960), "input", 2), ((1, 64, 288, 480), "block", 2),
            ((1, 64, 144, 240), "block", 6),
            ((1, 64, 144, 240), "residual", 4), ((1, 8, 144, 240), "block", 1),
            ((48, 64, 144, 240), "block", 2),
            ((48, 64, 144, 240), "residual", 2),
            ((1, 8, 48, 144, 240), "block", 3),
            ((1, 16, 24, 72, 120), "block", 4),
            ((1, 32, 12, 36, 60), "block", 4), ((1, 64, 6, 18, 30), "block", 4),
            ((1, 128, 3, 9, 15), "block", 2),
            ((1, 4, 96, 288, 480), "block", 1)]
# Checked in float32 too, and the KITTI cell's matching volume (batch 4,
# D=255, 1280x384 padding: 256 entries of [64, 96, 320]) in both dtypes.
K5_KITTI_MATCHING = (256, 64, 96, 320)
K5_FLOAT32 = [((1, 3, 576, 960), "input"), ((1, 64, 144, 240), "block"),
              ((1, 64, 144, 240), "residual"), ((48, 64, 144, 240), "block"),
              ((48, 64, 144, 240), "residual"),
              ((1, 8, 48, 144, 240), "block"), ((1, 4, 96, 288, 480), "block")]
# K5's backward (with its forward) at each of the 35 conv-block norms of a
# D=255 train step at 540x960 (as ([N, C, *spatial], variant, dtype, norms
# a step)): matching's two residual blocks over 64 disparities, the
# hourglass's levels and its full-size upsampler, the embedding's blocks
# as in K5_IMAGE; KITTI's matching (batch 4, 1280x384 padding); and for
# the variants' sake the matching volume in float32 and the input norm's
# (no LeakyReLU, no affine map).
K5_TRAIN = [((64, 64, 144, 240), "block", torch.bfloat16, 2),
            ((64, 64, 144, 240), "residual", torch.bfloat16, 2),
            ((1, 4, 128, 288, 480), "block", torch.bfloat16, 1),
            ((1, 8, 64, 144, 240), "block", torch.bfloat16, 3),
            ((1, 16, 32, 72, 120), "block", torch.bfloat16, 4),
            ((1, 32, 16, 36, 60), "block", torch.bfloat16, 4),
            ((1, 64, 8, 18, 30), "block", torch.bfloat16, 4),
            ((1, 128, 4, 9, 15), "block", torch.bfloat16, 2),
            ((1, 64, 288, 480), "block", torch.bfloat16, 2),
            ((1, 64, 144, 240), "block", torch.bfloat16, 6),
            ((1, 64, 144, 240), "residual", torch.bfloat16, 4),
            ((1, 8, 144, 240), "block", torch.bfloat16, 1),
            ((256, 64, 96, 320), "block", torch.bfloat16, None),
            ((256, 64, 96, 320), "residual", torch.bfloat16, None),
            ((64, 64, 144, 240), "residual", torch.float32, None),
            ((1, 3, 576, 960), "input", torch.bfloat16, None)]
# K5's dweight and dbias against float64: their largest error within this
# share of their largest element. Float32 sums over a channel's rows read
# ~2e-7 there; a sum that drops a sample or a chunk of a row misses it.
K5_PARAMETER_GRADIENT = 1e-5
K5_SOURCE = "practicaldeepstereo_nips2018_tpu_torch/csrc/block_norm.cu"
# K5 replaces no Pallas kernel: the JAX package's instance norm, which XLA
# fuses with the activation around it.
K5_REPLACES = "practicaldeepstereo_nips2018_tpu/models/blocks.py::instance_norm"
# Phase 5: requests served again under the profiler after the timed ones,
# and the ``pds.*`` spans each image opens there (kernel spans: one per
# launch counted).
STAGE_REQUESTS = 5
SERVED_SPANS = {"pds.predict": 1, "pds.prepare": 1, "pds.embedding": 2,
                "pds.matching": 1, "pds.regularization": 1,
                "pds.estimator": 1, "pds.crop": 1, "pds.copy_out": 1}

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


def check_k1(shape, dtype, generator, batch: int = 1) -> dict:
    depth, channels, height, width = shape
    x = torch.randn((batch, channels, depth, height, width), device="cuda",
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
    what = f"K1 {shape} batch {batch} {dtype}"
    check(ok, f"{what}: max abs err {float(error.max())}")
    again = conv3d.conv3d_k3s1(x, weight, bias)
    check(torch.equal(again, got), f"{what}: two launches on the same "
          "input differ")
    other = torch.randn(x.shape, device="cuda", generator=generator).to(dtype)
    pair = conv3d.conv3d_k3s1(torch.cat([x, other]), weight, bias)
    check(torch.equal(pair[:batch], got) and torch.equal(
        pair[batch:], conv3d.conv3d_k3s1(other, weight, bias)),
        f"{what}: batch {2 * batch} differs from its halves' results")
    library_bias = bias.to(dtype)
    element = x.element_size()
    voxels = batch * depth * height * width
    record = {
        "kernel": conv3d.NAME, "shape": list(shape), "batch": batch,
        "dtype": str(dtype),
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


def check_k1_gradient(shape, generator, batch: int = 1) -> dict:
    """K1 at a training level: forward against its plain version, and the
    autograd Function's gradients against autograd of the plain version;
    times of the forward and of the input gradient through K1, against
    cuDNN's forward and input gradient (``convolution_backward``)."""
    depth, channels, height, width = shape
    what = f"K1 {shape} batch {batch}"
    limit = 1.0 / np.sqrt(27 * channels)
    x32 = torch.randn((batch, channels, depth, height, width), device="cuda",
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
          f"{what} bfloat16 forward: max abs err {forward_error}")

    got = _gradients(conv3d.Conv3dK3S1.apply, (x, weight, bias), grad)
    plain = _gradients(conv3d.conv3d_k3s1_plain, (x, weight, bias), grad)
    dgrad_error = float((got[1].float() - plain[1].float()).abs().max())
    check(one_ulp(got[1], plain[1]), f"{what} bfloat16 input gradient: "
          f"max abs err {dgrad_error}")
    got32 = _gradients(conv3d.Conv3dK3S1.apply, (x32, weight32, bias),
                       grad32)
    plain32 = _gradients(conv3d.conv3d_k3s1_plain, (x32, weight32, bias),
                         grad32)
    errors32 = [_relative_error(a, b) for a, b in zip(got32[1:],
                                                      plain32[1:])]
    check(max(errors32[1:]) <= 1e-4, f"{what} float32 weight/bias "
          f"gradients: relative errors {errors32[1:]}")
    check(errors32[0] <= 1e-4, f"{what} float32 input gradient: "
          f"relative error {errors32[0]}")

    flipped = weight.flip(2, 3, 4).transpose(0, 1)
    zero = torch.zeros(channels, device="cuda")
    library_bias = bias.bfloat16()
    voxels = batch * depth * height * width
    one_conv = bound(2 * (2 * channels * voxels + 27 * channels * channels)
                     + 4 * channels, 2.0 * voxels * channels * channels * 27,
                     torch.bfloat16)
    return {
        "kernel": conv3d.NAME, "shape": list(shape), "batch": batch,
        "dtype": "bfloat16", "forward_max_abs_err": forward_error,
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


@contextlib.contextmanager
def cudnn_benchmark():
    """cuDNN picks its algorithm by timing them (``cudnn.benchmark``); the
    first call of each shape, outside the graph :func:`time_ms` captures,
    makes the choice."""
    saved = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        yield
    finally:
        torch.backends.cudnn.benchmark = saved


def transposed_macs(input_shape, weight_shape, stride, padding) -> int:
    """Multiply-adds of a transposed conv on these shapes that touch the
    input: per axis, the (input, tap) pairs whose output ``stride * i -
    pad + t`` lies inside (the kernel visits no other tap)."""
    batch, cin, *sizes = input_shape
    total = batch * cin * weight_shape[1]
    for size, s, p, k in zip(sizes, stride, padding, weight_shape[2:]):
        out = (size - 1) * s - 2 * p + k
        total *= sum(1 for i in range(size) for t in range(k)
                     if 0 <= s * i - p + t < out)
    return total


def _k3_case(shape, generator, batch: int, width_padding: int = 1) -> tuple:
    """Float32 (x, weight, bias, stride, padding) at a K3 shape: a normal
    input and PyTorch's default U(+-1/sqrt(cout * taps)) weights."""
    cin, cout, depth, height, width = shape
    kernel, stride, padding = k3_geometry(cout, width_padding)
    limit = 1.0 / np.sqrt(cout * np.prod(kernel))
    x = torch.randn((batch, cin, depth, height, width), device="cuda",
                    generator=generator)
    weight = (torch.rand((cin, cout, *kernel), device="cuda",
                         generator=generator) * 2 - 1) * limit
    bias = (torch.rand(cout, device="cuda", generator=generator) * 2
            - 1) * limit
    return x, weight, bias, stride, padding


def _k3_bound(x, weight, stride, padding) -> dict:
    """K3's (and K4's) bound: the volume read, the weights, the output
    written, the float32 bias; 2 operations per multiply-add."""
    output = conv_transpose3d.output_shape(x.shape, weight.shape, stride,
                                           padding)
    return bound(x.element_size() * (x.numel() + weight.numel()
                                     + int(np.prod(output)))
                 + 4 * weight.shape[1],
                 2.0 * transposed_macs(x.shape, weight.shape, stride,
                                       padding), x.dtype)


def _close_enough(got, plain, dtype) -> bool:
    """float32: within 1e-4 absolute (TF32 off); bfloat16: one ulp."""
    if dtype == torch.float32:
        return float((got.float() - plain.float()).abs().max()) <= 1e-4
    return one_ulp(got, plain)


def _library_k3_ms(x, weight, bias, stride, padding) -> dict:
    """cuDNN's transposed conv on the same inputs (its bias in ``x``'s
    dtype), with ``cudnn.benchmark`` off and on. The slow library and
    plain calls are timed over fewer replays."""
    library_bias = bias.to(x.dtype)

    def library():
        return F.conv_transpose3d(x, weight, library_bias, stride, padding)

    timed = {"library_ms": time_ms(library, runs=5, calls=2)}
    with cudnn_benchmark():
        timed["library_benchmark_ms"] = time_ms(library, runs=5, calls=2)
    return timed


def check_k3(shape, dtype, generator, batch: int = 1,
             width_padding: int = 1, timed: bool = True) -> dict:
    """K3 forward against its plain version (float32 within 1e-4 with TF32
    off, bfloat16 within one ulp), twice on the same input (bit-equal), and
    at twice the batch (each half equal to its own result). ``timed``:
    kernel, plain and cuDNN times (benchmark off and on); else the kernel's
    alone."""
    x, weight, bias, stride, padding = _k3_case(shape, generator, batch,
                                                width_padding)
    x, weight = x.to(dtype), weight.to(dtype)
    got = conv_transpose3d.conv_transpose3d(x, weight, bias, stride, padding)
    plain = conv_transpose3d.conv_transpose3d_plain(x, weight, bias, stride,
                                                    padding)
    torch.cuda.synchronize()
    error = float((got.float() - plain.float()).abs().max())
    what = f"K3 {shape} W padding {width_padding} batch {batch} {dtype}"
    check(_close_enough(got, plain, dtype), f"{what}: max abs err {error}")
    again = conv_transpose3d.conv_transpose3d(x, weight, bias, stride,
                                              padding)
    check(torch.equal(again, got), f"{what}: two launches on the same "
          "input differ")
    other = torch.randn(x.shape, device="cuda", generator=generator).to(dtype)
    pair = conv_transpose3d.conv_transpose3d(torch.cat([x, other]), weight,
                                             bias, stride, padding)
    check(torch.equal(pair[:batch], got) and torch.equal(
        pair[batch:], conv_transpose3d.conv_transpose3d(
            other, weight, bias, stride, padding)),
        f"{what}: batch {2 * batch} differs from its halves' results")
    del pair, other, again
    record = {
        "kernel": conv_transpose3d.NAME, "shape": list(shape),
        "batch": batch, "width_padding": width_padding, "dtype": str(dtype),
        "max_abs_err": error,
        "tolerance": "abs <= 1e-4" if dtype == torch.float32
                     else "one bfloat16 ulp",
        "ms": time_ms(lambda: conv_transpose3d.conv_transpose3d(
            x, weight, bias, stride, padding)),
        **_k3_bound(x, weight, stride, padding)}
    if timed:
        record["plain_ms"] = time_ms(
            lambda: conv_transpose3d.conv_transpose3d_plain(
                x, weight, bias, stride, padding), runs=5, calls=2)
        record.update(_library_k3_ms(x, weight, bias, stride, padding))
    return record


def check_k3_gradient(shape, generator, batch: int = 1,
                      width_padding: int = 1, timed: bool = True) -> dict:
    """A transposed conv of the train path: K3's bfloat16 forward within one
    ulp of its plain version; ``ConvTranspose3dK3``'s gradients against
    autograd of the plain version (the input gradient through K4 within one
    bfloat16 ulp; the float32 input, weight and bias gradients within 1e-4
    of their largest); K4 alone against its plain version, twice on the
    same gradient (bit-equal) and at twice the batch. ``timed``: K3's and
    K4's times beside their plain versions' and cuDNN's (benchmark off and
    on), and cuDNN's weight gradient; else K3's and K4's alone."""
    x32, weight32, bias, stride, padding = _k3_case(shape, generator, batch,
                                                    width_padding)
    what = f"K3/K4 {shape} W padding {width_padding} batch {batch}"
    output_shape = conv_transpose3d.output_shape(x32.shape, weight32.shape,
                                                 stride, padding)
    grad32 = torch.randn(output_shape, device="cuda", generator=generator)
    x, weight, grad = (tensor.bfloat16() for tensor in (x32, weight32,
                                                        grad32))

    def function(x, weight, bias):
        return conv_transpose3d.ConvTranspose3dK3.apply(x, weight, bias,
                                                        stride, padding)

    def plain_function(x, weight, bias):
        return conv_transpose3d.conv_transpose3d_plain(x, weight, bias,
                                                       stride, padding)

    got = _gradients(function, (x, weight, bias), grad)
    plain = _gradients(plain_function, (x, weight, bias), grad)
    forward_error = float((got[0].float() - plain[0].float()).abs().max())
    check(one_ulp(got[0], plain[0]),
          f"{what} bfloat16 forward: max abs err {forward_error}")
    dgrad_error = float((got[1].float() - plain[1].float()).abs().max())
    check(one_ulp(got[1], plain[1]), f"{what} bfloat16 input gradient: "
          f"max abs err {dgrad_error}")
    del got, plain
    got32 = _gradients(function, (x32, weight32, bias), grad32)
    plain32 = _gradients(plain_function, (x32, weight32, bias), grad32)
    errors32 = [_relative_error(a, b) for a, b in zip(got32[1:],
                                                      plain32[1:])]
    check(max(errors32) <= 1e-4, f"{what} float32 input, weight and bias "
          f"gradients: relative errors {errors32}")
    del got32, plain32

    def k4(grad):
        return conv_transpose3d.conv_transpose3d_input_grad(
            grad, weight, stride, padding, (grad.shape[0], *x.shape[1:]))

    alone = k4(grad)
    alone_plain = conv_transpose3d.conv_transpose3d_input_grad_plain(
        grad, weight, stride, padding)
    torch.cuda.synchronize()
    check(one_ulp(alone, alone_plain), f"{what} K4 alone: max abs err "
          f"{float((alone.float() - alone_plain.float()).abs().max())}")
    check(torch.equal(k4(grad), alone), f"{what}: two K4 launches on the "
          "same gradient differ")
    other = torch.randn(grad.shape, device="cuda", generator=generator
                        ).bfloat16()
    pair = k4(torch.cat([grad, other]))
    check(torch.equal(pair[:batch], alone)
          and torch.equal(pair[batch:], k4(other)),
          f"{what}: K4 at batch {2 * batch} differs from its halves' results")
    del pair, other, alone_plain
    one_conv = _k3_bound(x, weight, stride, padding)
    record = {
        "kernel": conv_transpose3d.NAME,
        "input_gradient_kernel": conv_transpose3d.INPUT_GRAD_NAME,
        "shape": list(shape), "batch": batch,
        "width_padding": width_padding, "dtype": "bfloat16",
        "forward_max_abs_err": forward_error,
        "input_gradient_max_abs_err": dgrad_error,
        "float32_relative_err": dict(zip(("input", "weight", "bias"),
                                         errors32)),
        "tolerance": "bfloat16 forward and input gradient: one ulp; float32 "
                     "gradients: 1e-4 of the largest",
        "ms": time_ms(lambda: conv_transpose3d.conv_transpose3d(
            x, weight, bias, stride, padding)),
        "dgrad_ms": time_ms(lambda: k4(grad)),
        # K4 moves the same bytes and multiply-adds as K3.
        **one_conv, "dgrad_bound_ms": one_conv["bound_ms"]}
    if timed:
        def library_dgrad():
            return torch.ops.aten.convolution_backward(
                grad, x, weight, None, list(stride), list(padding),
                [1, 1, 1], True, [0, 0, 0], 1, [True, False, False])

        record["plain_ms"] = time_ms(lambda: plain_function(x, weight, bias),
                                     runs=5, calls=2)
        record["dgrad_plain_ms"] = time_ms(
            lambda: conv_transpose3d.conv_transpose3d_input_grad_plain(
                grad, weight, stride, padding), runs=5, calls=2)
        record.update(_library_k3_ms(x, weight, bias, stride, padding))
        record["dgrad_library_ms"] = time_ms(library_dgrad, runs=5, calls=2)
        with cudnn_benchmark():
            record["dgrad_library_benchmark_ms"] = time_ms(
                library_dgrad, runs=5, calls=2)
        record["wgrad_library_ms"] = time_ms(
            lambda: torch.ops.aten.convolution_backward(
                grad, x, weight, None, list(stride), list(padding),
                [1, 1, 1], True, [0, 0, 0], 1, [False, True, False]),
            runs=5, calls=2)
    return record


def check_k3_other_shapes(generator) -> float:
    """K3 and K4 at shapes off the main path, against their plain versions:
    even and mixed paddings (a pair of outputs then starts at -1), odd
    sizes, a channel count that takes one channel per thread, batch 2."""
    worst = 0.0
    for kernel, stride, padding, shape in (
            ((4, 4, 4), (2, 2, 2), (0, 2, 0), (2, 6, 3, 5, 7)),
            ((3, 4, 4), (1, 2, 2), (2, 0, 3), (1, 4, 5, 7, 9)),
            ((4, 4, 4), (2, 2, 2), (1, 1, 1), (1, 3, 4, 5, 3))):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(shape, device="cuda", generator=generator).to(
                dtype)
            weight = (torch.randn((shape[1], 5, *kernel), device="cuda",
                                  generator=generator) * 0.1).to(dtype)
            bias = torch.randn(5, device="cuda", generator=generator) * 0.1
            got = conv_transpose3d.conv_transpose3d(x, weight, bias, stride,
                                                    padding)
            grad = torch.randn(got.shape, device="cuda",
                               generator=generator).to(dtype)
            pairs = ((got, conv_transpose3d.conv_transpose3d_plain(
                          x, weight, bias, stride, padding)),
                     (conv_transpose3d.conv_transpose3d_input_grad(
                          grad, weight, stride, padding, x.shape),
                      conv_transpose3d.conv_transpose3d_input_grad_plain(
                          grad, weight, stride, padding)))
            for name, (kernel_result, plain) in zip(("K3", "K4"), pairs):
                error = float((kernel_result.float() - plain.float()).abs(
                ).max())
                check(_close_enough(kernel_result, plain, dtype),
                      f"{name} padding {padding} {shape} {dtype}: max abs "
                      f"err {error}")
                worst = max(worst, error)
    return worst


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


def _k5_arguments(shape, variant: str, dtype, generator) -> dict:
    """A conv block's tail at ``shape``: its input (the conv's output),
    affine map, slope and residual, as ``block_norm`` takes them."""
    channels = shape[1]
    x = (torch.randn(shape, device="cuda", generator=generator) * 2
         + 0.3).to(dtype)
    if variant == "input":
        return {"x": x, "weight": None, "bias": None, "negative_slope": None,
                "residual": None}
    return {"x": x,
            "weight": 1 + 0.3 * torch.randn(channels, device="cuda",
                                            generator=generator),
            "bias": torch.randn(channels, device="cuda", generator=generator),
            "negative_slope": models.blocks.LEAKY_RELU_SLOPE,
            "residual": (torch.randn(shape, device="cuda",
                                     generator=generator).to(dtype)
                         if variant == "residual" else None)}


def check_k5(shape, variant: str, dtype, generator) -> dict:
    """K5 against its plain version at ``shape``: the norm in bfloat16
    within one ulp, in float32 within 1e-4; the residual add exact (K5 with
    a residual equal to K5 without it plus the residual); two launches
    bit-equal, and each half of a batch of two equal to its own result;
    K5, plain and PyTorch's own leaky_relu + instance_norm (+ add) times,
    and the byte bound: x (and the residual) read once, y written once."""
    arguments = _k5_arguments(shape, variant, dtype, generator)
    x, residual = arguments["x"], arguments["residual"]
    eps = models.blocks.INSTANCE_NORM_EPS

    def kernel(**changed):
        return block_norm.block_norm(**{**arguments, **changed}, eps=eps)

    def plain(**changed):
        return block_norm.block_norm_plain(**{**arguments, **changed},
                                           eps=eps)

    def library():
        y = x if variant == "input" else F.leaky_relu(
            x, arguments["negative_slope"])
        y = F.instance_norm(y, weight=arguments["weight"],
                            bias=arguments["bias"], eps=eps)
        return y if residual is None else y + residual

    got, norm = kernel(), kernel(residual=None)
    expected = plain(residual=None)
    torch.cuda.synchronize()
    error = (norm.float() - expected.float()).abs()
    what = f"K5 {shape} {variant} {dtype}"
    if dtype == torch.float32:
        tolerance = "norm abs <= 1e-4"
        ok = float(error.max()) <= 1e-4
    else:
        tolerance = "norm abs <= 2^-7 * |value| + 1e-6 (one bfloat16 ulp)"
        ok = one_ulp(norm, expected)
    check(ok, f"{what}: max abs err {float(error.max())}")
    if residual is not None:
        check(torch.equal(got, norm + residual),
              f"{what}: K5 with the residual differs from K5 without it "
              "plus the residual")
    check(torch.equal(kernel(), got), f"{what}: two launches on the same "
          "input differ")
    other = _k5_arguments(shape, variant, dtype, generator)
    pair = kernel(x=torch.cat([x, other["x"]]), residual=None
                  if residual is None else torch.cat([residual,
                                                      other["residual"]]))
    check(torch.equal(pair[:shape[0]], got) and torch.equal(
        pair[shape[0]:], kernel(x=other["x"], residual=other["residual"])),
        f"{what}: a batch of two differs from its halves' results")
    del pair, other
    streams = 2 + (residual is not None)
    record = {
        "kernel": block_norm.NAME, "shape": list(shape), "variant": variant,
        "dtype": str(dtype), "max_abs_err": float(error.max()),
        "tolerance": tolerance, "ms": time_ms(kernel),
        "plain_ms": time_ms(plain, runs=5, calls=2),
        "library_ms": time_ms(library, runs=5, calls=2)}
    record.update(bound(streams * x.numel() * x.element_size()
                        + 8 * shape[1], 10.0 * x.numel(), torch.float32))
    record["of_bound"] = record["ms"] / record["bound_ms"]
    return record


def time_events_ms(function, runs: int = 5) -> float:
    """Median device time of one call between CUDA events, no graph (for
    autograd's backward, which a graph does not capture here)."""
    function()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        function()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _k5_exact(grad, x, weight, slope, eps, got, samples: int = 16) -> dict:
    """K5's gradients ``got`` (dx, dweight, dbias) against float64 ones on
    the card (``block_norm_backward_plain`` of a float64 output gradient,
    the LeakyReLU rounded in ``x``'s dtype as K5 rounds it, so only K5's
    float32 arithmetic lies between them), in slices of ``samples`` rows of
    the batch: dx within ``ulp`` (2^-7 bfloat16, 2^-20 float32) of 2 |value|
    plus the magnitude of the terms it sums (``block_norm_backward_scale``);
    dweight and dbias within ``K5_PARAMETER_GRADIENT`` of their largest
    float64 element. Returns the worst share of each tolerance and each
    error over its tensor's largest float64 element."""
    ulp = 2 ** -7 if x.dtype == torch.bfloat16 else 2 ** -20
    weight64 = None if weight is None else weight.double()
    share, gap_largest, exact_dx_largest, parameters = 0.0, 0.0, 0.0, None
    for first in range(0, x.shape[0], samples):
        part = slice(first, first + samples)
        d = grad[part].double()
        exact = block_norm.block_norm_backward_plain(d, x[part], weight64,
                                                     slope, eps)
        scale = block_norm.block_norm_backward_scale(d, x[part], weight64,
                                                     slope, eps)
        gap = (got[0][part].double() - exact[0]).abs()
        share = max(share, float(
            (gap / (ulp * (2 * exact[0].abs() + scale))).max()))
        gap_largest = max(gap_largest, float(gap.max()))
        exact_dx_largest = max(exact_dx_largest,
                               float(exact[0].abs().max()))
        if weight is not None:
            parameters = exact[1:] if parameters is None else [
                total + value for total, value in zip(parameters, exact[1:])]
        del exact, scale, gap
    worst = {"dx": share}
    relative = {"dx": gap_largest / exact_dx_largest
                if exact_dx_largest else 0.0}
    if weight is not None:
        for name, value, exact in zip(("dweight", "dbias"), got[1:],
                                      parameters):
            relative[name] = float((value.double() - exact).abs().max()
                                   / exact.abs().max())
            worst[name] = relative[name] / K5_PARAMETER_GRADIENT
    return {"share_of_tolerance": worst, "relative_err": relative}


def check_k5_gradient(shape, variant: str, dtype, generator) -> dict:
    """K5's backward at a training shape: ``BlockNorm``'s input, weight,
    bias and residual gradients against float64 ones on the card
    (:func:`_k5_exact`) for an output gradient with a mean and a share
    along ``x``, so that the row sums dx subtracts are not small beside it,
    the residual's equal to the output gradient; two
    backward launches bit-equal; K5's backward ms beside its byte bound
    (read x and dy, write dx: the least a backward moves) and autograd's
    backward of the composition (``models/blocks.py``'s LeakyReLU,
    ``instance_norm`` and add), K5's forward beside the composition's."""
    arguments = _k5_arguments(shape, variant, dtype, generator)
    x, weight, bias, slope, residual = (
        arguments[key] for key in ("x", "weight", "bias", "negative_slope",
                                   "residual"))
    eps = models.blocks.INSTANCE_NORM_EPS
    grad = (torch.randn(shape, device="cuda", generator=generator) + 0.5
            + 0.25 * x.float()).to(dtype)
    what = f"K5 backward {shape} {variant} {dtype}"
    leaves = [None if tensor is None else
              tensor.detach().clone().requires_grad_()
              for tensor in (x, weight, bias, residual)]
    block_norm.BlockNorm.apply(leaves[0], leaves[1], leaves[2], slope,
                               leaves[3], eps).backward(grad)
    got = [None if leaf is None else leaf.grad for leaf in leaves]
    del leaves
    if residual is not None:
        check(torch.equal(got[3], grad), f"{what}: the residual's gradient "
              "is not the output's")
    moments = block_norm._forward(x, weight, bias, slope, residual, eps)[1]

    def backward():
        return block_norm.block_norm_backward(grad, x, weight, slope, eps,
                                              moments)

    again = backward()
    check(all(a is None or torch.equal(a, b) for a, b in zip(again, got)),
          f"{what}: two backward launches differ")
    del again
    exact = _k5_exact(grad, x, weight, slope, eps, got)
    check(max(exact["share_of_tolerance"].values()) <= 1.0,
          f"{what}: against float64 {exact}")
    del got

    def composition():
        leaves = [None if tensor is None else
                  tensor.detach().requires_grad_()
                  for tensor in (x, weight, bias)]
        y = leaves[0] if slope is None else F.leaky_relu(leaves[0], slope)
        y = models.blocks.instance_norm(y, leaves[1], leaves[2], eps)
        return y if residual is None else y + residual, [
            leaf for leaf in leaves if leaf is not None]

    y, inputs = composition()
    record = {
        "kernel": block_norm.BACKWARD_NAME, "shape": list(shape),
        "variant": variant, "dtype": str(dtype), **exact,
        "tolerance": "dx: ulp * (2 |value| + the terms' magnitude), ulp "
                     "2^-7 bfloat16, 2^-20 float32; dweight and dbias: "
                     f"{K5_PARAMETER_GRADIENT} of their largest element; "
                     "against float64 on the card",
        "ms": time_ms(backward, runs=10, calls=4),
        "library_ms": time_events_ms(lambda: torch.autograd.grad(
            y, inputs, grad, retain_graph=True)),
        "forward_ms": time_ms(lambda: block_norm.block_norm(
            **arguments, eps=eps), runs=10, calls=4),
        "library_forward_ms": time_events_ms(lambda: composition()[0])}
    del y, inputs
    record.update(bound(3 * x.numel() * x.element_size() + 12 * shape[1],
                        12.0 * x.numel(), torch.float32))
    record["of_bound"] = record["ms"] / record["bound_ms"]
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
    for shape in K3_LEVELS:
        for dtype in (torch.float32, torch.bfloat16):
            record = check_k3(shape, dtype, generator)
            record["launches_per_image"] = 1
            emit({"phase": "kernel_check", **record})
            results[(conv_transpose3d.NAME, shape, dtype)] = record
    emit({"phase": "kernel_check", "kernel": conv_transpose3d.NAME,
          "shapes": "off the main path, K3 and K4: paddings (0, 2, 0) "
                    "[2, 6, 3, 5, 7], (2, 0, 3) [1, 4, 5, 7, 9] (3, 4, 4) "
                    "kernel, (1, 1, 1) [1, 3, 4, 5, 3]; cout 5",
          "max_abs_err": check_k3_other_shapes(generator)})
    k5_shapes = [(shape, variant, torch.bfloat16, count)
                  for shape, variant, count in K5_IMAGE]
    k5_shapes += [(K5_KITTI_MATCHING, variant, dtype, None)
                  for variant in ("block", "residual")
                  for dtype in (torch.bfloat16, torch.float32)]
    k5_shapes += [(shape, variant, torch.float32, None)
                  for shape, variant in K5_FLOAT32]
    for shape, variant, dtype, count in k5_shapes:
        record = check_k5(shape, variant, dtype, generator)
        if count is not None:
            record["launches_per_image"] = count
        emit({"phase": "kernel_check", **record})
        results[(block_norm.NAME, shape, variant, dtype)] = record
        torch.cuda.empty_cache()
    for shape, variant, dtype, count in K5_TRAIN:
        record = check_k5_gradient(shape, variant, dtype, generator)
        if count is not None:
            record["norms_per_train_step"] = count
        emit({"phase": "kernel_gradient_check", **record})
        results[(block_norm.BACKWARD_NAME, shape, variant, dtype)] = record
        torch.cuda.empty_cache()
    for shape in K3_TRAIN_LEVELS:
        record = check_k3_gradient(shape, generator)
        record["launches_per_train_step"] = {"K3": 1, "K4": 1}
        emit({"phase": "kernel_gradient_check", **record})
        results[("k3 train", shape)] = record
    for path, shapes in K3_VOLUME_SHAPES.items():
        for shape in shapes:
            if "training" in path:
                records = [check_k3_gradient(
                    shape, generator, width_padding=K3_VOLUME_PADDING,
                    timed=False)]
            else:
                records = [check_k3(shape, dtype, generator,
                                    width_padding=K3_VOLUME_PADDING,
                                    timed=False)
                           for dtype in (torch.float32, torch.bfloat16)]
            for record in records:
                record["on"] = f"{path}: a haloed W-slice of one process"
                emit({"phase": "kernel_check", **record})
    for batch in BENCH_BATCHES:
        for shape in K3_LEVELS:
            record = check_k3(shape, torch.bfloat16, generator, batch,
                              timed=False)
            record["on"] = 'phase 14: the bench\'s "direct" serving'
            emit({"phase": "kernel_check", **record})
            results[(conv_transpose3d.NAME, shape, torch.bfloat16,
                     batch)] = record
        for shape in K3_TRAIN_LEVELS:
            record = check_k3_gradient(shape, generator, batch, timed=False)
            record["on"] = "phase 14: the bench's train steps"
            emit({"phase": "kernel_gradient_check", **record})
            results[("k3 train", shape, batch)] = record
    for batch in BENCH_BATCHES:
        for shape, convs in K1_LEVELS:
            record = check_k1(shape, torch.bfloat16, generator, batch)
            record["launches_per_batch"] = convs
            record["on"] = 'phase 14: the bench\'s "direct" serving'
            emit({"phase": "kernel_check", **record})
            results[(conv3d.NAME, shape, torch.bfloat16, batch)] = record
        for shape, convs in K1_TRAIN_LEVELS:
            record = check_k1_gradient(shape, generator, batch)
            record["launches_per_train_step"] = 2 * convs
            record["on"] = "phase 14: the bench's train steps"
            emit({"phase": "kernel_gradient_check", **record})
            results[("train", shape, batch)] = record
        for dtype in (torch.float32, torch.bfloat16):
            shape = (batch, *K2_SHAPE[1:])
            record = check_k2(dtype, generator, shape)
            record["launches_per_batch"] = 1
            record["on"] = 'phase 14: the bench\'s "direct" serving'
            emit({"phase": "kernel_check", **record})
            results[(subpixel.NAME, shape, dtype)] = record
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
    """Forward hooks on every ``nn.LeakyReLU`` of ``network``, and on each
    conv block's ``tail``, whose LeakyReLU runs inside K5 on the card
    without calling the module. Without ``branches`` they record, per
    LeakyReLU module and call, where the input is > 0 (the branch of slope
    1), and that record is returned. With ``branches``, such a record of
    another run on the same inputs, each call takes the recorded branches
    instead of its own (the composition's modules: a run on the CPU or on
    W-slices), and the returned record holds per call the number of
    elements whose own branch differs and the largest |input| among them
    over the call's largest |input|."""
    record = {}

    def tail(y, columns=None, residual=None, *, block, name):
        if branches is None and models.blocks.runs_block_norm(y, columns):
            record.setdefault(name, []).append((y > 0).cpu())
        return type(block).tail(block, y, columns, residual)

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
        if isinstance(module, models.blocks.ConvBlock):
            module.tail = functools.partial(tail, block=module,
                                            name=f"{name}.1")
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
    _expect_launches(counts, launches_of(steps=1), "train_path")
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
    """Returns the launch counts, the median ms per request and the card's
    busy ms per image of the profiled requests."""
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
    _expect_launches(counts, launches_of(images=served_images),
                     f"serving, {served_images} images")
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
    before = collections.Counter(kernels.launch_counts)
    spans, busy_ms = serving_spans(session, images[:STAGE_REQUESTS])
    launched = collections.Counter(kernels.launch_counts) - before
    expected = {**{name: count * STAGE_REQUESTS
                   for name, count in SERVED_SPANS.items()},
                **{f"pds.kernel.{name}": count
                   for name, count in launched.items()}}
    calls = {name: span["calls"] for name, span in spans.items()}
    check(calls == expected,
          f"serving: spans {calls}, expected {expected}")
    for name, span in spans.items():
        emit({"phase": "serving_span", "card": card, "span": name,
              "requests": STAGE_REQUESTS, **span})
    emit({"phase": "serving", "card": card,
          "size": [HEIGHT, WIDTH], "maximum_disparity": MAXIMUM_DISPARITY,
          "dtype": "bfloat16", "requests": SERVING_REQUESTS + 1,
          "images": served_images,
          "ms_per_image_median": statistics.median(request_ms),
          "ms_per_image_p90": float(np.percentile(request_ms, 90)),
          "request_ms": request_ms,
          "device_busy_ms_per_image": busy_ms,
          "batch2_vs_batch1_max_abs_diff": batch_difference,
          "max_memory_allocated_bytes": peak_bytes,
          "launches": counts,
          "disparity_range": [float(min(o.min() for o in outputs)),
                              float(max(o.max() for o in outputs))]})
    return counts, statistics.median(request_ms), busy_ms


def serving_spans(session, images) -> tuple:
    """Serves ``images`` (``[N, 2, H, W, 3]`` pairs) one request at a time
    under ``utils/profiling.trace``; per ``pds.*`` span of the port, from
    the profiler's ``key_averages()`` by name: its calls, and per image
    its host ms and the device ms of the kernels launched inside it; and
    the card's busy ms per image inside ``pds.predict`` (:func:`busy_us`),
    which also counts the hand kernels that the profiler links to no host
    range."""
    with profiling.trace(str(SCRATCH / "serving_trace")) as profile:
        for left, right in images:
            session.predict(left[None], right[None])
        torch.cuda.synchronize()
    spans = {}
    for event in profile.key_averages():
        if (event.key.startswith("pds.")
                and event.device_type == torch.autograd.DeviceType.CPU):
            spans[event.key] = {
                "calls": event.count,
                "host_ms_per_image": event.cpu_time_total / 1e3
                / len(images),
                "device_ms_per_image": event.device_time_total / 1e3
                / len(images)}
    busy = sum(busy for busy, _ in busy_us(profile, "pds.predict"))
    return spans, busy / 1e3 / len(images)


def _top_kernels(profile, count: int = 10) -> list:
    """The ``count`` kernels with the most device time in ``profile``."""
    def device_us(event):
        return getattr(event, "self_device_time_total",
                       getattr(event, "self_cuda_time_total", 0.0))

    events = [event for event in profile.key_averages()
              if device_us(event) > 0]
    # The kernels themselves, not the operators that launched them nor the
    # device-side shadows of host ranges such as the port's spans.
    events = [event for event in events
              if "CUDA" in str(getattr(event, "device_type", ""))
              and not getattr(event, "is_user_annotation", False)] or events
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
        _expect_launches(counts, launches_of(steps=1), "training, one step")
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
    _expect_launches(launches["eval"], launches_of(images=1), "eval")
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


def launches_of(images: int = 0, steps: int = 0,
                step: dict = TRAIN_STEP, image: dict = SERVED_IMAGE) -> dict:
    """The launches of ``images`` served images of ``image``'s counts and
    ``steps`` train steps of ``step``'s, by kernel, kernels launched no
    time left out."""
    total = collections.Counter()
    for per, count in ((image, images), (step, steps)):
        for name, launches in per.items():
            total[name] += launches * count
    return {name: count for name, count in total.items() if count}


def _expect_launches(counts: dict, expected: dict, what: str) -> None:
    """Each kernel launched exactly as often as ``expected`` says."""
    got = {name: count for name, count in counts.items() if count}
    check(got == expected, f"{what}: launches {got}, expected {expected}")


def _decodes(path: pathlib.Path) -> bool:
    return path.is_file() and png.read_png(str(path)).ndim == 3


def busy_us(profile, range_name: str) -> list:
    """(busy, wall) microseconds of each ``range_name`` range, from the
    profiler's events: busy is the union of the device intervals (kernels,
    copies; host ranges' shadows on the device's timeline left out) that
    start inside the range, cut at its end."""
    events = profile.events()
    device = sorted(
        (event.time_range.start, event.time_range.end) for event in events
        if event.device_type == torch.autograd.DeviceType.CUDA
        and not getattr(event, "is_user_annotation", False))
    result = []
    for event in events:
        if (event.name != range_name
                or event.device_type != torch.autograd.DeviceType.CPU):
            continue
        start, end = event.time_range.start, event.time_range.end
        busy, reach = 0.0, start
        for first, last in device:
            if start <= first < end:
                busy += max(0.0, min(last, end) - max(first, reach))
                reach = max(reach, min(last, end))
        result.append((busy, end - start))
    return result


def busy_share(profile, range_name: str):
    """Share of the last ``range_name`` range's wall time in which the card
    ran something (:func:`busy_us`). None when the trace has no such
    range."""
    ranges = busy_us(profile, range_name)
    if not ranges:
        return None
    busy, wall = ranges[-1]
    return busy / wall


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
    # Per run: 3 train steps and one validation image with its untimed
    # warm-up.
    _expect_launches(launches, launches_of(images=2 * 2, steps=2 * 3),
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
        _expect_launches(counts, launches_of(images=images + 1),
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
    _expect_launches(launches, launches_of(images=2, steps=3),
                     "kitti fine-tune")
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
    _expect_launches(exported, launches_of(images=3), "kitti export")
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
        _expect_launches(counts, launches_of(images=SERVING_REQUESTS),
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
    for name, (policy, per_step) in REMAT_POLICIES.items():
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
            _expect_launches(counts, launches_of(steps=1, step=per_step),
                             f"options remat {name}, one step")
        check(all(np.isfinite(losses)), f"options remat {name}: losses "
              f"{losses}")
        milliseconds[f"train_remat_{name}"] = statistics.median(step_ms)
        training[name] = {
            "ms_per_step_median": milliseconds[f"train_remat_{name}"],
            "step_ms": step_ms, "losses": losses,
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "launches_per_step": per_step}
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
    per_step = []
    for _ in range(TRAIN_STEPS):
        kernels.launch_counts.clear()
        begin = time.perf_counter()
        losses.append(float(step()))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - begin) * 1e3)
        per_step.append(dict(kernels.launch_counts))
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
                   "launches_per_step": per_step,
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
        _expect_launches(pair[rank]["launches"], launches_of(steps=1),
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
        for counts in full[rank]["launches_per_step"]:
            _expect_launches(counts, launches_of(steps=1),
                             f"parallel full size, process {rank}, one step")
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
    # Per process: its images and the untimed warm-up.
    for rank, images in ((0, 2), (1, 1)):
        _expect_launches(full[rank]["validation"]["launches"],
                         launches_of(images=images + 1),
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
            "launches_per_step": result["launches_per_step"]}
            for result in full],
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
    _expect_launches(launches["parallel_nccl"],
                     launches_of(images=2, steps=3),
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
    step_ms, losses, per_step, launches = [], [], [], {}
    for _ in range(TRAIN_STEPS):
        kernels.launch_counts.clear()
        begin = time.perf_counter()
        losses.append(float(step()))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - begin) * 1e3)
        per_step.append(dict(kernels.launch_counts))
        for name, count in kernels.launch_counts.items():
            launches[name] = launches.get(name, 0) + count
    peak_bytes = torch.cuda.max_memory_allocated()
    runtime.barrier()
    return {"first_loss": first_loss, "step_ms": step_ms, "losses": losses,
            "launches_per_step": per_step, "launches": launches,
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
    launches took: K1's input as (B, D, C, H, W), K2's scores as (B, D, H,
    W), K3's input and K4's gradient as (B, cin, D, H, W, W padding)."""
    shapes = {"k1_shapes": set(), "k2_shapes": set(), "k3_shapes": set(),
              "k4_shapes": set()}
    k1, k2 = conv3d.conv3d_k3s1, subpixel.subpixel_map
    k3 = conv_transpose3d.conv_transpose3d
    k4 = conv_transpose3d.conv_transpose3d_input_grad

    def k1_recorded(x, *args, **kwargs):
        batch, channels, depth, height, width = x.shape
        shapes["k1_shapes"].add((batch, depth, channels, height, width))
        return k1(x, *args, **kwargs)

    def k2_recorded(scores, *args, **kwargs):
        batch, height, width, disparities = scores.shape
        shapes["k2_shapes"].add((batch, disparities, height, width))
        return k2(scores, *args, **kwargs)

    def k3_recorded(x, weight, bias, stride, padding):
        shapes["k3_shapes"].add((*x.shape, padding[-1]))
        return k3(x, weight, bias, stride, padding)

    def k4_recorded(grad_y, weight, stride, padding, input_shape):
        shapes["k4_shapes"].add((*input_shape, padding[-1]))
        return k4(grad_y, weight, stride, padding, input_shape)

    conv3d.conv3d_k3s1, subpixel.subpixel_map = k1_recorded, k2_recorded
    conv_transpose3d.conv_transpose3d = k3_recorded
    conv_transpose3d.conv_transpose3d_input_grad = k4_recorded
    try:
        result = function()
    finally:
        conv3d.conv3d_k3s1, subpixel.subpixel_map = k1, k2
        conv_transpose3d.conv_transpose3d = k3
        conv_transpose3d.conv_transpose3d_input_grad = k4
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
    gradients and updated weights bit-equal on every process; a train
    step's launches per step and a served image's per ``infer`` on each."""
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
        _expect_launches(rank["step_launches"],
                         launches_of(steps=1, step=SLICED_STEP),
                         f"volume ({name}) step, process {index}")
        _expect_launches(rank["infer_launches"],
                         launches_of(images=1, image=SLICED_IMAGE),
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


def _at_batch(shapes, batch: int = 1) -> list:
    """(D, C, H, W) K1 shapes -> (batch, D, C, H, W)."""
    return [(batch, *shape) for shape in shapes]


def _expect_checked_shapes(runs: list, what: str, k1_shapes: list,
                           k2_shapes: list, k3_shapes: list,
                           k4_shapes: list) -> None:
    """Each run (one per process) of ``what`` launched K1 to K4 only at
    shapes that phase 2 held against their plain versions: K1 as (B, D,
    C, H, W), K2 as (B, D, H, W), K3 and K4 as :func:`_k3_key`."""
    for rank, run in enumerate(runs):
        for key, checked in (("k1_shapes", k1_shapes),
                             ("k2_shapes", k2_shapes),
                             ("k3_shapes", k3_shapes),
                             ("k4_shapes", k4_shapes)):
            unchecked = [shape for shape in run[key]
                         if tuple(shape) not in checked]
            check(not unchecked, f"{what}, process {rank}: {key} "
                  f"{unchecked} were not checked in phase 2")


def check_volume_training(results: list, bare_step_ms: float,
                          first_step_loss: float) -> dict:
    """(c): equal losses on both processes, the first within
    :data:`VOLUME_LOSS_TOLERANCE` relative of phase 6's unsharded first
    step (same example, same first weights), a train step's launches per
    step."""
    runs = [result["c"] for result in results]
    for rank, run in enumerate(runs):
        for counts in run["launches_per_step"]:
            _expect_launches(counts, launches_of(steps=1, step=SLICED_STEP),
                             f"volume (c), process {rank}, one step")
        check(all(np.isfinite(run["losses"] + [run["first_loss"]])),
              f"volume (c): losses {run['losses']}")
    sliced = [_k3_key(1, shape, K3_VOLUME_PADDING) for shape in
              K3_VOLUME_SHAPES["phase 13 (c): D=255 training"]]
    _expect_checked_shapes(runs, "volume (c)", _at_batch(K1_VOLUME_SHAPES[
        "phase 13 (c): D=255 training"]), [], sliced, sliced)
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
            "k1_shapes": run["k1_shapes"], "k3_shapes": run["k3_shapes"],
            "k4_shapes": run["k4_shapes"],
            "launches_per_step": run["launches_per_step"]} for run in runs]}


def check_volume_serving(results: list, serving_ms: float) -> dict:
    """(d): the whole map equal on both processes and over the images,
    finite, in [0, 190]; a served image's launches per image on each."""
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
            _expect_launches(counts,
                             launches_of(images=1, image=SLICED_IMAGE),
                             f"volume (d), process {rank}")
    _expect_checked_shapes(runs, "volume (d)", _at_batch(K1_VOLUME_SHAPES[
        "phase 13 (d): D=191 serving"]), K2_VOLUME_SHAPES, [
            _k3_key(1, shape, K3_VOLUME_PADDING) for shape in
            K3_VOLUME_SHAPES["phase 13 (d): D=191 serving"]], [])
    return {"size": [HEIGHT, WIDTH], "maximum_disparity": MAXIMUM_DISPARITY,
            "compute_dtype": "bfloat16", "images": VOLUME_SERVING_IMAGES,
            "k1_shapes": [run["k1_shapes"] for run in runs],
            "k2_shapes": [run["k2_shapes"] for run in runs],
            "k3_shapes": [run["k3_shapes"] for run in runs],
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


def missing_keys(line, structure: dict, path: str = "") -> list:
    """The paths of ``structure``'s keys (:data:`JAX_BENCH_LINE`) that
    ``line`` lacks."""
    if not isinstance(line, dict):
        return [path or "the line"]
    if BATCH_KEY in structure:
        if not line:
            return [f"{path}: no batch"]
        return [missing for batch, record in line.items()
                for missing in missing_keys(record, structure[BATCH_KEY],
                                            f"{path}.{batch}")]
    missing = []
    for key, inner in structure.items():
        if key not in line:
            missing.append(f"{path}.{key}")
        elif inner is not None:
            missing += missing_keys(line[key], inner, f"{path}.{key}")
    return missing


def _bench_times(line: dict) -> list:
    """Every time in the bench's line, in seconds or images per second."""
    detail = line["detail"]
    times = [line["value"], detail["frames_per_second"],
             detail["train_step_seconds"], *detail["slope_samples_s"]]
    for key in ("eval_images_per_second", "eval_images_per_second_direct",
                "train_images_per_second"):
        for record in detail[key].values():
            times += [record["step_seconds"], record["images_per_second"]]
    for record in detail["configurations"].values():
        times += [record["seconds"], *record["slopes_s"]]
    return times


def _expected_bench_launches(name: str, batch: int) -> dict:
    """The launches of one call of a bench configuration: a served image's
    per image under "unroll" (and the batch-1 headline), per batch under
    "direct"; a train step's per train step."""
    if name.startswith("train"):
        return launches_of(steps=1)
    return launches_of(images=batch if name.startswith("unroll") else 1)


def phase_bench(card: str, serving_ms: float, serving_busy_ms: float,
                step_ms: float) -> dict:
    """The port's bench at its published defaults (540x960; D=191 at batch
    1, 2 and 4; D=255 train steps at batch 1, 2 and 4): its line, which
    must have every key of the JAX bench's, finite positive times, finite
    last losses, the launches of each configuration's untimed call, finite
    maps in [0, 190], only kernel shapes phase 2 held, and its headline
    and batch-1 step within :data:`BENCH_RATIO_LIMITS` of phase 5's busy
    ms per image and phase 6's step. Returns the run's launch counts."""
    start = time.perf_counter()
    kernels.launch_counts.clear()
    shapes = kernel_shapes(lambda: {"line": bench.run()})
    launches = dict(kernels.launch_counts)
    seconds = time.perf_counter() - start
    line = shapes.pop("line")
    print(json.dumps(line), flush=True)
    missing = missing_keys(line, JAX_BENCH_LINE)
    check(not missing, f"bench: the line lacks {missing}")
    times = _bench_times(line)
    check(all(np.isfinite(value) and value > 0 for value in times),
          f"bench: a time is not finite and positive: {times}")
    configurations = line["detail"]["configurations"]
    for name, record in configurations.items():
        expected = _expected_bench_launches(name, record["batch"])
        check(record["launches"] == expected, f"bench {name}: launches "
              f"{record['launches']} in one call, expected {expected}")
        if name.startswith("train"):
            check(np.isfinite(record["last_loss"]),
                  f"bench {name}: last loss {record['last_loss']}")
        else:
            low, high = record["disparity_range"]
            check(record["disparity_finite"] and 0.0 <= low
                  and high <= MAXIMUM_DISPARITY - 1,
                  f"bench {name}: map in [{low}, {high}], finite "
                  f"{record['disparity_finite']}")
    _expect_checked_shapes([shapes], "bench", K1_BENCH_SHAPES,
                           K2_BENCH_SHAPES, K3_BENCH_SHAPES, K4_BENCH_SHAPES)
    ratios = {"time_per_image_over_phase5_device_busy":
              configurations["infer_1"]["seconds"] * 1e3 / serving_busy_ms,
              "train_step_over_phase6_median":
              configurations["train_1"]["seconds"] * 1e3 / step_ms}
    low, high = BENCH_RATIO_LIMITS
    for name, ratio in ratios.items():
        check(low <= ratio <= high, f"bench: {name} {ratio} outside "
              f"[{low}, {high}]")
    emit({"phase": "bench", "card": card, **ratios,
          "time_per_image_over_phase5_median":
          configurations["infer_1"]["seconds"] * 1e3 / serving_ms,
          "phase5_device_busy_ms_per_image": serving_busy_ms,
          "phase5_serving_ms_median": serving_ms,
          "phase6_step_ms_median": step_ms, "launches": launches,
          **shapes})
    emit({"phase": "bench_seconds", "seconds": seconds})
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
    processes, the bench of phase 14; each counted from 0 just before it
    ran), and the serving path's bfloat16 work for one image, times and
    bounds summed over the launches one image makes at their shapes. K1
    adds the same sums for one train step at D=255 (forward and input
    gradient), K2 for one eval image at D=128; both for phase 14's
    "direct" batches of 2 and 4, and K1 for its train steps at batch 2
    and 4."""
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
    def train_step(batch_key):
        training = [(results[batch_key(shape)], count)
                    for shape, count in K1_TRAIN_LEVELS]
        return {
            "ms": sum((record["ms"] + record["dgrad_ms"]) * count
                      for record, count in training),
            "bound_ms": sum(2 * record["bound_ms"] * count
                            for record, count in training),
            "library_ms": sum((record["library_ms"]
                               + record["dgrad_library_ms"]) * count
                              for record, count in training),
            "dgrad_ms": sum(record["dgrad_ms"] * count
                            for record, count in training),
            "dgrad_library_ms": sum(record["dgrad_library_ms"] * count
                                    for record, count in training)}

    entries[0]["per_train_step"] = {
        "per": "one 540x960 D=255 bfloat16 train step: forward + input "
               "gradient of the nine convs",
        **train_step(lambda shape: ("train", shape))}
    evaluation = results[(subpixel.NAME, K2_EVAL_SHAPE, torch.bfloat16)]
    entries[1]["per_eval_image"] = {
        key: evaluation[key] for key in ("shape", "ms", "plain_ms",
                                         "bound_ms", "max_abs_err")}
    # Phase 14's batches: K1 over one "direct" batch's nine convs and one
    # train step's, K2 on one "direct" batch.
    timed = ("ms", "plain_ms", "library_ms", "bound_ms")
    for batch in BENCH_BATCHES:
        direct = [(results[(conv3d.NAME, shape, torch.bfloat16, batch)],
                   count) for shape, count in K1_LEVELS]
        entries[0][f"per_direct_batch_of_{batch}"] = {
            key: sum(record[key] * count for record, count in direct)
            for key in timed}
        entries[0][f"per_train_step_at_batch_{batch}"] = train_step(
            lambda shape, batch=batch: ("train", shape, batch))
        k2 = results[(subpixel.NAME, (batch, *K2_SHAPE[1:]),
                      torch.bfloat16)]
        entries[1][f"per_direct_batch_of_{batch}"] = {
            key: k2[key] for key in ("ms", "plain_ms", "bound_ms",
                                     "max_abs_err")}
    entries += transposed_summary(results, launches)
    entries.append(norm_summary(results, launches))
    return {"kernels": entries}


def norm_summary(results: dict, launches: dict) -> dict:
    """K5's entry of the ``kernels`` line: one 540x960 D=191 bfloat16
    image's 37 norms, times and bounds summed over them, PyTorch's own
    leaky_relu + instance_norm as the library; and the largest share of its
    bound at the matching volumes."""
    records = [(results[(block_norm.NAME, shape, variant, torch.bfloat16)],
                count) for shape, variant, count in K5_IMAGE]

    def total(key):
        return sum(record[key] * count for record, count in records)

    by_path = {path: counts.get(block_norm.NAME, 0)
               for path, counts in launches.items()}
    matching = {f"{shape} {variant}": results[
        (block_norm.NAME, shape, variant, torch.bfloat16)]["of_bound"]
        for shape in (K5_IMAGE[5][0], K5_KITTI_MATCHING)
        for variant in ("block", "residual")}
    return {"name": block_norm.NAME, "route": "cuda", "source": K5_SOURCE,
            "replaces": K5_REPLACES, "pallas_kernel": False,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(record["max_abs_err"]
                               for record, _ in records),
            "ms": total("ms"), "plain_ms": total("plain_ms"),
            "library_ms": total("library_ms"),
            "bound_ms": total("bound_ms"), "bound_by": "bytes",
            "matching_ms_over_bound": matching,
            "per": "one 540x960 D=191 bfloat16 image: its 37 norms",
            "backward": norm_backward_summary(results, launches)}


def norm_backward_summary(results: dict, launches: dict) -> dict:
    """K5's backward in the ``kernels`` line: one 540x960 D=255 bfloat16
    train step's 35 conv-block norms (``K5_TRAIN``'s counts), K5's forward
    and backward ms, the backward's byte bound and autograd's composition
    forward and backward ms, summed over them."""
    records = [(results[(block_norm.BACKWARD_NAME, shape, variant, dtype)],
                count) for shape, variant, dtype, count in K5_TRAIN
               if count is not None]

    def total(key):
        return sum(record[key] * count for record, count in records)

    by_path = {path: counts.get(block_norm.BACKWARD_NAME, 0)
               for path, counts in launches.items()}
    return {"name": block_norm.BACKWARD_NAME,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "norms": sum(count for _, count in records),
            "ms": total("ms"), "bound_ms": total("bound_ms"),
            "forward_ms": total("forward_ms"),
            "library_ms": total("library_ms"),
            "library_forward_ms": total("library_forward_ms"),
            "per": "one 540x960 D=255 bfloat16 train step: its 35 conv "
                   "blocks' norms"}


def transposed_summary(results: dict, launches: dict) -> list:
    """K3's and K4's entries of the ``kernels`` line. K3: one 540x960 D=191
    bfloat16 image's six launches (cuDNN's ``conv_transpose3d`` as the
    library, benchmark off; on, beside it), and one D=255 train step's;
    K4: one D=255 train step's six (cuDNN's input gradient as the library),
    with cuDNN's weight gradient of the six beside it. Both at phase 14's
    batches of 2 and 4 (kernel and bound only)."""
    serving = [results[(conv_transpose3d.NAME, shape, torch.bfloat16)]
               for shape in K3_LEVELS]
    training = [results[("k3 train", shape)] for shape in K3_TRAIN_LEVELS]

    def total(records, key):
        return sum(record[key] for record in records)

    def bound_by(records, key="bound_ms"):
        by_bytes = sum(record[key] for record in records
                       if record["bound_by"] == "bytes")
        if 2 * by_bytes >= total(records, key):
            return "bytes"
        return "operations"

    def by_path(name):
        counts = {path: counts.get(name, 0)
                  for path, counts in launches.items()}
        return sum(counts.values()), counts

    k3_launches, k3_by_path = by_path(conv_transpose3d.NAME)
    k4_launches, k4_by_path = by_path(conv_transpose3d.INPUT_GRAD_NAME)
    k3 = {
        "name": conv_transpose3d.NAME, "route": "cuda", "source": K3_SOURCE,
        "replaces": K3_REPLACES, "pallas_kernel": False,
        "launches": k3_launches, "launches_by_path": k3_by_path,
        "max_abs_err": max(record["max_abs_err"] for record in serving),
        "ms": total(serving, "ms"), "plain_ms": total(serving, "plain_ms"),
        "bound_ms": total(serving, "bound_ms"),
        "bound_by": bound_by(serving),
        "library_ms": total(serving, "library_ms"),
        "library_benchmark_ms": total(serving, "library_benchmark_ms"),
        "per": "one 540x960 D=191 bfloat16 image: its six transposed convs",
        "per_train_step": {
            key: total(training, key)
            for key in ("ms", "plain_ms", "bound_ms", "library_ms",
                        "library_benchmark_ms")}}
    k4 = {
        "name": conv_transpose3d.INPUT_GRAD_NAME, "route": "cuda",
        "source": K3_SOURCE, "replaces": K3_REPLACES,
        "pallas_kernel": False,
        "launches": k4_launches, "launches_by_path": k4_by_path,
        "max_abs_err": max(record["input_gradient_max_abs_err"]
                           for record in training),
        "ms": total(training, "dgrad_ms"),
        "plain_ms": total(training, "dgrad_plain_ms"),
        "bound_ms": total(training, "dgrad_bound_ms"),
        "bound_by": bound_by(training, "dgrad_bound_ms"),
        "library_ms": total(training, "dgrad_library_ms"),
        "library_benchmark_ms": total(training, "dgrad_library_benchmark_ms"),
        "wgrad_library_ms": total(training, "wgrad_library_ms"),
        "per": "one 540x960 D=255 bfloat16 train step: the input gradients "
               "of its six transposed convs"}
    for batch in BENCH_BATCHES:
        direct = [results[(conv_transpose3d.NAME, shape, torch.bfloat16,
                           batch)] for shape in K3_LEVELS]
        steps = [results[("k3 train", shape, batch)]
                 for shape in K3_TRAIN_LEVELS]
        k3[f"per_direct_batch_of_{batch}"] = {
            key: total(direct, key) for key in ("ms", "bound_ms")}
        k3[f"per_train_step_at_batch_{batch}"] = {
            key: total(steps, key) for key in ("ms", "bound_ms")}
        k4[f"per_train_step_at_batch_{batch}"] = {
            "ms": total(steps, "dgrad_ms"),
            "bound_ms": total(steps, "dgrad_bound_ms")}
    return [k3, k4]


# PSMNet at the published SceneFlow recipe (phase 15).
PSM_BATCH = 12
PSM_HEIGHT, PSM_WIDTH = 256, 512
PSM_DISPARITY = 192
PSM_SERVED = (540, 960)
PSM_STEPS = 5
PSM_FLOAT32_GAP_PX = 0.05
# (name, cin, cout, depth, height, width) of the stride-1 3x3x3 convs at
# batch 12, D=192, 256x512: the full level (dres0's first, the 32-channel
# convs), the hourglasses' 1/8 and 1/16 levels, the classifiers' last.
PSM_K1_SHAPES = (("dres0.0", 64, 32, 48, 64, 128),
                 ("full", 32, 32, 48, 64, 128),
                 ("conv2", 64, 64, 24, 32, 64),
                 ("conv4", 64, 64, 12, 16, 32),
                 ("classif.2", 32, 1, 48, 64, 128))


def check_psm_k1(name, cin, cout, depth, height, width, generator) -> dict:
    """K1 at one of PSMNet's shapes in bfloat16: forward and input gradient
    (through K1, as the autograd Function's backward) against their plain
    versions, and their times beside cuDNN's."""
    shape = (PSM_BATCH, cin, depth, height, width)
    limit = 1.0 / np.sqrt(27 * cin)
    x = torch.randn(shape, device="cuda", generator=generator).bfloat16()
    weight = ((torch.rand((cout, cin, 3, 3, 3), device="cuda",
                          generator=generator) * 2 - 1) * limit).bfloat16()
    grad = torch.randn((PSM_BATCH, cout, depth, height, width),
                       device="cuda", generator=generator).bfloat16()
    zero_out = torch.zeros(cout, device="cuda")
    zero_in = torch.zeros(cin, device="cuda")
    what = f"psmnet K1 {name} {shape} -> {cout}"
    forward = conv3d.conv3d_k3s1(x, weight, zero_out)
    check(one_ulp(forward, conv3d.conv3d_k3s1_plain(x, weight, zero_out)),
          f"{what}: forward beyond one ulp")
    flipped = weight.flip(2, 3, 4).transpose(0, 1)
    dgrad = conv3d.conv3d_k3s1(grad, weight, zero_in, input_gradient=True)
    check(one_ulp(dgrad, conv3d.conv3d_k3s1_plain(grad, flipped, zero_in)),
          f"{what}: input gradient beyond one ulp")
    voxels = PSM_BATCH * depth * height * width
    return {
        "kernel": conv3d.NAME, "layer": name, "shape": list(shape),
        "cout": cout,
        "ms": time_ms(lambda: conv3d.conv3d_k3s1(x, weight, zero_out)),
        "library_ms": time_ms(lambda: F.conv3d(x, weight, padding=1)),
        "dgrad_ms": time_ms(lambda: conv3d.conv3d_k3s1(
            grad, weight, zero_in, input_gradient=True)),
        "dgrad_library_ms": time_ms(
            lambda: torch.ops.aten.convolution_backward(
                grad, x, weight, None, [1, 1, 1], [1, 1, 1], [1, 1, 1],
                False, [0, 0, 0], 1, [True, False, False])),
        "wgrad_library_ms": time_ms(lambda: torch.nn.grad.conv3d_weight(
            x, weight.shape, grad, padding=1)),
        **bound(2 * (cin * voxels + cout * voxels + 27 * cin * cout),
                2.0 * voxels * cin * cout * 27, torch.bfloat16),
    }


def psmnet_weights(config: dict, seed: int) -> dict:
    """The benchmark's seeded weights of ``config`` under its yardstick's
    layout, on the card."""
    from pds_bench import generator as bench_generator
    from pds_bench.architectures import psmnet as yardstick
    return bench_generator.make_weights(yardstick.weight_layout(config),
                                        seed, "cuda")


def psmnet_train_steps(config: dict, seed: int) -> dict:
    """PSM_STEPS train steps at batch 12 after two warm-up steps: ms a
    step between CUDA events, peak memory, launches per step."""
    network = models.PsmNetwork(models.PSMConfig()).cuda().train()
    network.load_state_dict(psmnet_weights(config, seed))
    adam = optimizer.adam(network.parameters())
    generator = torch.Generator(device="cuda").manual_seed(seed)
    left = torch.rand((PSM_BATCH, PSM_HEIGHT, PSM_WIDTH, 3), device="cuda",
                      generator=generator) * 255
    right = torch.roll(left, -24, dims=2)
    truth = torch.rand((PSM_BATCH, PSM_HEIGHT, PSM_WIDTH), device="cuda",
                       generator=generator) * PSM_DISPARITY

    def step():
        return trainer.train_step(network, adam, left, right, truth, 1e-3,
                                  models.PSMConfig(), torch.bfloat16)

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.launch_counts.clear()
    kernels.fallback_counts.clear()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    losses = [step() for _ in range(PSM_STEPS)]
    end.record()
    end.synchronize()
    losses = [float(value) for value in losses]
    check(all(np.isfinite(losses)), f"psmnet train losses {losses}")
    record = {"step_ms": start.elapsed_time(end) / PSM_STEPS,
              "losses": losses,
              "memory_peak_bytes": torch.cuda.max_memory_allocated(),
              "launches_per_step": {
                  name: count / PSM_STEPS
                  for name, count in kernels.launch_counts.items()},
              "fallbacks_per_step": {
                  name: count / PSM_STEPS
                  for name, count in kernels.fallback_counts.items()}}
    check(record["launches_per_step"].get(conv3d.NAME) == 32,
          f"psmnet K1 launches per step {record['launches_per_step']}: "
          "expected 16 convs forward and 16 input gradients")
    return record


def with_batch_statistics(weights: dict, left, right) -> dict:
    """``weights`` with each BatchNorm's running statistics those of one
    float32 train-mode forward on the pair, as training would leave them:
    random weights under running statistics at 0 and 1 fade through the
    network's depth to a near-uniform softmax, a map of ~95.5 px."""
    network = models.PsmNetwork(models.PSMConfig()).cuda().train()
    network.load_state_dict(weights)
    for module in network.modules():
        if isinstance(module, torch.nn.modules.batchnorm._BatchNorm):
            module.momentum = 1.0
    with torch.no_grad():
        psmnet.apply(network, left, right, models.PSMConfig())
    return network.state_dict()


def psmnet_served_pair(config: dict, seed: int) -> dict:
    """One 960x540 pair served in bfloat16 and in float32 against the
    benchmark's float32 reference on the same weights (the running
    statistics those of the pair, :func:`with_batch_statistics`): gaps in
    px."""
    from pds_bench.architectures import psmnet as yardstick
    generator = torch.Generator(device="cuda").manual_seed(seed)
    left = torch.rand((1, *PSM_SERVED, 3), device="cuda",
                      generator=generator) * 255
    right = torch.roll(left, -30, dims=2)
    weights = with_batch_statistics(psmnet_weights(config, seed), left,
                                    right)
    expected = yardstick.reference_map(weights, config, left, right,
                                       PSM_DISPARITY)
    record = {"size": list(PSM_SERVED),
              "reference_mean_px": float(expected.mean()),
              "reference_std_px": float(expected.std())}
    for name, dtype in (("bfloat16", torch.bfloat16),
                        ("float32", torch.float32)):
        session = InferenceSession(weights, models.PSMConfig(),
                                   compute_dtype=dtype)
        served = torch.as_tensor(session.predict(left.cpu().numpy(),
                                                 right.cpu().numpy()),
                                 device="cuda")
        gap = (served - expected).abs()
        record[name] = {"gap_max_px": float(gap.max()),
                        "gap_mean_px": float(gap.mean()),
                        "share_over_1px": float((gap > 1).float().mean())}
        del session
    check(record["float32"]["gap_max_px"] <= PSM_FLOAT32_GAP_PX,
          f"psmnet float32 served map off the reference: {record}")
    return record


def phase_psmnet(card: str) -> dict:
    """Phase 15; returns the launches of one train step."""
    from pds_bench.architectures import psmnet as yardstick
    config = json.loads((pathlib.Path(__file__).resolve().parent /
                         "pds_bench" / "configs" / "psmnet-sceneflow.json"
                         ).read_text())
    generator = torch.Generator(device="cuda").manual_seed(15)
    for shape in PSM_K1_SHAPES:
        emit({"phase": "psmnet", "card": card,
              **check_psm_k1(*shape, generator)})
    seed = 2 ** 31 + 15
    steps = psmnet_train_steps(config, seed)
    useful = 2.0 * yardstick.useful_macs(config, "train") * PSM_BATCH
    emit({"phase": "psmnet", "card": card, "train": steps,
          "mfu_pct": 100.0 * useful / (steps["step_ms"] / 1e3)
          / PEAK_OPS_PER_S[torch.bfloat16]})
    torch.cuda.empty_cache()
    emit({"phase": "psmnet", "card": card,
          "served": psmnet_served_pair(config, seed)})
    return steps["launches_per_step"]


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
    if sys.argv[1:] == ["--psmnet"]:
        phase_psmnet(card)
        return finish(card)
    results = phase_kernels()
    phase_path()
    phase_train_path()
    launches = {}
    launches["serving"], serving_ms, serving_busy_ms = phase_serving(card)
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
    launches["bench"] = phase_bench(card, serving_ms, serving_busy_ms,
                                    step_ms)
    launches["psmnet"] = phase_psmnet(card)
    phase_mfu(serving_ms, step_ms, options_ms)
    emit(kernel_summary(results, launches))
    return finish(card)


def finish(card: str) -> int:
    """The ``nvidia-smi`` line, then the exit status: 1 after a failed
    check, else 0 after the ``ok`` line."""
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
