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
3. path     -- ``infer`` at 70x90, D=63, float32, on the card against the
               same seeded weights on the CPU (plain versions).
4. serving  -- an ``InferenceSession`` at 540x960, D=191, bfloat16 (the
               published protocol) answering 17 requests, one of batch 2;
               checks the outputs and that every image went through 9 K1
               and 1 K2 launches; ms per image and peak device memory.

Then the ``kernels`` summary line (launch counts from phase 4), the
``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``. Any failed
check makes the script exit 1 without that last line; so does a host
without a card or a directory without the port.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from practicaldeepstereo_nips2018_tpu_torch import models
from practicaldeepstereo_nips2018_tpu_torch.ops import conv3d, kernels
from practicaldeepstereo_nips2018_tpu_torch.ops import subpixel
from practicaldeepstereo_nips2018_tpu_torch.serving import InferenceSession
from practicaldeepstereo_nips2018_tpu_torch.training import weights

# Published H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit).
MEMORY_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}

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
K1_COLD_SHAPE = (48, 8, 144, 240)  # 26.5 MB in bfloat16: fits the L2 warm
K1_SOURCE = "practicaldeepstereo_nips2018_tpu_torch/csrc/conv3d_k3s1.cu"
K2_SOURCE = "practicaldeepstereo_nips2018_tpu_torch/csrc/subpixel_map.cu"
K1_REPLACES = "practicaldeepstereo_nips2018_tpu/ops/folded_banded.py:242"
K2_REPLACES = "practicaldeepstereo_nips2018_tpu/ops/subpixel_pallas.py:35"
SERVING_REQUESTS = 16  # batch-1 requests, plus one batch-2 request

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
        # Both accumulate in float32 from the same bfloat16 values and round
        # once: they agree or differ by one bfloat16 ulp, <= 2^-7 |value|.
        tolerance = "abs <= 2^-7 * |value| + 1e-6 (one bfloat16 ulp)"
        scale = torch.maximum(got.float().abs(), plain.float().abs())
        ok = bool((error <= scale * 2 ** -7 + 1e-6).all())
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


def check_k2(dtype, generator) -> dict:
    volume = torch.randn(K2_SHAPE, device="cuda", generator=generator).to(
        dtype)
    view = volume.permute(0, 2, 3, 1)  # the hourglass's disparity-last view
    got = subpixel.subpixel_map(view)
    plain = subpixel.subpixel_map_plain(view)
    torch.cuda.synchronize()
    error = float((got - plain).abs().max())
    # Both compute in float32 from the same values.
    check(error <= 1e-4, f"K2 {dtype}: max abs err {error} px")
    disparities = K2_SHAPE[1]
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
        "kernel": subpixel.NAME, "shape": list(K2_SHAPE), "dtype": str(dtype),
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
            ok = bool((error <= torch.maximum(got.abs(), plain.abs()) * 2 ** -7
                       + 1e-6).all())
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
        record = check_k2(dtype, generator)
        record["launches_per_image"] = 1
        emit({"phase": "kernel_check", **record})
        results[(subpixel.NAME, K2_SHAPE, dtype)] = record
    return results


def phase_path() -> None:
    config = models.PDSConfig(maximum_disparity=63)
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
        outputs[device] = (similarities.cpu().numpy(),
                           disparity.cpu().numpy())
    similarity_error = float(np.abs(outputs["cuda"][0]
                                    - outputs["cpu"][0]).max())
    disparity_error = np.abs(outputs["cuda"][1] - outputs["cpu"][1])
    outside = int((disparity_error > 1e-2).sum())
    check(outside <= 0.001 * disparity_error.size,
          f"path: {outside} of {disparity_error.size} pixels differ by more "
          "than 1e-2 px")
    check(similarity_error <= 1e-3,
          f"path: similarities differ by {similarity_error}")
    emit({"phase": "path", "size": [70, 90], "maximum_disparity": 63,
          "dtype": "float32", "similarity_max_abs_err": similarity_error,
          "disparity_max_abs_err": float(disparity_error.max()),
          "pixels_outside_1e-2": outside, "pixels": disparity_error.size})


def phase_serving(card: str) -> dict:
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
    return counts


def kernel_summary(results: dict, launches: dict) -> dict:
    """Per kernel: its launches in the serving run, and the main path's
    bfloat16 work for one image, times and bounds summed over the launches
    one image makes at their shapes."""
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
        entries.append({
            "name": name, "route": route, "source": source,
            "replaces": replaces,
            "launches": launches.get(name, 0),
            "max_abs_err": max(record["max_abs_err"] for record, _ in records),
            "ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"),
            "bound_by": ("bytes" if bytes_bound >= operations_bound
                         else "operations"),
            "library_ms": total("library_ms"),
            "per": "one 540x960 D=191 bfloat16 image",
        })
    return {"kernels": entries}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on a CUDA GPU only", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = phase_device()
    results = phase_kernels()
    phase_path()
    launches = phase_serving(card)
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
