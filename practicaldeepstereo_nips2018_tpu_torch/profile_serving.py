"""Where the time of one served image goes on the card.

    python3 -m practicaldeepstereo_nips2018_tpu_torch.profile_serving \
        [--requests 10] [--seed 0]

Serves 540x960, D=191, bfloat16 requests (the published protocol) through
``InferenceSession`` with weights drawn from ``--seed`` and prints JSON
lines:

* ``stages``  -- device ms per image of the embedding (both images), the
  matching stage, the hourglass and, inside it, its two upsamplers, from
  CUDA events recorded by forward hooks on those modules, and the wall ms
  of the whole request (median); the rest of the request is padding, the
  estimator, the crop and the copies between host and card;
* ``busy``    -- device time per image summed over all kernels, from
  ``torch.profiler``, and its share of the unprofiled request's wall time
  (the profiler's own overhead makes the profiled wall time meaningless);
* ``top``     -- the kernels with the most device time per image.

It needs a CUDA card and exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

from practicaldeepstereo_nips2018_tpu_torch.models import network as models
from practicaldeepstereo_nips2018_tpu_torch.serving import InferenceSession
from practicaldeepstereo_nips2018_tpu_torch.training import weights

HEIGHT, WIDTH, MAXIMUM_DISPARITY = 540, 960, 191
# Stage name -> module path in PdsNetwork.
STAGES = {"embedding": "_embedding", "matching": "_matching",
          "regularization": "_regularization",
          "upsample_to_halfsize": "_regularization._upsample_to_halfsize",
          "upsample_to_fullsize": "_regularization._upsample_to_fullsize"}


def _stage_hooks(network, events):
    """Forward hooks that record a CUDA event before and after each stage
    module; ``events[name]`` collects (start, end) pairs."""
    handles = []
    for name, path in STAGES.items():
        module = network.get_submodule(path)

        def before(_module, _inputs, name=name):
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            events[name].append([start, None])

        def after(_module, _inputs, _output, name=name):
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            events[name][-1][1] = end

        handles.append(module.register_forward_pre_hook(before))
        handles.append(module.register_forward_hook(after))
    return handles


def stage_ms(session, images) -> tuple:
    """Serves ``images`` (``[N, 2, H, W, 3]`` pairs) one request at a time
    with the stage hooks on: (device ms per image of each stage of
    :data:`STAGES`, the median of its calls times its calls per image; wall
    ms of each request)."""
    events = {name: [] for name in STAGES}
    handles = _stage_hooks(session._network, events)
    wall_ms = []
    try:
        for left, right in images:
            start = time.perf_counter()
            session.predict(left[None], right[None])
            wall_ms.append((time.perf_counter() - start) * 1e3)
    finally:
        for handle in handles:
            handle.remove()
    torch.cuda.synchronize()
    stages = {}
    for name in STAGES:
        per_call = [start.elapsed_time(end) for start, end in events[name]]
        stages[name] = (len(per_call) // len(images)
                        * statistics.median(per_call))
    return stages, wall_ms


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--requests", type=int, default=10)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_serving: needs a CUDA card", file=sys.stderr)
        return 1

    config = models.PDSConfig(maximum_disparity=MAXIMUM_DISPARITY)
    session = InferenceSession(
        weights.state_dict_from_jax_params(
            weights.random_jax_params(config, seed=args.seed)),
        config, compute_dtype=torch.bfloat16, device="cuda")
    session.warmup(HEIGHT, WIDTH)
    rng = np.random.RandomState(args.seed)
    images = rng.uniform(0, 255, (args.requests, 2, HEIGHT, WIDTH, 3)
                         ).astype(np.float32)

    stages, wall_ms = stage_ms(session, images)
    print(json.dumps({"stages": stages,
                      "wall_ms_median": statistics.median(wall_ms),
                      "requests": args.requests,
                      "card": torch.cuda.get_device_name(0)}), flush=True)

    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    profiled = min(args.requests, 3)
    with torch.profiler.profile(activities=activities) as profile:
        for left, right in images[:profiled]:
            session.predict(left[None], right[None])
    kernels = [event for event in profile.key_averages()
               if event.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(event.self_device_time_total for event in kernels
                  ) / 1e3 / profiled
    print(json.dumps({"busy": {
        "device_ms_per_image": busy_ms,
        "busy_share": busy_ms / statistics.median(wall_ms)}}), flush=True)
    top = sorted(kernels, key=lambda event: event.self_device_time_total,
                 reverse=True)[:25]
    print(json.dumps({"top": [
        {"name": event.key[:120],
         "launches_per_image": event.count / profiled,
         "device_ms_per_image": event.self_device_time_total / 1e3
         / profiled} for event in top]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
