"""Profiling: trace capture, step timing and device memory.

Port of ``practicaldeepstereo_nips2018_tpu/utils/profiling.py``:

* :func:`trace` -- ``torch.profiler`` around a block, written as a Chrome
  trace (``trace.json``, for ``chrome://tracing`` or Perfetto);
* :func:`span` -- a named range at one of the port's layer boundaries
  (``pds.*``), on the profiler's timeline while a profiler records, and
  next to free while none does;
* :class:`StepTimer` -- the slope of N chained steps, so that a fixed cost
  per measurement (the final wait for the card) cancels;
* :func:`device_memory_stats` -- per card, the bytes PyTorch's allocator
  holds for tensors, its peak and the card's total and free memory.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

TRACE_FILE = "trace.json"
_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def trace(log_dir: str):
    """Profiles the block (host operators and, with a card, its kernels)
    and writes ``log_dir/trace.json``; yields the profiler, whose
    ``key_averages()`` sum the time by operator and kernel."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as profile:
        yield profile
    profile.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def span(name: str, args=None):
    """A context manager: while a ``torch.profiler`` records, a
    ``record_function`` range ``name`` (with ``args``, a string or a
    callable that returns one, such as shapes and a dtype), which the
    profiler puts on the timeline of the card's kernels and copies; while
    none records, one shared null context, so the cost is one check and
    no string is built.

    The port opens one at each layer boundary: a request's or a step's
    root (``pds.predict``, ``pds.train_step``) and, nested in it, its
    stages (``pds.prepare``, ``pds.embedding``, ``pds.matching``, ...)
    and each hand-kernel launch (``pds.kernel.<name>``)."""
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    if callable(args):
        args = args()
    return torch.profiler.record_function(name, args)


def _wait_for(output) -> None:
    """Returns once the work that produced ``output`` (a tensor, or a
    tuple, list or dict of them) has finished: a card is synchronised, the
    CPU has finished when the call returned."""
    if isinstance(output, dict):
        output = list(output.values())
    if isinstance(output, (tuple, list)):
        for item in output:
            _wait_for(item)
    elif isinstance(output, torch.Tensor) and output.is_cuda:
        torch.cuda.synchronize(output.device)


class StepTimer:
    """Two-point slope timing of a nullary step function.

    ``step_fn()`` launches its work and returns a tensor (or a tuple, list
    or dict of them); the timer waits for the last step's output
    (``torch.cuda.synchronize()`` on the card). Seconds per step =
    ``(t(long) - t(short)) / (long - short)``, which cancels the fixed
    costs of a measurement.
    """

    def __init__(self, step_fn, short: int = 2, long: int = 8):
        self._step_fn = step_fn
        self._short = short
        self._long = long

    def _run(self, iterations: int) -> float:
        start = time.perf_counter()
        output = None
        for _ in range(iterations):
            output = self._step_fn()
        _wait_for(output)
        return time.perf_counter() - start

    def measure(self, repeats: int = 3) -> dict:
        """The median slope of ``repeats`` (short, long) pairs, after one
        warm-up step; ``slopes`` lists every pair's slope in the order
        measured."""
        self._run(1)
        slopes = [(self._run(self._long) - self._run(self._short))
                  / (self._long - self._short) for _ in range(repeats)]
        seconds = sorted(slopes)[len(slopes) // 2]
        return {"seconds_per_step": seconds,
                "steps_per_second": 1.0 / seconds if seconds > 0
                else float("inf"),
                "slopes": slopes}


def device_memory_stats() -> list[dict]:
    """Per card: ``bytes_in_use`` (tensors), ``peak_bytes_in_use`` (since
    the last ``torch.cuda.reset_peak_memory_stats``), ``bytes_limit`` (the
    card's memory) and ``bytes_free`` (free on the card, other processes
    included). Without a card, one ``cpu`` entry whose values are None, as
    the JAX package reports its CPU device."""
    if not torch.cuda.is_available():
        return [{"device": "cpu", "bytes_in_use": None,
                 "peak_bytes_in_use": None, "bytes_limit": None,
                 "bytes_free": None}]
    stats = []
    for index in range(torch.cuda.device_count()):
        free, total = torch.cuda.mem_get_info(index)
        stats.append({
            "device": f"cuda:{index}",
            "name": torch.cuda.get_device_name(index),
            "bytes_in_use": torch.cuda.memory_allocated(index),
            "peak_bytes_in_use": torch.cuda.max_memory_allocated(index),
            "bytes_limit": total, "bytes_free": free})
    return stats
