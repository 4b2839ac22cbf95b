"""What a traced run hands the per-layer metric readers.

A reader is a module ``pds_bench/metrics/<name>.py``, found by the part of
a metric's name before its first dot (``embedding_ms.train`` is read by
``metrics/embedding_ms.py``). It may define:

* ``SPANS``: span name -> module path, or predicate ``(path, module)``, of
  the port's modules to time (:mod:`pds_bench.spans`);
* ``BACKWARD``: True to time those modules' backward passes too, in train
  cells;
* ``UNDER``: host-range name prefixes whose kernels' device time it needs
  (:mod:`pds_bench.trace`);
* ``PROFILE``: True if it reads the profiler window;

and must define ``read(record) -> float | None``: None when the record holds
nothing for it, which leaves the metric out of the line.
"""

from __future__ import annotations

import dataclasses

from pds_bench import trace


@dataclasses.dataclass
class Record:
    kind: str                 # "serve" or "train"
    window_seconds: float     # the measured window's wall time
    window_images: int        # images (training examples) it completed
    useful_flops_per_image: float
    peak_flops: float | None
    paced: bool = False       # the traffic paces the window's requests
    span_images: int = 0      # images the span phase ran
    spans: dict = dataclasses.field(default_factory=dict)
    profile: trace.Profile | None = None


def per_image_ms(record: Record, name: str) -> float | None:
    """Forward device ms per image of the calls under span ``name``."""
    calls = record.spans.get(name)
    if not calls or not record.span_images:
        return None
    return sum(call["forward_ms"] for call in calls) / record.span_images


def roofline_pct(record: Record, name: str) -> float | None:
    """100 x the least time the calls under span ``name`` could take (their
    forward, and in train cells their two gradient passes) over the time
    their spans took."""
    from pds_bench import accounting
    calls = record.spans.get(name)
    if not calls:
        return None
    train = record.kind == "train"
    bound = spent = 0.0
    for call in calls:
        if train and "backward_ms" not in call:
            return None
        bound += accounting.conv_bound_ms(
            call["input_shape"], call["weight_shape"], call["output_shape"],
            call["stride"], call["padding"], call["transposed"],
            call["dtype"], passes=3 if train else 1)
        spent += call["forward_ms"] + call.get("backward_ms", 0.0)
    return 100.0 * bound / spent if spent > 0 else None
