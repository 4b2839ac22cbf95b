"""The card's idle time in the profiled phase, put down to the port's
layer the host was in.

The port opens ``pds.*`` ranges at its layer boundaries while a profiler
records (its ``utils/profiling.py::span``); the profiler puts them in
:attr:`trace.Profile.host` on the clock of the device's activities. Each
idle microsecond (:func:`trace.gaps`) goes to the innermost layer span
open over it, by exact overlap; a kernel span (``pds.kernel.*``) has no
layer and counts to the layer span that encloses it; idle with no layer
span open is :data:`OUTSIDE`, the client's loop. The layers' and
outside's idle sum to the profile's.

The span names are the benchmark's copy: nothing of the port is imported.
"""

from __future__ import annotations

from pds_bench import trace

PREFIX = "pds."
OUTSIDE = "outside"
LAYERS = {
    "pds.predict": "serving", "pds.prepare": "serving",
    "pds.estimator": "serving", "pds.crop": "serving",
    "pds.copy_out": "serving",
    "pds.embedding": "embedding",
    "pds.matching": "matching",
    "pds.regularization": "regularization",
    "pds.train_step": "trainer", "pds.loss": "trainer",
    "pds.backward": "trainer", "pds.all_reduce": "trainer",
    "pds.optimizer": "trainer",
}


def idle_us_by_layer(profile: trace.Profile) -> dict[str, float] | None:
    """Idle microseconds of the window per layer and :data:`OUTSIDE`
    (every layer listed, 0 where none); None when the profile holds no
    ``pds.`` span (a port without them)."""
    if not any(name.startswith(PREFIX) for _, _, name in profile.host):
        return None
    spans = sorted((begin, end, LAYERS[name])
                   for begin, end, name in profile.host
                   if name in LAYERS and end > begin)
    gaps = trace.gaps(profile)
    idle = dict.fromkeys([*sorted(set(LAYERS.values())), OUTSIDE], 0.0)
    # The ends of every span and every gap cut the window into pieces
    # over each of which the innermost open span, and whether the card is
    # idle, stay the same.
    cuts = sorted({point for begin, end, _ in spans
                   for point in (begin, end)}
                  | {point for gap in gaps for point in gap})
    open_spans: list[tuple[float, float, str]] = []
    next_span = next_gap = 0
    for left, right in zip(cuts, cuts[1:]):
        while next_gap < len(gaps) and gaps[next_gap][1] <= left:
            next_gap += 1
        if next_gap == len(gaps) or gaps[next_gap][0] >= right:
            continue  # the card is busy over the piece
        while next_span < len(spans) and spans[next_span][0] <= left:
            open_spans.append(spans[next_span])
            next_span += 1
        open_spans = [span for span in open_spans if span[1] >= right]
        # The innermost: the latest to start, the earliest to end of
        # those that start together.
        inner = max(open_spans, key=lambda span: (span[0], -span[1]),
                    default=None)
        idle[OUTSIDE if inner is None else inner[2]] += right - left
    return idle


def idle_ms(record, layer: str, per: str = "image") -> float | None:
    """Idle ms of the card while the host was in ``layer``, per image or
    per ``"iteration"`` (a request or a train step) of the profiled
    phase; None without a profile or without the port's spans."""
    profile = record.profile
    if profile is None:
        return None
    count = profile.images if per == "image" else profile.iterations
    idle = idle_us_by_layer(profile)
    if idle is None or not count:
        return None
    return idle[layer] / 1e3 / count
