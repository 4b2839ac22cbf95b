"""One ``torch.profiler`` window, reduced to what the readers need.

:func:`profiled` runs a callable under the profiler inside a
``pds_bench.window`` range; :func:`reduce` turns the profiler's events into
a :class:`Profile` of plain numbers, so that the metric readers and the
tests work on records and not on the profiler:

* ``device``: every device activity in the window, ``(start_us, end_us,
  name, kind)`` with ``kind`` one of ``kernel``, ``memcpy``, ``memset``;
* ``host``: every host operation, ``(start_us, end_us, name)``;
* ``under``: for each requested name prefix, the device microseconds of the
  kernels launched inside host ranges whose names start with it (the
  outermost such ranges, so nothing counts twice).
"""

from __future__ import annotations

import dataclasses
import heapq

import torch

WINDOW = "pds_bench.window"


@dataclasses.dataclass
class Profile:
    window_us: tuple[float, float]
    iterations: int
    images: int
    device: list[tuple[float, float, str, str]]
    host: list[tuple[float, float, str]]
    under: dict[str, float]


def _kind(name: str) -> str:
    lowered = name.lower()
    if "memcpy" in lowered:
        return "memcpy"
    if "memset" in lowered:
        return "memset"
    return "kernel"


def profiled(run, cuda: bool):
    """Runs ``run()`` under the profiler and returns the profile."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as profile:
        with torch.profiler.record_function(WINDOW):
            run()
            if cuda:
                torch.cuda.synchronize()
    return profile


def _device_time_us(event) -> float:
    total = getattr(event, "device_time_total", None)
    if total is None:
        total = event.cuda_time_total
    return float(total)


def reduce(profile, iterations: int, images: int,
           prefixes=()) -> Profile:
    events = profile.events()
    window = next(event for event in events if event.name == WINDOW)
    start, end = window.time_range.start, window.time_range.end
    device, host = [], []
    for event in events:
        begin, finish = event.time_range.start, event.time_range.end
        if event.device_type == torch.autograd.DeviceType.CPU:
            if event.name != WINDOW:
                host.append((begin, finish, event.name))
        elif getattr(event, "is_user_annotation", False) or \
                event.name.startswith("pds_bench."):
            continue  # a host range's shadow on the device's timeline
        elif finish > start and begin < end:
            device.append((max(begin, start), min(finish, end), event.name,
                           _kind(event.name)))
    under = {}
    for prefix in prefixes:
        total = 0.0
        for event in events:
            if (event.device_type != torch.autograd.DeviceType.CPU
                    or not event.name.startswith(prefix)):
                continue
            parent = event.cpu_parent
            while parent is not None and not parent.name.startswith(prefix):
                parent = parent.cpu_parent
            if parent is None:
                total += _device_time_us(event)
        under[prefix] = total
    return Profile((start, end), iterations, images, device, host, under)


def union_us(intervals) -> float:
    """Length of the union of ``(start, end, ...)`` intervals."""
    total, reach = 0.0, None
    for begin, finish, *_ in sorted(intervals):
        if reach is None or begin > reach:
            total += finish - begin
            reach = finish
        elif finish > reach:
            total += finish - reach
            reach = finish
    return total


def gaps(profile: Profile) -> list[tuple[float, float]]:
    """The window's stretches with no device activity, ``(start, end)``."""
    result, reach = [], profile.window_us[0]
    for begin, finish, *_ in sorted(profile.device):
        if begin > reach:
            result.append((reach, begin))
        reach = max(reach, finish)
    if profile.window_us[1] > reach:
        result.append((reach, profile.window_us[1]))
    return result


def breakdown(profile: Profile, top: int = 10) -> dict:
    """The device operations with the most time, and the idle time by the
    host operation open during it (the innermost, at each gap's middle),
    both in seconds over the window."""
    by_name: dict[str, float] = {}
    for begin, finish, name, _ in profile.device:
        by_name[name] = by_name.get(name, 0.0) + (finish - begin)
    # A sweep over the gaps' middles: the open operation that started last
    # is the innermost one.
    idle: dict[str, float] = {}
    host = sorted(profile.host)
    open_ops: list = []
    index = 0
    for begin, finish in sorted(gaps(profile), key=lambda gap: sum(gap)):
        middle = (begin + finish) / 2
        while index < len(host) and host[index][0] <= middle:
            op_start, op_end, name = host[index]
            heapq.heappush(open_ops, (-op_start, op_end, name))
            index += 1
        while open_ops and open_ops[0][1] < middle:
            heapq.heappop(open_ops)
        name = open_ops[0][2] if open_ops else "(no host operation)"
        idle[name] = idle.get(name, 0.0) + (finish - begin)

    def ranked(values):
        return [[name[:160], seconds / 1e6] for name, seconds in
                sorted(values.items(), key=lambda item: -item[1])[:top]]

    return {"device_ops": ranked(by_name), "idle_gaps": ranked(idle)}
