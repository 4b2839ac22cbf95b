"""Percent of the profiled window's wall time in which no kernel, copy or
memset ran on the card."""

from pds_bench import trace

PROFILE = True


def read(record):
    profile = record.profile
    if profile is None or not profile.device:
        return None
    start, end = profile.window_us
    return 100.0 * (1.0 - trace.union_us(profile.device) / (end - start))
