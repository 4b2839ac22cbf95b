"""Idle ms of the card per image of the profiled phase while the host was
in the matching stage: the innermost of the port's layer spans open was
``pds.matching``, a remat policy's recompute in the backward pass
included (:mod:`pds_bench.program_spans`)."""

from pds_bench import program_spans

PROFILE = True


def read(record):
    return program_spans.idle_ms(record, "matching")
