"""Idle ms of the card per image of the profiled phase while the host was
in the embedding: the innermost of the port's layer spans open was
``pds.embedding``, either view (:mod:`pds_bench.program_spans`)."""

from pds_bench import program_spans

PROFILE = True


def read(record):
    return program_spans.idle_ms(record, "embedding")
