"""Idle ms of the card per image of the profiled phase while the host was
in the serving layer: the innermost of the port's layer spans open was
``pds.predict``, ``pds.prepare``, ``pds.estimator``, ``pds.crop`` or
``pds.copy_out`` (:mod:`pds_bench.program_spans`)."""

from pds_bench import program_spans

PROFILE = True


def read(record):
    return program_spans.idle_ms(record, "serving")
