"""Idle ms of the card per train step of the profiled phase while the host
was in the trainer: the innermost of the port's layer spans open was
``pds.train_step``, ``pds.loss``, ``pds.backward``, ``pds.all_reduce`` or
``pds.optimizer`` (:mod:`pds_bench.program_spans`)."""

from pds_bench import program_spans

PROFILE = True


def read(record):
    return program_spans.idle_ms(record, "trainer", per="iteration")
