"""Device ms per image of the regularization stage (``_regularization``),
forward, from CUDA events at its forward hooks; summed over its calls."""

from pds_bench import record

SPANS = {"regularization": "_regularization"}


def read(trace_record):
    return record.per_image_ms(trace_record, "regularization")
