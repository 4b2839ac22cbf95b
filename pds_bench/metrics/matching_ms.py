"""Device ms per image of the matching stage (``_matching``), forward,
from CUDA events at its forward hooks; summed over its calls."""

from pds_bench import record

SPANS = {"matching": "_matching"}


def read(trace_record):
    return record.per_image_ms(trace_record, "matching")
