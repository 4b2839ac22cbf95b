"""Device ms per image of the embedding stage (``_embedding``), forward,
from CUDA events at its forward hooks; summed over its calls."""

from pds_bench import record

SPANS = {"embedding": "_embedding"}


def read(trace_record):
    return record.per_image_ms(trace_record, "embedding")
