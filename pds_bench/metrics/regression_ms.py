"""Device ms per image of PSMNet's disparity heads, forward: the trilinear
upsampling, softmax and regression of each head, from CUDA events at the
forward hooks of its ``regression`` module, summed over the three heads'
calls."""

from pds_bench import record

SPANS = {"regression": "regression"}


def read(trace_record):
    return record.per_image_ms(trace_record, "regression")
