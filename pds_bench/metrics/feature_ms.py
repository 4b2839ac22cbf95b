"""Device ms per image (stereo pair) of PSMNet's feature tower, forward,
both views: CUDA events at the forward hooks of its ``feature_extraction``
module, summed over its calls."""

from pds_bench import record

SPANS = {"feature_extraction": "feature_extraction"}


def read(trace_record):
    return record.per_image_ms(trace_record, "feature_extraction")
