"""Device ms per image of PSMNet's 3-D aggregation, forward: ``dres0``,
``dres1``, the three hourglasses ``dres2``-``dres4`` and the three
classifiers, from CUDA events at their modules' forward hooks, summed
over their calls (the residual adds between them are left out)."""

from pds_bench import record

MODULES = ("dres0", "dres1", "dres2", "dres3", "dres4", "classif1",
           "classif2", "classif3")
SPANS = {"aggregation": lambda path, module: path in MODULES}


def read(trace_record):
    return record.per_image_ms(trace_record, "aggregation")
