"""Share of their roofline that the hourglass's transposed convs (the four
expansions' upsamplers and the two final upsamplers) reach, read as
``conv3d_roofline`` reads the stride-1 convs."""

import torch

from pds_bench import record

BACKWARD = True


def _select(path, module):
    return isinstance(module, torch.nn.ConvTranspose3d)


SPANS = {"conv_transpose3d": _select}


def read(trace_record):
    return record.roofline_pct(trace_record, "conv_transpose3d")
