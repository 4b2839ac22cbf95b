"""Share of their roofline that the hourglass's stride-1 3x3x3 convs reach:
the least time the published peaks allow for their work (forward; in train
cells forward, input and weight gradients) over the time between CUDA
events at their modules' forward and full backward hooks. Chosen by the
modules' shapes, never by kernel names, so it reads the same work whatever
implements the conv."""

import torch

from pds_bench import record

BACKWARD = True


def _select(path, module):
    return (isinstance(module, torch.nn.Conv3d)
            and tuple(module.kernel_size) == (3, 3, 3)
            and tuple(module.stride) == (1, 1, 1))


SPANS = {"conv3d_k3s1": _select}


def read(trace_record):
    return record.roofline_pct(trace_record, "conv3d_k3s1")
