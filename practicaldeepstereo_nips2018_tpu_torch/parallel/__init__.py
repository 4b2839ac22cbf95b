"""Parallelism over processes: the runtime (``torch.distributed``), the
``(data, volume)`` mesh, and the W-slices of the ``volume`` axis with
their halos (``sharding.py``); the train step over both axes is
``training/trainer.py::train_step``."""

from practicaldeepstereo_nips2018_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    VOLUME_AXIS,
    Mesh,
    make_mesh,
)
from practicaldeepstereo_nips2018_tpu_torch.parallel.runtime import (
    all_hosts_sum,
    initialize_distributed,
    topology,
)

__all__ = [
    "DATA_AXIS",
    "VOLUME_AXIS",
    "Mesh",
    "make_mesh",
    "all_hosts_sum",
    "initialize_distributed",
    "topology",
]
