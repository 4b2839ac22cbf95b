"""The ``(data, volume)`` mesh over the processes.

Port of ``practicaldeepstereo_nips2018_tpu/parallel/mesh.py::make_mesh``.
The JAX mesh is an array of devices that GSPMD shards over; here each
process drives one device, so a mesh is only the sizes of its two axes,
laid over the processes of the group:

* ``data``: the batch is split over it; each process trains on its own
  loader shard and the gradients are summed over it
  (``training/trainer.py::train_step``);
* ``volume``: the W axis of the cost volume, sharded in the JAX package.
  Not ported yet (ROADMAP Queue 1 item 13b): only 1 is accepted.

There are no device arrays and no physical topology to lay the axes on
(JAX's ``mesh_utils.create_device_mesh``).
"""

from __future__ import annotations

import dataclasses

from practicaldeepstereo_nips2018_tpu_torch.parallel import runtime

DATA_AXIS = "data"
VOLUME_AXIS = "volume"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis sizes; ``data * volume`` processes, one device each."""

    data: int
    volume: int = 1

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, VOLUME_AXIS: self.volume}

    @property
    def size(self) -> int:
        return self.data * self.volume


def make_mesh(data: int | None = None, volume: int = 1) -> Mesh:
    """Builds a ``(data, volume)`` mesh over the processes of the group.

    Args:
        data: size of the data axis; default: processes / volume.
        volume: size of the cost-volume axis; only 1 is ported.

    Raises ValueError where ``data * volume`` is not the number of
    processes (the JAX mesh takes a subset of the devices; here every
    process runs the same program, so none may be left out).
    """
    if volume != 1:
        raise ValueError(
            f"volume={volume}: the cost-volume mesh axis is not ported to "
            "the PyTorch package yet (ROADMAP Queue 1 item 13b); use "
            "volume=1")
    world = runtime.process_count()
    if data is None:
        data = world // volume
    if data * volume != world:
        raise ValueError(
            f"a mesh of data={data} x volume={volume} needs {data * volume} "
            f"processes, but the world size is {world} (one device per "
            "process; launch with torchrun --nproc_per_node "
            f"{data * volume})")
    return Mesh(data, volume)
