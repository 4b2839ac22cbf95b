"""The ``(data, volume)`` mesh over the processes.

Port of ``practicaldeepstereo_nips2018_tpu/parallel/mesh.py::make_mesh``.
The JAX mesh is an array of devices that GSPMD shards over; here each
process drives one device, so a mesh is the sizes of its two axes, laid
over the processes of the group as JAX lays them, ``volume`` innermost:
process ``rank = data_index * volume + volume_index``.

* ``data``: the batch is split over it; the processes of one
  ``volume_index`` train on the loader shards of their ``data_index``;
* ``volume``: the W axis of the images, descriptors, cost volume and
  hourglass (``parallel/sharding.py``). The processes of one
  ``data_index``, its volume group, take the same examples and each runs
  the network on its own columns.

The gradients and the loss's count are summed over every process
(``training/trainer.py::loss_and_gradients``), which covers both axes, so
nothing reduces over the ``data`` axis alone and the mesh keeps only the
volume groups. There are no device arrays and no physical topology to lay
the axes on (JAX's ``mesh_utils.create_device_mesh``).
"""

from __future__ import annotations

import dataclasses

from practicaldeepstereo_nips2018_tpu_torch.parallel import runtime

DATA_AXIS = "data"
VOLUME_AXIS = "volume"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis sizes; ``data * volume`` processes, one device each.
    ``volume_group`` is this process's volume group (None at volume 1)."""

    data: int
    volume: int = 1
    volume_group: object = dataclasses.field(default=None, compare=False,
                                             repr=False)

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, VOLUME_AXIS: self.volume}

    @property
    def size(self) -> int:
        return self.data * self.volume

    @property
    def data_index(self) -> int:
        """This process's position on the ``data`` axis: its loader
        shard."""
        return runtime.process_index() // self.volume

    @property
    def volume_index(self) -> int:
        """This process's position on the ``volume`` axis: its slice of
        the columns."""
        return runtime.process_index() % self.volume

    @property
    def volume_ranks(self) -> tuple[int, ...]:
        """The processes of this process's volume group, in order."""
        first = self.data_index * self.volume
        return tuple(range(first, first + self.volume))


def make_mesh(data: int | None = None, volume: int = 1) -> Mesh:
    """Builds a ``(data, volume)`` mesh over the processes of the group.

    Args:
        data: size of the data axis; default: processes / volume.
        volume: size of the cost-volume axis.

    Raises ValueError where ``data * volume`` is not the number of
    processes (the JAX mesh takes a subset of the devices; here every
    process runs the same program, so none may be left out). With
    ``volume > 1`` a collective: every process creates every volume group.
    """
    world = runtime.process_count()
    if data is None:
        data = max(1, world // volume)
    if data < 1 or volume < 1:
        raise ValueError(f"mesh axes must be positive, got data={data}, "
                         f"volume={volume}")
    if data * volume != world:
        raise ValueError(
            f"a mesh of data={data} x volume={volume} needs {data * volume} "
            f"processes, but the world size is {world} (one device per "
            "process; launch with torchrun --nproc_per_node "
            f"{data * volume})")
    if volume == 1:
        return Mesh(data, volume)
    groups = [runtime.new_group(range(index * volume, (index + 1) * volume))
              for index in range(data)]
    return Mesh(data, volume, groups[runtime.process_index() // volume])
