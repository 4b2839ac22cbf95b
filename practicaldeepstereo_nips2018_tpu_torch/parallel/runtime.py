"""The multi-process runtime over ``torch.distributed``.

Port of ``practicaldeepstereo_nips2018_tpu/parallel/runtime.py``. Each
process drives one device: ``cuda:{LOCAL_RANK}`` on the card, or the CPU.
:func:`initialize_distributed` joins the process group (idempotent) and
reports the topology used by the host-sharded loaders (``data/loader.py``)
and the single writer of logs, pictures and checkpoints
(``training/trainer.py``, ``training/checkpoint.py``).

The collectives here (:func:`all_reduce_sum`, :func:`all_reduce_in_place`,
:func:`all_gather_values`, :func:`all_hosts_sum`, :func:`barrier`,
:func:`broadcast_parameters`) are
the identity in a process that joined no group. In a group (of one
process too, as under ``torchrun --nproc_per_node 1``) they go through
the backend, but for :func:`all_hosts_sum`, which is the identity in one
process as the JAX runtime's is. Every process must call each of them the
same number of times, in the same order.

The ``volume`` mesh axis (``parallel/sharding.py``) adds collectives over a
subgroup (:func:`new_group`): the sum and the maximum
(:func:`all_reduce_sum`, :func:`all_reduce_max`), an all-gather
(:func:`all_gather`) and a point-to-point exchange (:func:`exchange`).
Gloo takes host tensors, so under gloo each of them copies a CUDA tensor
to the host and back inside the call; the caller sees tensors on its own
device.
"""

from __future__ import annotations

import datetime
import os
import warnings

import numpy as np
import torch
import torch.distributed as dist

# A lost peer makes every collective fail after this long instead of
# hanging.
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)
# What ``torchrun`` sets; the discovery that :func:`initialize_distributed`
# attempts without arguments reads them.
CLUSTER_VARIABLES = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                     "MASTER_PORT")


def rank_device(device: str | torch.device = "cuda") -> torch.device:
    """This process's device: ``"cuda"`` without an index becomes
    ``cuda:{LOCAL_RANK}``; a device with an index (two processes that
    share one card) and the CPU stay as given."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", local_process_index())
    return device


def local_process_index() -> int:
    """This process's index among those of its host (``LOCAL_RANK``; 0
    without ``torchrun``)."""
    return int(os.environ.get("LOCAL_RANK", 0))


def initialize_distributed(rank: int | None = None,
                           world_size: int | None = None,
                           init_method: str | None = None,
                           device: str | torch.device = "cuda",
                           backend: str | None = None) -> dict:
    """Joins the process group; returns :func:`topology`.

    Args:
        rank, world_size, init_method: explicit rendezvous (e.g.
            ``"tcp://localhost:29500"``); a missing one is read from the
            environment (``RANK``, ``WORLD_SIZE``, ``env://``). A failed
            join raises.
        device: this process's device (:func:`rank_device`); on the card
            it becomes the current CUDA device.
        backend: ``"nccl"`` when the device is CUDA, ``"gloo"`` on the CPU,
            unless given (two processes that share one card need gloo).

    Every collective of the group fails after :data:`DEFAULT_TIMEOUT`.

    Without explicit arguments the rendezvous is read from ``torchrun``'s
    variables (:data:`CLUSTER_VARIABLES`). Where neither ``RANK`` nor
    ``WORLD_SIZE`` is set there is nothing to join, and the process runs
    alone with no group. Where they are set and the join fails, it warns
    and runs alone: on a real cluster that is a misconfiguration (each
    process would train its own model), as the JAX package's runtime warns.
    A second call returns the current topology.
    """
    if dist.is_initialized():
        return topology()
    device = rank_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    explicit = (rank, world_size, init_method) != (None, None, None)
    if explicit:
        rank = int(os.environ.get("RANK", 0)) if rank is None else rank
        world_size = (int(os.environ.get("WORLD_SIZE", 1))
                      if world_size is None else world_size)
        if world_size < 1 or not 0 <= rank < world_size:
            raise ValueError(f"rank {rank} is not in a world of "
                             f"{world_size} processes")
        _join(backend, init_method or "env://", rank, world_size, device)
        return topology()
    if not (os.environ.get("RANK") or os.environ.get("WORLD_SIZE")):
        return topology()
    try:
        _join(backend, "env://", int(os.environ.get("RANK", 0)),
              int(os.environ.get("WORLD_SIZE", 1)), device)
    except (ValueError, RuntimeError) as error:
        variables = [name for name in CLUSTER_VARIABLES
                     if os.environ.get(name)]
        warnings.warn(
            f"joining the process group failed ({error}) although the "
            f"cluster variables {variables} are set; running as a SINGLE "
            "process, which on a real cluster is a misconfiguration",
            RuntimeWarning, stacklevel=2)
    return topology()


def _join(backend: str, init_method: str, rank: int, world_size: int,
          device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, timeout=DEFAULT_TIMEOUT)


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def topology() -> dict:
    """The JAX runtime's four keys; one device per process."""
    return {
        "process_index": process_index(),
        "process_count": process_count(),
        "local_device_count": 1,
        "global_device_count": process_count(),
    }


def destroy() -> None:
    """Leaves the process group, if any."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _collective_device() -> torch.device:
    """Where a tensor must lie for the group's backend: the card for
    NCCL, the host for gloo (a CUDA tensor goes through a host copy)."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def new_group(ranks):
    """A subgroup of ``ranks``; a collective over the whole world: every
    process calls it for every subgroup, in the same order, including the
    subgroups it is not in."""
    return dist.new_group(ranks=list(ranks))


def _all_reduce(tensor: torch.Tensor, op, group) -> torch.Tensor:
    if not dist.is_initialized():
        return tensor
    reduced = tensor.detach().to(_collective_device(), copy=True)
    dist.all_reduce(reduced, op=op, group=group)
    return reduced.to(tensor.device)


def all_reduce_sum(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """The element-wise sum of ``tensor`` over the processes of ``group``
    (default: all), as a new tensor on ``tensor``'s device (``tensor``
    itself without a group)."""
    return _all_reduce(tensor, dist.ReduceOp.SUM, group)


def all_reduce_max(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """The element-wise maximum over the processes of ``group``, as
    :func:`all_reduce_sum` gives the sum; no gradient."""
    return _all_reduce(tensor, dist.ReduceOp.MAX, group)


def all_gather(tensor: torch.Tensor, group=None) -> list[torch.Tensor]:
    """Each process's ``tensor`` (all of one shape), in the group's rank
    order, on ``tensor``'s device; no gradient."""
    local = tensor.detach().to(_collective_device()).contiguous()
    gathered = [torch.empty_like(local)
                for _ in range(dist.get_world_size(group))]
    dist.all_gather(gathered, local, group=group)
    return [part.to(tensor.device) for part in gathered]


def exchange(sends: dict, receives: dict, like: torch.Tensor) -> dict:
    """Point-to-point, all at once: sends ``sends[rank]`` to each process
    ``rank`` and receives from each process ``rank`` of ``receives`` a
    tensor of shape ``receives[rank]`` in ``like``'s dtype, which it
    returns on ``like``'s device. The processes' calls must match (what one
    sends to another, the other receives, with its shape); ranks are the
    world's. No gradient."""
    device = _collective_device() if dist.is_initialized() else like.device
    buffers = {rank: torch.empty(shape, dtype=like.dtype, device=device)
               for rank, shape in receives.items()}
    operations = [dist.P2POp(dist.irecv, buffer, rank)
                  for rank, buffer in buffers.items()]
    operations += [dist.P2POp(dist.isend, tensor.detach().to(device)
                              .contiguous(), rank)
                   for rank, tensor in sends.items()]
    if operations:
        for request in dist.batch_isend_irecv(operations):
            request.wait()
    return {rank: buffer.to(like.device) for rank, buffer in buffers.items()}


def all_gather_values(values) -> np.ndarray:
    """``[processes, len(values)]`` float32: each process's vector, in rank
    order, on every process."""
    vector = torch.tensor([float(value) for value in values],
                          dtype=torch.float32)
    if not dist.is_initialized():
        return vector.numpy()[None]
    vector = vector.to(_collective_device())
    gathered = [torch.empty_like(vector) for _ in range(process_count())]
    dist.all_gather(gathered, vector)
    return torch.stack(gathered).cpu().numpy()


def all_hosts_sum(values) -> list[float]:
    """Element-wise sum of a per-process float vector across all processes.

    Turns per-process accumulators (sum, count) into global ones: each
    process's validation loader sees a disjoint shard, so the global mean
    is ``sum(sums) / sum(counts)``. One process: the identity. Across
    processes, as the JAX runtime does: the float32 vectors gathered in
    rank order and summed by numpy, the same bits on every process. A
    collective."""
    values = [float(value) for value in values]
    if process_count() == 1:
        return values
    return [float(value) for value in all_gather_values(values).sum(axis=0)]


def barrier() -> None:
    """Waits until every process has reached it."""
    if not dist.is_initialized():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def _through_flat_buffers(tensors, collective) -> None:
    """Runs ``collective`` on one flat buffer per dtype that holds
    ``tensors``, on the backend's device, and copies the result back into
    them: one call for the whole set instead of one per tensor."""
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for tensor in tensors:
        by_dtype.setdefault(tensor.dtype, []).append(tensor)
    with torch.no_grad():
        for group in by_dtype.values():
            flat = torch.cat([tensor.reshape(-1) for tensor in group]).to(
                _collective_device())
            collective(flat)
            offset = 0
            for tensor in group:
                tensor.copy_(flat[offset:offset + tensor.numel()]
                             .view_as(tensor))
                offset += tensor.numel()


def all_reduce_in_place(tensors) -> None:
    """Replaces each of ``tensors`` by its sum over the processes, in one
    flat buffer per dtype."""
    if dist.is_initialized():
        _through_flat_buffers(tensors, dist.all_reduce)


def broadcast_parameters(module: torch.nn.Module, source: int = 0) -> None:
    """Copies ``source``'s parameters into every process's ``module``, in
    one flat buffer per dtype."""
    if dist.is_initialized():
        _through_flat_buffers(list(module.parameters()),
                              lambda flat: dist.broadcast(flat, source))
