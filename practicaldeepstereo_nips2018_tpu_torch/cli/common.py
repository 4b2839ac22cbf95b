"""What the command-line entry points share: the runtime and the mesh,
the loaders' shards, the network's configuration and first weights.

Launched by ``torchrun --nproc_per_node N -m
practicaldeepstereo_nips2018_tpu_torch.cli.<name> ... --mesh_data D
--mesh_volume V`` (``D * V = N``), each process drives
``cuda:{LOCAL_RANK}`` (or the CPU under ``--device cpu``, over gloo); the
processes of one data index share a training shard and each trains on its
own columns of it, and every process evaluates its own shard of whole
images. Alone (no ``torchrun``) a process is the whole world."""

from __future__ import annotations

import argparse

import torch

from practicaldeepstereo_nips2018_tpu_torch import models
from practicaldeepstereo_nips2018_tpu_torch import parallel
from practicaldeepstereo_nips2018_tpu_torch.data import Loader
from practicaldeepstereo_nips2018_tpu_torch.parallel import runtime
from practicaldeepstereo_nips2018_tpu_torch.training import weights

BATCH_SIZE_HELP = ("examples per step on each process, i.e. per device "
                   "(the JAX scripts' is per host, split over the host's "
                   "devices; with one device per process the two are the "
                   "same)")
MESH_DATA_HELP = ("data-parallel mesh axis size (default: the number of "
                  "processes over --mesh_volume); the batch, the training "
                  "shards and the gradients are split and summed over it")
MESH_VOLUME_HELP = ("cost-volume mesh axis size: the processes of one data "
                    "index train on the same examples, each on its own "
                    "columns of the images, cost volume and hourglass "
                    "(halo exchanges and norm all-reduces between them); "
                    "at most the padded width over 64")
# ``--remat`` values -> ``PDSConfig.remat`` (the JAX scripts' mapping).
REMAT_POLICIES = {"none": False, "selective": "selective", "all": True}


def add_device_argument(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default="cuda",
                        help='"cuda" (default) or "cpu" (the plain PyTorch '
                        "versions of the kernels)")


def initialize(args: argparse.Namespace) -> torch.device:
    """Joins the process group that ``torchrun``'s variables name, if any,
    and returns this process's device (``--device``: ``cuda`` becomes
    ``cuda:{LOCAL_RANK}``)."""
    runtime.initialize_distributed(device=args.device)
    return runtime.rank_device(args.device)


def mesh(args: argparse.Namespace):
    """The mesh ``--mesh_data`` and ``--mesh_volume`` ask for, the data
    axis over every process without ``--mesh_data``; raises unless it
    spans every process."""
    return parallel.make_mesh(data=args.mesh_data, volume=args.mesh_volume)


def on_each_host_first(function, *arguments, **options):
    """``function(*arguments, **options)`` in the first process of each
    host, then, once it has returned, in the others: a dataset's first
    scan writes its statistics caches once per host, and the other
    processes read them."""
    if runtime.local_process_index() == 0:
        result = function(*arguments, **options)
    runtime.barrier()
    if runtime.local_process_index() != 0:
        result = function(*arguments, **options)
    return result


def network_config(args: argparse.Namespace,
                   maximum_disparity: int | None = None) -> models.PDSConfig:
    """The ``PDSConfig`` a command's flags ask for: ``--maximum_disparity``
    (or ``maximum_disparity``), ``--folded_conv_impl``, and ``--remat`` and
    ``--matching_tail_int8`` where the command has them."""
    return models.PDSConfig(
        maximum_disparity=(args.maximum_disparity if maximum_disparity is None
                           else maximum_disparity),
        folded_conv_impl=args.folded_conv_impl,
        remat=REMAT_POLICIES[getattr(args, "remat", "none")],
        matching_tail_int8=getattr(args, "matching_tail_int8", False))


def initial_network(config: models.PDSConfig) -> models.PdsNetwork:
    """The network with weights drawn from numpy's seed 0
    (``weights.random_jax_params``), on the CPU."""
    network = models.PdsNetwork(config)
    network.load_state_dict(weights.state_dict_from_jax_params(
        weights.random_jax_params(config, seed=0)))
    return network


def shard(dataset, batch_size: int = 1, num_workers: int = 3,
          **options) -> Loader:
    """A loader of this process's shard of ``dataset``."""
    return Loader(dataset, batch_size=batch_size, num_workers=num_workers,
                  host_index=runtime.process_index(),
                  host_count=runtime.process_count(), **options)


def build_loaders(training_set, validation_set, batch_size: int,
                  num_workers: int, mesh):
    """This process's shards: the training loader of its ``mesh.data_index``
    (shuffled per epoch, alike on the processes of a volume group; the
    trailing incomplete batch dropped when batches are larger than 1;
    every shard as long as the shortest, so that every process takes the
    same number of steps) and the batch-1 validation loader over all the
    processes (each evaluates its own shard of whole images; the trainer
    sums the metrics)."""
    training_loader = Loader(training_set, batch_size=batch_size,
                             num_workers=num_workers, shuffle=True,
                             drop_last=batch_size > 1, equal_shards=True,
                             host_index=mesh.data_index,
                             host_count=mesh.data)
    validation_loader = shard(validation_set, 1, num_workers)
    return training_loader, validation_loader
