"""What the command-line entry points share."""

from __future__ import annotations

import argparse

from practicaldeepstereo_nips2018_tpu_torch import models
from practicaldeepstereo_nips2018_tpu_torch.data import Loader
from practicaldeepstereo_nips2018_tpu_torch.training import weights

# Flags of the JAX scripts for features not ported yet: name -> (the only
# value accepted, its default; the ROADMAP Queue 1 item that ports it).
NOT_PORTED = {
    "mesh_data": (None, 13),
    "mesh_volume": (1, 13),
}
# ``--remat`` values -> ``PDSConfig.remat`` (the JAX scripts' mapping).
REMAT_POLICIES = {"none": False, "selective": "selective", "all": True}


def add_device_argument(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default="cuda",
                        help='"cuda" (default) or "cpu" (the plain PyTorch '
                        "versions of the kernels)")


def reject_unported_flags(args: argparse.Namespace) -> None:
    """Raises for a flag of :data:`NOT_PORTED` set to another value than
    its default."""
    for name, (default, item) in NOT_PORTED.items():
        value = getattr(args, name, default)
        if value != default:
            raise ValueError(
                f"--{name}={value!r} is not ported to the PyTorch package "
                f"yet (ROADMAP Queue 1 item {item}); leave it at its "
                f"default ({default!r})")


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


def build_loaders(training_set, validation_set, batch_size: int,
                  num_workers: int):
    """The training loader (shuffled per epoch; the trailing incomplete
    batch dropped when batches are larger than 1) and the batch-1
    validation loader."""
    training_loader = Loader(
        training_set, batch_size=batch_size, shuffle=True,
        num_workers=num_workers, drop_last=batch_size > 1)
    validation_loader = Loader(validation_set, batch_size=1,
                               num_workers=num_workers)
    return training_loader, validation_loader
