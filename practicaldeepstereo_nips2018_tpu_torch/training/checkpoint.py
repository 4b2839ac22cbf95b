"""Checkpoints in the JAX package's ``.npz`` contract, both ways.

Port of ``practicaldeepstereo_nips2018_tpu/training/checkpoint.py``. A
``{epoch:03d}_checkpoint.npz`` holds each saved tree's leaves as
``<name>.<index>`` arrays plus a JSON ``__metadata__`` blob, and is written
to a temporary name and renamed into place. The leaf order is that of
``jax.tree.leaves``: nested dict keys visited in SORTED order, depth first.
:func:`tree_leaves` and :func:`tree_unflatten` reproduce it without JAX.

The trainer's trees are ``params`` and ``opt_state``. The JAX package's
``opt_state`` is optax's ``ScaleByRmsState(nu=<params tree>)``, whose
leaves are RMSprop's square averages in params order; here they come from
``torch.optim.RMSprop``'s ``square_avg`` through the weight bridge
(:func:`save_training_state`, :func:`load_training_state`), so a checkpoint
written by either package resumes in the other. optax keeps no step count;
the port writes RMSprop's ``step`` into the metadata (``rmsprop_step``),
and a file without it restores ``step`` 0, which the update does not read.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from practicaldeepstereo_nips2018_tpu_torch.training import weights


def tree_leaves(tree) -> list:
    """Leaves of a nested dict in ``jax.tree.leaves`` order."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    return [tree]


def tree_unflatten(template, leaves) -> dict:
    """A nested dict shaped like ``template`` holding ``leaves`` in
    :func:`tree_leaves` order."""
    iterator = iter(leaves)

    def rebuild(node):
        if isinstance(node, dict):
            return {key: rebuild(node[key]) for key in sorted(node)}
        return next(iterator)

    return rebuild(template)


def save_checkpoint(filename: str, trees: dict, metadata: dict) -> None:
    """Writes nested dicts of arrays + JSON ``metadata`` to ``filename``,
    through a temporary file and an atomic rename."""
    arrays = {}
    for name, tree in trees.items():
        for index, leaf in enumerate(tree_leaves(tree)):
            arrays[f"{name}.{index}"] = np.asarray(leaf)
    arrays["__metadata__"] = np.frombuffer(
        json.dumps(metadata).encode("utf-8"), dtype=np.uint8)
    temporary = filename + ".tmp"
    with open(temporary, "wb") as handle:
        np.savez(handle, **arrays)
    os.replace(temporary, filename)


def training_trees(network,
                   optimizer: torch.optim.RMSprop | None = None) -> dict:
    """``{"params", "opt_state"}`` in the JAX package's layout: the weights
    and, with an optimizer, RMSprop's square averages (zeros for a
    parameter not stepped yet, as optax initialises them)."""
    trees = {"params": weights.jax_tree_of_parameters(
        network, lambda _, parameter: parameter)}
    if optimizer is not None:
        def square_average(_, parameter):
            state = optimizer.state.get(parameter, {})
            if "square_avg" in state:
                return state["square_avg"]
            return torch.zeros_like(parameter)

        trees["opt_state"] = weights.jax_tree_of_parameters(network,
                                                            square_average)
    return trees


def _rmsprop_step(optimizer: torch.optim.RMSprop) -> int:
    steps = [int(state["step"]) for state in optimizer.state.values()
             if "step" in state]
    return max(steps, default=0)


def save_training_state(filename: str, network,
                        optimizer: torch.optim.RMSprop,
                        metadata: dict) -> None:
    """Writes the network and RMSprop state with the trainer's
    ``metadata`` (``training.trainer.checkpoint_metadata``)."""
    save_checkpoint(filename, training_trees(network, optimizer),
                    {**metadata, "rmsprop_step": _rmsprop_step(optimizer)})


def load_training_state(filename: str, network,
                        optimizer: torch.optim.RMSprop | None = None
                        ) -> dict:
    """Restores the network and, when ``optimizer`` is given, RMSprop's
    square averages and step from a checkpoint written by either package;
    without it only the network (``load_only_network``). Returns the
    metadata."""
    trees, metadata = load_checkpoint(filename,
                                      training_trees(network, optimizer))
    network.load_state_dict(weights.state_dict_from_jax_params(
        trees["params"]))
    if optimizer is not None:
        square_averages = weights.state_dict_from_jax_params(
            trees["opt_state"])
        names = {parameter: name
                 for name, parameter in network.named_parameters()}
        step = float(metadata.get("rmsprop_step", 0))
        state = optimizer.state_dict()
        parameters = [parameter for group in optimizer.param_groups
                      for parameter in group["params"]]
        state["state"] = {
            index: {"step": torch.tensor(step),
                    "square_avg": square_averages[names[parameter]]}
            for index, parameter in enumerate(parameters)}
        optimizer.load_state_dict(state)
    return metadata


def load_checkpoint(filename: str, templates: dict):
    """Loads nested dicts + metadata from ``filename``.

    Args:
        filename: ``.npz`` checkpoint path.
        templates: name -> template nested dict with the structure and leaf
            shapes the tree had when it was saved. Only these names are
            read (e.g. ``{"params": ...}`` for a network-only restore).

    Returns:
        (trees, metadata): numpy trees keyed like ``templates`` and the
        metadata dict. Raises ValueError when the leaf count or a shape
        does not match the template.
    """
    with np.load(filename) as content:
        metadata = json.loads(bytes(content["__metadata__"]).decode("utf-8"))
        trees = {}
        for name, template in templates.items():
            expected = tree_leaves(template)
            stored = sum(1 for key in content.files
                         if key.startswith(f"{name}."))
            if stored != len(expected):
                raise ValueError(
                    f'checkpoint "{filename}" holds {stored} "{name}" arrays '
                    f"but the template expects {len(expected)}: the "
                    "checkpoint was written by a different network/optimizer "
                    "configuration")
            restored = [content[f"{name}.{index}"]
                        for index in range(len(expected))]
            for index, (leaf, value) in enumerate(zip(expected, restored)):
                if tuple(value.shape) != tuple(np.shape(leaf)):
                    raise ValueError(
                        f'checkpoint "{filename}" array "{name}.{index}" has '
                        f"shape {tuple(value.shape)} but the template expects "
                        f"{tuple(np.shape(leaf))}: configuration mismatch")
            trees[name] = tree_unflatten(template, restored)
    return trees, metadata


def checkpoint_filename(experiment_folder: str, epoch: int) -> str:
    """The reference naming scheme, ``{epoch:03d}_checkpoint`` with the
    ``.npz`` extension."""
    return os.path.join(experiment_folder, f"{epoch:03d}_checkpoint.npz")
