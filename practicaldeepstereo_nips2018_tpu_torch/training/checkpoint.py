"""Reading checkpoints written by the JAX package's trainer.

Port of the read side of ``practicaldeepstereo_nips2018_tpu/training/
checkpoint.py::load_checkpoint``. A ``{epoch:03d}_checkpoint.npz`` holds
each saved tree's leaves as ``<name>.<index>`` arrays plus a JSON
``__metadata__`` blob. The leaf order is that of ``jax.tree.leaves``: nested
dict keys visited in SORTED order, depth first. :func:`tree_leaves` and
:func:`tree_unflatten` reproduce it without JAX.
"""

from __future__ import annotations

import json
import os

import numpy as np


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
