"""Converts a reference PyTorch checkpoint (``.bin``) into an ``.npz``.

Reads the reference trainer's file (``{"network": state_dict, ...}`` or a
bare state_dict) into the port's network and writes a network-only
``.npz`` checkpoint in the JAX package's layout, which both packages load
with ``PDSTrainer.load_checkpoint(..., load_only_network=True)``.

Example:
    python -m practicaldeepstereo_nips2018_tpu_torch.cli.import_torch_checkpoint \
        --torch_checkpoint 010_checkpoint.bin \
        --output experiments/imported/000_checkpoint.npz
"""

from __future__ import annotations

import argparse
import os

from practicaldeepstereo_nips2018_tpu_torch.training import (
    checkpoint, weights)


def main(argv=None) -> str:
    """Converts as the command line asks; returns the output path."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--torch_checkpoint", required=True)
    parser.add_argument("--output", required=True)
    args = parser.parse_args(argv)
    network = weights.load_torch_checkpoint(args.torch_checkpoint)
    os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
    checkpoint.save_checkpoint(
        args.output, checkpoint.training_trees(network),
        {"training_losses": [], "test_errors": [],
         "source": os.path.abspath(args.torch_checkpoint)})
    print(f"wrote {args.output}")
    return args.output


if __name__ == "__main__":
    main()
