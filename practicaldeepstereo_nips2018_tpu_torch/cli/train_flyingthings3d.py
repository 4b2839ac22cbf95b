"""Trains PDS from scratch on FlyingThings3D.

The reference protocol: maximum disparity 255, full-size 960x540 images, no
augmentation, RMSprop at 1e-2 halved at epochs 6 to 10, 10 epochs, 500
examples held out for validation, the artifact and disparity-range filters.

Example:
    python -m practicaldeepstereo_nips2018_tpu_torch.cli.train_flyingthings3d \
        --dataset_folder datasets/flyingthings3d \
        --experiment_folder experiments/flyingthings3d --bfloat16 \
        [--checkpoint_file experiments/flyingthings3d/001_checkpoint.npz]
"""

from __future__ import annotations

import argparse
import os

import torch

from practicaldeepstereo_nips2018_tpu_torch.cli import common
from practicaldeepstereo_nips2018_tpu_torch.data import (
    FlyingThings3D, transforms)
from practicaldeepstereo_nips2018_tpu_torch.training.trainer import (
    PDSTrainer)


def parse_arguments(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--dataset_folder",
                        default="datasets/flyingthings3d")
    parser.add_argument("--experiment_folder",
                        default="experiments/flyingthings3d")
    parser.add_argument("--checkpoint_file", default=None,
                        help="checkpoint to resume training from")
    parser.add_argument("--maximum_disparity", type=int, default=255)
    parser.add_argument("--number_of_validation_examples", type=int,
                        default=500)
    parser.add_argument("--end_epoch", type=int, default=10)
    parser.add_argument("--learning_rate", type=float, default=1e-2)
    parser.add_argument("--learning_rate_milestones", type=int, nargs="*",
                        default=None,
                        help="epochs at which the rate halves (default: "
                        "the reference's 6 7 8 9 10; pass with no values "
                        "for a constant rate)")
    parser.add_argument("--batch_size", type=int, default=1)
    parser.add_argument("--crop_height", type=int, default=None,
                        help="random-crop height for uniform batches")
    parser.add_argument("--crop_width", type=int, default=None)
    parser.add_argument("--mesh_data", type=int, default=None,
                        help="not ported yet: default only")
    parser.add_argument("--mesh_volume", type=int, default=1,
                        help="not ported yet: default only")
    parser.add_argument("--bfloat16", action="store_true",
                        help="bfloat16 compute (parameters stay float32)")
    parser.add_argument("--num_workers", type=int, default=3)
    parser.add_argument("--small_split", action="store_true",
                        help="use the 3000/300-example tuning split")
    parser.add_argument("--folded_conv_impl", default="banded_slab",
                        choices=["dense", "banded_slab"],
                        help="the JAX package's hourglass execution; the "
                        "port runs one hourglass for every value")
    parser.add_argument("--remat", default="none",
                        choices=["none", "selective", "all"],
                        help="activation recompute policy: none, the "
                        "volume-sized stages, or every stage (PDSConfig."
                        "remat False, \"selective\", True)")
    common.add_device_argument(parser)
    return parser.parse_args(argv)


def main(argv=None) -> PDSTrainer:
    """Trains as the command line asks; returns the trainer."""
    args = parse_arguments(argv)
    common.reject_unported_flags(args)
    os.makedirs(args.experiment_folder, exist_ok=True)
    if args.small_split:
        training_set, validation_set = FlyingThings3D.small_training_split(
            args.dataset_folder)
        maximum_disparity = 127
    else:
        training_set, validation_set = FlyingThings3D.training_split(
            args.dataset_folder, maximum_disparity=args.maximum_disparity,
            number_of_validation_examples=(
                args.number_of_validation_examples))
        maximum_disparity = args.maximum_disparity
    config = common.network_config(args, maximum_disparity)
    if args.crop_height and args.crop_width:
        training_set.append_transformers(
            [transforms.RandomCrop(args.crop_height, args.crop_width)])
    training_loader, validation_loader = common.build_loaders(
        training_set, validation_set, args.batch_size, args.num_workers)
    trainer = PDSTrainer(
        network_config=config,
        network=common.initial_network(config),
        training_set_loader=training_loader,
        test_set_loader=validation_loader,
        experiment_folder=os.path.abspath(args.experiment_folder),
        initial_learning_rate=args.learning_rate,
        **({} if args.learning_rate_milestones is None
           else {"learning_rate_milestones":
                 tuple(args.learning_rate_milestones)}),
        end_epoch=args.end_epoch,
        compute_dtype=torch.bfloat16 if args.bfloat16 else None,
        device=args.device)
    if args.checkpoint_file:
        trainer.load_checkpoint(os.path.abspath(args.checkpoint_file))
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()
