"""Fine-tunes a FlyingThings3D-trained PDS network on KITTI 2012 + 2015.

Loads the pretrained weights (network only), trains on the combined KITTI
training split (sparse ground truth: unknown pixels are inf and the loss
leaves them out) and validates on the 58 held-out examples. Images are
padded top/left to 384x1280 so that every batch has one shape.

Example:
    python -m practicaldeepstereo_nips2018_tpu_torch.cli.finetune_kitti \
        --dataset_folder datasets/kitti --experiment_folder experiments/kitti \
        --checkpoint_file experiments/flyingthings3d/010_checkpoint.npz
"""

from __future__ import annotations

import argparse
import os

import torch

from practicaldeepstereo_nips2018_tpu_torch.cli import common
from practicaldeepstereo_nips2018_tpu_torch.data import Kitti, transforms
from practicaldeepstereo_nips2018_tpu_torch.training.trainer import (
    PDSTrainer)


def parse_arguments(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--dataset_folder", default="datasets/kitti")
    parser.add_argument("--experiment_folder", default="experiments/kitti")
    parser.add_argument("--checkpoint_file", default=None,
                        help="pretrained checkpoint (loaded network-only)")
    parser.add_argument("--resume_checkpoint_file", default=None,
                        help="fine-tuning checkpoint to resume from")
    parser.add_argument("--maximum_disparity", type=int, default=255,
                        help="KITTI ground truth reaches 231 px")
    parser.add_argument("--end_epoch", type=int, default=500)
    parser.add_argument("--learning_rate", type=float, default=1e-3)
    parser.add_argument("--number_of_validation_examples", type=int,
                        default=58,
                        help="held-out examples (reference: seed 0, 58)")
    parser.add_argument("--pad_height", type=int, default=384)
    parser.add_argument("--pad_width", type=int, default=1280)
    parser.add_argument("--batch_size", type=int, default=1)
    parser.add_argument("--mesh_data", type=int, default=None,
                        help="not ported yet: default only")
    parser.add_argument("--mesh_volume", type=int, default=1,
                        help="not ported yet: default only")
    parser.add_argument("--bfloat16", action="store_true")
    parser.add_argument("--num_workers", type=int, default=3)
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
    """Fine-tunes as the command line asks; returns the trainer."""
    args = parse_arguments(argv)
    common.reject_unported_flags(args)
    os.makedirs(args.experiment_folder, exist_ok=True)
    training_set, validation_set = Kitti.training_split(
        args.dataset_folder,
        number_of_validation_examples=args.number_of_validation_examples)
    pad = [transforms.PadToSize(args.pad_height, args.pad_width)]
    training_set.append_transformers(pad)
    validation_set.append_transformers(pad)
    config = common.network_config(args)
    training_loader, validation_loader = common.build_loaders(
        training_set, validation_set, args.batch_size, args.num_workers)
    trainer = PDSTrainer(
        network_config=config,
        network=common.initial_network(config),
        training_set_loader=training_loader,
        test_set_loader=validation_loader,
        experiment_folder=os.path.abspath(args.experiment_folder),
        initial_learning_rate=args.learning_rate,
        learning_rate_milestones=(args.end_epoch // 2,),
        end_epoch=args.end_epoch,
        compute_dtype=torch.bfloat16 if args.bfloat16 else None,
        device=args.device)
    if args.checkpoint_file:
        trainer.load_checkpoint(os.path.abspath(args.checkpoint_file),
                                load_only_network=True)
    if args.resume_checkpoint_file:
        trainer.load_checkpoint(
            os.path.abspath(args.resume_checkpoint_file))
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()
