"""Exports a KITTI benchmark submission: uint16 disparity PNGs.

Runs the network over a KITTI testing set (no ground truth) at each
image's own size and writes ``disparity * 256`` as a 16-bit PNG named
after the example's source file (``000000_10.png``, ...), the format of
the KITTI website, into ``<experiment_folder>/submission``.

Example:
    python -m practicaldeepstereo_nips2018_tpu_torch.cli.export_kitti_submission \
        --dataset_folder datasets/kitti \
        --experiment_folder experiments/kitti_submission \
        --checkpoint_file experiments/kitti/500_checkpoint.npz \
        --benchmark 2015 --bfloat16
"""

from __future__ import annotations

import argparse
import os

import torch

from practicaldeepstereo_nips2018_tpu_torch import models
from practicaldeepstereo_nips2018_tpu_torch.cli import common
from practicaldeepstereo_nips2018_tpu_torch.data import Kitti
from practicaldeepstereo_nips2018_tpu_torch.training.trainer import (
    PDSTrainer)


def parse_arguments(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--dataset_folder", default="datasets/kitti")
    parser.add_argument("--experiment_folder",
                        default="experiments/kitti_submission")
    parser.add_argument("--checkpoint_file", required=True)
    parser.add_argument("--benchmark", default="2015",
                        choices=["2012", "2015"])
    parser.add_argument("--maximum_disparity", type=int, default=255)
    parser.add_argument("--bfloat16", action="store_true")
    parser.add_argument("--num_workers", type=int, default=3)
    common.add_device_argument(parser)
    return parser.parse_args(argv)


def main(argv=None) -> float:
    """Exports as the command line asks; returns the seconds per image."""
    args = parse_arguments(argv)
    device = common.initialize(args)
    os.makedirs(args.experiment_folder, exist_ok=True)
    factory = (Kitti.kitti2015_benchmark if args.benchmark == "2015"
               else Kitti.kitti2012_benchmark)
    config = models.PDSConfig(maximum_disparity=args.maximum_disparity)
    trainer = PDSTrainer(
        network_config=config,
        network=common.initial_network(config),
        test_set_loader=common.shard(factory(args.dataset_folder), 1,
                                     args.num_workers),
        experiment_folder=os.path.abspath(args.experiment_folder),
        compute_dtype=torch.bfloat16 if args.bfloat16 else None,
        device=device)
    trainer.load_checkpoint(os.path.abspath(args.checkpoint_file),
                            load_only_network=True)
    _, processing_time = trainer.test()
    submission_folder = os.path.join(args.experiment_folder, "submission")
    count = len(os.listdir(submission_folder))
    print(f"exported {count} submission PNGs to {submission_folder} "
          f"({processing_time:.3f} s/image)")
    return processing_time


if __name__ == "__main__":
    main()
