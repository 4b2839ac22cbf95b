"""Benchmarks PDS on the FlyingThings3D test set (PSM or CRL protocol).

Maximum disparity 191 on full-size 960x540 images; the PSM protocol keeps
every TEST example, the CRL protocol drops examples with more than 25 % of
their pixels above 300 px; both mask ground truth above 192 px. Prints the
MAE [px], the 3PE [%] and the time per image [sec], measured between
device synchronisations after an untimed call at each batch shape.

Example:
    python -m practicaldeepstereo_nips2018_tpu_torch.cli.benchmark_flyingthings3d \
        --dataset_folder datasets/flyingthings3d \
        --experiment_folder experiments/flyingthings3d_benchmark \
        --checkpoint_file experiments/flyingthings3d/010_checkpoint.npz \
        --is_psm_protocol --bfloat16
"""

from __future__ import annotations

import argparse
import os

import torch

from practicaldeepstereo_nips2018_tpu_torch.cli import common
from practicaldeepstereo_nips2018_tpu_torch.data import FlyingThings3D
from practicaldeepstereo_nips2018_tpu_torch.training.trainer import (
    PDSTrainer)


def parse_arguments(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--dataset_folder",
                        default="datasets/flyingthings3d")
    parser.add_argument("--experiment_folder",
                        default="experiments/flyingthings3d_benchmarking")
    parser.add_argument("--checkpoint_file", required=True)
    parser.add_argument("--is_psm_protocol", action="store_true")
    parser.add_argument("--maximum_disparity", type=int, default=191)
    parser.add_argument("--bfloat16", action="store_true")
    parser.add_argument("--num_workers", type=int, default=3)
    parser.add_argument("--eval_batch_size", type=int, default=1,
                        help="examples per eval step (metrics are per "
                        "example)")
    parser.add_argument("--mesh_data", type=int, default=None,
                        help="the number of processes (torchrun "
                        "--nproc_per_node); each evaluates its own shard "
                        "of the examples and the metrics are summed")
    parser.add_argument("--mesh_volume", type=int, default=1,
                        help=common.MESH_VOLUME_HELP)
    parser.add_argument("--folded_conv_impl", default="banded_slab",
                        choices=["dense", "banded_slab", "banded_pallas"],
                        help="the JAX package's hourglass execution; the "
                        "port runs one hourglass for every value")
    parser.add_argument("--matching_tail_int8", action="store_true",
                        help="run the matching tail's convs on int8 "
                        "operands (an approximation)")
    common.add_device_argument(parser)
    return parser.parse_args(argv)


def main(argv=None):
    """Benchmarks as the command line asks; returns (errors, seconds per
    image)."""
    args = parse_arguments(argv)
    device = common.initialize(args)
    mesh = common.mesh(args)
    os.makedirs(args.experiment_folder, exist_ok=True)
    test_set = common.on_each_host_first(
        FlyingThings3D.benchmark_dataset, args.dataset_folder,
        is_psm_protocol=args.is_psm_protocol)
    config = common.network_config(args)
    trainer = PDSTrainer(
        network_config=config,
        network=common.initial_network(config),
        test_set_loader=common.shard(test_set, args.eval_batch_size,
                                     args.num_workers),
        experiment_folder=os.path.abspath(args.experiment_folder),
        compute_dtype=torch.bfloat16 if args.bfloat16 else None,
        device=device, mesh=mesh)
    trainer.load_checkpoint(os.path.abspath(args.checkpoint_file),
                            load_only_network=True)
    errors, processing_time = trainer.test()
    print(f"MAE = {errors['mean_absolute_error']:.5f} [pix], "
          f"3PE = {errors['three_pixels_error']:.5f} [%], "
          f"time-per-image = {processing_time:.3f} [sec]")
    return errors, processing_time


if __name__ == "__main__":
    main()
