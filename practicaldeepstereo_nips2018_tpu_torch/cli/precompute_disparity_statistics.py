"""Writes the FlyingThings3D disparity statistics caches ahead of training.

The first scan of the dataset computes each example's statistics (one PFM
read each), in C++ threads (``data/native.py``, built with ``g++`` into
``build/native/`` at first use); run this once (with ``--cache_folder``
somewhere writable when the dataset is read-only) and later scans only read
the caches.

Example:
    python -m practicaldeepstereo_nips2018_tpu_torch.cli.precompute_disparity_statistics \
        --dataset_folder datasets/flyingthings3d
"""

from __future__ import annotations

import argparse
import time

from practicaldeepstereo_nips2018_tpu_torch.data import (
    precompute_disparity_statistics)


def main(argv=None) -> int:
    """Scans as the command line asks; returns the number of examples."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--dataset_folder", required=True)
    parser.add_argument("--cache_folder", default=None)
    args = parser.parse_args(argv)
    start = time.time()
    count = precompute_disparity_statistics(args.dataset_folder,
                                            args.cache_folder)
    print(f"scanned {count} examples in {time.time() - start:.1f}s")
    return count


if __name__ == "__main__":
    main()
