"""PFM (portable float map) disparity IO.

Port of ``practicaldeepstereo_nips2018_tpu/data/pfm.py``. The FlyingThings3D
ground-truth disparities ship as PFM files: a ``PF`` (color) or ``Pf``
(gray) line, a ``width height`` line, a scale line whose sign gives the
byte order (negative: little-endian), then float32 rows stored bottom-up,
so the array is flipped vertically on read. The writer writes
little-endian; a file written by either package reads equal in both.
"""

from __future__ import annotations

import re

import numpy as np


def read_pfm(filename: str) -> np.ndarray:
    """Reads a PFM file into an ``[H, W]`` or ``[H, W, 3]`` float32 array."""
    with open(filename, "rb") as handle:
        header = handle.readline().decode("utf-8").rstrip()
        if header == "PF":
            color = True
        elif header == "Pf":
            color = False
        else:
            raise ValueError(f"Not a PFM file: {filename}")
        dimensions = handle.readline().decode("utf-8")
        match = re.match(r"^(\d+)\s(\d+)\s*$", dimensions)
        if not match:
            raise ValueError(f"Malformed PFM header in {filename}")
        width, height = map(int, match.groups())
        scale = float(handle.readline().decode("utf-8").rstrip())
        endianness = "<" if scale < 0 else ">"
        data = np.fromfile(handle, endianness + "f")
    shape = (height, width, 3) if color else (height, width)
    # PFM stores rows bottom-up.
    return np.ascontiguousarray(np.flipud(data.reshape(shape))).astype(
        np.float32)


def write_pfm(filename: str, image: np.ndarray) -> None:
    """Writes an ``[H, W]`` or ``[H, W, 3]`` float array as a little-endian
    PFM."""
    image = np.asarray(image, dtype=np.float32)
    if image.ndim == 3 and image.shape[2] == 3:
        header = b"PF\n"
    elif image.ndim == 2:
        header = b"Pf\n"
    else:
        raise ValueError("PFM supports [H, W] or [H, W, 3] arrays only.")
    height, width = image.shape[:2]
    with open(filename, "wb") as handle:
        handle.write(header)
        handle.write(f"{width} {height}\n".encode("utf-8"))
        handle.write(b"-1.0\n")
        np.flipud(image).astype("<f").tofile(handle)
