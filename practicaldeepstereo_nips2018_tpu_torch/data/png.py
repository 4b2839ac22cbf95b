"""PNG reading and writing on numpy and ``zlib``.

The JAX package reads its images with OpenCV; the port runs where OpenCV
may be missing, so it carries its own codec for what the datasets and the
trainer's dumps use:

* reading non-interlaced 8-bit gray, gray + alpha, RGB and RGBA, and 16-bit
  gray, with all five row filters;
* writing 8-bit RGB and 8- or 16-bit gray, with any one of the five
  filters.

:func:`read_png` gives what the JAX package gets from ``cv2.imread``:

* ``"color"`` (``IMREAD_COLOR``): ``[H, W, 3]`` uint8, alpha dropped, gray
  replicated, 16-bit shifted to 8 (``v >> 8``); in RGB order, where the
  JAX package converts OpenCV's BGR itself;
* ``"grayscale"`` (``IMREAD_GRAYSCALE``) of a gray file: ``[H, W]`` uint8,
  16-bit as ``v >> 8``;
* ``"unchanged"`` (``IMREAD_UNCHANGED``): the stored samples, ``[H, W]``
  for gray, else ``[H, W, C]`` in the file's RGB(A) order.

When OpenCV imports, :func:`read_png` uses it by default: it is the JAX
package's decoder and much faster on Paeth-filtered rows, and both give
the same pixels. :func:`default_decoder` says which one is in use.

Rows filtered with None, Sub or Up are undone one row at a time, each row
vectorised. Average and Paeth rows depend on the pixel to their left as
already decoded, so an image with such rows is undone one anti-diagonal at
a time: pixel ``(r, x)`` needs ``(r, x - 1)``, ``(r - 1, x)`` and
``(r - 1, x - 1)``, all on earlier anti-diagonals ``r + x``, and an
anti-diagonal is one vectorised step (``H + W - 1`` steps in all).
"""

from __future__ import annotations

import functools
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# Color type -> samples per pixel (PNG specification, IHDR).
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
MODES = ("color", "grayscale", "unchanged")
DECODERS = ("opencv", "numpy")


@functools.cache
def default_decoder() -> str:
    """The decoder :func:`read_png` uses unless told otherwise:
    ``"opencv"`` when ``cv2`` imports, else ``"numpy"``. Fixed at its first
    call for the life of the process."""
    try:
        import cv2  # noqa: F401
    except ImportError:
        return "numpy"
    return "opencv"


def read_png(filename: str, mode: str = "color",
             decoder: str | None = None) -> np.ndarray:
    """Reads a PNG as ``cv2.imread`` would in ``mode`` (see the module
    docstring), color in RGB order.

    Args:
        filename: the file.
        mode: ``"color"``, ``"grayscale"`` or ``"unchanged"``.
        decoder: ``"opencv"`` or ``"numpy"``; ``None`` takes
            :func:`default_decoder`.
    """
    if mode not in MODES:
        raise ValueError(f'unknown mode "{mode}"; expected one of {MODES}')
    decoder = decoder or default_decoder()
    if decoder == "opencv":
        return _read_with_opencv(filename, mode)
    if decoder != "numpy":
        raise ValueError(f'unknown decoder "{decoder}"; expected one of '
                         f"{DECODERS}")
    with open(filename, "rb") as handle:
        samples = decode(handle.read(), filename)
    if mode == "unchanged":
        return samples[..., 0] if samples.shape[2] == 1 else samples
    if samples.dtype == np.uint16:
        samples = (samples >> 8).astype(np.uint8)
    if mode == "grayscale":
        if samples.shape[2] > 2:
            raise ValueError(
                f"{filename}: grayscale reading of a color PNG is not "
                "supported by the numpy decoder")
        return np.ascontiguousarray(samples[..., 0])
    if samples.shape[2] <= 2:  # gray (+ alpha): replicate the gray
        return np.repeat(samples[..., :1], 3, axis=2)
    return np.ascontiguousarray(samples[..., :3])


def _read_with_opencv(filename: str, mode: str) -> np.ndarray:
    import cv2
    flag = {"color": cv2.IMREAD_COLOR, "grayscale": cv2.IMREAD_GRAYSCALE,
            "unchanged": cv2.IMREAD_UNCHANGED}[mode]
    image = cv2.imread(filename, flag)
    if image is None:
        raise FileNotFoundError(filename)
    if image.ndim == 3:  # BGR(A) -> RGB(A)
        image = np.concatenate([image[..., 2::-1], image[..., 3:]], axis=2)
    return image


def decode(content: bytes, name: str = "<bytes>") -> np.ndarray:
    """PNG file bytes -> ``[H, W, C]`` uint8 or uint16 samples as stored."""
    if content[:8] != _SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    position, header, data = 8, None, []
    while position < len(content):
        length, kind = struct.unpack(">I4s", content[position:position + 8])
        body = content[position + 8:position + 8 + length]
        (crc,) = struct.unpack(">I", content[position + 8 + length:
                                             position + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"{name}: bad CRC in chunk {kind!r}")
        position += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            data.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{name}: no IHDR chunk")
    width, height, depth, color_type, _, _, interlace = header
    if interlace:
        raise ValueError(f"{name}: interlaced PNGs are not supported")
    if color_type not in _CHANNELS or depth not in (8, 16) or (
            depth == 16 and color_type != 0):
        raise ValueError(
            f"{name}: {depth}-bit color type {color_type} is not supported "
            "(8-bit gray, gray + alpha, RGB, RGBA and 16-bit gray are)")
    channels = _CHANNELS[color_type]
    pixel_bytes = channels * depth // 8
    raw = _unfilter(zlib.decompress(b"".join(data)), height, width,
                    pixel_bytes)
    if depth == 8:
        return raw.reshape(height, width, channels)
    pairs = raw.reshape(height, width, channels, 2).astype(np.uint16)
    return (pairs[..., 0] << 8) | pairs[..., 1]


def _unfilter(data: bytes, height: int, width: int,
              pixel_bytes: int) -> np.ndarray:
    """Decompressed image data (a filter byte before each row) ->
    ``[H, W * pixel_bytes]`` uint8 with the row filters undone."""
    stride = width * pixel_bytes
    rows = np.frombuffer(data, np.uint8)
    if rows.size < height * (stride + 1):
        raise ValueError("PNG image data is truncated")
    rows = rows[:height * (stride + 1)].reshape(height, stride + 1)
    types, filtered = rows[:, 0], rows[:, 1:]
    if int(types.max(initial=0)) > 4:
        raise ValueError(f"unknown PNG filter type {int(types.max())}")
    if np.isin(types, (3, 4)).any():
        return _unfilter_by_anti_diagonal(filtered, types, width,
                                          pixel_bytes)
    out = np.empty((height, stride), np.uint8)
    previous = np.zeros(stride, np.uint8)
    for row, (kind, values) in enumerate(zip(types, filtered)):
        if kind == 0:
            out[row] = values
        elif kind == 1:  # Sub: a running sum (mod 256) per byte of a pixel
            out[row] = np.cumsum(values.reshape(width, pixel_bytes), axis=0,
                                 dtype=np.uint8).reshape(-1)
        else:  # Up
            out[row] = values + previous
        previous = out[row]
    return out


def _unfilter_by_anti_diagonal(filtered: np.ndarray, types: np.ndarray,
                               width: int, pixel_bytes: int) -> np.ndarray:
    """Undoes any mix of filters one anti-diagonal ``s = r + x`` at a time.

    ``skewed[s + 2, r + 1]`` holds pixel ``(r, s - r)``; cells of pixels
    outside the image are never written, so they read as the zeros that
    the filters assume beyond the left and top edges. Then the left
    neighbour of the step's pixels is ``skewed[s + 1, r + 1]``, the one
    above ``skewed[s + 1, r]`` and the one above-left ``skewed[s, r]``:
    slices, no gathers."""
    height = filtered.shape[0]
    diagonals = height + width - 1
    row_index = np.arange(height)[:, None]
    diagonal_index = row_index + np.arange(width)[None, :]
    values = np.zeros((diagonals, height, pixel_bytes), np.int16)
    values[diagonal_index, row_index] = filtered.reshape(height, width,
                                                         pixel_bytes)
    skewed = np.zeros((diagonals + 2, height + 1, pixel_bytes), np.int16)
    present = set(np.unique(types).tolist())
    masks = {kind: (types == kind)[:, None] for kind in present}
    # The last kind present is the default; the others are masked in.
    kinds = sorted(present)
    for s in range(diagonals):
        first, last = max(0, s - width + 1), min(height - 1, s) + 1
        left = skewed[s + 1, first + 1:last + 1]
        up = skewed[s + 1, first:last]
        up_left = skewed[s, first:last]
        predictions = {0: 0, 1: left, 2: up}
        if 3 in present:
            predictions[3] = (left + up) >> 1
        if 4 in present:
            predictions[4] = _paeth(left, up, up_left)
        prediction = predictions[kinds[-1]]
        for kind in kinds[:-1]:
            prediction = np.where(masks[kind][first:last], predictions[kind],
                                  prediction)
        skewed[s + 2, first + 1:last + 1] = (values[s, first:last]
                                             + prediction) & 255
    pixels = skewed[diagonal_index + 2, row_index + 1]
    return pixels.astype(np.uint8).reshape(height, width * pixel_bytes)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def write_png(filename: str, image: np.ndarray, filter_type: int = 0
              ) -> None:
    """Writes ``[H, W, 3]`` uint8 (RGB), ``[H, W]`` uint8 or ``[H, W]``
    uint16 as a PNG whose every row uses ``filter_type`` (0 None, 1 Sub,
    2 Up, 3 Average, 4 Paeth)."""
    image = np.asarray(image)
    if image.dtype == np.uint8 and image.ndim == 3 and image.shape[2] == 3:
        depth, color_type = 8, 2
    elif image.dtype == np.uint8 and image.ndim == 2:
        depth, color_type = 8, 0
    elif image.dtype == np.uint16 and image.ndim == 2:
        depth, color_type = 16, 0
    else:
        raise ValueError(f"cannot write a {image.dtype} array of shape "
                         f"{image.shape} (uint8 [H, W, 3], uint8 or uint16 "
                         "[H, W])")
    if filter_type not in range(5):
        raise ValueError(f"unknown PNG filter type {filter_type}")
    height, width = image.shape[:2]
    raw = np.ascontiguousarray(image.astype(image.dtype.newbyteorder(">")))
    raw = raw.view(np.uint8).reshape(height, width, -1).astype(np.int16)
    filtered = (raw - _prediction(raw, filter_type)) & 255
    rows = np.concatenate(
        [np.full((height, 1), filter_type, np.uint8),
         filtered.astype(np.uint8).reshape(height, -1)], axis=1)
    header = struct.pack(">IIBBBBB", width, height, depth, color_type, 0, 0,
                         0)
    with open(filename, "wb") as handle:
        handle.write(_SIGNATURE + _chunk(b"IHDR", header)
                     + _chunk(b"IDAT", zlib.compress(rows.tobytes()))
                     + _chunk(b"IEND", b""))


def _prediction(raw: np.ndarray, filter_type: int) -> np.ndarray:
    """The filter's prediction of every byte from the unfiltered image
    ``[H, W, pixel_bytes]`` (int16): zeros beyond the left and top edge."""
    left = np.zeros_like(raw)
    left[:, 1:] = raw[:, :-1]
    up = np.zeros_like(raw)
    up[1:] = raw[:-1]
    if filter_type == 0:
        return np.zeros_like(raw)
    if filter_type == 1:
        return left
    if filter_type == 2:
        return up
    if filter_type == 3:
        return (left + up) >> 1
    up_left = np.zeros_like(raw)
    up_left[1:, 1:] = raw[:-1, :-1]
    return _paeth(left, up, up_left)


def _paeth(left: np.ndarray, up: np.ndarray, up_left: np.ndarray
           ) -> np.ndarray:
    """The Paeth predictor (int16 inputs): of left, up and up-left, the
    one nearest to ``left + up - up_left``, ties in that order."""
    to_up, to_left = up - up_left, left - up_left
    # |p - left| = |up - up_left|, |p - up| = |left - up_left|.
    distance_left, distance_up = np.abs(to_up), np.abs(to_left)
    distance_up_left = np.abs(to_up + to_left)
    return np.where((distance_left <= distance_up)
                    & (distance_left <= distance_up_left), left,
                    np.where(distance_up <= distance_up_left, up, up_left))
