"""Logs and pictures of a training run: text log, image and disparity dumps,
the per-epoch plot.

Port of ``practicaldeepstereo_nips2018_tpu/utils/visualization.py`` on
numpy and :mod:`~..data.png` alone (the JAX package draws with
matplotlib). The functions and the files they write keep their names; the
pixels are the port's own:

* :class:`Logger` appends lines to a text file; :class:`NullLogger` drops
  them.
* :func:`save_image` writes the ``[H, W, 3]`` image itself.
* :func:`save_matrix` maps ``[H, W]`` values through the 256-entry magma
  table (:data:`MAGMA`, matplotlib's ``magma`` as bytes); inf, NaN and
  values outside the range are white; no colorbar.
* :func:`plot_points_on_background` and
  :func:`overlay_image_with_binary_error` return the same arrays as the
  JAX functions, and raise the same ``ValueError``.
* :func:`plot_losses_and_errors` draws the training loss (blue) and the
  validation error (red) per epoch as polylines, each on its own vertical
  scale.
"""

from __future__ import annotations

import numpy as np

from practicaldeepstereo_nips2018_tpu_torch.data import png

# matplotlib.colormaps["magma"](range(256), bytes=True)[:, :3], row-major
# RGB bytes.
_MAGMA_HEX = (
    "00000300000400000601000701010901010b02020d02020f030311040313040415050417"
    "06051907051b08061d09071f0a07220b08240c09260d0a280e0a2a0f0b2c100c2f110c31"
    "120d33140d35150e38160e3a170f3c180f3f1a10411b10441c10461e10491f114b20114d"
    "2211502311522511552611572811592a115c2b115e2d10602f1062301065321067341068"
    "350f6a370f6c390f6e3b0f6f3c0f713e0f72400f73420f74430f75450f76470f77481078"
    "4a10794b10794d117a4f117b50127b52127c53137c55137d57147d58157e5a157e5b167e"
    "5d177e5e177f60187f61187f63197f651a80661a80681b80691c806b1c806c1d806e1e81"
    "6f1e81711f81731f817420817621817721817922817a22817c23817e24817f2481812581"
    "8225818426818526818727818928818a28818c29808d29808f2a80912a80922b80942b80"
    "952c80972c7f992d7f9a2d7f9c2e7f9e2e7e9f2f7ea12f7ea3307ea4307da6317da7317d"
    "a9327cab337cac337bae347bb0347bb1357ab3357ab53679b63679b83778b93778bb3877"
    "bd3977be3976c03a75c23a75c33b74c53c74c63c73c83d72ca3e72cb3e71cd3f70ce4070"
    "d0416fd1426ed3426dd4436dd6446cd7456bd9466ada4769dc4869dd4968de4a67e04b66"
    "e14c66e24d65e44e64e55063e65162e75262e85461ea5560eb5660ec585fed595fee5b5e"
    "ee5d5def5e5df0605df1615cf2635cf3655cf3675bf4685bf56a5bf56c5bf66e5bf6705b"
    "f7715bf7735cf8755cf8775cf9795cf97b5df97d5dfa7f5efa805efa825ffb8460fb8660"
    "fb8861fb8a62fc8c63fc8e63fc9064fc9265fc9366fd9567fd9768fd9969fd9b6afd9d6b"
    "fd9f6cfda16efda26ffda470fea671fea873feaa74feac75feae76feaf78feb179feb37b"
    "feb57cfeb77dfeb97ffebb80febc82febe83fec085fec286fec488fec689fec78bfec98d"
    "fecb8efdcd90fdcf92fdd193fdd295fdd497fdd698fdd89afdda9cfddc9dfddd9ffddfa1"
    "fde1a3fce3a5fce5a6fce6a8fce8aafceaacfcecaefceeb0fcf0b1fcf1b3fcf3b5fcf5b7"
    "fbf7b9fbf9bbfbfabdfbfcbf"
)
MAGMA = np.frombuffer(bytes.fromhex(_MAGMA_HEX), np.uint8).reshape(256, 3)

BLUE, RED, GRAY = (0, 0, 255), (255, 0, 0), (128, 128, 128)
PLOT_HEIGHT, PLOT_WIDTH, PLOT_MARGIN = 480, 640, 40


class Logger:
    """Appends text lines to a file."""

    def __init__(self, filename: str):
        self._filename = filename

    def log(self, text: str) -> None:
        with open(self._filename, "a") as handle:
            handle.write(text + "\n")


class NullLogger:
    """Drops every line."""

    def log(self, text: str) -> None:
        pass


def save_image(filename: str, image: np.ndarray) -> None:
    """Saves an ``[H, W, 3]`` RGB image (0..255) as a PNG."""
    png.write_png(filename, np.asarray(image).astype(np.uint8))


def colorize(matrix: np.ndarray, minimum_value: float,
             maximum_value: float) -> np.ndarray:
    """``[H, W]`` values -> ``[H, W, 3]`` uint8 through :data:`MAGMA`,
    ``minimum_value`` to entry 0 and ``maximum_value`` to entry 255 (a
    value at fraction f of the range takes entry ``floor(256 f)``, as
    matplotlib's colormaps do); inf, NaN and values outside the range are
    white."""
    matrix = np.asarray(matrix, dtype=np.float64)
    span = float(maximum_value) - float(minimum_value)
    inside = (np.isfinite(matrix) & (matrix >= minimum_value)
              & (matrix <= maximum_value))
    scaled = np.zeros(matrix.shape)
    if span > 0:
        scaled[inside] = (matrix[inside] - minimum_value) / span
    index = np.minimum((scaled * 256).astype(np.int64), 255)
    colored = np.full(matrix.shape + (3,), 255, np.uint8)
    colored[inside] = MAGMA[index[inside]]
    return colored


def save_matrix(filename: str,
                matrix: np.ndarray,
                minimum_value: float | None = None,
                maximum_value: float | None = None) -> None:
    """Saves an ``[H, W]`` matrix (possibly holding inf) as a magma PNG.

    Missing bounds default to the 0.001 and 0.999 quantiles of the finite
    values (0 and 1 when there are none)."""
    matrix = np.asarray(matrix, dtype=np.float64)
    finite = matrix[np.isfinite(matrix)]
    if minimum_value is None:
        minimum_value = np.quantile(finite, 0.001) if finite.size else 0.0
    if maximum_value is None:
        maximum_value = np.quantile(finite, 0.999) if finite.size else 1.0
    png.write_png(filename, colorize(matrix, minimum_value, maximum_value))


def plot_points_on_background(points_coordinates: np.ndarray,
                              background: np.ndarray,
                              points_color=(0, 0, 255)) -> np.ndarray:
    """Returns ``background`` with the given pixels painted
    ``points_color``.

    Args:
        points_coordinates: ``[N, 2]`` array of (y, x) coordinates, each
            inside the background (else ``ValueError``).
        background: ``[H, W, 3]`` byte image (else ``ValueError``).
        points_color: (red, green, blue) byte color.
    """
    background = np.asarray(background)
    if not (background.ndim == 3 and background.shape[2] == 3):
        raise ValueError("background should be (height x width x color).")
    height, width = background.shape[:2]
    with_points = background.copy()
    points_coordinates = np.asarray(points_coordinates).reshape(-1, 2)
    if points_coordinates.size:
        y, x = points_coordinates[:, 0], points_coordinates[:, 1]
        if not (y.min() >= 0 and x.min() >= 0 and y.max() < height
                and x.max() < width):
            raise ValueError(
                'points coordinates are outside of "background" boundaries.')
        with_points[y, x] = np.asarray(points_color, dtype=background.dtype)
    return with_points


def overlay_image_with_binary_error(color_image: np.ndarray,
                                    binary_error: np.ndarray) -> np.ndarray:
    """Returns the ``[H, W, 3]`` image washed out, with error pixels in
    blue.

    Args:
        color_image: ``[H, W, 3]`` byte image.
        binary_error: ``[H, W]`` mask; nonzero marks an error.
    """
    washed_out = np.asarray(color_image).astype(np.uint8) // 2 + 128
    points = np.argwhere(np.asarray(binary_error) != 0)
    return plot_points_on_background(points, washed_out)


def _draw_polyline(canvas: np.ndarray, values, color) -> None:
    """Draws ``values`` (one per epoch) across the plot area, scaled so
    that their finite minimum and maximum touch its bottom and top; a point
    that is not finite breaks the line."""
    values = np.asarray(values, dtype=np.float64)
    inner_width = PLOT_WIDTH - 2 * PLOT_MARGIN
    inner_height = PLOT_HEIGHT - 2 * PLOT_MARGIN
    finite = np.isfinite(values)
    if not finite.any():
        return
    low, high = values[finite].min(), values[finite].max()
    scaled = ((values - low) / (high - low) if high > low
              else np.full(values.shape, 0.5))
    count = len(values)
    x = PLOT_MARGIN + (np.arange(count) * inner_width / (count - 1)
                       if count > 1 else np.full(1, inner_width / 2))
    y = PLOT_HEIGHT - PLOT_MARGIN - scaled * inner_height
    for index in range(count - 1):
        if not (finite[index] and finite[index + 1]):
            continue
        steps = int(max(abs(x[index + 1] - x[index]),
                        abs(y[index + 1] - y[index]))) + 1
        columns = np.rint(np.linspace(x[index], x[index + 1], steps)).astype(
            int)
        rows = np.rint(np.linspace(y[index], y[index + 1], steps)).astype(int)
        for offset in (-1, 0, 1):  # 3 px thick
            canvas[rows + offset, columns] = color
    for column, row in zip(np.rint(x[finite]).astype(int),
                           np.rint(y[finite]).astype(int)):
        canvas[row - 3:row + 4, column - 3:column + 4] = color


def plot_losses_and_errors(filename: str, losses: list, errors: list
                           ) -> None:
    """Per-epoch training loss (blue) and validation error (red), each on
    its own vertical scale, inside a gray frame, as a PNG."""
    canvas = np.full((PLOT_HEIGHT, PLOT_WIDTH, 3), 255, np.uint8)
    top, bottom = PLOT_MARGIN - 8, PLOT_HEIGHT - PLOT_MARGIN + 8
    left, right = PLOT_MARGIN - 8, PLOT_WIDTH - PLOT_MARGIN + 8
    canvas[[top, bottom], left:right + 1] = GRAY
    canvas[top:bottom + 1, [left, right]] = GRAY
    _draw_polyline(canvas, losses, BLUE)
    _draw_polyline(canvas, errors, RED)
    png.write_png(filename, canvas)
