"""PyTorch port, run pictures (``utils/visualization.py``) on numpy and the
port's PNG writer: the overlay and points functions return the JAX
package's arrays and raise its errors; the magma table is matplotlib's;
values map to its entries as matplotlib's colormaps map them; the dumps
and the plot are PNGs that decode."""

import matplotlib
import numpy as np
import pytest

from practicaldeepstereo_nips2018_tpu.utils import (
    visualization as jax_visualization)
from practicaldeepstereo_nips2018_tpu_torch.data import png
from practicaldeepstereo_nips2018_tpu_torch.utils import visualization


def test_magma_table_is_matplotlibs():
    expected = matplotlib.colormaps["magma"](np.arange(256), bytes=True)
    np.testing.assert_array_equal(visualization.MAGMA, expected[:, :3])


def test_colorize_maps_like_matplotlib():
    rng = np.random.RandomState(0)
    matrix = rng.uniform(-10, 110, (20, 30))
    matrix[0, :5] = [np.inf, np.nan, -np.inf, 0.0, 100.0]
    colored = visualization.colorize(matrix, 0.0, 100.0)
    inside = np.isfinite(matrix) & (matrix >= 0) & (matrix <= 100)
    expected = matplotlib.colormaps["magma"](
        matplotlib.colors.Normalize(0.0, 100.0)(matrix), bytes=True)[..., :3]
    np.testing.assert_array_equal(colored[inside], expected[inside])
    assert (colored[~inside] == 255).all()
    # A constant range maps everything inside it to the first entry.
    flat = visualization.colorize(np.full((2, 2), 5.0), 5.0, 5.0)
    assert (flat == visualization.MAGMA[0]).all()


def test_overlay_and_points_equal_the_jax_arrays():
    rng = np.random.RandomState(1)
    image = rng.uniform(0, 255, (9, 11, 3)).astype(np.float32)
    error = rng.uniform(size=(9, 11)) < 0.3
    np.testing.assert_array_equal(
        visualization.overlay_image_with_binary_error(image, error),
        jax_visualization.overlay_image_with_binary_error(image, error))
    points = np.array([[0, 0], [8, 10], [4, 5]])
    background = rng.randint(0, 255, (9, 11, 3)).astype(np.uint8)
    np.testing.assert_array_equal(
        visualization.plot_points_on_background(points, background,
                                                (1, 2, 3)),
        jax_visualization.plot_points_on_background(points, background,
                                                    (1, 2, 3)))


@pytest.mark.parametrize("points, background", [
    (np.array([[9, 0]]), np.zeros((9, 11, 3), np.uint8)),
    (np.array([[0, -1]]), np.zeros((9, 11, 3), np.uint8)),
    (np.array([[0, 0]]), np.zeros((9, 11), np.uint8))])
def test_points_raise_as_the_jax_function_does(points, background):
    with pytest.raises(ValueError) as expected:
        jax_visualization.plot_points_on_background(points, background)
    with pytest.raises(ValueError) as got:
        visualization.plot_points_on_background(points, background)
    assert str(got.value) == str(expected.value)


def test_dumps_and_plot_are_pngs(tmp_path):
    image = np.random.RandomState(2).uniform(0, 255, (10, 12, 3))
    path = str(tmp_path / "image.png")
    visualization.save_image(path, image)
    np.testing.assert_array_equal(png.read_png(path, decoder="numpy"),
                                  image.astype(np.uint8))
    matrix = np.linspace(0, 50, 120).reshape(10, 12)
    matrix[0, 0] = np.inf
    for bounds in ((None, None), (0.0, 40.0)):
        visualization.save_matrix(path, matrix, *bounds)
        colored = png.read_png(path, decoder="numpy")
        assert colored.shape == (10, 12, 3)
        assert (colored[0, 0] == 255).all()
    visualization.save_matrix(path, np.full((4, 4), np.inf))
    assert (png.read_png(path, decoder="numpy") == 255).all()

    plot = str(tmp_path / "plot.png")
    visualization.plot_losses_and_errors(plot, [3.0, 2.0, np.nan, 1.5],
                                         [30.0, 60.0, 45.0, 40.0])
    drawn = png.read_png(plot, decoder="numpy")
    assert drawn.shape == (visualization.PLOT_HEIGHT,
                           visualization.PLOT_WIDTH, 3)
    for color in (visualization.BLUE, visualization.RED):
        assert (drawn == color).all(axis=2).sum() > 100
    visualization.plot_losses_and_errors(plot, [2.0], [50.0])


def test_loggers(tmp_path):
    path = str(tmp_path / "log.txt")
    logger = visualization.Logger(path)
    logger.log("one")
    logger.log("two")
    with open(path) as handle:
        assert handle.read() == "one\ntwo\n"
    visualization.NullLogger().log("nothing")
