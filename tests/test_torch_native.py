"""PyTorch port, the native PFM reader and statistics scanner
(``data/native.py`` over ``csrc/pfm_stats.cpp``) against the JAX package's
(``data/native.py`` over ``native/pfm_stats.cpp``) and against the port's
own Python statistics, on the same files: the scan equal to JAX's bit for
bit, within 1e-3 of Python's; the reader equal to ``data/pfm.py``'s;
unreadable files reported; ``find_examples`` equal to JAX's with either
package's scanner, and the two Python paths equal; the library built under
``build/native/`` and nowhere else, a failed build raising."""

import os
import pathlib

import numpy as np
import pytest

from practicaldeepstereo_nips2018_tpu.data import (
    flyingthings3d as jax_flyingthings3d, native as jax_native)
from practicaldeepstereo_nips2018_tpu_torch.data import (
    flyingthings3d, native, pfm)
from tests import fixtures

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _disparity_files(folder: pathlib.Path) -> list[str]:
    """Gray PFMs: uniform, with negative values, beyond 511, with inf and
    NaN, integral values on the bin edges, one tall and narrow."""
    rng = np.random.RandomState(1)
    images = [rng.uniform(0, 200, (31, 29)),
              rng.uniform(-20, 180, (31, 29)),
              rng.uniform(0, 600, (17, 40)),
              np.where(rng.uniform(size=(9, 11)) < 0.2, np.inf,
                       rng.uniform(0, 300, (9, 11))),
              np.where(rng.uniform(size=(9, 11)) < 0.1, np.nan,
                       rng.uniform(0, 100, (9, 11))),
              rng.randint(0, 513, (12, 12)).astype(np.float64),
              rng.uniform(0, 50, (64, 3))]
    paths = []
    for index, image in enumerate(images):
        path = str(folder / f"{index}.pfm")
        pfm.write_pfm(path, image.astype(np.float32))
        paths.append(path)
    return paths


def test_scan_equals_jax_native_scan_bit_for_bit(tmp_path):
    assert jax_native.available()
    paths = _disparity_files(tmp_path)
    got = native.scan_disparity_statistics(paths, threads=3)
    expected = jax_native.scan_disparity_statistics(paths, threads=2)
    assert [array.dtype for array in got] == [np.float32] * 3 + [np.int32]
    for a, b in zip(got, expected):
        np.testing.assert_array_equal(a, b)
    assert np.all(got[3] == 0)


def test_scan_statistics_match_the_python_ones(tmp_path):
    """Minimum and maximum equal, the cumulative distribution within 1e-3
    (float32 against float64), for every image with finite values."""
    paths = _disparity_files(tmp_path)
    minimums, maximums, cumulatives, status = (
        native.scan_disparity_statistics(paths))
    for index, path in enumerate(paths):
        if not np.isfinite(pfm.read_pfm(path)).all():
            continue  # Python's statistics fail on it (int of inf or NaN)
        expected = flyingthings3d.compute_disparity_statistic(path)
        assert int(minimums[index]) == expected["minimum_disparity"]
        assert int(maximums[index]) == expected["maximum_disparity"]
        np.testing.assert_allclose(cumulatives[index],
                                   expected["cumulative_distribution"],
                                   rtol=0, atol=1e-3)


@pytest.mark.parametrize("color", [False, True])
def test_read_pfm_equals_the_python_reader(tmp_path, color):
    shape = (17, 23, 3) if color else (17, 23)
    image = np.random.RandomState(0).uniform(-5, 400, shape).astype(
        np.float32)
    image[0, 0] = np.inf
    path = str(tmp_path / "image.pfm")
    pfm.write_pfm(path, image)
    got = native.read_pfm(path)
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_array_equal(got, pfm.read_pfm(path))
    np.testing.assert_array_equal(got, jax_native.read_pfm(path))
    # Big-endian (positive scale).
    big = str(tmp_path / "big.pfm")
    with open(big, "wb") as handle:
        handle.write((b"PF\n" if color else b"Pf\n") + b"23 17\n1.0\n")
        np.flipud(image).astype(">f").tofile(handle)
    np.testing.assert_array_equal(native.read_pfm(big), image)


def test_unreadable_files_get_status_minus_one(tmp_path):
    good = str(tmp_path / "good.pfm")
    pfm.write_pfm(good, np.ones((4, 4), np.float32))
    garbage = tmp_path / "garbage.pfm"
    garbage.write_bytes(b"P6\n4 4\n255\n" + bytes(48))
    truncated = tmp_path / "truncated.pfm"
    truncated.write_bytes(b"Pf\n4 4\n-1.0\n" + bytes(12))
    paths = [good, str(tmp_path / "missing.pfm"), str(garbage),
             str(truncated)]
    status = native.scan_disparity_statistics(paths)[3]
    np.testing.assert_array_equal(status, [0, -1, -1, -1])
    np.testing.assert_array_equal(
        status, jax_native.scan_disparity_statistics(paths)[3])
    with pytest.raises(ValueError, match="native PFM read failed"):
        native.read_pfm(str(garbage))


@pytest.mark.parametrize("jax_scanner", [True, False])
def test_find_examples_equals_jax(tmp_path, jax_scanner):
    """The port's ``find_examples`` (its scanner by default) against JAX's
    with its scanner (the same arithmetic: equal records) or its Python
    path (the same minima and maxima, distributions within 1e-3); the
    caches it writes in JAX's format (float64 distribution)."""
    port_root = fixtures.make_flyingthings3d_tree(str(tmp_path / "port"))
    jax_root = fixtures.make_flyingthings3d_tree(str(tmp_path / "jax"))
    got = flyingthings3d.find_examples(port_root)
    expected = jax_flyingthings3d.find_examples(
        jax_root, use_native_scanner=jax_scanner)
    assert len(got) == len(expected) == 4
    for port_example, jax_example in zip(got, expected):
        assert (os.path.relpath(port_example["left"]["image"], port_root)
                == os.path.relpath(jax_example["left"]["image"], jax_root))
        for key in ("minimum_disparity", "maximum_disparity"):
            assert port_example[key] == jax_example[key]
        key = "cumulative_distribution_from_0_to_511"
        assert port_example[key].dtype == np.float64
        if jax_scanner:
            np.testing.assert_array_equal(port_example[key], jax_example[key])
        else:
            np.testing.assert_allclose(port_example[key], jax_example[key],
                                       rtol=0, atol=1e-3)
    cache = flyingthings3d._statistic_filename(
        got[0]["left"]["disparity_image"], None)
    with np.load(cache) as content:
        assert content["cumulative_distribution"].dtype == np.float64
        assert content["minimum_disparity"].dtype == np.int64


def test_python_path_equals_jax_python_path(tmp_path):
    port_root = fixtures.make_flyingthings3d_tree(str(tmp_path / "port"))
    jax_root = fixtures.make_flyingthings3d_tree(str(tmp_path / "jax"))
    got = flyingthings3d.find_examples(port_root, use_native_scanner=False)
    expected = jax_flyingthings3d.find_examples(jax_root,
                                                use_native_scanner=False)
    for port_example, jax_example in zip(got, expected):
        for key in ("minimum_disparity", "maximum_disparity",
                    "cumulative_distribution_from_0_to_511"):
            np.testing.assert_array_equal(port_example[key],
                                          jax_example[key])


def test_find_examples_scans_the_missing_caches_in_one_call(tmp_path,
                                                            monkeypatch):
    """One threaded scan of the files without a cache; a file the scanner
    cannot read goes through the Python path."""
    root = fixtures.make_flyingthings3d_tree(str(tmp_path / "tree"))
    calls = []
    scan = native.scan_disparity_statistics

    def counted(paths, threads=None):
        calls.append(list(paths))
        minimums, maximums, cumulatives, status = scan(paths, threads)
        status[0] = -1  # as if unreadable: left to Python
        return minimums, maximums, cumulatives, status

    monkeypatch.setattr(native, "scan_disparity_statistics", counted)
    first = flyingthings3d.find_examples(root)
    assert len(calls) == 1 and len(calls[0]) == 4
    python = flyingthings3d.compute_disparity_statistic(calls[0][0])
    assert first[0]["minimum_disparity"] == python["minimum_disparity"]
    np.testing.assert_array_equal(
        first[0]["cumulative_distribution_from_0_to_511"],
        python["cumulative_distribution"])
    flyingthings3d.find_examples(root)
    assert len(calls) == 1  # every cache there: nothing scanned


def test_library_is_built_under_build_only():
    path = native.build()
    assert path.parent == ROOT / "build" / "native"
    assert path.name.startswith("libpds_pfm_stats-") and path.is_file()
    assert path == native.library_path()
    assert not list((ROOT / "native").glob("libpds_pfm_stats-*"))


@pytest.mark.parametrize("compiler", ["false", "no-such-compiler-on-path"])
def test_failed_build_raises(tmp_path, monkeypatch, compiler):
    """No quiet fallback to numpy: a compiler that fails, or none, raises
    with what went wrong."""
    monkeypatch.setattr(native, "BUILD_DIRECTORY", tmp_path / "build")
    monkeypatch.setattr(native, "COMPILER", compiler)
    with pytest.raises(RuntimeError, match="native PFM library build "
                                           "failed"):
        native.scan_disparity_statistics([str(tmp_path / "any.pfm")])
    root = fixtures.make_flyingthings3d_tree(str(tmp_path / "tree"))
    with pytest.raises(RuntimeError, match="build failed"):
        flyingthings3d.find_examples(root)
    assert len(flyingthings3d.find_examples(
        root, use_native_scanner=False)) == 4
    assert not list((tmp_path / "build").glob("*.so"))
