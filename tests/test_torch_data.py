"""PyTorch port, data pipeline (``data/``) against the JAX package's, on
the ``tests/fixtures.py`` trees: PFM files either package writes read equal
in both; FlyingThings3D discovery, statistics, artifact list, the three
splits and the benchmark protocols; KITTI splits, the reflective merge and
the benchmark sets; the transforms (RandomCrop per seed, epoch and index);
the Loader's batches per seed, epoch and host shard; statistics caches
written by one package and read by the other. Records, selections and
arrays are compared exactly."""

import os
import random
import shutil

import numpy as np
import pytest
import torch

from practicaldeepstereo_nips2018_tpu.data import (
    dataset as jax_dataset, flyingthings3d as jax_flyingthings3d,
    kitti as jax_kitti, loader as jax_loader, pfm as jax_pfm,
    transforms as jax_transforms)
from practicaldeepstereo_nips2018_tpu_torch.data import (
    dataset, flyingthings3d, kitti, loader, pfm, transforms)
from tests import fixtures


def _relative(value, root):
    """Records with paths relative to ``root`` and arrays as lists."""
    if isinstance(value, dict):
        return {key: _relative(item, root) for key, item in value.items()}
    if isinstance(value, list):
        return [_relative(item, root) for item in value]
    if isinstance(value, str):
        return os.path.relpath(value, root)
    if isinstance(value, np.ndarray):
        return value.tolist()
    return value


def _records(data, root):
    return [_relative(data.example_files(index), root)
            for index in range(len(data))]


def _assert_examples_equal(port_example, jax_example):
    for side in ("left", "right"):
        assert set(port_example[side]) == set(jax_example[side])
        for key, value in jax_example[side].items():
            if value is None:
                assert port_example[side][key] is None
            else:
                assert port_example[side][key].dtype == value.dtype
                np.testing.assert_array_equal(port_example[side][key], value)


def _assert_datasets_equal(port_data, jax_data, port_root, jax_root):
    assert _records(port_data, port_root) == _records(jax_data, jax_root)
    for index in range(len(jax_data)):
        _assert_examples_equal(port_data[index], jax_data[index])


@pytest.fixture(scope="module")
def flyingthings(tmp_path_factory):
    """Two identical trees: statistics computed by each package on its
    own (the JAX one by its Python path, as the port computes them)."""
    port_root = fixtures.make_flyingthings3d_tree(
        str(tmp_path_factory.mktemp("port") / "ft3d"))
    jax_root = fixtures.make_flyingthings3d_tree(
        str(tmp_path_factory.mktemp("jax") / "ft3d"))
    jax_flyingthings3d.find_examples(jax_root, use_native_scanner=False)
    return port_root, jax_root


@pytest.fixture(scope="module")
def kitti_trees(tmp_path_factory):
    return (fixtures.make_kitti_tree(str(tmp_path_factory.mktemp("port"))),
            fixtures.make_kitti_tree(str(tmp_path_factory.mktemp("jax"))))


@pytest.mark.parametrize("color", [False, True])
def test_pfm_files_read_equal_in_both_packages(tmp_path, color):
    shape = (7, 5, 3) if color else (7, 5)
    image = np.random.RandomState(0).uniform(-5, 300, shape).astype(
        np.float32)
    image[0, 0] = np.inf
    port_file, jax_file = str(tmp_path / "port.pfm"), str(tmp_path /
                                                          "jax.pfm")
    pfm.write_pfm(port_file, image)
    jax_pfm.write_pfm(jax_file, image)
    with open(port_file, "rb") as a, open(jax_file, "rb") as b:
        assert a.read() == b.read()
    for path in (port_file, jax_file):
        np.testing.assert_array_equal(pfm.read_pfm(path), image)
        np.testing.assert_array_equal(jax_pfm.read_pfm(path), image)
    # Big-endian (positive scale), rows bottom-up.
    big = str(tmp_path / "big.pfm")
    with open(big, "wb") as handle:
        handle.write((b"PF\n" if color else b"Pf\n") + b"5 7\n1.0\n")
        np.flipud(image).astype(">f").tofile(handle)
    np.testing.assert_array_equal(pfm.read_pfm(big), image)
    np.testing.assert_array_equal(pfm.read_pfm(big), jax_pfm.read_pfm(big))


def test_find_examples_and_statistics(flyingthings):
    port_root, jax_root = flyingthings
    port = flyingthings3d.find_examples(port_root)
    expected = jax_flyingthings3d.find_examples(jax_root,
                                                use_native_scanner=False)
    assert len(port) == 4
    assert _relative(port, port_root) == _relative(expected, jax_root)
    assert flyingthings3d.ARTIFACT_FRAMES == jax_flyingthings3d.ARTIFACT_FRAMES
    frames = [f"/d/frames_cleanpass/{scene}/left/{frame:04d}.png"
              for scene in list(flyingthings3d.ARTIFACT_FRAMES) + [
                  "TRAIN/A/0000", "TEST/A/0011"]
              for frame in range(6, 16)]
    flags = [flyingthings3d._is_example_with_artifacts(path)
             for path in frames]
    assert flags == [jax_flyingthings3d._is_example_with_artifacts(path)
                     for path in frames]
    assert sum(flags) == 74


@pytest.mark.parametrize("validation, maximum_disparity",
                         [(0, 63), (1, 255), (0, 255)])
def test_training_split(flyingthings, validation, maximum_disparity):
    port_root, jax_root = flyingthings
    port = flyingthings3d.FlyingThings3D.training_split(
        port_root, number_of_validation_examples=validation,
        maximum_disparity=maximum_disparity)
    expected = jax_flyingthings3d.FlyingThings3D.training_split(
        jax_root, number_of_validation_examples=validation,
        maximum_disparity=maximum_disparity)
    for port_data, jax_data in zip(port, expected):
        _assert_datasets_equal(port_data, jax_data, port_root, jax_root)
    assert len(port[0]) + len(port[1]) == (1 if maximum_disparity == 63
                                           else 2)


def test_small_training_split(flyingthings):
    port_root, jax_root = flyingthings
    port = flyingthings3d.FlyingThings3D.small_training_split(
        port_root, maximum_disparity=255, number_of_validation_examples=1,
        number_of_training_examples=1, height=16, width=24)
    expected = jax_flyingthings3d.FlyingThings3D.small_training_split(
        jax_root, maximum_disparity=255, number_of_validation_examples=1,
        number_of_training_examples=1, height=16, width=24)
    for port_data, jax_data in zip(port, expected):
        _assert_datasets_equal(port_data, jax_data, port_root, jax_root)
        assert port_data[0]["left"]["image"].shape == (16, 24, 3)


@pytest.mark.parametrize("is_psm_protocol", [True, False])
def test_benchmark_protocols(flyingthings, is_psm_protocol):
    port_root, jax_root = flyingthings
    port = flyingthings3d.FlyingThings3D.benchmark_dataset(
        port_root, is_psm_protocol)
    expected = jax_flyingthings3d.FlyingThings3D.benchmark_dataset(
        jax_root, is_psm_protocol)
    assert len(port) == (2 if is_psm_protocol else 1)
    _assert_datasets_equal(port, expected, port_root, jax_root)


def test_statistics_caches_are_shared(tmp_path):
    """A cache written by either package is read, not recomputed, by the
    other: a value planted in it shows up in the records."""
    for writer, reader in ((flyingthings3d, jax_flyingthings3d),
                           (jax_flyingthings3d, flyingthings3d)):
        root = fixtures.make_flyingthings3d_tree(str(tmp_path / "tree"))
        cache = str(tmp_path / "cache")
        kwargs = ({"use_native_scanner": False}
                  if writer is jax_flyingthings3d else {})
        written = writer.find_examples(root, cache, **kwargs)
        assert len(os.listdir(cache)) == 4
        statistic_file = flyingthings3d._statistic_filename(
            written[0]["left"]["disparity_image"], cache)
        assert statistic_file == jax_flyingthings3d._statistic_filename(
            written[0]["left"]["disparity_image"], cache)
        with np.load(statistic_file) as content:
            planted = dict(content)
        planted["maximum_disparity"] = np.asarray(12345)
        np.savez(statistic_file, **planted)
        kwargs = ({"use_native_scanner": False}
                  if reader is jax_flyingthings3d else {})
        read = reader.find_examples(root, cache, **kwargs)
        assert read[0]["maximum_disparity"] == 12345
        assert _relative(read[1:], root) == _relative(written[1:], root)
        shutil.rmtree(tmp_path / "tree")
        shutil.rmtree(cache)


def test_kitti_training_split_and_reflective_merge(kitti_trees):
    port_root, jax_root = kitti_trees
    port = kitti.Kitti.training_split(port_root,
                                      number_of_validation_examples=1)
    expected = jax_kitti.Kitti.training_split(
        jax_root, number_of_validation_examples=1)
    assert [len(part) for part in port] == [3, 1]
    for port_data, jax_data in zip(port, expected):
        _assert_datasets_equal(port_data, jax_data, port_root, jax_root)
    # The reflective map of 2012 example 0 replaced rows 8-11.
    merged = [port_data for port_data in port
              for index in range(len(port_data))
              if port_data.example_files(index)["left"]["image"].endswith(
                  os.path.join("colored_0", "000000_10.png"))]
    assert merged
    data = merged[0]
    index = [i for i in range(len(data)) if data.example_files(i)["left"][
        "image"].endswith(os.path.join("colored_0", "000000_10.png"))][0]
    assert (data[index]["left"]["disparity_image"][8:12] == 77).all()
    assert np.isinf(data[index]["left"]["disparity_image"][:4]).all()


@pytest.mark.parametrize("year", ["2012", "2015"])
def test_kitti_benchmark_sets(kitti_trees, year):
    port_root, jax_root = kitti_trees
    port = getattr(kitti.Kitti, f"kitti{year}_benchmark")(port_root)
    expected = getattr(jax_kitti.Kitti, f"kitti{year}_benchmark")(jax_root)
    assert len(port) == 2
    _assert_datasets_equal(port, expected, port_root, jax_root)
    assert port[0]["left"]["disparity_image"] is None


def test_kitti_sub_pixel_toggle_is_per_instance(kitti_trees):
    """The JAX package toggles sub-pixel ground truth on the class; the
    port on each dataset, and ``split_in_two`` keeps it in both halves,
    leaving other datasets alone."""
    port_root, jax_root = kitti_trees
    sub_pixel = kitti.Kitti.training_split(
        port_root, number_of_validation_examples=1,
        use_sub_pixel_ground_truth=True)
    whole_pixel = kitti.Kitti.training_split(
        port_root, number_of_validation_examples=1)
    assert all(part.use_sub_pixel_ground_truth for part in sub_pixel)
    assert not any(part.use_sub_pixel_ground_truth for part in whole_pixel)
    jax_whole = jax_kitti.Kitti.training_split(
        jax_root, number_of_validation_examples=1)
    jax_kitti.Kitti.use_sub_pixel_ground_truth = True
    try:
        jax_sub = jax_kitti.Kitti.training_split(
            jax_root, number_of_validation_examples=1)
        sub_examples = [part[0] for part in jax_sub]
    finally:
        jax_kitti.Kitti.use_sub_pixel_ground_truth = False
    whole_examples = [part[0] for part in jax_whole]
    for port_part, expected in zip(sub_pixel, sub_examples):
        _assert_examples_equal(port_part[0], expected)
    for port_part, expected in zip(whole_pixel, whole_examples):
        _assert_examples_equal(port_part[0], expected)
    assert not np.array_equal(sub_pixel[0][0]["left"]["disparity_image"],
                              whole_pixel[0][0]["left"]["disparity_image"])


def _example(seed, height=12, width=17):
    rng = np.random.RandomState(seed)
    disparity = rng.uniform(-5, 300, (height, width)).astype(np.float32)
    return {"left": {"image": rng.uniform(0, 255, (height, width, 3)).astype(
        np.float32), "disparity_image": disparity},
        "right": {"image": rng.uniform(0, 255, (height, width, 3)).astype(
            np.float32)}}


@pytest.mark.parametrize("name, arguments", [
    ("CentralCrop", (5, 9)), ("PadToSize", (15, 20)),
    ("MaskLargeDisparities", (192,))])
def test_transforms(name, arguments):
    port = getattr(transforms, name)(*arguments)(_example(0))
    expected = getattr(jax_transforms, name)(*arguments)(_example(0))
    _assert_examples_equal(port, expected)


def test_random_crop_positions_per_seed_epoch_and_index():
    for seed in (0, 3):
        port = transforms.RandomCrop(5, 7, seed=seed)
        expected = jax_transforms.RandomCrop(5, 7, seed=seed)
        for epoch in (0, 1, 4):
            port.set_epoch(epoch)
            expected.set_epoch(epoch)
            for index in range(6):
                _assert_examples_equal(port(_example(index), index),
                                       expected(_example(index), index))
    with pytest.raises(ValueError, match="exceeds"):
        transforms.PadToSize(4, 4)(_example(0))


def test_subsample_with_a_seed_keeps_the_jax_subset():
    records = [{"left": {"image": f"{index}.png"}} for index in range(20)]
    port = dataset.Dataset(records)
    expected = jax_dataset.Dataset(records)
    port.subsample(7, random_seed=5)
    expected.subsample(7, random_seed=5)
    assert [port.example_files(i) for i in range(7)] == [
        expected.example_files(i) for i in range(7)]


class _ArrayDataset:
    """Examples made from (index, epoch), with path records; one instance
    feeds both packages' loaders."""

    def __init__(self, size=7):
        self._size = size
        self._epoch = 0

    def __len__(self):
        return self._size

    def set_epoch(self, epoch):
        self._epoch = epoch

    def example_files(self, index):
        return {"left": {"image": f"/data/{index:06d}_10.png"}}

    def __getitem__(self, index):
        example = _example(1000 * self._epoch + index, 4, 6)
        if index == 3:
            example["left"]["disparity_image"] = None
        return example


@pytest.mark.parametrize("batch_size, shuffle, drop_last, hosts, equal", [
    (1, False, False, 1, False), (2, True, False, 1, False),
    (2, True, True, 1, False), (1, True, False, 2, False),
    (2, True, True, 3, True)])
def test_loader_batches_per_seed_epoch_and_shard(batch_size, shuffle,
                                                 drop_last, hosts, equal):
    source = _ArrayDataset()
    for seed in (0, 2):
        for host in range(hosts):
            kwargs = dict(batch_size=batch_size, shuffle=shuffle,
                          num_workers=2, drop_last=drop_last, seed=seed,
                          host_index=host, host_count=hosts,
                          equal_shards=equal)
            port = loader.Loader(source, **kwargs)
            expected = jax_loader.Loader(source, **kwargs)
            assert len(port) == len(expected)
            for epoch in (0, 1, 5):
                port.set_epoch(epoch)
                expected.set_epoch(epoch)
                assert port.epoch_indices() == expected._epoch_indices()
                got, want = list(port), list(expected)
                assert len(got) == len(want) == len(port)
                for a, b in zip(got, want):
                    assert a.get("names") == b.get("names")
                    assert set(a["left"]) == set(b["left"])
                    for side in ("left", "right"):
                        for key, value in b[side].items():
                            np.testing.assert_array_equal(a[side][key],
                                                          value)


def test_batch_to_device_on_the_cpu():
    batch = next(iter(loader.Loader(_ArrayDataset(), batch_size=2)))
    moved = loader.batch_to_device(batch, "cpu")
    assert moved["names"] == batch["names"]
    for side in ("left", "right"):
        for key, value in batch[side].items():
            assert isinstance(moved[side][key], torch.Tensor)
            assert moved[side][key].device.type == "cpu"
            np.testing.assert_array_equal(moved[side][key].numpy(), value)


def test_selection_shuffles_match_the_global_random_module():
    """``random.Random(0).shuffle`` is the permutation of ``random.seed(0);
    random.shuffle``, which the JAX package runs."""
    items = list(range(50))
    expected = list(items)
    state = random.getstate()
    try:
        random.seed(0)
        random.shuffle(expected)
    finally:
        random.setstate(state)
    random.Random(0).shuffle(items)
    assert items == expected
