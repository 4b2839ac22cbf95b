"""PyTorch port, the command-line entry points (``cli/``) on the CPU at
fixture size (``tests/fixtures.py`` trees, D=63): training then
benchmarking as ``python -m`` subprocesses; the KITTI fine-tune, the
submission export, the statistics precompute and the reference-checkpoint
import in-process through ``main(argv)``; the import's weights equal, leaf
for leaf, to the JAX package's ``torch_import.load_torch_checkpoint``;
meshes that do not span the world refused, and ``--remat`` and
``--matching_tail_int8`` passed to ``PDSConfig``."""

import importlib
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from practicaldeepstereo_nips2018_tpu import models as jax_models
from practicaldeepstereo_nips2018_tpu.training import (
    PDSTrainer as JaxPDSTrainer, torch_import)
from practicaldeepstereo_nips2018_tpu_torch import models
from practicaldeepstereo_nips2018_tpu_torch.cli import (
    common, export_kitti_submission, finetune_kitti, import_torch_checkpoint,
    precompute_disparity_statistics)
from practicaldeepstereo_nips2018_tpu_torch.data import png
from practicaldeepstereo_nips2018_tpu_torch.training import (
    checkpoint, weights)
from tests import fixtures

torch.set_num_threads(1)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = "practicaldeepstereo_nips2018_tpu_torch.cli"


def _run(module: str, arguments: list[str]) -> str:
    result = subprocess.run(
        [sys.executable, "-m", f"{PACKAGE}.{module}"] + arguments,
        capture_output=True, text=True, timeout=600, cwd=REPO_ROOT)
    assert result.returncode == 0, (result.stdout, result.stderr)
    return result.stdout


def test_train_then_benchmark_as_subprocesses(tmp_path):
    dataset = fixtures.make_flyingthings3d_tree(str(tmp_path / "dataset"))
    experiment = str(tmp_path / "experiment")
    _run("train_flyingthings3d", [
        "--dataset_folder", dataset, "--experiment_folder", experiment,
        "--maximum_disparity", "63", "--number_of_validation_examples", "0",
        "--end_epoch", "1", "--learning_rate", "1e-3", "--num_workers", "1",
        "--device", "cpu"])
    assert os.path.isfile(os.path.join(experiment, "001_checkpoint.npz"))
    with open(os.path.join(experiment, "log.txt")) as handle:
        assert "epoch 01 (01) : training loss = " in handle.read()
    stdout = _run("benchmark_flyingthings3d", [
        "--dataset_folder", dataset,
        "--experiment_folder", str(tmp_path / "benchmark"),
        "--checkpoint_file", os.path.join(experiment, "001_checkpoint.npz"),
        "--is_psm_protocol", "--maximum_disparity", "63",
        "--num_workers", "1", "--device", "cpu"])
    assert stdout.startswith("MAE = ") and "3PE = " in stdout, stdout


def test_kitti_finetune_and_submission_in_process(tmp_path):
    dataset = fixtures.make_kitti_tree(str(tmp_path / "kitti"))
    experiment = str(tmp_path / "finetune")
    trainer = finetune_kitti.main([
        "--dataset_folder", dataset, "--experiment_folder", experiment,
        "--maximum_disparity", "63", "--number_of_validation_examples", "1",
        "--end_epoch", "1", "--pad_height", "40", "--pad_width", "56",
        "--num_workers", "1", "--device", "cpu"])
    assert len(trainer.training_losses) == 1
    assert np.isfinite(trainer.training_losses[0])
    finetuned = os.path.join(experiment, "001_checkpoint.npz")
    assert os.path.isfile(finetuned)
    seconds = export_kitti_submission.main([
        "--dataset_folder", dataset,
        "--experiment_folder", str(tmp_path / "export"),
        "--checkpoint_file", finetuned, "--maximum_disparity", "63",
        "--num_workers", "1", "--device", "cpu"])
    assert seconds > 0
    folder = tmp_path / "export" / "submission"
    assert sorted(os.listdir(folder)) == ["000000_10.png", "000001_10.png"]
    decoded = png.read_png(str(folder / "000000_10.png"), "unchanged")
    assert decoded.dtype == np.uint16
    assert decoded.shape == (fixtures.HEIGHT, fixtures.WIDTH)


def test_precompute_disparity_statistics_in_process(tmp_path, capsys):
    dataset = fixtures.make_flyingthings3d_tree(str(tmp_path / "dataset"))
    assert precompute_disparity_statistics.main(
        ["--dataset_folder", dataset]) == 4
    assert capsys.readouterr().out.startswith("scanned 4 examples in ")
    caches = [name for folder, _, names in os.walk(
        os.path.join(dataset, "disparity")) for name in names
        if name.endswith(".npz")]
    assert len(caches) == 4


@pytest.mark.parametrize("bare", [False, True])
def test_import_torch_checkpoint(tmp_path, bare):
    """A reference-layout ``.bin`` (state_dict under the reference's keys,
    as its trainer saves it, or bare) -> the port's network, equal leaf for
    leaf to the JAX package's import; the ``.npz`` the command writes loads
    network-only in the JAX trainer."""
    config = models.PDSConfig(maximum_disparity=63)
    state = weights.state_dict_from_jax_params(
        weights.random_jax_params(config, 8))
    source = str(tmp_path / "010_checkpoint.bin")
    torch.save(state if bare else {"network": state, "training_losses": [],
                                   "test_errors": []}, source)
    network = weights.load_torch_checkpoint(source)
    expected = torch_import.load_torch_checkpoint(source)
    got = weights.jax_params_from_state_dict(network.state_dict())
    assert jax.tree.structure(got) == jax.tree.structure(expected)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(expected)):
        np.testing.assert_array_equal(a, np.asarray(b))

    output = str(tmp_path / "imported" / "000_checkpoint.npz")
    assert import_torch_checkpoint.main(["--torch_checkpoint", source,
                                         "--output", output]) == output
    reader = JaxPDSTrainer(jax_models.PDSConfig(maximum_disparity=63),
                           weights.random_jax_params(config, 0))
    reader.load_checkpoint(output, load_only_network=True)
    for a, b in zip(jax.tree.leaves(reader.params),
                    jax.tree.leaves(expected)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert checkpoint.load_checkpoint(output, {})[1]["source"] == source


# Items 13a and 13b (the data and volume axes) are ported: a mesh of
# ``--mesh_data`` by ``--mesh_volume`` other than the world size (1 here)
# is refused.
UNPORTED = [
    ("train_flyingthings3d", ["--mesh_data", "2"], "13a"),
    ("train_flyingthings3d", ["--mesh_volume", "2"], "13b"),
    ("train_flyingthings3d", ["--remat", "selective"], 14),
    ("benchmark_flyingthings3d", ["--mesh_data", "2"], "13a"),
    ("benchmark_flyingthings3d", ["--mesh_volume", "4"], "13b"),
    ("benchmark_flyingthings3d", ["--matching_tail_int8"], 14),
    ("finetune_kitti", ["--mesh_data", "2"], "13a"),
    ("finetune_kitti", ["--mesh_volume", "2"], "13b"),
    ("finetune_kitti", ["--remat", "all"], 14),
]
# What the ported flags (item 14) set in the command's PDSConfig.
PASSED_THROUGH = {"--remat": ("remat", {"selective": "selective",
                                        "all": True}),
                  "--matching_tail_int8": ("matching_tail_int8", {})}


@pytest.mark.parametrize("command, flag, item", UNPORTED, ids=[
    f"{command}-{flag[0].lstrip('-')}" for command, flag, _ in UNPORTED])
def test_unported_flags_are_refused(tmp_path, command, flag, item):
    """``--mesh_data`` (ROADMAP Queue 1 item 13a) and ``--mesh_volume``
    (13b) whose mesh does not span the world are refused before anything
    is written; the ``PDSConfig`` opt-ins (item 14) pass through to the
    command's configuration as the JAX scripts map them."""
    arguments = ["--dataset_folder", str(tmp_path), "--experiment_folder",
                 str(tmp_path / "experiment"), "--device", "cpu"] + flag
    if command == "benchmark_flyingthings3d":
        arguments += ["--checkpoint_file", str(tmp_path / "none.npz")]
    module = importlib.import_module(f"{PACKAGE}.{command}")
    if item == 14:
        field, values = PASSED_THROUGH[flag[0]]
        config = common.network_config(module.parse_arguments(arguments))
        assert getattr(config, field) == (values[flag[1]] if len(flag) > 1
                                          else True)
        assert config == models.PDSConfig(
            maximum_disparity=config.maximum_disparity,
            folded_conv_impl="banded_slab", **{field: getattr(config, field)})
        return
    with pytest.raises(ValueError, match="but the world size is 1"):
        module.main(arguments)
    assert not os.path.exists(tmp_path / "experiment")
