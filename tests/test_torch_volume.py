"""PyTorch port, the ``volume`` mesh axis (``parallel/sharding.py``, the
sliced network under ``mesh=``, the trainer and the CLIs under
``--mesh_volume``) on the CPU, in groups of gloo processes.

Each group runs this file as ``python -m tests.test_torch_volume
<scenario> <output> ...`` with ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT`` set, as ``torchrun`` sets them; its
processes import no JAX, and the group is killed after
:data:`GROUP_TIMEOUT_S`. One module-scoped fixture per group; the tests
read what the group wrote. The scenarios:

* ``pair``: 2 processes, ``volume=2``, 128x512 (512 = 256 + 256 columns),
  D=63, the full widths, float32: the similarities, ``infer``, and the
  loss and gradients of one step under each remat policy, held against
  JAX's unsharded ``models.apply``/``infer``/``value_and_grad`` on the
  same numpy-seeded weights, at ``tests/test_parallel.py``'s tolerances
  (JAX runs in this process while the group runs); each stage's local
  width (``regularization.sharding_probe``); a step at 64x256 in float64
  against the port's unsharded float64 step.
* ``quad``: 4 processes: the halo's values and adjoint at the widths the
  network uses, a multi-neighbour one included, and ``gather_columns``;
  ``volume=4`` at 64x320 (128 + 64 + 64 + 64 columns), D=127, whose
  16-column quarter slices are narrower than the cost volume's halo; the
  options ``factor_tail_conv1`` + ``embedding_s2d`` there; int8 ``infer``
  with and without the scale's MAX all-reduce; ``data=2 x volume=2`` at
  64x256, D=63, batch 2; all in float64 against the port unsharded, which
  the processes compute one reference each.
* ``cli``: 2 processes: ``cli.train_flyingthings3d --mesh_volume 2`` (3
  steps, 1 validation image) on a 64x128 tree, its first loss against a
  direct unsharded ``train_step``; ``cli.benchmark_flyingthings3d`` and
  ``cli.finetune_kitti`` under ``--mesh_volume 2``.

Float64 tolerance of the sliced port against the unsliced one: 1e-9 of
each tensor's largest element (the two differ by summation order only,
~1e-13 measured), leaving out the tensors whose exact gradient is below
1e-6 of the largest (zero in exact arithmetic: the last transposed conv's
bias shifts every similarity of a pixel alike).
"""

import hashlib
import json
import os
import sys

import numpy as np
import pytest
import torch

from practicaldeepstereo_nips2018_tpu_torch import models
from practicaldeepstereo_nips2018_tpu_torch.data import pfm, png
from practicaldeepstereo_nips2018_tpu_torch.models import (
    blocks, regularization)
from practicaldeepstereo_nips2018_tpu_torch.ops import int8, loss, subpixel
from practicaldeepstereo_nips2018_tpu_torch.parallel import (
    make_mesh, runtime, sharding)
from practicaldeepstereo_nips2018_tpu_torch.training import (
    checkpoint, trainer, weights)
from tests.torch_process_group import Group

torch.set_num_threads(1)

GROUP_TIMEOUT_S = 150
SEED = 5
REMAT = {"none": False, "all": True, "selective": "selective"}
STAGES = (["matching_handoff", "smoothing"]
          + [f"contraction{index}" for index in range(1, 5)]
          + [f"expansion{index}" for index in range(1, 5)]
          + ["upsample_to_halfsize", "similarities"])
# Each stage's width over the padded width (the probe's levels).
STAGE_SCALES = dict(zip(STAGES, [4, 4, 8, 16, 32, 64, 32, 16, 8, 4, 2, 1]))
EXACT = 1e-9  # float64, relative to each tensor's largest element
# (halo left, halo right, level width of the volume=4 slices) in the
# quad scenario: the 3x3, 5x5 stride-2, 3x3x3 stride-2 and transposed
# convs' halos, and the cost volume's at D=127 (D' + 4 = 35 columns, over
# slices of 32, 16, 16, 16).
HALOS = [(1, 1, 80), (2, 1, 320), (1, 0, 40), (1, 1, 5), (35, 2, 80)]
CLI_HEIGHT, CLI_WIDTH = 64, 128


# -- what the processes of a group run -------------------------------------


def _network(config, dtype=torch.float32) -> models.PdsNetwork:
    network = models.PdsNetwork(config)
    network.load_state_dict(weights.state_dict_from_jax_params(
        weights.random_jax_params(config, SEED)))
    return network.to(dtype)


def case(batch: int, height: int, width: int, maximum_disparity: int,
         seed: int = 0):
    """Images and ground truth (a band of unknown rows) from a seed."""
    rng = np.random.RandomState(seed)
    left = rng.uniform(0, 255, (batch, height, width, 3)).astype(np.float32)
    right = rng.uniform(0, 255, (batch, height, width, 3)).astype(np.float32)
    ground_truth = rng.uniform(0, 0.8 * maximum_disparity,
                               (batch, height, width)).astype(np.float32)
    ground_truth[:, :3] = np.inf
    return left, right, ground_truth


def _gradients(network) -> list:
    return [parameter.grad.detach().double().numpy().copy()
            for parameter in network.parameters()]


def _sliced_step(config, dtype, mesh, batch):
    """``trainer.loss_and_gradients`` under ``mesh`` on this process's
    example: (loss, gradients summed over the world)."""
    network = _network(config, dtype)
    index = mesh.data_index
    left, right, ground_truth = (array[index:index + 1] for array in batch)
    value = trainer.loss_and_gradients(network, left, right, ground_truth,
                                       config, dtype, device="cpu",
                                       mesh=mesh)
    return float(value), _gradients(network)


def _unsliced_step(config, batch):
    """The port's float64 loss, gradients and first example's similarities
    on the whole batch, in this process alone (no collective)."""
    network = _network(config, torch.float64)
    left, right, ground_truth = batch
    similarities = models.apply(network, left, right, config, torch.float64,
                                "cpu")
    value = loss.subpixel_cross_entropy(
        similarities, torch.as_tensor(ground_truth, dtype=torch.float64),
        disparity_step=config.disparity_step)
    value.backward()
    return (float(value.detach()), _gradients(network),
            similarities[:1].detach().numpy())


def _similarities(config, dtype, batch, mesh=None):
    network = _network(config, dtype)
    with torch.no_grad():
        output = models.apply(network, batch[0][:1], batch[1][:1], config,
                              dtype, "cpu", mesh)
    if mesh is None:
        return output.numpy(), None
    return output[0].numpy(), output[1]


def _rank_pair(output: str) -> None:
    runtime.initialize_distributed(device="cpu")
    rank = runtime.process_index()
    mesh = make_mesh(volume=2)
    result = {"mesh": [mesh.data, mesh.volume, mesh.data_index,
                       mesh.volume_index, list(mesh.volume_ranks)]}
    try:
        make_mesh(data=2, volume=2)
    except ValueError as error:
        result["refused"] = str(error)
    config = models.PDSConfig(maximum_disparity=63)
    batch = case(1, 128, 512, 63)
    arrays = {}
    arrays["similarities"], result["columns"] = _similarities(
        config, torch.float32, batch, mesh)
    arrays["disparity"] = models.infer(
        _network(config), batch[0], batch[1], config, device="cpu",
        mesh=mesh).numpy()
    small = case(2, 64, 256, 63)
    with torch.no_grad():
        result["k2_layout"] = subpixel._pixel_layout(models.apply_padded(
            _network(config), small[0], small[1], config, device="cpu",
            mesh=mesh)) is not None
    widths = {}
    for name, remat in REMAT.items():
        recorded = widths[name] = {}
        regularization.sharding_probe = recorded.__setitem__
        try:
            value, gradients = _sliced_step(
                models.PDSConfig(maximum_disparity=63, remat=remat),
                torch.float32, mesh, batch)
        finally:
            regularization.sharding_probe = None
        result[f"loss_{name}"] = value
        arrays.update({f"gradient_{name}_{index}": gradient
                       for index, gradient in enumerate(gradients)})
    result["widths"] = widths
    # The float64 check, at a quarter of the size.
    batch = case(1, 64, 256, 63, seed=3)
    result["loss_float64"], gradients = _sliced_step(
        config, torch.float64, mesh, batch)
    arrays.update({f"gradient_float64_{index}": gradient
                   for index, gradient in enumerate(gradients)})
    arrays["similarities_float64"], _ = _similarities(
        config, torch.float64, batch, mesh)
    if rank == 0:
        (result["reference_loss"], gradients,
         arrays["reference_similarities"]) = _unsliced_step(config, batch)
        arrays.update({f"reference_{index}": gradient
                       for index, gradient in enumerate(gradients)})
    _save(output, result, arrays)


def _local(columns, width: int) -> torch.Tensor:
    """This process's columns of a ``[2, 3, width]`` tensor that holds its
    global column number + 1 (so that a zero is the image's edge)."""
    scale = columns.bounds[-1] // width
    first, end = (bound // scale for bound in
                  columns.bounds[columns.index:columns.index + 2])
    return torch.arange(first + 1, end + 1, dtype=torch.float64).expand(
        2, 3, -1).clone()


def _halo_checks(columns) -> dict:
    """Each halo of :data:`HALOS`, and its adjoint: the local terms of
    <halo(x), g> and <x, halo^T(g)>, which sum over the group to equal
    values; and the columns of a 40-wide level gathered."""
    rng = np.random.RandomState(runtime.process_index())
    checks = []
    for left, right, width in HALOS:
        x = _local(columns, width).requires_grad_()
        first = int(x[0, 0, 0]) - 1
        haloed = sharding.halo(x, left, right, columns)
        expected = np.arange(first - left + 1,
                             first + x.shape[-1] + right + 1, dtype=float)
        expected[(expected < 1) | (expected > width)] = 0
        g = torch.from_numpy(rng.standard_normal(haloed.shape))
        haloed.backward(g)
        checks.append({
            "halo": [left, right, width], "local": x.shape[-1],
            "value_error": float(np.abs(haloed.detach().numpy()
                                        - expected).max()),
            "forward_term": float((haloed.detach() * g).sum()),
            "adjoint_term": float((x.detach() * x.grad).sum())})
    return {"halos": checks, "gathered": sharding.gather_columns(
        _local(columns, 40)[0], columns).tolist()}


def _rank_quad(output: str) -> None:
    runtime.initialize_distributed(device="cpu")
    rank = runtime.process_index()
    quad = make_mesh(volume=4)
    grid = make_mesh(data=2, volume=2)
    result = {"grid": [grid.data_index, grid.volume_index,
                       list(grid.volume_ranks)]}
    result.update(_halo_checks(sharding.column_slice(quad, 320)))
    arrays = {}
    config = models.PDSConfig(maximum_disparity=127)
    options = models.PDSConfig(maximum_disparity=127, factor_tail_conv1=True,
                               embedding_s2d=True)
    quantized = models.PDSConfig(maximum_disparity=127,
                                 matching_tail_int8=True)
    grid_config = models.PDSConfig(maximum_disparity=63)
    batch = case(1, 64, 320, 127, seed=1)
    grid_batch = case(2, 64, 256, 63, seed=2)
    for name, case_config in (("quad", config), ("options", options)):
        result[f"loss_{name}"], gradients = _sliced_step(
            case_config, torch.float64, quad, batch)
        arrays.update({f"gradient_{name}_{index}": gradient
                       for index, gradient in enumerate(gradients)})
        arrays[f"similarities_{name}"], result[f"columns_{name}"] = (
            _similarities(case_config, torch.float64, batch, quad))
    network = _network(quantized, torch.float64)
    arrays["int8"] = models.infer(network, batch[0], batch[1], quantized,
                                  torch.float64, "cpu", quad).numpy()
    with_max = int8.runtime.all_reduce_max
    int8.runtime.all_reduce_max = lambda tensor, group=None: tensor
    try:
        arrays["int8_slice_scales"] = models.infer(
            network, batch[0], batch[1], quantized, torch.float64, "cpu",
            quad).numpy()
    finally:
        int8.runtime.all_reduce_max = with_max
    result["loss_grid"], gradients = _sliced_step(
        grid_config, torch.float64, grid, grid_batch)
    arrays.update({f"gradient_grid_{index}": gradient
                   for index, gradient in enumerate(gradients)})
    # One unsliced reference per process.
    if rank in (0, 1):
        name, case_config = (("quad", config), ("options", options))[rank]
        (result[f"reference_loss_{name}"], gradients,
         arrays[f"reference_similarities_{name}"]) = _unsliced_step(
            case_config, batch)
        arrays.update({f"reference_{name}_{index}": gradient
                       for index, gradient in enumerate(gradients)})
    elif rank == 2:
        arrays["reference_int8"] = models.infer(
            _network(quantized, torch.float64), batch[0], batch[1],
            quantized, torch.float64, "cpu").numpy()
    else:
        result["reference_loss_grid"], gradients, _ = _unsliced_step(
            grid_config, grid_batch)
        arrays.update({f"reference_grid_{index}": gradient
                       for index, gradient in enumerate(gradients)})
    _save(output, result, arrays)


def write_tree(root: str) -> str:
    """A FlyingThings3D tree at 64x128: 4 TRAIN and 2 TEST examples,
    disparities in [0, 40]."""
    examples = [("TRAIN/A/0000", "0006"), ("TRAIN/A/0001", "0007"),
                ("TRAIN/B/0002", "0006"), ("TRAIN/C/0003", "0010"),
                ("TEST/A/0000", "0006"), ("TEST/B/0001", "0007")]
    for index, (scene, frame) in enumerate(examples):
        rng = np.random.RandomState(40 + index)
        for side in ("left", "right"):
            folder = os.path.join(root, "frames_cleanpass", scene, side)
            os.makedirs(folder, exist_ok=True)
            png.write_png(os.path.join(folder, f"{frame}.png"), rng.randint(
                0, 256, (CLI_HEIGHT, CLI_WIDTH, 3)).astype(np.uint8))
        folder = os.path.join(root, "disparity", scene, "left")
        os.makedirs(folder, exist_ok=True)
        pfm.write_pfm(os.path.join(folder, f"{frame}.pfm"), rng.uniform(
            0, 40, (CLI_HEIGHT, CLI_WIDTH)).astype(np.float32))
    return root


def _rank_cli(output: str, dataset: str, kitti: str, experiment: str
              ) -> None:
    from practicaldeepstereo_nips2018_tpu_torch.cli import (
        benchmark_flyingthings3d, finetune_kitti, train_flyingthings3d)
    common = ["--maximum_disparity", "63", "--num_workers", "1",
              "--device", "cpu", "--mesh_volume", "2"]
    run = train_flyingthings3d.main(
        ["--dataset_folder", dataset, "--experiment_folder",
         os.path.join(experiment, "train"), "--end_epoch", "1",
         "--number_of_validation_examples", "1", "--learning_rate", "1e-3"]
        + common)
    loader = run._training_set_loader
    loader.set_epoch(0)
    result = {
        "topology": runtime.topology(),
        "shard": [loader._dataset.example_files(index)["left"]["image"]
                  for index in loader.epoch_indices()],
        "step_losses": run.step_losses,
        "training_losses": run.training_losses,
        "weights": hashlib.sha256(b"".join(
            parameter.detach().numpy().tobytes()
            for parameter in run.network.parameters())).hexdigest()}
    errors, _ = benchmark_flyingthings3d.main(
        ["--dataset_folder", dataset, "--experiment_folder",
         os.path.join(experiment, "benchmark"), "--checkpoint_file",
         os.path.join(experiment, "train", "001_checkpoint.npz"),
         "--is_psm_protocol"] + common)
    result["benchmark"] = errors
    finetune = finetune_kitti.main(
        ["--dataset_folder", kitti, "--experiment_folder",
         os.path.join(experiment, "kitti"), "--end_epoch", "1",
         "--number_of_validation_examples", "1", "--pad_height", "64",
         "--pad_width", "128"] + common)
    result["kitti_losses"] = finetune.training_losses
    with open(output, "w") as handle:
        json.dump(result, handle)


def _save(output: str, result: dict, arrays: dict) -> None:
    with open(output, "wb") as handle:
        np.savez(handle, result=json.dumps(result), **arrays)


SCENARIOS = {"pair": _rank_pair, "quad": _rank_quad, "cli": _rank_cli}


# -- the tests --------------------------------------------------------------


def _group(folder, scenario: str, size: int, *arguments: str) -> Group:
    return Group(folder, "tests.test_torch_volume", scenario, size,
                 GROUP_TIMEOUT_S, *arguments)


def _load(outputs) -> list[dict]:
    ranks = []
    for output in outputs:
        with np.load(output) as content:
            arrays = dict(content)
        ranks.append({"result": json.loads(str(arrays.pop("result"))),
                      "arrays": arrays})
    return ranks


def _series(arrays: dict, prefix: str) -> list:
    return [arrays[f"{prefix}_{index}"] for index in range(sum(
        1 for key in arrays if key.startswith(prefix + "_")
        and key[len(prefix) + 1:].isdigit()))]


def _worst_relative_error(got, exact) -> float:
    """max over tensors of max |got - exact| / max |exact|, leaving out
    those whose exact value is below 1e-6 of the largest."""
    floor = 1e-6 * max(np.abs(leaf).max() for leaf in exact)
    assert [leaf.shape for leaf in got] == [leaf.shape for leaf in exact]
    return max(np.abs(a - b).max() / np.abs(b).max()
               for a, b in zip(got, exact) if np.abs(b).max() >= floor)


def _stitched(ranks, key: str) -> np.ndarray:
    """The processes' W-slices of ``[B, H, w, D]`` similarities, joined."""
    return np.concatenate([rank["arrays"][key] for rank in ranks], axis=2)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    from practicaldeepstereo_nips2018_tpu import models as jax_models
    from practicaldeepstereo_nips2018_tpu import ops as jax_ops

    group = _group(tmp_path_factory.mktemp("pair"), "pair", 2)
    config = jax_models.PDSConfig(maximum_disparity=63)
    params = jax.tree.map(jnp.asarray, weights.random_jax_params(
        models.PDSConfig(maximum_disparity=63), SEED))
    left, right, ground_truth = case(1, 128, 512, 63)

    def loss_fn(p):
        similarities = jax_models.apply(p, left, right, config)
        return jax_ops.subpixel_cross_entropy(
            similarities, ground_truth, disparity_step=2), similarities

    (value, similarities), gradients = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    disparity = jax.jit(lambda p: jax_models.infer(p, left, right, config))(
        params)
    jax_result = {"loss": float(value),
                  "similarities": np.asarray(similarities),
                  "disparity": np.asarray(disparity),
                  "gradients": [np.asarray(leaf) for leaf in
                                jax.tree.leaves(gradients)]}
    return _load(group.wait()), jax_result


def _port_gradients(arrays: dict, prefix: str) -> list:
    """The port's gradients, in the JAX tree's leaf order."""
    network = _network(models.PDSConfig(maximum_disparity=63),
                       torch.float64)
    for parameter, gradient in zip(network.parameters(),
                                   _series(arrays, prefix)):
        parameter.grad = torch.from_numpy(gradient)
    return [np.asarray(leaf) for leaf in checkpoint.tree_leaves(
        weights.jax_tree_of_parameters(
            network, lambda _, parameter: parameter.grad))]


def test_pair_mesh_and_column_ranges(pair):
    """``make_mesh(volume=2)`` in a world of 2: one data index, the two
    processes its volume group; 512 columns give slices 0..255 and
    256..511; ``data=2 x volume=2`` needs 4 processes."""
    ranks, _ = pair
    for index, rank in enumerate(ranks):
        assert rank["result"]["mesh"] == [1, 2, 0, index, [0, 1]]
        assert "world size is 2" in rank["result"]["refused"]
    assert [rank["result"]["columns"] for rank in ranks] == [[0, 256],
                                                            [256, 512]]


def test_pair_similarities_take_k2s_layout(pair):
    """A batch of 2's sliced similarities are a ``[B, H, w, D]`` view that
    K2 reads without a copy (the transposed convs' outputs stay
    contiguous)."""
    ranks, _ = pair
    assert all(rank["result"]["k2_layout"] for rank in ranks)


def test_pair_forward_matches_jax_unsharded(pair):
    ranks, jax_result = pair
    error = np.abs(_stitched(ranks, "similarities")
                   - jax_result["similarities"]).max()
    assert error <= 1e-3, error


def test_pair_infer_matches_jax_unsharded(pair):
    """Every process returns the whole map; > 99.9 % of its pixels within
    1e-2 px of JAX's (random weights make isolated argmax flips)."""
    ranks, jax_result = pair
    for rank in ranks:
        disparity = rank["arrays"]["disparity"]
        assert disparity.shape == (1, 128, 512)
        np.testing.assert_array_equal(disparity,
                                      ranks[0]["arrays"]["disparity"])
        difference = np.abs(disparity - jax_result["disparity"])
        assert (difference < 1e-2).mean() > 0.999, (difference > 1e-2).mean()


@pytest.mark.parametrize("remat", list(REMAT))
def test_pair_loss_and_gradients_match_jax_unsharded(pair, remat):
    """Loss within 1e-4 and every gradient within 1e-3 of JAX's, on both
    processes, which hold the same loss and gradients bit for bit."""
    ranks, jax_result = pair
    for rank in ranks:
        assert abs(rank["result"][f"loss_{remat}"]
                   - jax_result["loss"]) <= 1e-4
        got = _port_gradients(rank["arrays"], f"gradient_{remat}")
        worst = max(np.abs(a - b).max()
                    for a, b in zip(got, jax_result["gradients"]))
        assert worst < 1e-3, worst
    for first, second in zip(_series(ranks[0]["arrays"], f"gradient_{remat}"),
                             _series(ranks[1]["arrays"], f"gradient_{remat}")):
        np.testing.assert_array_equal(first, second)


@pytest.mark.parametrize("remat", list(REMAT))
def test_every_hourglass_stage_stays_w_sliced(pair, remat):
    """The counterpart of JAX's ``test_folded_volume_stays_w_sharded_at_
    every_level``: every stage holds its slice's width (256 / scale) on
    each process, never the whole width (512 / scale)."""
    ranks, _ = pair
    for rank in ranks:
        widths = rank["result"]["widths"][remat]
        assert sorted(widths) == sorted(STAGES)
        for stage, width in widths.items():
            assert width == 256 // STAGE_SCALES[stage], (stage, width)


def test_pair_float64_matches_port_unsharded(pair):
    ranks, _ = pair
    reference = ranks[0]
    loss_value = reference["result"]["reference_loss"]
    exact = _series(reference["arrays"], "reference")
    for rank in ranks:
        assert abs(rank["result"]["loss_float64"] - loss_value) <= (
            EXACT * loss_value)
        assert _worst_relative_error(
            _series(rank["arrays"], "gradient_float64"), exact) <= EXACT
    similarities = reference["arrays"]["reference_similarities"]
    assert np.abs(_stitched(ranks, "similarities_float64")
                  - similarities).max() <= EXACT * np.abs(similarities).max()


@pytest.fixture(scope="module")
def quad(tmp_path_factory):
    return _load(_group(tmp_path_factory.mktemp("quad"), "quad", 4).wait())


@pytest.mark.parametrize("halo", range(len(HALOS)))
def test_halo_values_and_adjoint(quad, halo):
    """Four slices of 128, 64, 64, 64 full-resolution columns: each halo
    holds its neighbours' columns (two neighbours' for the cost volume's
    35 columns over slices of 16) and zeros past the image; summed over
    the group, <halo(x), g> equals <x, grad> (backward is the adjoint)."""
    checks = [rank["result"]["halos"][halo] for rank in quad]
    assert [check["local"] for check in checks] == [
        2 * HALOS[halo][2] // 5] + [HALOS[halo][2] // 5] * 3
    assert all(check["value_error"] == 0 for check in checks)
    forward = sum(check["forward_term"] for check in checks)
    adjoint = sum(check["adjoint_term"] for check in checks)
    assert abs(forward - adjoint) <= 1e-12 * abs(forward)


def test_gather_columns_rebuilds_the_width(quad):
    """Slices of 16, 8, 8, 8 columns gathered: the whole 40 on every
    process."""
    expected = [float(value) for value in range(1, 41)]
    for rank in quad:
        assert rank["result"]["gathered"] == [expected] * 3


@pytest.mark.parametrize("name", ["quad", "options"])
def test_volume_4_float64_matches_port_unsharded(quad, name):
    """``volume=4`` at 64x320, D=127: quarter slices of 32, 16, 16, 16
    columns against the cost volume's D' + 1 = 32 disparities; the
    default network and (``options``) ``factor_tail_conv1`` with
    ``embedding_s2d``, sliced against unsliced."""
    reference = quad[0 if name == "quad" else 1]
    loss_value = reference["result"][f"reference_loss_{name}"]
    exact = _series(reference["arrays"], f"reference_{name}")
    for rank in quad:
        assert abs(rank["result"][f"loss_{name}"] - loss_value) <= (
            EXACT * loss_value)
        assert _worst_relative_error(
            _series(rank["arrays"], f"gradient_{name}"), exact) <= EXACT
    assert [rank["result"][f"columns_{name}"] for rank in quad] == [
        [0, 128], [128, 192], [192, 256], [256, 320]]
    similarities = reference["arrays"][f"reference_similarities_{name}"]
    assert np.abs(_stitched(quad, f"similarities_{name}")
                  - similarities).max() <= EXACT * np.abs(similarities).max()


def test_int8_infer_takes_the_group_maximum(quad):
    """int8 ``infer`` sliced over 4 equals the unsliced map; with each
    slice's own activation maximum instead of the group's, it differs."""
    reference = quad[2]["arrays"]["reference_int8"]
    for rank in quad:
        assert np.abs(rank["arrays"]["int8"] - reference).max() <= 1e-9
        assert np.abs(rank["arrays"]["int8_slice_scales"]
                      - reference).max() > 1e-3


def test_data_and_volume_axes_float64(quad):
    """``data=2 x volume=2``: processes 0, 1 take example 0 and 2, 3
    example 1, each its half of the columns; the loss and gradients,
    summed over both axes, are the unsharded batch of 2's."""
    assert [rank["result"]["grid"] for rank in quad] == [
        [0, 0, [0, 1]], [0, 1, [0, 1]], [1, 0, [2, 3]], [1, 1, [2, 3]]]
    reference = quad[3]
    loss_value = reference["result"]["reference_loss_grid"]
    exact = _series(reference["arrays"], "reference_grid")
    for rank in quad:
        assert abs(rank["result"]["loss_grid"] - loss_value) <= (
            EXACT * loss_value)
        assert _worst_relative_error(
            _series(rank["arrays"], "gradient_grid"), exact) <= EXACT


def test_column_bounds():
    """Whole 64-column blocks, the first slices one block wider; the
    published 960 columns over 2 and 4; a volume wider than the padded
    width's blocks raises naming the width."""
    assert sharding.column_bounds(960, 2) == (0, 512, 960)
    assert sharding.column_bounds(960, 4) == (0, 256, 512, 768, 960)
    assert sharding.column_bounds(320, 4) == (0, 128, 192, 256, 320)
    assert sharding.column_bounds(128, 1) == (0, 128)
    with pytest.raises(ValueError, match="64 wide"):
        sharding.column_bounds(64, 2)
    with pytest.raises(ValueError, match="not a multiple of 64"):
        sharding.column_bounds(100, 1)
    columns = sharding.ColumnSlice((0, 512, 960), 1, (0, 1))
    assert columns.span(448) == (512, 960, 960)
    assert columns.span(112) == (128, 240, 240)
    assert columns.span(7) == (8, 15, 15)
    with pytest.raises(ValueError, match="no level"):
        columns.level(100)


@pytest.mark.parametrize("conv, expected", [
    ((3, 1, 1), (1, 1)),  # 3x3 and 3x3x3 stride 1
    ((5, 2, 2), (2, 1)),  # the embedding's 5x5 stride 2
    ((3, 2, 1), (1, 0)),  # the hourglass's 3x3x3 stride 2
])
def test_conv_halo(conv, expected):
    assert sharding.conv_halo(*conv) == expected


def test_transposed_conv_halo():
    """4x4x4 (and (3, 4, 4)) stride 2, padding 1: 1 and 1 halo columns, 2
    output columns dropped on each side; a transposed conv that would drop
    unequal numbers raises."""
    assert sharding.transposed_conv_halo(4, 2, 1) == (1, 1, 2)
    with pytest.raises(ValueError, match="drops 0 and 1 columns"):
        sharding.transposed_conv_halo(3, 2, 1)


@pytest.mark.parametrize("conv, transposed", [
    (torch.nn.Conv2d(2, 3, 3, 1, 1), False),
    (torch.nn.Conv2d(2, 3, 5, 2, 2), False),
    (torch.nn.Conv3d(2, 3, 3, 2, 1), False),
    (torch.nn.ConvTranspose3d(2, 3, 4, 2, 1), True),
    (torch.nn.ConvTranspose3d(2, 3, (3, 4, 4), (1, 2, 2), (1, 1, 1)), True),
])
def test_halo_widths_give_the_whole_conv(conv, transposed):
    """Each conv of a slice taken with its halo (the full tensor's
    columns, zeros past the edges) and no padding along W (a transposed
    conv with its padding, its dropped columns cut) gives the slice's
    columns of the conv of the whole tensor, for every slice of 64, 32,
    32 full-resolution columns at its level (here 1/8); a transposed conv
    drops its halo's outputs through its W padding, contiguous."""
    conv = conv.double()
    spatial = conv.weight.ndim - 2
    x = torch.from_numpy(np.random.RandomState(0).standard_normal(
        (1, 2) + (6,) * (spatial - 1) + (16,)))
    whole = conv(x)
    bounds = [0, 8, 12, 16]
    kernel, stride, padding = (conv.kernel_size[-1], conv.stride[-1],
                               conv.padding[-1])
    for first, end in zip(bounds, bounds[1:]):
        if transposed:
            left, right, drop = sharding.transposed_conv_halo(
                kernel, stride, padding)
        else:
            left, right = sharding.conv_halo(kernel, stride, padding)
        padded = torch.nn.functional.pad(x, (left, right))
        haloed = padded[..., first:end + left + right]
        if transposed:
            y = torch.nn.functional.conv_transpose3d(
                haloed, conv.weight, conv.bias, conv.stride,
                conv.padding[:-1] + (padding + drop,))
            assert y.is_contiguous()
            expected = whole[..., stride * first:stride * end]
        else:
            y = torch.nn.functional.conv3d if spatial == 3 else (
                torch.nn.functional.conv2d)
            y = y(haloed, conv.weight, conv.bias, conv.stride,
                  conv.padding[:-1] + (0,))
            expected = whole[..., first // stride:end // stride]
        np.testing.assert_allclose(y.detach().numpy(),
                                   expected.detach().numpy(), atol=1e-12)


def test_halo_plan_across_two_neighbours():
    """Slices of 32, 16, 16, 16 (quarter resolution of 128, 64, 64, 64):
    the last slice's 35-column left halo takes 3 columns of slice 0 and
    all of slices 1 and 2; slice 0 gives 32, 19 and 3 columns to slices
    1, 2 and 3, and its 2 right-halo columns come from slice 1."""
    bounds = (0, 32, 48, 64, 80)
    sends, receives = sharding.halo_plan(bounds, 3, 35, 2)
    assert receives == {0: (0, 3), 1: (3, 19), 2: (19, 35)}
    assert sends == {2: (0, 2)}
    sends, receives = sharding.halo_plan(bounds, 0, 35, 2)
    assert receives == {1: (67, 69)}
    assert sends == {1: (0, 32), 2: (13, 32), 3: (29, 32)}


def test_halo_of_one_process_pads_zeros():
    """A volume group of one process: the halo is zeros on both sides,
    and its backward takes the middle of the gradient."""
    columns = sharding.ColumnSlice((0, 64), 0, (0,))
    x = torch.arange(1.0, 17.0, dtype=torch.float64).expand(2, -1).clone()
    x.requires_grad_()
    haloed = sharding.halo(x, 3, 2, columns)
    np.testing.assert_array_equal(haloed.detach()[0].numpy(), np.concatenate(
        [np.zeros(3), np.arange(1.0, 17.0), np.zeros(2)]))
    g = torch.arange(42.0, dtype=torch.float64).reshape(2, 21)
    haloed.backward(g)
    np.testing.assert_array_equal(x.grad.numpy(), g[:, 3:19].numpy())


def test_moments_of_one_slice_match_var_mean():
    """The sliced moments' Function, forward and backward, against
    ``torch.var_mean`` in float64."""
    x = torch.from_numpy(np.random.RandomState(11).normal(
        3.0, 2.0, (2, 3, 4, 5, 64))).requires_grad_()
    dims = (2, 3, 4)
    mean, variance = sharding.moments(x, dims, sharding.whole(64))
    exact_variance, exact_mean = torch.var_mean(x, dim=dims, correction=0,
                                                keepdim=True)
    rng = np.random.RandomState(12)
    grads = [torch.from_numpy(rng.normal(size=mean.shape)) for _ in range(2)]
    got = torch.autograd.grad([mean, variance], x, grads)[0]
    exact = torch.autograd.grad([exact_mean, exact_variance], x, grads)[0]
    for a, b in ((mean, exact_mean), (variance, exact_variance),
                 (got, exact)):
        torch.testing.assert_close(a, b, atol=1e-12 * float(b.abs().max()),
                                   rtol=0)


def _saved_bytes(function) -> int:
    """Bytes autograd saves for backward in ``function``, each storage
    once."""
    storages = {}

    def pack(tensor):
        storage = tensor.untyped_storage()
        storages[storage.data_ptr()] = storage.nbytes()
        return tensor

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        function()
    return sum(storages.values())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sliced_instance_norm_saves_what_the_unsliced_one_saves(dtype):
    """The sliced norm keeps no full-size tensor more than ``var_mean``
    does for backward (not its deviations from the mean)."""
    x = torch.randn(4, 8, 16, 64).to(dtype).requires_grad_()
    weight, bias = torch.ones(8, requires_grad=True), torch.zeros(8)
    unsliced = _saved_bytes(lambda: blocks.instance_norm(x, weight, bias))
    sliced = _saved_bytes(lambda: blocks.instance_norm(
        x, weight, bias, columns=sharding.whole(64)))
    assert sliced <= unsliced + 1024, (sliced, unsliced)


def test_make_mesh_in_one_process():
    """In a world of 1, ``volume=2`` raises naming the world size; a mesh
    of 1 has no volume group, and the network under it is unsliced."""
    with pytest.raises(ValueError, match="world size is 1"):
        make_mesh(volume=2)
    mesh = make_mesh()
    assert (mesh.data_index, mesh.volume_index, mesh.volume_ranks,
            mesh.volume_group) == (0, 0, (0,), None)


@pytest.fixture(scope="module")
def cli_group(tmp_path_factory):
    from tests import fixtures
    root = tmp_path_factory.mktemp("cli")
    dataset = write_tree(str(root / "dataset"))
    kitti = fixtures.make_kitti_tree(str(root / "kitti"))
    group = _group(root, "cli", 2, dataset, kitti, str(root / "experiment"))
    direct = _direct_first_step(dataset)
    results = []
    for output in group.wait():
        with open(output) as handle:
            results.append(json.load(handle))
    return root / "experiment", results, direct


def _direct_first_step(dataset: str) -> float:
    """The training CLI's first step, unsliced in this process: its first
    batch (the data axis is 1, so the loader of one process) through
    ``trainer.train_step`` from the same first weights."""
    from practicaldeepstereo_nips2018_tpu_torch.cli import common
    from practicaldeepstereo_nips2018_tpu_torch.data import FlyingThings3D
    from practicaldeepstereo_nips2018_tpu_torch.training import optimizer
    training_set, validation_set = FlyingThings3D.training_split(
        dataset, maximum_disparity=63, number_of_validation_examples=1)
    loader, _ = common.build_loaders(training_set, validation_set, 1, 1,
                                     make_mesh())
    loader.set_epoch(0)
    batch = next(iter(loader))
    config = models.PDSConfig(maximum_disparity=63)
    network = common.initial_network(config)
    return float(trainer.train_step(
        network, optimizer.rmsprop(network.parameters(), 1e-3),
        batch["left"]["image"], batch["right"]["image"],
        batch["left"]["disparity_image"], 1e-3, config, device="cpu"))


def test_training_cli_with_mesh_volume_2(cli_group):
    """Both processes train on the same 3 examples, each on its half of
    the columns; equal losses and weights; the first loss within 1e-5
    relative of the unsliced step's; one log, one checkpoint."""
    experiment, results, direct = cli_group
    assert results[0]["shard"] == results[1]["shard"]
    assert len(results[0]["shard"]) == 3
    assert results[0]["step_losses"] == results[1]["step_losses"]
    assert results[0]["training_losses"] == results[1]["training_losses"]
    assert results[0]["weights"] == results[1]["weights"]
    first = results[0]["step_losses"][0]
    assert abs(first - direct) <= 1e-5 * abs(direct), (first, direct)
    log = (experiment / "train" / "log.txt").read_text()
    assert log.count("Training started.") == 1
    assert (experiment / "train" / "001_checkpoint.npz").is_file()


def test_benchmark_and_kitti_clis_with_mesh_volume_2(cli_group):
    """The benchmark CLI evaluates whole images over both processes, the
    same metrics on each; the KITTI fine-tune trains on 64x128 slices of
    its padded images."""
    _, results, _ = cli_group
    first, second = results
    assert first["benchmark"] == second["benchmark"]
    assert set(first["benchmark"]) == {"three_pixels_error",
                                       "mean_absolute_error"}
    assert np.isfinite(list(first["benchmark"].values())).all()
    assert first["kitti_losses"] == second["kitti_losses"]
    assert np.isfinite(first["kitti_losses"]).all()


if __name__ == "__main__":
    SCENARIOS[sys.argv[1]](*sys.argv[2:])
    if "jax" in sys.modules:
        raise SystemExit("a process of the group imported JAX")
