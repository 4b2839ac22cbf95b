"""PyTorch port, data parallelism over processes (``parallel/``, the
trainer under a mesh, the CLIs under ``torchrun``'s variables) on the CPU:
two gloo processes per group, NARROW widths, 40x120 images, D=63.

Each group runs this file as ``python -m tests.test_torch_parallel
<scenario> <output> ...`` with ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT`` set, as ``torchrun`` sets them; its
processes import no JAX (JAX is imported inside the tests only), and the
group is killed after :data:`GROUP_TIMEOUT_S`, so that a hung collective
fails one test instead of the suite. The scenarios:

* ``step``: one float64 data-parallel step, one example per process, the
  examples with 6 and 300 unknown pixels. Held against JAX float64
  ``value_and_grad`` of the loss on the batch of 2: the pooled loss (the
  mean over the valid pixels of both examples), not the mean of the two
  per-process means, which the test shows to differ; the replicas equal
  bit for bit after RMSprop. Also ``all_hosts_sum`` and the idempotent
  ``initialize_distributed`` in a group.
* ``trainer``: test metrics over shards of 2 + 1 examples (valid
  fractions 1.0, 0.6, 0.25) identical on both processes and equal to the
  sequential ones; ``PDSTrainer.train()`` for one epoch and resumed for a
  second, process 1 starting from other weights: parameters equal on both
  after construction and after each epoch, and process 0 alone writes the
  log, plot, dumps and checkpoints (each process has its own experiment
  folder, so a write by process 1 shows); submission PNGs named
  ``host{process}_...``; unequal batch counts raise on both processes.
* ``cli``: ``cli.train_flyingthings3d`` with ``--device cpu --mesh_data
  2`` on a ``tests/fixtures.py`` tree: disjoint shards, one log, equal
  losses and weights; ``--mesh_data 3`` refused, and ``--mesh_volume 2``
  on its 64-column padded images; without ``--mesh_data`` the run is
  data-parallel over the group all the same (the processes do not train
  apart). The volume axis itself: ``tests/test_torch_volume.py``.
"""

import hashlib
import json
import os
import sys

import numpy as np
import pytest
import torch

from practicaldeepstereo_nips2018_tpu_torch import models
from practicaldeepstereo_nips2018_tpu_torch.data import Loader
from practicaldeepstereo_nips2018_tpu_torch.parallel import (
    make_mesh, runtime)
from practicaldeepstereo_nips2018_tpu_torch.training import (
    checkpoint, optimizer, trainer, weights)
from tests.torch_process_group import Group

torch.set_num_threads(1)

GROUP_TIMEOUT_S = 120
HEIGHT, WIDTH = 40, 120
NARROW = dict(maximum_disparity=63, number_of_embedding_features=16,
              number_of_matching_features=16,
              number_of_embedding_residual_blocks=1,
              number_of_matching_residual_blocks=1)
LEARNING_RATE = 1e-2
UNKNOWN_PIXELS = (6, 300)  # per example of the float64 step
VALID_FRACTIONS = (1.0, 0.6, 0.25)  # the test metrics' examples


# -- what the processes of a group run -------------------------------------


def _network(params, config) -> models.PdsNetwork:
    network = models.PdsNetwork(config)
    network.load_state_dict(weights.state_dict_from_jax_params(params))
    return network


def _leaves(network, value) -> list:
    return [np.asarray(leaf) for leaf in checkpoint.tree_leaves(
        weights.jax_tree_of_parameters(network, value))]


def step_batch():
    """Two examples, the first with 6 unknown pixels, the second with
    300 (a band of rows)."""
    rng = np.random.RandomState(0)
    left = rng.uniform(0, 255, (2, HEIGHT, WIDTH, 3)).astype(np.float32)
    right = rng.uniform(0, 255, (2, HEIGHT, WIDTH, 3)).astype(np.float32)
    ground_truth = rng.uniform(0, 60, (2, HEIGHT, WIDTH)).astype(np.float32)
    ground_truth[0, 0, :UNKNOWN_PIXELS[0]] = np.inf
    ground_truth[1].reshape(-1)[:UNKNOWN_PIXELS[1]] = np.inf
    return left, right, ground_truth


def _examples(count: int, seed: int, valid_fractions=None,
              ground_truth: bool = True) -> list[dict]:
    """In-memory examples for a ``Loader``; the ground truth scaled per
    example and, with ``valid_fractions``, that share of it known."""
    rng = np.random.RandomState(seed)
    examples = []
    for index in range(count):
        example = {
            "left": {"image": rng.uniform(0, 255, (HEIGHT, WIDTH, 3)).astype(
                np.float32)},
            "right": {"image": rng.uniform(0, 255, (HEIGHT, WIDTH, 3))
                      .astype(np.float32)}}
        disparity = (rng.rand(HEIGHT, WIDTH) * 20.0 * (index + 1)).astype(
            np.float32)
        if valid_fractions is not None:
            disparity[rng.rand(HEIGHT, WIDTH) > valid_fractions[index]] = (
                np.inf)
        if ground_truth:
            example["left"]["disparity_image"] = disparity
        examples.append(example)
    return examples


def _test_metrics(rank, count, folder, mesh):
    config = models.PDSConfig(**NARROW)
    network = _network(weights.random_jax_params(config, seed=5), config)
    loader = Loader(_examples(3, 7, VALID_FRACTIONS), num_workers=1,
                    host_index=rank, host_count=count)
    return trainer.PDSTrainer(config, network, test_set_loader=loader,
                              experiment_folder=folder, device="cpu",
                              mesh=mesh).test()


def _rank_step(output: str) -> None:
    topology = runtime.initialize_distributed(device="cpu")
    again = runtime.initialize_distributed(device="cpu")
    rank = topology["process_index"]
    config = models.PDSConfig(**NARROW)
    network = _network(weights.random_jax_params(config, seed=5),
                       config).double()
    rmsprop = optimizer.rmsprop(network.parameters(), LEARNING_RATE)
    left, right, ground_truth = step_batch()
    shard = slice(rank, rank + 1)
    value = trainer.train_step(
        network, rmsprop, left[shard], right[shard], ground_truth[shard],
        LEARNING_RATE, config, torch.float64, device="cpu")
    sums = runtime.all_hosts_sum([rank + 1.5, 2.0 ** -30, 10.0 * rank])
    with open(output, "wb") as handle:
        np.savez(handle, loss=float(value), topology=json.dumps(topology),
                 again=json.dumps(again), sums=np.asarray(sums),
                 backend=torch.distributed.get_backend(),
                 **{f"gradient_{index}": leaf for index, leaf in enumerate(
                     _leaves(network, lambda _, parameter: parameter.grad))},
                 **{f"parameter_{index}": leaf for index, leaf in enumerate(
                     _leaves(network, lambda _, parameter: parameter))})


def _rank_trainer(output: str, root: str) -> None:
    rank = runtime.initialize_distributed(device="cpu")["process_index"]
    mesh = make_mesh(data=2)
    result = {"metrics": _test_metrics(rank, 2, os.path.join(
        root, f"metrics_{rank}"), mesh)}
    folder = os.path.join(root, f"experiment_{rank}")
    config = models.PDSConfig(**NARROW)
    parameters = {}

    def run(end_epoch, seed, checkpoint_file=None):
        # Process 1 starts from other weights: the trainer must replace
        # them by process 0's.
        network = _network(weights.random_jax_params(config, seed + rank),
                           config)
        run_trainer = trainer.PDSTrainer(
            config, network,
            training_set_loader=Loader(
                _examples(4, 3), shuffle=True, num_workers=1,
                host_index=rank, host_count=2, equal_shards=True),
            test_set_loader=Loader(_examples(3, 7, VALID_FRACTIONS),
                                   num_workers=1, host_index=rank,
                                   host_count=2),
            experiment_folder=folder, initial_learning_rate=1e-3,
            end_epoch=end_epoch, device="cpu", mesh=mesh)
        parameters[f"start_{end_epoch}"] = _leaves(
            network, lambda _, parameter: parameter)
        if checkpoint_file:
            run_trainer.load_checkpoint(checkpoint_file)
        run_trainer.train()
        parameters[f"epoch_{end_epoch}"] = _leaves(
            network, lambda _, parameter: parameter)
        return run_trainer

    first = run(1, 5)
    second = run(2, 11, os.path.join(root, "experiment_0",
                                     "001_checkpoint.npz"))
    result["losses"] = [first.training_losses, second.training_losses]
    trainer.PDSTrainer(
        config, _network(weights.random_jax_params(config, 5), config),
        test_set_loader=Loader(_examples(3, 9, ground_truth=False),
                               num_workers=1, host_index=rank, host_count=2),
        experiment_folder=folder, device="cpu", mesh=mesh).test()
    try:
        trainer.PDSTrainer(
            config, _network(weights.random_jax_params(config, 5), config),
            training_set_loader=Loader(_examples(3, 3), num_workers=1,
                                       host_index=rank, host_count=2),
            experiment_folder=os.path.join(root, f"unequal_{rank}"),
            device="cpu", mesh=mesh).train()
        result["unequal"] = None
    except ValueError as error:
        result["unequal"] = str(error)
    with open(output, "wb") as handle:
        np.savez(handle, result=json.dumps(result), **{
            f"{name}_{index}": leaf for name, leaves in parameters.items()
            for index, leaf in enumerate(leaves)})


def _rank_cli(output: str, dataset: str, experiment: str) -> None:
    from practicaldeepstereo_nips2018_tpu_torch.cli import (
        train_flyingthings3d)
    arguments = ["--dataset_folder", dataset, "--experiment_folder",
                 experiment, "--maximum_disparity", "255",
                 "--number_of_validation_examples", "0", "--end_epoch", "1",
                 "--learning_rate", "1e-3", "--num_workers", "1",
                 "--device", "cpu"]
    refused = {}
    for flags in (["--mesh_data", "3"], ["--mesh_volume", "2"]):
        try:
            train_flyingthings3d.main(arguments + flags)
        except ValueError as error:
            refused[" ".join(flags)] = str(error)
    runs = {}
    for name, flags in (("mesh_data_2", ["--mesh_data", "2"]),
                        ("no_mesh_data", [])):
        run = train_flyingthings3d.main(
            arguments + flags + ["--experiment_folder",
                                 os.path.join(experiment, name)])
        loader = run._training_set_loader
        loader.set_epoch(0)
        runs[name] = {
            "shard": [loader._dataset.example_files(index)["left"]["image"]
                      for index in loader.epoch_indices()],
            "losses": run.training_losses,
            "weights": hashlib.sha256(b"".join(
                parameter.detach().numpy().tobytes()
                for parameter in run.network.parameters())).hexdigest()}
    with open(output, "w") as handle:
        json.dump({"topology": runtime.topology(), "refused": refused,
                   "runs": runs}, handle)


SCENARIOS = {"step": _rank_step, "trainer": _rank_trainer, "cli": _rank_cli}


# -- the tests --------------------------------------------------------------


def _run_group(folder, scenario: str, *arguments: str) -> list[str]:
    """Runs ``scenario`` in 2 processes joined over gloo; returns each
    one's output file. Kills the group after ``GROUP_TIMEOUT_S``."""
    return Group(folder, "tests.test_torch_parallel", scenario, 2,
                 GROUP_TIMEOUT_S, *arguments).wait()


@pytest.fixture(scope="module")
def step(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    from practicaldeepstereo_nips2018_tpu import models as jax_models
    from practicaldeepstereo_nips2018_tpu import ops as jax_ops

    outputs = _run_group(tmp_path_factory.mktemp("step"), "step")
    ranks = [dict(np.load(output)) for output in outputs]
    config = models.PDSConfig(**NARROW)
    params = weights.random_jax_params(config, seed=5)
    jax_config = jax_models.PDSConfig(**NARROW)

    def loss_and_gradients(batch):
        left, right, ground_truth = (jnp.asarray(array, jnp.float64)
                                     for array in batch)

        def loss_fn(p):
            return jax_ops.subpixel_cross_entropy(
                jax_models.apply(p, left, right, jax_config), ground_truth,
                disparity_step=jax_config.disparity_step)

        value, gradients = jax.jit(jax.value_and_grad(loss_fn))(
            jax.tree.map(lambda leaf: jnp.asarray(leaf, jnp.float64),
                         params))
        return float(value), [np.asarray(leaf, np.float64)
                              for leaf in jax.tree.leaves(gradients)]

    batch = step_batch()
    with jax.enable_x64(True):
        pooled = loss_and_gradients(batch)
        per_example = [loss_and_gradients(tuple(
            array[index:index + 1] for array in batch))[0]
            for index in range(2)]
    return {"ranks": ranks, "pooled": pooled, "per_example": per_example,
            "params": params, "config": config, "batch": batch}


def _worst_relative_error(got, exact):
    """max over tensors of max |got - exact| / max |exact|, leaving out
    tensors whose exact gradient is below 1e-6 of the largest (zero in
    exact arithmetic; ``tests/test_torch_train_step.py``)."""
    floor = 1e-6 * max(np.abs(leaf).max() for leaf in exact)
    assert [leaf.shape for leaf in got] == [leaf.shape for leaf in exact]
    return max(np.abs(a - b).max() / np.abs(b).max()
               for a, b in zip(got, exact) if np.abs(b).max() >= floor)


def _arrays(rank: dict, prefix: str) -> list:
    return [rank[f"{prefix}_{index}"] for index in range(sum(
        1 for key in rank if key.startswith(prefix + "_")))]


def test_two_process_step_is_jax_batch_of_two_in_float64(step):
    """Loss within 1e-12 relative of JAX's batch-2 loss, each gradient
    within 1e-6 of its tensor's largest element, on both processes."""
    loss, gradients = step["pooled"]
    for rank in step["ranks"]:
        assert abs(float(rank["loss"]) - loss) <= 1e-12 * loss
        assert _worst_relative_error(_arrays(rank, "gradient"),
                                     gradients) <= 1e-6
    assert str(step["ranks"][0]["backend"]) == "gloo"


def test_mean_of_process_means_is_not_the_pooled_loss(step):
    """The examples' valid-pixel counts differ, so an average of the two
    processes' own means misses the pooled loss by far more than the
    tolerance above: the test tells the two apart."""
    loss = step["pooled"][0]
    mean_of_means = float(np.mean(step["per_example"]))
    assert abs(mean_of_means - loss) > 1e-6 * loss
    assert abs(float(step["ranks"][0]["loss"]) - mean_of_means) > (
        1e-6 * loss)


def test_replicas_equal_bit_for_bit_after_rmsprop(step):
    first, second = (_arrays(rank, "parameter") for rank in step["ranks"])
    assert len(first) == len(second) > 0
    for a, b in zip(first, second):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(_arrays(step["ranks"][0], "gradient"),
                    _arrays(step["ranks"][1], "gradient")):
        np.testing.assert_array_equal(a, b)


def test_one_process_batch_of_two_step_is_jax_too(step):
    """The port's step on the whole batch in one process (no group: every
    collective is the identity) agrees with JAX as the two processes do,
    and its update with theirs."""
    network = _network(step["params"], step["config"]).double()
    rmsprop = optimizer.rmsprop(network.parameters(), LEARNING_RATE)
    value = trainer.train_step(network, rmsprop, *step["batch"],
                               LEARNING_RATE, step["config"], torch.float64,
                               device="cpu")
    loss, gradients = step["pooled"]
    assert abs(float(value) - loss) <= 1e-12 * loss
    assert _worst_relative_error(
        _leaves(network, lambda _, parameter: parameter.grad),
        gradients) <= 1e-6
    for got, replica in zip(
            _leaves(network, lambda _, parameter: parameter),
            _arrays(step["ranks"][0], "parameter")):
        np.testing.assert_allclose(got, replica, rtol=0, atol=1e-10)


def test_all_hosts_sum_and_topology_in_a_group(step):
    """Across 2 processes ``all_hosts_sum`` sums in float32 (2^-30 + 2^-30
    is exact), the same on both; ``initialize_distributed`` a second time
    returns the same topology."""
    for rank in step["ranks"]:
        np.testing.assert_array_equal(rank["sums"], [4.0, 2.0 ** -29,
                                                     10.0])
        assert json.loads(str(rank["again"])) == json.loads(
            str(rank["topology"]))
    assert [json.loads(str(rank["topology"])) for rank in step["ranks"]] == [
        {"process_index": index, "process_count": 2, "local_device_count": 1,
         "global_device_count": 2} for index in range(2)]


def test_all_hosts_sum_is_the_identity_in_one_process():
    values = [1.0 + 2.0 ** -40, 3.0, 0.0]
    assert runtime.all_hosts_sum(values) == values
    assert runtime.process_count() == 1


def test_initialize_distributed_without_a_group(monkeypatch):
    """Without cluster variables: one process, no group, the same answer
    twice. With ``WORLD_SIZE``/``RANK`` but no ``MASTER_ADDR``: a
    RuntimeWarning naming them, and one process. Bad explicit arguments
    raise."""
    for name in runtime.CLUSTER_VARIABLES:
        monkeypatch.delenv(name, raising=False)
    alone = {"process_index": 0, "process_count": 1, "local_device_count": 1,
             "global_device_count": 1}
    assert runtime.initialize_distributed(device="cpu") == alone
    assert runtime.initialize_distributed(device="cpu") == alone
    assert not torch.distributed.is_initialized()
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    with pytest.warns(RuntimeWarning, match="'RANK', 'WORLD_SIZE'"):
        assert runtime.initialize_distributed(device="cpu") == alone
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="rank 2 is not in a world of 2"):
        runtime.initialize_distributed(rank=2, world_size=2, device="cpu")
    with pytest.raises(RuntimeError, match="bogus"):
        runtime.initialize_distributed(rank=0, world_size=1,
                                       init_method="bogus://", device="cpu")
    assert not torch.distributed.is_initialized()


def test_make_mesh_checks_the_world_size():
    """Every mesh must span the world of 1 here; ``volume=2`` in a world
    of 2 is ``tests/test_torch_volume.py``'s."""
    assert make_mesh().shape == {"data": 1, "volume": 1}
    with pytest.raises(ValueError, match="world size is 1"):
        make_mesh(data=2)
    with pytest.raises(ValueError, match="world size is 1"):
        make_mesh(volume=2)


@pytest.fixture(scope="module")
def trainer_group(tmp_path_factory):
    root = tmp_path_factory.mktemp("trainer")
    outputs = _run_group(root, "trainer", str(root))
    ranks = []
    for output in outputs:
        with np.load(output) as content:
            arrays = dict(content)
        ranks.append({"result": json.loads(str(arrays.pop("result"))),
                      "arrays": arrays})
    return root, ranks


def test_test_metrics_over_unequal_shards(trainer_group, tmp_path):
    """2 + 1 examples with valid fractions 1.0, 0.6, 0.25: the metrics are
    the same on both processes and equal the sequential ones (per-example
    sums and counts reduced, not pooled pixels)."""
    _, ranks = trainer_group
    first, second = (rank["result"]["metrics"] for rank in ranks)
    assert first == second
    errors, seconds = first
    sequential, _ = _test_metrics(0, 1, str(tmp_path), None)
    assert set(errors) == {"three_pixels_error", "mean_absolute_error"}
    for key, value in sequential.items():
        assert abs(errors[key] - value) <= 1e-6 * abs(value), (key, errors,
                                                               sequential)
    assert seconds > 0


def test_replicas_start_and_stay_equal(trainer_group):
    """Process 1 built its network from other weights: the trainer
    replaced them by process 0's at construction (and after the resume's
    load), and the replicas are equal bit for bit after each epoch."""
    _, ranks = trainer_group
    for name in ("start_1", "epoch_1", "start_2", "epoch_2"):
        first, second = (_arrays(rank["arrays"], name) for rank in ranks)
        assert len(first) == len(second) > 0
        for a, b in zip(first, second):
            np.testing.assert_array_equal(a, b)
    assert ranks[0]["result"]["losses"] == ranks[1]["result"]["losses"]
    assert len(ranks[0]["result"]["losses"][1]) == 2


def test_process_zero_alone_writes(trainer_group):
    """One "Training started." per run in process 0's log, one checkpoint
    per epoch, the plot and the dumps; process 1 wrote only its submission
    PNGs."""
    root, _ = trainer_group
    first = root / "experiment_0"
    log = (first / "log.txt").read_text()
    assert log.count("Training started.") == 2
    assert log.count("training loss = ") == 2
    for name in ("001_checkpoint.npz", "002_checkpoint.npz", "plot.png",
                 "example_0001_image.png",
                 "example_0001_disparity_epoch_002.png"):
        assert (first / name).is_file(), name
    second = root / "experiment_1"
    written = sorted(str(path.relative_to(second))
                     for path in second.rglob("*") if path.is_file())
    assert written == ["submission/host1_000000_10.png"]
    assert not (root / "metrics_1").exists()


def test_submission_names_carry_the_process(trainer_group):
    root, _ = trainer_group
    assert sorted(os.listdir(root / "experiment_0" / "submission")) == [
        "host0_000000_10.png", "host0_000001_10.png"]


def test_unequal_batch_counts_raise_on_every_process(trainer_group):
    _, ranks = trainer_group
    for rank in ranks:
        assert "equal_shards" in rank["result"]["unequal"]
        assert "[2, 1]" in rank["result"]["unequal"]


@pytest.fixture(scope="module")
def cli_group(tmp_path_factory):
    from tests import fixtures
    root = tmp_path_factory.mktemp("cli")
    dataset = fixtures.make_flyingthings3d_tree(str(root / "dataset"))
    experiment = root / "experiment"
    outputs = _run_group(root, "cli", dataset, str(experiment))
    results = []
    for output in outputs:
        with open(output) as handle:
            results.append(json.load(handle))
    return experiment, results


@pytest.mark.parametrize("run", ["mesh_data_2", "no_mesh_data"])
def test_training_cli_over_two_processes(cli_group, run):
    """At world 2 on the CPU, with ``--mesh_data 2`` and without
    ``--mesh_data``: the two shards are disjoint and cover the training
    set, one log, equal losses and weights bit for bit (without the flag
    too: the processes do not train apart on their shards)."""
    experiment, results = cli_group
    runs = [result["runs"][run] for result in results]
    shards = [set(result["shard"]) for result in runs]
    assert all(len(shard) == 1 for shard in shards)
    assert shards[0].isdisjoint(shards[1])
    assert {os.path.basename(os.path.dirname(os.path.dirname(path)))
            for shard in shards for path in shard} == {"0000", "0749"}
    assert runs[0]["losses"] == runs[1]["losses"]
    assert runs[0]["weights"] == runs[1]["weights"]
    assert [result["topology"]["process_index"] for result in results] == [
        0, 1]
    log = (experiment / run / "log.txt").read_text()
    assert log.count("Training started.") == 1
    assert log.count("PNG decoder: ") == 1
    assert (experiment / run / "001_checkpoint.npz").is_file()


def test_training_cli_refuses_other_meshes(cli_group):
    """A ``--mesh_data`` other than the world size is refused on both
    processes, and ``--mesh_volume 2`` on images whose padded width holds
    one 64-column block."""
    _, results = cli_group
    for result in results:
        assert "world size is 2" in result["refused"]["--mesh_data 3"]
        assert "but it is 64 wide" in result["refused"]["--mesh_volume 2"]


if __name__ == "__main__":
    SCENARIOS[sys.argv[1]](*sys.argv[2:])
    if "jax" in sys.modules:
        raise SystemExit("a process of the group imported JAX")
