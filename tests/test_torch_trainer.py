"""PyTorch port, the ``PDSTrainer`` epoch loop (``training/trainer.py``) on
the CPU against the JAX package's trainer:

* the reference's end-to-end check on the ``tests/fixtures.py`` tree: two
  epochs, a resume into a third in a fresh trainer, the loss falling,
  checkpoints, ``log.txt`` (the JAX line formats), the plot and the dumps;
* the first epoch's loss on a one-example set against the JAX loss of the
  JAX Loader's batch under the same weights, within 1e-4 relative;
* checkpoints resumed across packages: epoch, losses, errors, weights and
  RMSprop state equal;
* the configuration identity check raising and warning with the JAX
  trainer's messages;
* the loss not read inside the step loop; the untimed warm-up per batch
  shape; dumps of the first ``number_of_examples_to_visualize + 1``
  examples; all-inf ground truth (which the JAX trainer fails on); the
  KITTI submission export; the file names of the JAX trainer.
"""

import os
import time

import numpy as np
import pytest
import torch

import jax

from practicaldeepstereo_nips2018_tpu import models as jax_models
from practicaldeepstereo_nips2018_tpu import ops as jax_ops
from practicaldeepstereo_nips2018_tpu.data import (
    FlyingThings3D as JaxFlyingThings3D, Loader as JaxLoader)
from practicaldeepstereo_nips2018_tpu.training import (
    PDSTrainer as JaxPDSTrainer, checkpoint as jax_checkpoint,
    rmsprop as jax_rmsprop)
from practicaldeepstereo_nips2018_tpu_torch import models
from practicaldeepstereo_nips2018_tpu_torch.data import (
    FlyingThings3D, Kitti, Loader, png)
from practicaldeepstereo_nips2018_tpu_torch.training import (
    checkpoint, weights)
from practicaldeepstereo_nips2018_tpu_torch.training.trainer import (
    PDSTrainer)
from tests import fixtures

torch.set_num_threads(1)

CONFIG = models.PDSConfig(maximum_disparity=63)
NARROW = dict(maximum_disparity=63, number_of_embedding_features=16,
              number_of_matching_features=16,
              number_of_embedding_residual_blocks=1,
              number_of_matching_residual_blocks=1)


def _network(config=CONFIG, seed=0):
    network = models.PdsNetwork(config)
    network.load_state_dict(weights.state_dict_from_jax_params(
        weights.random_jax_params(config, seed)))
    return network


def _batch(seed, batch=1, height=16, width=24, ground_truth=True):
    rng = np.random.RandomState(seed)
    result = {"left": {"image": rng.uniform(0, 255, (batch, height, width,
                                                     3)).astype(np.float32)},
              "right": {"image": rng.uniform(0, 255, (batch, height, width,
                                                      3)).astype(np.float32)}}
    if ground_truth:
        result["left"]["disparity_image"] = rng.uniform(
            0, 30, (batch, height, width)).astype(np.float32)
    return result


class _Batches:
    """A loader over fixed batches."""

    def __init__(self, batches):
        self._batches = batches

    def __len__(self):
        return len(self._batches)

    def __iter__(self):
        return iter(self._batches)


@pytest.fixture(scope="module")
def flyingthings(tmp_path_factory):
    return fixtures.make_flyingthings3d_tree(
        str(tmp_path_factory.mktemp("ft3d")))


def test_file_names_are_the_jax_trainers(tmp_path):
    port = PDSTrainer(CONFIG, _network(models.PDSConfig(**NARROW)),
                      experiment_folder=str(tmp_path), device="cpu")
    expected = JaxPDSTrainer(jax_models.PDSConfig(maximum_disparity=63), {},
                             experiment_folder=str(tmp_path))
    for name in ("_log_filename", "_plot_filename", "_left_image_template",
                 "_estimated_disparity_image_template",
                 "_ground_truth_disparity_image_template",
                 "_3_pixels_error_image_template"):
        assert getattr(port, name) == getattr(expected, name), name


def test_pds_trainer_end_to_end(flyingthings, tmp_path):
    experiment = str(tmp_path / "experiment")
    training_set, _ = FlyingThings3D.training_split(
        flyingthings, number_of_validation_examples=0, maximum_disparity=63)
    assert len(training_set) == 1

    def make_trainer(seed, end_epoch):
        return PDSTrainer(
            CONFIG, _network(seed=seed),
            training_set_loader=Loader(training_set, shuffle=True,
                                       num_workers=1),
            test_set_loader=Loader(training_set, num_workers=1),
            experiment_folder=experiment, initial_learning_rate=1e-3,
            end_epoch=end_epoch, device="cpu")

    trainer = make_trainer(0, end_epoch=2)
    trainer.train()
    assert trainer.current_epoch == 2
    assert len(trainer.training_losses) == len(trainer.test_errors) == 2
    assert len(trainer.step_losses) == len(trainer.step_ms) == 1
    for epoch in (1, 2):
        assert os.path.isfile(checkpoint.checkpoint_filename(experiment,
                                                             epoch))
    resumed = make_trainer(1, end_epoch=3)
    resumed.load_checkpoint(checkpoint.checkpoint_filename(experiment, 2))
    assert resumed.current_epoch == 2
    assert resumed.training_losses == trainer.training_losses
    resumed.train()
    losses = resumed.training_losses
    assert len(losses) == 3
    assert losses[0] > losses[2]

    errors, processing_time = resumed.test()
    assert set(errors) == {"mean_absolute_error", "three_pixels_error"}
    assert processing_time > 0
    with open(os.path.join(experiment, "log.txt")) as handle:
        log = handle.read().splitlines()
    assert log[:3] == [f"PNG decoder: {png.default_decoder()}",
                       "Training started.",
                       "epoch 01 (02) : training: 00001 (00001)"]
    assert log[3] == "epoch: 01 (02) : validation: 00001 (00001)"
    assert log[4].startswith("epoch 01 (02) : training loss = ")
    assert log[4].endswith(" [%], learning rate = 0.00100.")
    assert log[-1].startswith("Testing results:MAE = ")
    for name in ("plot.png", "example_0001_image.png",
                 "example_0001_disparity_ground_truth.png",
                 "example_0001_disparity_epoch_003.png",
                 "example_0001_error_map_epoch_003.png"):
        assert png.read_png(os.path.join(experiment, name)).ndim == 3, name


def test_epoch_loss_equals_the_jax_loss(flyingthings, tmp_path):
    config = models.PDSConfig(**NARROW)
    training_set, _ = FlyingThings3D.training_split(
        flyingthings, number_of_validation_examples=0, maximum_disparity=63)
    trainer = PDSTrainer(config, _network(config, 5),
                         training_set_loader=Loader(training_set,
                                                    shuffle=True),
                         experiment_folder=str(tmp_path), end_epoch=1,
                         device="cpu")
    trainer.train()

    jax_set, _ = JaxFlyingThings3D.training_split(
        flyingthings, number_of_validation_examples=0, maximum_disparity=63)
    batch = next(iter(JaxLoader(jax_set, shuffle=True)))
    jax_config = jax_models.PDSConfig(**NARROW)
    expected = float(jax.jit(lambda params, left, right, truth:
                             jax_ops.subpixel_cross_entropy(
                                 jax_models.apply(params, left, right,
                                                  jax_config), truth))(
        weights.random_jax_params(config, 5), batch["left"]["image"],
        batch["right"]["image"], batch["left"]["disparity_image"]))
    assert abs(trainer.training_losses[0] - expected) <= 1e-4 * abs(expected)


def test_checkpoints_resume_across_packages(tmp_path):
    config = models.PDSConfig(**NARROW)
    jax_config = jax_models.PDSConfig(**NARROW)
    port = PDSTrainer(config, _network(config, 2),
                      training_set_loader=_Batches([_batch(0, height=40,
                                                           width=56)]),
                      experiment_folder=str(tmp_path / "port"), end_epoch=1,
                      device="cpu")
    port.train()
    path = checkpoint.checkpoint_filename(str(tmp_path / "port"), 1)
    reader = JaxPDSTrainer(jax_config, weights.random_jax_params(config, 9))
    reader.load_checkpoint(path)
    assert reader.current_epoch == 1
    assert reader.training_losses == port.training_losses
    assert reader.test_errors == port.test_errors == [{}]
    written = checkpoint.training_trees(port.network, port._optimizer)
    for got, want in ((reader.params, written["params"]),
                      (reader._opt_state, written["opt_state"])):
        leaves = jax.tree.leaves(got)
        assert len(leaves) == len(checkpoint.tree_leaves(want))
        for a, b in zip(leaves, checkpoint.tree_leaves(want)):
            np.testing.assert_array_equal(np.asarray(a), b)

    params = weights.random_jax_params(config, 4)
    writer = JaxPDSTrainer(jax_config, params,
                           experiment_folder=str(tmp_path / "jax"))
    rng = np.random.RandomState(4)
    writer._opt_state = jax.tree.map(lambda leaf: rng.uniform(
        1e-6, 1e-2, leaf.shape).astype(np.float32), jax_rmsprop().init(
        params))
    writer._training_losses = [3.0, 2.5]
    writer._test_errors = [{"three_pixels_error": 50.0,
                            "mean_absolute_error": 9.0}, {}]
    writer._current_epoch = 1
    os.makedirs(str(tmp_path / "jax"))
    writer._save_checkpoint()
    resumed = PDSTrainer(config, _network(config, 7),
                         experiment_folder=str(tmp_path), device="cpu")
    resumed.load_checkpoint(jax_checkpoint.checkpoint_filename(
        str(tmp_path / "jax"), 2))
    assert resumed.current_epoch == 2
    assert resumed.training_losses == [3.0, 2.5]
    assert resumed.test_errors == writer._test_errors
    trees = checkpoint.training_trees(resumed.network, resumed._optimizer)
    for got, want in ((trees["params"], params),
                      (trees["opt_state"], writer._opt_state)):
        for a, b in zip(checkpoint.tree_leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(a, np.asarray(b))


def test_config_identity_check_raises_and_warns_as_jax_does(tmp_path):
    jax_config = jax_models.PDSConfig(maximum_disparity=63)
    writer = JaxPDSTrainer(jax_config, weights.random_jax_params(CONFIG, 0),
                           experiment_folder=str(tmp_path))
    writer._save_checkpoint()
    path = checkpoint.checkpoint_filename(str(tmp_path), 1)

    def pair(loss_diversity=1.0, **overrides):
        return (PDSTrainer(models.PDSConfig(maximum_disparity=63,
                                            **overrides), _network(),
                           experiment_folder=str(tmp_path),
                           loss_diversity=loss_diversity, device="cpu"),
                JaxPDSTrainer(jax_models.PDSConfig(maximum_disparity=63,
                                                   **overrides),
                              weights.random_jax_params(CONFIG, 0),
                              experiment_folder=str(tmp_path),
                              loss_diversity=loss_diversity))

    for overrides, network_only in (
            ({"disparity_step": 1}, False),
            ({"estimator_half_support_window": 2}, True),
            ({"loss_diversity": 2.0}, False)):
        port, expected = pair(**overrides)
        with pytest.raises(ValueError) as jax_error:
            expected.load_checkpoint(path, load_only_network=network_only)
        with pytest.raises(ValueError) as port_error:
            port.load_checkpoint(path, load_only_network=network_only)
        assert str(port_error.value) == str(jax_error.value)
        assert next(iter(overrides)) in str(port_error.value)
    port, expected = pair(disparity_step=1)
    with pytest.warns(UserWarning) as jax_warning:
        expected.load_checkpoint(path, allow_config_mismatch=True)
    with pytest.warns(UserWarning) as port_warning:
        port.load_checkpoint(path, allow_config_mismatch=True)
    assert str(port_warning[0].message) == str(jax_warning[0].message)
    # A network-only load ignores the loss; another range and execution
    # alternatives are allowed; a file without a configuration loads.
    pair(loss_diversity=2.0)[0].load_checkpoint(path, load_only_network=True)
    PDSTrainer(models.PDSConfig(maximum_disparity=255,
                                folded_conv_impl="banded_slab"), _network(),
               device="cpu").load_checkpoint(path, load_only_network=True)
    legacy = str(tmp_path / "legacy.npz")
    checkpoint.save_checkpoint(legacy, checkpoint.training_trees(_network()),
                               {"training_losses": [], "test_errors": []})
    pair(disparity_step=1)[0].load_checkpoint(legacy, load_only_network=True)


def test_training_under_banded_pallas_is_refused_as_in_jax(tmp_path):
    config = models.PDSConfig(maximum_disparity=63,
                              folded_conv_impl="banded_pallas")
    with pytest.raises(ValueError) as port_error:
        PDSTrainer(config, _network(), training_set_loader=object(),
                   device="cpu")
    with pytest.raises(ValueError) as jax_error:
        JaxPDSTrainer(jax_models.PDSConfig(maximum_disparity=63,
                                           folded_conv_impl="banded_pallas"),
                      {}, training_set_loader=object())
    assert str(port_error.value) == str(jax_error.value)
    PDSTrainer(config, _network(), device="cpu")  # inference only: allowed


def test_train_loop_reads_the_loss_only_at_the_epoch_end(tmp_path):
    events = []

    class LazyLoss:
        """A device scalar that records when the host reads it."""

        def __init__(self, step, value):
            self._step, self._value = step, value

        def __float__(self):
            events.append(("read", self._step))
            return self._value

    values = [3.0, 2.0, 1.5, 1.25]
    trainer = PDSTrainer(CONFIG, _network(models.PDSConfig(**NARROW)),
                         training_set_loader=_Batches(
                             [_batch(index) for index in range(4)]),
                         experiment_folder=str(tmp_path), end_epoch=1,
                         number_of_examples_to_visualize=0, device="cpu")

    def fake_train_step(left, right, ground_truth, learning_rate):
        assert isinstance(left, torch.Tensor)
        step = sum(1 for kind, _ in events if kind == "step")
        events.append(("step", step))
        return LazyLoss(step, values[step])

    trainer._train_step = fake_train_step
    trainer.train()
    first_read = events.index(("read", 0))
    assert events[:first_read] == [("step", index) for index in range(4)]
    assert trainer.training_losses == [float(np.mean(values))]
    assert trainer.step_losses == values
    assert len(trainer.step_ms) == len(trainer.loader_wait_ms) == 4


def test_eval_warms_up_each_batch_shape_and_dumps_the_first_examples(
        tmp_path):
    """5 examples at batch size 2 (batches of 2, 2 and 1): one untimed call
    per batch shape, its delay outside the time per image; dumps of the
    first ``number_of_examples_to_visualize + 1`` examples."""
    calls = {}

    def fake_eval_step(left, right, ground_truth):
        shape = tuple(ground_truth.shape)
        calls[shape] = calls.get(shape, 0) + 1
        if calls[shape] == 1:
            time.sleep(0.4)
        return (torch.zeros(shape), torch.ones(shape), torch.zeros(
            shape[:1]), torch.zeros(shape[:1]))

    trainer = PDSTrainer(CONFIG, _network(models.PDSConfig(**NARROW)),
                         test_set_loader=_Batches([_batch(0, 2),
                                                   _batch(1, 2),
                                                   _batch(2, 1)]),
                         experiment_folder=str(tmp_path),
                         number_of_examples_to_visualize=2, device="cpu")
    trainer._eval_step = fake_eval_step
    errors, processing_time = trainer.test()
    assert calls == {(2, 16, 24): 3, (1, 16, 24): 2}
    assert processing_time < 0.2
    assert errors == {"three_pixels_error": 0.0, "mean_absolute_error": 0.0}
    dumped = sorted(name for name in os.listdir(tmp_path)
                    if name.endswith("_image.png"))
    assert dumped == [f"example_{index:04d}_image.png"
                      for index in (1, 2, 3)]


def test_all_inf_ground_truth_dumps_where_jax_fails(tmp_path):
    batch = _batch(3)
    batch["left"]["disparity_image"][:] = np.inf
    disparity = np.random.RandomState(0).uniform(0, 9, (1, 16, 24)).astype(
        np.float32)
    error_map = np.zeros((1, 16, 24), np.float32)
    expected = JaxPDSTrainer(jax_models.PDSConfig(maximum_disparity=63), {},
                             experiment_folder=str(tmp_path / "jax"))
    os.makedirs(str(tmp_path / "jax"))
    with pytest.raises(ValueError):
        expected._visualize_example(batch, disparity, error_map, 0)
    port = PDSTrainer(CONFIG, _network(models.PDSConfig(**NARROW)),
                      experiment_folder=str(tmp_path), device="cpu")
    port._visualize_example(batch, disparity, error_map, 0)
    truth = png.read_png(str(tmp_path / "example_0001_disparity_ground_"
                                        "truth.png"))
    assert (truth == 255).all()
    estimate = png.read_png(str(tmp_path / "example_0001_disparity_epoch_"
                                           "001.png"))
    assert not (estimate == 255).all()


def test_kitti_submission_export(tmp_path):
    config = models.PDSConfig(**NARROW)
    root = fixtures.make_kitti_tree(str(tmp_path / "kitti"))
    benchmark = Kitti.kitti2015_benchmark(root)
    network = _network(config, 6)
    trainer = PDSTrainer(config, network,
                         test_set_loader=Loader(benchmark, num_workers=1),
                         experiment_folder=str(tmp_path / "experiment"),
                         device="cpu")
    errors, processing_time = trainer.test()
    assert errors == {} and processing_time > 0
    folder = tmp_path / "experiment" / "submission"
    assert sorted(os.listdir(folder)) == ["000000_10.png", "000001_10.png"]
    for index in range(2):
        example = benchmark[index]
        disparity = models.infer(network, example["left"]["image"][None],
                                 example["right"]["image"][None], config,
                                 device="cpu")[0].numpy()
        decoded = png.read_png(str(folder / f"{index:06d}_10.png"),
                               "unchanged")
        assert decoded.dtype == np.uint16
        np.testing.assert_array_equal(
            decoded, np.clip(disparity * 256.0, 0, 65535).astype(np.uint16))
    with open(tmp_path / "experiment" / "log.txt") as handle:
        assert handle.read().splitlines()[-1].startswith(
            "Testing results: no ground truth; time-per-image = ")
