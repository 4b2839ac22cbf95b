"""The PDS trainer: its train and eval steps and its epoch loop.

Port of ``practicaldeepstereo_nips2018_tpu/training/trainer.py``:

* :func:`train_step`: the similarities of :func:`~..models.network.apply`,
  the sub-pixel cross-entropy, its gradient and one RMSprop step at the
  given learning rate. On the card the hourglass's nine stride-1 3x3x3
  convs run K1 forward and K1 again for their input gradients. In a
  process group it is data-parallel over the processes, each with its own
  batch shard, as GSPMD makes the JAX step over a mesh's ``data`` axis
  (``parallel/sharding.py``'s specs): the loss is the mean over the pooled
  valid pixels of the GLOBAL batch (each process divides its sum by the
  all-reduced count, so the processes' terms sum to it; an average of
  per-process means differs wherever their counts differ, as on KITTI's
  sparse ground truth), and after ``backward`` the gradients and the loss
  are summed over the processes in one flat buffer per dtype, so RMSprop
  takes the same step everywhere and the replicas stay equal bit for bit.
  ``PdsNetwork`` has no ``forward`` (``models.apply`` calls its
  submodules), so ``DistributedDataParallel``, which prepares its
  reduction inside ``forward``, would never reduce: no wrapper. Without a
  group every collective is the identity and the step is the plain one.
  Under a ``mesh`` whose ``volume`` axis is above 1 the processes of a
  volume group take the same examples and each the loss of its own
  columns (``models.apply`` under the mesh, the ground truth cut the same
  way): the same sums over the whole world then give the loss and the
  gradients of the global batch, because the halos' and the norms'
  backward passes have already carried every cross-slice term to the
  process whose parameters' uses it belongs to.
* :func:`eval_step`: :func:`~..models.network.infer` (K1 and K2), then per
  example the 3-pixel error map and percentage and the mean absolute error
  (the JAX step ``vmap``s the metrics over the batch; here the batch loop
  is written out).
* :class:`PDSTrainer`: the epoch loop over a :class:`~..data.loader.Loader`
  (train, validate, report, checkpoint), resume, the benchmark pass with
  its per-image timing, example dumps and the KITTI submission export;
  in a process group, data-parallel over its processes as the JAX trainer
  is over a mesh whose ``data`` axis spans processes, and W-sliced over
  the ``volume`` axis of its ``mesh``.
"""

from __future__ import annotations

import dataclasses
import os
import time
import warnings

import numpy as np
import torch

from practicaldeepstereo_nips2018_tpu_torch import models
from practicaldeepstereo_nips2018_tpu_torch.data import png
from practicaldeepstereo_nips2018_tpu_torch.data.loader import (
    batch_to_device)
from practicaldeepstereo_nips2018_tpu_torch.device import resolve_device
from practicaldeepstereo_nips2018_tpu_torch.ops import errors, loss
from practicaldeepstereo_nips2018_tpu_torch.parallel import runtime
from practicaldeepstereo_nips2018_tpu_torch.training import checkpoint
from practicaldeepstereo_nips2018_tpu_torch.training import optimizer as opt
from practicaldeepstereo_nips2018_tpu_torch.utils import visualization


def _as_disparities(ground_truth, device: torch.device) -> torch.Tensor:
    """``[B, H, W]`` numpy array or tensor -> float32 tensor on
    ``device``; unknown pixels stay ``inf``."""
    return torch.as_tensor(ground_truth, dtype=torch.float32, device=device)


def loss_and_gradients(network: models.PdsNetwork, left, right,
                       ground_truth, config: models.PDSConfig,
                       compute_dtype=None, loss_diversity: float = 1.0,
                       device: str | torch.device = "cuda", mesh=None
                       ) -> torch.Tensor:
    """Sets every parameter's ``.grad`` to the gradient of the loss on the
    global batch (replacing what was there) and returns the loss, detached;
    in a process group this process's shard of the batch is ``left``,
    ``right``, ``ground_truth`` (the same shard on every process of a
    volume group of ``mesh``) and the call is a collective."""
    device = resolve_device(device)
    for parameter in network.parameters():
        parameter.grad = None
    similarities = models.apply(network, left, right, config, compute_dtype,
                                device, mesh)
    ground_truth = _as_disparities(ground_truth, device)
    if mesh is not None and mesh.volume > 1:
        similarities, (first, end) = similarities
        ground_truth = ground_truth[..., first:end]
    total, count = loss.cross_entropy_sum_and_count(
        similarities, ground_truth, diversity=loss_diversity,
        disparity_step=config.disparity_step)
    value = total / runtime.all_reduce_sum(count)
    value.backward()
    value = value.detach().reshape(1)
    runtime.all_reduce_in_place(
        [parameter.grad for parameter in network.parameters()] + [value])
    return value.reshape(())


def train_step(network: models.PdsNetwork,
               optimizer: torch.optim.RMSprop, left, right, ground_truth,
               learning_rate: float,
               config: models.PDSConfig = models.PDSConfig(),
               compute_dtype=None, loss_diversity: float = 1.0,
               device: str | torch.device = "cuda", mesh=None
               ) -> torch.Tensor:
    """One optimisation step on a batch; returns the loss as a device
    scalar (reading it waits for the card).

    Args:
        network: the weights (float32), on ``device``; updated in place.
        optimizer: RMSprop over ``network.parameters()``
            (:func:`~.optimizer.rmsprop`).
        left, right: ``[B, H, W, 3]`` images, 0..255.
        ground_truth: ``[B, H, W]`` disparities, unknown pixels ``inf``.
        learning_rate: this step's rate (:func:`~.optimizer.multistep_lr`
            of the epoch).
        config: static network configuration.
        compute_dtype: e.g. ``torch.bfloat16``; parameters, gradients and
            the optimizer state stay float32.
        loss_diversity: Laplace diversity of the loss target.
        device: ``"cuda"`` (default) or ``"cpu"``.
        mesh: optional ``parallel.Mesh``; a ``volume`` axis above 1
            W-slices the step over each volume group.

    The gradients stay in ``.grad`` after the step.
    """
    value = loss_and_gradients(network, left, right, ground_truth, config,
                               compute_dtype, loss_diversity, device, mesh)
    opt.set_learning_rate(optimizer, learning_rate)
    optimizer.step()
    return value


@torch.no_grad()
def eval_step(network: models.PdsNetwork, left, right, ground_truth,
              config: models.PDSConfig = models.PDSConfig(),
              compute_dtype=None, device: str | torch.device = "cuda"):
    """Returns (disparity ``[B, H, W]``, 3-pixel error map ``[B, H, W]``,
    3-pixel error in percent ``[B]``, mean absolute error ``[B]``), each
    example's metrics over its own known pixels."""
    device = resolve_device(device)
    disparity = models.infer(network, left, right, config, compute_dtype,
                             device)
    error_maps, three_pixels_errors, mean_absolute_errors = [], [], []
    for estimated, truth in zip(disparity,
                                _as_disparities(ground_truth, device)):
        error_map, three_pixels_error = errors.n_pixels_error(estimated,
                                                              truth)
        _, mean_absolute_error = errors.absolute_error(estimated, truth)
        error_maps.append(error_map)
        three_pixels_errors.append(three_pixels_error)
        mean_absolute_errors.append(mean_absolute_error)
    return (disparity, torch.stack(error_maps),
            torch.stack(three_pixels_errors),
            torch.stack(mean_absolute_errors))


def checkpoint_metadata(config: models.PDSConfig,
                        training_losses=(), test_errors=(),
                        initial_learning_rate: float = 1e-2,
                        milestones=(6, 7, 8, 9, 10), gamma: float = 0.5,
                        loss_diversity: float = 1.0) -> dict:
    """The metadata the JAX trainer writes with each checkpoint (its
    ``_save_checkpoint``), under the same keys, so that either package's
    trainer reads it."""
    return {
        "training_losses": [float(value) for value in training_losses],
        "test_errors": list(test_errors),
        "learning_rate_scheduler": {
            "initial_learning_rate": initial_learning_rate,
            "milestones": list(milestones),
            "gamma": gamma,
        },
        "network_config": dataclasses.asdict(config),
        "loss_diversity": loss_diversity,
    }


def _is_logging_required(example_index: int, number_of_examples: int) -> bool:
    """True after every 10 % of the examples."""
    return (example_index + 1) % max(1, number_of_examples // 10) == 0


def _timed(iterable, waits: list):
    """Yields from ``iterable``, appending to ``waits`` the seconds each
    item took to arrive."""
    iterator = iter(iterable)
    while True:
        start = time.perf_counter()
        try:
            item = next(iterator)
        except StopIteration:
            return
        waits.append(time.perf_counter() - start)
        yield item


def _as_numpy(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


class _StepClock:
    """Marks the end of each step on the device's timeline: a CUDA event on
    the card (recording one does not wait for the card), the host clock on
    the CPU, where a step has ended when its call returns."""

    def __init__(self, device: torch.device):
        self._cuda = device.type == "cuda"
        self._marks = []

    def mark(self) -> None:
        if self._cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self._marks.append(event)
        else:
            self._marks.append(time.perf_counter())

    def intervals_ms(self) -> list[float]:
        """Milliseconds between consecutive marks; on the card, call it
        once the marked work has finished."""
        pairs = zip(self._marks, self._marks[1:])
        if self._cuda:
            return [start.elapsed_time(end) for start, end in pairs]
        return [(end - start) * 1e3 for start, end in pairs]


class PDSTrainer:
    """PDS training engine: the JAX ``PDSTrainer``.

    Per epoch: train over the training loader at the epoch's learning rate
    (``optimizer.multistep_lr``), validate over the test loader, log and
    plot, write ``{epoch:03d}_checkpoint.npz``. The loss of each step stays
    a device scalar until the epoch ends, so the host never waits for the
    card inside the step loop.

    In a process group, as the JAX trainer under a mesh whose ``data``
    axis spans processes (one device each): each process trains on its own
    loader shard with the data-parallel :func:`train_step`, starting from
    process 0's parameters, and the processes' loaders must give the same
    number of batches; each evaluates its own shard and the test metrics
    are reduced over the processes. Process 0 alone writes the log, plot,
    dumps and checkpoints, and every process writes its own shard's
    submission PNGs. A ``mesh`` (``parallel.make_mesh``), where given, must
    span the group. With a ``volume`` axis above 1 the train steps are
    W-sliced over each volume group, whose processes' training loaders
    must give the same examples (shards by ``mesh.data_index``,
    ``cli/common.py::build_loaders``); validation, benchmark and export
    run whole images, each process its own shard of the test loader, as
    the JAX trainer evaluates unsharded under a mesh that spans processes.
    """

    # Fields of the stored configuration that may differ from this
    # trainer's: ``maximum_disparity`` (the matching weights are shared
    # across disparities, so any valid range evaluates them) and execution
    # alternatives that compute the same network.
    _CONFIG_IDENTITY_EXEMPT = frozenset({
        "maximum_disparity", "remat", "folded_conv_impl",
        "factor_tail_conv1",
    })

    def __init__(self,
                 network_config: models.PDSConfig,
                 network: models.PdsNetwork,
                 training_set_loader=None,
                 test_set_loader=None,
                 experiment_folder: str = ".",
                 initial_learning_rate: float = 1e-2,
                 learning_rate_milestones=(6, 7, 8, 9, 10),
                 learning_rate_gamma: float = 0.5,
                 end_epoch: int = 10,
                 loss_diversity: float = 1.0,
                 compute_dtype=None,
                 number_of_examples_to_visualize: int = 3,
                 device: str | torch.device = "cuda",
                 mesh=None):
        if (training_set_loader is not None
                and network_config.folded_conv_impl == "banded_pallas"):
            # The message of the JAX trainer, whose Pallas kernel has no
            # gradient; the option names the same network in both
            # packages, so both refuse to train under it.
            raise ValueError(
                'folded_conv_impl="banded_pallas" is forward-only and '
                "cannot be trained (no VJP); use \"banded_slab\" (same "
                "numerics, measured equally fast) for training and keep "
                "banded_pallas for inference/benchmarking only")
        if (training_set_loader is not None
                and network_config.matching_tail_int8):
            # The message of the JAX trainer: rounding to int8 has no
            # gradient, so training would freeze the matching tail.
            raise ValueError(
                "matching_tail_int8 is an inference-only approximation "
                "(round-to-int8 has zero gradient); train in "
                "bf16/float32 and enable int8 for eval/benchmark only")
        if mesh is not None and mesh.size != runtime.process_count():
            raise ValueError(
                f"the mesh spans {mesh.size} processes but the world size "
                f"is {runtime.process_count()}")
        self._config = network_config
        self._mesh = mesh
        self._device = resolve_device(device)
        self._network = network.to(self._device)
        # Every replica starts from process 0's weights.
        runtime.broadcast_parameters(self._network)
        self._training_set_loader = training_set_loader
        self._test_set_loader = test_set_loader
        self._experiment_folder = experiment_folder
        self._end_epoch = end_epoch
        self._loss_diversity = loss_diversity
        self._compute_dtype = compute_dtype
        self._number_of_examples_to_visualize = (
            number_of_examples_to_visualize)

        self._optimizer = opt.rmsprop(self._network.parameters(),
                                      initial_learning_rate)
        self._learning_rate_schedule = opt.multistep_lr(
            initial_learning_rate, learning_rate_milestones,
            learning_rate_gamma)
        self._initial_learning_rate = initial_learning_rate
        self._learning_rate_milestones = tuple(learning_rate_milestones)
        self._learning_rate_gamma = learning_rate_gamma

        self._current_epoch = 0
        self._training_losses: list[float] = []
        self._test_errors: list[dict] = []
        # Measurements of the last epoch and test pass.
        self._step_losses: list[float] = []
        self._step_ms: list[float] = []
        self._loader_wait_ms: list[float] = []
        self._processing_time = 0.0

        self._initialize_filenames()
        self._logger = None

    # -- steps --------------------------------------------------------------

    def _train_step(self, left, right, ground_truth, learning_rate):
        return train_step(self._network, self._optimizer, left, right,
                          ground_truth, learning_rate, self._config,
                          self._compute_dtype, self._loss_diversity,
                          self._device, self._mesh)

    def _eval_step(self, left, right, ground_truth):
        return eval_step(self._network, left, right, ground_truth,
                         self._config, self._compute_dtype, self._device)

    def _infer_step(self, left, right):
        return models.infer(self._network, left, right, self._config,
                            self._compute_dtype, self._device)

    def _synchronize(self) -> None:
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)

    def _batch_tensors(self, batch: dict):
        moved = batch_to_device(batch, self._device)
        return (moved["left"]["image"], moved["right"]["image"],
                moved["left"].get("disparity_image"))

    # -- checkpoints --------------------------------------------------------

    def _initialize_filenames(self):
        folder = self._experiment_folder
        self._log_filename = os.path.join(folder, "log.txt")
        self._plot_filename = os.path.join(folder, "plot.png")
        self._left_image_template = os.path.join(
            folder, "example_{0:04d}_image.png")
        self._estimated_disparity_image_template = os.path.join(
            folder, "example_{0:04d}_disparity_epoch_{1:03d}.png")
        self._ground_truth_disparity_image_template = os.path.join(
            folder, "example_{0:04d}_disparity_ground_truth.png")
        self._3_pixels_error_image_template = os.path.join(
            folder, "example_{0:04d}_error_map_epoch_{1:03d}.png")

    def _save_checkpoint(self):
        """Process 0 writes; every process then waits for the file to be
        whole before any may read it."""
        checkpoint.save_training_state(
            checkpoint.checkpoint_filename(self._experiment_folder,
                                           self._current_epoch + 1),
            self._network, self._optimizer,
            checkpoint_metadata(
                self._config, self._training_losses, self._test_errors,
                self._initial_learning_rate, self._learning_rate_milestones,
                self._learning_rate_gamma, self._loss_diversity))
        runtime.barrier()

    def _verify_checkpoint_config(self, filename: str, metadata: dict,
                                  allow_config_mismatch: bool,
                                  check_loss: bool) -> None:
        """Raises (or, with ``allow_config_mismatch``, warns) when the
        checkpoint was written under a configuration that computes
        something else with the same weight shapes (``disparity_step``,
        ``estimator_half_support_window``, ...) or, on a full resume, under
        another loss diversity. A checkpoint without a stored configuration
        (a reference import) passes."""
        stored = metadata.get("network_config")
        if stored is None:
            return
        current = dataclasses.asdict(self._config)
        mismatches = [
            f"{key}: checkpoint={stored[key]!r} vs current={current[key]!r}"
            for key in sorted(set(stored) & set(current))
            if key not in self._CONFIG_IDENTITY_EXEMPT
            and stored[key] != current[key]]
        stored_diversity = metadata.get("loss_diversity")
        if (check_loss and stored_diversity is not None
                and stored_diversity != self._loss_diversity):
            mismatches.append(
                f"loss_diversity: checkpoint={stored_diversity!r} vs "
                f"current={self._loss_diversity!r}")
        if not mismatches:
            return
        message = (
            f'checkpoint "{filename}" was written under different '
            "semantics: " + "; ".join(mismatches)
            + ". (maximum_disparity changes are always allowed — the "
            "reference's set_maximum_disparity workflow.)")
        if allow_config_mismatch:
            warnings.warn(message + " Loading anyway "
                          "(allow_config_mismatch=True).", stacklevel=3)
            return
        raise ValueError(
            message + " Pass allow_config_mismatch=True to load anyway.")

    def load_checkpoint(self, filename: str,
                        load_only_network: bool = False,
                        allow_config_mismatch: bool = False) -> None:
        """Restores the training state (network, RMSprop, losses, errors
        and epoch) from a checkpoint written by either package, or only the
        network with ``load_only_network`` (fine-tuning, evaluation).

        Raises when the stored configuration differs in meaning from this
        trainer's (``allow_config_mismatch=True`` warns instead);
        ``maximum_disparity`` may always differ."""
        _, metadata = checkpoint.load_checkpoint(filename, {})
        self._verify_checkpoint_config(filename, metadata,
                                       allow_config_mismatch,
                                       check_loss=not load_only_network)
        checkpoint.load_training_state(
            filename, self._network,
            None if load_only_network else self._optimizer)
        runtime.broadcast_parameters(self._network)
        if load_only_network:
            return
        self._training_losses = list(metadata["training_losses"])
        self._test_errors = list(metadata["test_errors"])
        self._current_epoch = len(self._training_losses)

    # -- epoch loops ----------------------------------------------------------

    def _check_equal_batch_counts(self, number_of_batches: int) -> None:
        """Raises on every process when the processes' loaders give
        different numbers of batches: the one with fewer would leave the
        others waiting in a collective for ever."""
        counts = [int(count) for count in runtime.all_gather_values(
            [number_of_batches])[:, 0]]
        if len(set(counts)) > 1:
            raise ValueError(
                f"the processes' training loaders give {counts} "
                "batches this epoch; data-parallel steps need the same "
                "number on every process (build the loaders with "
                "equal_shards=True)")

    def _train_for_epoch(self) -> float:
        losses, waits = [], []
        number_of_batches = len(self._training_set_loader)
        self._check_equal_batch_counts(number_of_batches)
        if hasattr(self._training_set_loader, "set_epoch"):
            self._training_set_loader.set_epoch(self._current_epoch)
        learning_rate = self._learning_rate_schedule(self._current_epoch)
        clock = _StepClock(self._device)
        with torch.profiler.record_function("PDSTrainer.train_epoch"):
            clock.mark()
            for batch_index, batch in enumerate(
                    _timed(self._training_set_loader, waits)):
                if _is_logging_required(batch_index, number_of_batches):
                    self._logger.log(
                        "epoch {0:02d} ({1:02d}) : training: {2:05d} "
                        "({3:05d})".format(self._current_epoch + 1,
                                           self._end_epoch, batch_index + 1,
                                           number_of_batches))
                left, right, ground_truth = self._batch_tensors(batch)
                # The loss stays on the device: reading it here would make
                # the host wait for the card at every step.
                losses.append(self._train_step(left, right, ground_truth,
                                               learning_rate))
                clock.mark()
            self._step_losses = [float(value) for value in losses]
            self._synchronize()
        self._step_ms = clock.intervals_ms()
        self._loader_wait_ms = [wait * 1e3 for wait in waits]
        return float(np.mean(np.asarray(self._step_losses, np.float64)))

    def _test(self):
        errors = []
        processing_times = []
        if self._test_set_loader is None:
            return {}, 0.0
        number_of_batches = len(self._test_set_loader)
        example_offset = 0
        warmed_shapes: set[tuple] = set()
        for batch_index, example in enumerate(self._test_set_loader):
            if _is_logging_required(batch_index, number_of_batches):
                self._logger.log(
                    "epoch: {0:02d} ({1:02d}) : validation: {2:05d} "
                    "({3:05d})".format(self._current_epoch + 1,
                                       self._end_epoch, batch_index + 1,
                                       number_of_batches))
            left, right, ground_truth = self._batch_tensors(example)
            batch_count = int(left.shape[0])
            if tuple(left.shape) not in warmed_shapes:
                # An untimed first call at each batch shape: the kernels'
                # build and cuDNN's plans stay out of the per-image time.
                warmed_shapes.add(tuple(left.shape))
                if ground_truth is None:
                    self._infer_step(left, right)
                else:
                    self._eval_step(left, right, ground_truth)
            self._synchronize()
            start_time = time.time()
            if ground_truth is None:
                # A set without ground truth (KITTI testing): inference,
                # submission files and dumps, no metrics.
                disparity = self._infer_step(left, right)
                self._synchronize()
                per_image_time = (time.time() - start_time) / batch_count
                processing_times.extend([per_image_time] * batch_count)
                disparity = _as_numpy(disparity)
                self._export_submission(disparity, example_offset,
                                        example.get("names"))
                for index_in_batch in range(batch_count):
                    self._visualize_example(
                        example, disparity, None,
                        example_offset + index_in_batch, index_in_batch)
                example_offset += batch_count
                continue
            outputs = self._eval_step(left, right, ground_truth)
            self._synchronize()
            per_image_time = (time.time() - start_time) / batch_count
            disparity, error_map, three_pixels_error, mean_absolute_error = (
                _as_numpy(output) for output in outputs)
            for index_in_batch in range(batch_count):
                errors.append({
                    "three_pixels_error":
                        float(three_pixels_error[index_in_batch]),
                    "mean_absolute_error":
                        float(mean_absolute_error[index_in_batch]),
                })
                processing_times.append(per_image_time)
                self._visualize_example(
                    example, disparity, error_map,
                    example_offset + index_in_batch, index_in_batch)
            example_offset += batch_count
        return self._reduce_test_metrics(errors, processing_times)

    def _reduce_test_metrics(self, errors: list[dict],
                             processing_times: list[float]):
        """Means over the examples of every process: (errors, seconds per
        image). Each process's loader holds a disjoint shard, so the
        per-process sums and counts are summed over the processes
        (``runtime.all_hosts_sum``) before they divide, as the JAX trainer
        does. A collective: every process calls it once per ``_test``, an
        empty shard too."""
        three_pixels_sum, absolute_sum, error_count, time_sum, time_count = (
            runtime.all_hosts_sum([
                sum(e["three_pixels_error"] for e in errors),
                sum(e["mean_absolute_error"] for e in errors),
                float(len(errors)),
                sum(processing_times),
                float(len(processing_times)),
            ]))
        self._processing_time = time_sum / time_count if time_count else 0.0
        if not error_count:
            return {}, self._processing_time
        return {
            "three_pixels_error": three_pixels_sum / error_count,
            "mean_absolute_error": absolute_sum / error_count,
        }, self._processing_time

    # -- reports and dumps ----------------------------------------------------

    def _export_submission(self, disparity: np.ndarray, example_offset: int,
                           names: list[str] | None = None) -> None:
        """Writes KITTI submission PNGs (uint16 ``disparity * 256``), named
        after each example's source file (e.g. ``000012_10.png``), or after
        its position where the dataset has no paths.

        Every process writes its own loader shard's PNGs; source names do
        not collide across processes, and the positional name takes the
        prefix ``host{process}_`` in a group of more than one."""
        folder = os.path.join(self._experiment_folder, "submission")
        os.makedirs(folder, exist_ok=True)
        for index_in_batch in range(disparity.shape[0]):
            if names is not None:
                filename = (os.path.splitext(names[index_in_batch])[0]
                            + ".png")
            else:
                prefix = (f"host{runtime.process_index()}_"
                          if runtime.process_count() > 1 else "")
                filename = (f"{prefix}{example_offset + index_in_batch:06d}"
                            "_10.png")
            encoded = np.clip(disparity[index_in_batch] * 256.0, 0,
                              65535).astype(np.uint16)
            png.write_png(os.path.join(folder, filename), encoded)

    def _visualize_example(self, example: dict, disparity: np.ndarray,
                           error_map: np.ndarray | None,
                           example_position: int,
                           index_in_batch: int = 0) -> None:
        """Dumps the images of the examples at positions 0 to
        ``number_of_examples_to_visualize`` of the test stream.

        Where the ground truth has no finite pixel, the disparity images
        take the estimate's range (the JAX trainer fails there). Process 0
        alone writes them."""
        if (example_position > self._number_of_examples_to_visualize
                or runtime.process_index() != 0):
            return
        ground_truth = example["left"].get("disparity_image")
        left_image = example["left"]["image"][index_in_batch]
        visualization.save_image(
            self._left_image_template.format(example_position + 1),
            left_image)
        if ground_truth is None:
            return
        ground_truth = ground_truth[index_in_batch]
        finite = np.isfinite(ground_truth)
        scale = ground_truth[finite] if finite.any() else disparity[
            index_in_batch]
        minimum_disparity = float(scale.min())
        maximum_disparity = float(scale.max())
        visualization.save_matrix(
            self._ground_truth_disparity_image_template.format(
                example_position + 1),
            ground_truth, minimum_disparity, maximum_disparity)
        visualization.save_matrix(
            self._estimated_disparity_image_template.format(
                example_position + 1, self._current_epoch + 1),
            disparity[index_in_batch], minimum_disparity, maximum_disparity)
        overlay = visualization.overlay_image_with_binary_error(
            left_image, error_map[index_in_batch])
        visualization.save_image(
            self._3_pixels_error_image_template.format(
                example_position + 1, self._current_epoch + 1), overlay)

    def _report_training_progress(self):
        last_errors = self._test_errors[-1] if self._test_errors else {}
        if last_errors:
            if runtime.process_index() == 0:
                visualization.plot_losses_and_errors(
                    self._plot_filename, self._training_losses,
                    [e["three_pixels_error"] for e in self._test_errors])
            self._logger.log(
                "epoch {0:02d} ({1:02d}) : training loss = {2:.5f}, "
                "MAE = {3:.5f} [pix], 3PE = {4:.5f} [%], "
                "learning rate = {5:.5f}.".format(
                    self._current_epoch + 1, self._end_epoch,
                    self._training_losses[-1],
                    last_errors["mean_absolute_error"],
                    last_errors["three_pixels_error"],
                    self._learning_rate_schedule(self._current_epoch)))
        else:
            self._logger.log(
                "epoch {0:02d} ({1:02d}) : training loss = {2:.5f}, "
                "learning rate = {3:.5f} (no validation set).".format(
                    self._current_epoch + 1, self._end_epoch,
                    self._training_losses[-1],
                    self._learning_rate_schedule(self._current_epoch)))

    def _report_test_results(self, error: dict, processing_time: float):
        if not error:
            self._logger.log(
                "Testing results: no ground truth; "
                "time-per-image = {0:.2f} [sec].".format(processing_time))
            return
        self._logger.log(
            "Testing results:"
            "MAE = {0:.5f} [pix], "
            "3PE = {1:.5f} [%], "
            "time-per-image = {2:.2f} [sec].".format(
                error["mean_absolute_error"], error["three_pixels_error"],
                processing_time))

    def _ensure_logger(self):
        """Process 0 logs to ``log.txt``; the others log nowhere."""
        if self._logger is None and runtime.process_index() != 0:
            self._logger = visualization.NullLogger()
        if self._logger is None:
            os.makedirs(self._experiment_folder, exist_ok=True)
            self._logger = visualization.Logger(self._log_filename)
            self._logger.log(f"PNG decoder: {png.default_decoder()}")

    # -- public API -----------------------------------------------------------

    def train(self):
        """Trains to ``end_epoch``; returns the last validation errors."""
        self._ensure_logger()
        number_of_batches = (0 if self._training_set_loader is None
                             else len(self._training_set_loader))
        # Before the empty check: a process with no batch must not leave
        # the others in the first collective.
        self._check_equal_batch_counts(number_of_batches)
        if number_of_batches == 0:
            raise ValueError(
                "training set is empty — check dataset filters "
                "(maximum_disparity) and the validation holdout size")
        start_epoch = self._current_epoch
        if start_epoch == self._end_epoch:
            return None
        self._logger.log("Training started.")
        for self._current_epoch in range(start_epoch, self._end_epoch):
            self._training_losses.append(self._train_for_epoch())
            self._test_errors.append(self._test()[0])
            self._report_training_progress()
            self._save_checkpoint()
        self._current_epoch = self._end_epoch
        return self._test_errors[-1]

    def test(self):
        """Evaluates on the test loader; logs and returns
        (average errors, seconds per image)."""
        self._ensure_logger()
        errors, processing_time = self._test()
        self._report_test_results(errors, processing_time)
        return errors, processing_time

    @property
    def network(self) -> models.PdsNetwork:
        return self._network

    @property
    def training_losses(self):
        return list(self._training_losses)

    @property
    def test_errors(self):
        return list(self._test_errors)

    @property
    def current_epoch(self):
        return self._current_epoch

    @property
    def step_losses(self) -> list[float]:
        """The loss of each step of the last epoch."""
        return list(self._step_losses)

    @property
    def step_ms(self) -> list[float]:
        """Milliseconds from the end of one step of the last epoch to the
        end of the next, on the device's timeline (the first from the
        epoch's start): what the loop costs per step, the wait for data
        included."""
        return list(self._step_ms)

    @property
    def loader_wait_ms(self) -> list[float]:
        """Milliseconds the host waited for each batch of the last
        epoch."""
        return list(self._loader_wait_ms)

    @property
    def processing_time(self) -> float:
        """Seconds per image of the last validation or test pass."""
        return self._processing_time
