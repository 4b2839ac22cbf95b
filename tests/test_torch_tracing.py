"""PyTorch port, its ``pds.*`` spans (``utils/profiling.py::span``) on the
CPU: with no profiler recording, ``span`` is one shared null context and
no ``record_function`` is made; under ``torch.profiler`` a served request
and a train step open exactly the spans of each layer boundary, nested
under their root, the same on every process of a group. Narrow widths,
40x120 images, D=63."""

import collections
import json
import sys

import numpy as np
import pytest
import torch

from practicaldeepstereo_nips2018_tpu_torch import models
from practicaldeepstereo_nips2018_tpu_torch.ops import kernels
from practicaldeepstereo_nips2018_tpu_torch.parallel import runtime
from practicaldeepstereo_nips2018_tpu_torch.serving import InferenceSession
from practicaldeepstereo_nips2018_tpu_torch.training import (
    optimizer, trainer)
from practicaldeepstereo_nips2018_tpu_torch.utils import profiling
from tests.torch_process_group import Group

torch.set_num_threads(1)

HEIGHT, WIDTH = 40, 120
NARROW = dict(maximum_disparity=63, number_of_embedding_features=16,
              number_of_matching_features=16,
              number_of_embedding_residual_blocks=1,
              number_of_matching_residual_blocks=1)
LEARNING_RATE = 1e-2
GROUP_TIMEOUT_S = 120
# The spans a forward opens under its root, each once but the embedding,
# once per view.
FORWARD = {"pds.prepare": 1, "pds.embedding": 2, "pds.matching": 1,
           "pds.regularization": 1}
SERVED = {**FORWARD, "pds.estimator": 1, "pds.crop": 1}
TRAINER = {"pds.loss": 1, "pds.backward": 1, "pds.all_reduce": 1,
           "pds.optimizer": 1}


def _network(config, seed=0) -> models.PdsNetwork:
    torch.manual_seed(seed)
    return models.PdsNetwork(config)


def _images(batch, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.uniform(0, 255, (batch, HEIGHT, WIDTH, 3)).astype(np.float32)
            for _ in range(2)]


def _ground_truth(batch, seed=0):
    rng = np.random.RandomState(seed)
    return rng.uniform(0, 60, (batch, HEIGHT, WIDTH)).astype(np.float32)


def _predict(batch: int, mode: str):
    session = InferenceSession(
        _network(models.PDSConfig(**NARROW)).state_dict(),
        models.PDSConfig(**NARROW), compute_dtype=None, device="cpu",
        batched_mode=mode)
    left, right = _images(batch)
    return lambda: session.predict(left, right)


def _train_step(remat=False):
    config = models.PDSConfig(**NARROW, remat=remat)
    network = _network(config)
    rmsprop = optimizer.rmsprop(network.parameters(), LEARNING_RATE)
    left, right = _images(1)
    ground_truth = _ground_truth(1)
    return lambda: trainer.train_step(network, rmsprop, left, right,
                                      ground_truth, LEARNING_RATE, config,
                                      device="cpu")


def span_tree(run) -> tuple[collections.Counter, dict]:
    """Runs ``run()`` under the profiler: (the number of each (span, its
    nearest enclosing ``pds.`` span or None) pair, the launches counted)."""
    kernels.launch_counts.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as profile:
        run()
    tree = collections.Counter()
    for event in profile.events():
        if not event.name.startswith("pds."):
            continue
        parent = event.cpu_parent
        while parent is not None and not parent.name.startswith("pds."):
            parent = parent.cpu_parent
        tree[event.name, None if parent is None else parent.name] += 1
    return tree, dict(kernels.launch_counts)


def _under(root: str, spans: dict, times: int = 1) -> dict:
    return {(name, root): count * times for name, count in spans.items()}


def _kernel_spans(tree) -> dict:
    counts = collections.Counter()
    for (name, _), count in tree.items():
        if name.startswith("pds.kernel."):
            counts[name.removeprefix("pds.kernel.")] += count
    return dict(counts)


def test_span_without_a_profiler_is_one_shared_null_context():
    called = []
    first = profiling.span("pds.a", lambda: called.append(1) or "args")
    assert first is profiling.span("pds.b")
    with first as entered:
        assert entered is None
    assert not called


@pytest.mark.parametrize("case", ["predict", "predict_direct_2",
                                  "train_step"])
def test_no_record_function_without_a_profiler(case, monkeypatch):
    def refuse(*_):
        raise AssertionError("record_function with no profiler recording")

    run = {"predict": lambda: _predict(1, "unroll"),
           "predict_direct_2": lambda: _predict(2, "direct"),
           "train_step": _train_step}[case]()
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    run()


@pytest.mark.parametrize("batch, mode, forwards", [
    (1, "unroll", 1), (2, "direct", 1), (2, "unroll", 2)])
def test_served_request_opens_the_serving_spans(batch, mode, forwards):
    tree, launches = span_tree(_predict(batch, mode))
    expected = {("pds.predict", None): 1, ("pds.copy_out", "pds.predict"): 1,
                **_under("pds.predict", SERVED, forwards)}
    assert {key: count for key, count in tree.items()
            if not key[0].startswith("pds.kernel.")} == expected
    # One kernel span per launch counted (on the CPU the plain versions
    # run, so neither).
    assert _kernel_spans(tree) == launches


@pytest.mark.parametrize("remat", [False, "selective"])
def test_train_step_opens_the_trainer_spans(remat):
    tree, launches = span_tree(_train_step(remat))
    expected = {("pds.train_step", None): 1,
                **_under("pds.train_step", {**FORWARD, **TRAINER})}
    if remat:
        # The recompute opens the matching span again in the backward.
        expected["pds.matching", "pds.backward"] = 1
    assert {key: count for key, count in tree.items()
            if not key[0].startswith("pds.kernel.")} == expected
    assert _kernel_spans(tree) == launches


def _rank_spans(output: str) -> None:
    runtime.initialize_distributed(device="cpu")
    tree, _ = span_tree(_train_step())
    with open(output, "w") as handle:
        json.dump(sorted([name, parent, count]
                         for (name, parent), count in tree.items()), handle)


SCENARIOS = {"spans": _rank_spans}


def test_every_process_of_a_group_opens_the_same_spans(tmp_path):
    outputs = Group(tmp_path, "tests.test_torch_tracing", "spans", 2,
                    GROUP_TIMEOUT_S).wait()
    trees = []
    for output in outputs:
        with open(output) as handle:
            trees.append(json.load(handle))
    single, _ = span_tree(_train_step())
    assert trees[0] == trees[1] == sorted(
        [name, parent, count] for (name, parent), count in single.items())


if __name__ == "__main__":
    SCENARIOS[sys.argv[1]](*sys.argv[2:])
    if "jax" in sys.modules:
        raise SystemExit("a process of the group imported JAX")
