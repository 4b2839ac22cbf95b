"""PyTorch port, the bench (``practicaldeepstereo_nips2018_tpu_torch/
bench.py``) on the CPU: its line has the JAX bench's keys (read from the
root ``bench.py`` through ``ast``: importing that file sets a JAX
compilation-cache directory) and its constants as defaults; its MAC counts
are the JAX package's at the published shapes; its train step is the JAX
bench's step (``models.apply`` + ``ops.subpixel_cross_entropy`` + optax
RMSprop, ``p - 1e-2 * u``) from the same numpy weights; a small run gives
finite positive times and finite losses; it raises without a card, and a
configuration that fails makes the whole run fail.

The runs here take the host's clock out of the outcome: the step timer
(``profiling.StepTimer.measure``) still runs each step as often as the real
one, but reports a fixed slope (:func:`_fixed_slope_measure`). A CPU shared
with other test workers can measure a negative slope of one call, which
``bench._measure`` rightly refuses; that check is held by a test of its
own, and the real timer's slopes are held positive on the card
(``chip_smoke.py`` phase 14).

Two float32 bench steps are held against two JAX bench steps with the JAX
update taken on the port's gradients, as
``tests/test_torch_train_step.py::test_train_step_matches_jax_update``
does, and within its tolerances. With JAX's own float32 gradients the
weights cannot agree to 1e-6: RMSprop's first step moves every weight by
``lr * g / (sqrt(0.01 g^2) + 1e-8)``, about 0.1 times the sign of its
gradient, so a gradient element that is zero up to rounding (a conv bias
ahead of an instance norm) moves by 0.1 one way or the other in each
implementation (worst 0.2 after one step at this size). In float64 one
step from the same weights is held with JAX's own gradients."""

import ast
import collections
import inspect
import json
import math
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from practicaldeepstereo_nips2018_tpu import models as jax_models
from practicaldeepstereo_nips2018_tpu import ops as jax_ops
from practicaldeepstereo_nips2018_tpu.training import (
    optimizer as jax_optimizer)
from practicaldeepstereo_nips2018_tpu.utils import flops as jax_flops
import chip_smoke
from practicaldeepstereo_nips2018_tpu_torch import bench, models
from practicaldeepstereo_nips2018_tpu_torch.training import (
    checkpoint, trainer, weights)
from practicaldeepstereo_nips2018_tpu_torch.utils import profiling

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_BENCH = ROOT / "bench.py"
PORT_BENCH = ROOT / "practicaldeepstereo_nips2018_tpu_torch" / "bench.py"
BATCH = "<batch>"
# The small run: 64x64 images, D=63 for serving and training.
SMALL = dict(device="cpu", height=64, width=64, maximum_disparity=63,
             train_maximum_disparity=63, short=1, long=2, repeats=1)
# The train-step comparison: batch 2, 64x128, D=63.
STEP_CASE = (2, 64, 128, 63)
# The slope :func:`_fixed_slope_measure` reports, in seconds per call.
FIXED_SLOPE_S = 0.25
# What the port's ``detail`` holds beyond the JAX bench's line.
PORT_DETAIL_KEYS = ("eval_images_per_second_direct", "eval_map_mode",
                    "configurations")


def _main_function(tree: ast.Module) -> ast.FunctionDef:
    return next(node for node in tree.body
                if isinstance(node, ast.FunctionDef) and node.name == "main")


def _literal_keys(node: ast.Dict) -> list:
    return [key.value for key in node.keys]


def _jax_line_structure() -> dict:
    """The keys of the JAX bench's line as a nested dict (a leaf is None,
    a dict keyed by batch size has the one key ``BATCH``): the
    ``json.dumps`` literal of ``main``, the dicts its names hold (their
    literal and every ``.update`` of them) and the per-batch dicts
    assigned into them."""
    main = _main_function(ast.parse(JAX_BENCH.read_text()))
    named, per_batch = collections.defaultdict(list), {}
    for node in ast.walk(main):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict):
            target = node.targets[0]
            if isinstance(target, ast.Name):
                named[target.id] += _literal_keys(node.value)
            elif isinstance(target, ast.Subscript):
                per_batch[target.value.id] = _literal_keys(node.value)
        elif (isinstance(node, ast.Call)
              and isinstance(node.func, ast.Attribute)
              and node.func.attr == "update"
              and isinstance(node.func.value, ast.Name)):
            named[node.func.value.id] += _literal_keys(node.args[0])
    line = next(node for node in ast.walk(main)
                if isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "dumps").args[0]

    def structure(value):
        if isinstance(value, ast.Dict):
            return {key.value: structure(item)
                    for key, item in zip(value.keys, value.values)}
        if isinstance(value, ast.Name) and value.id in per_batch:
            return {BATCH: dict.fromkeys(per_batch[value.id])}
        if isinstance(value, ast.Name) and value.id in named:
            return dict.fromkeys(named[value.id])
        return None

    return structure(line)


def _line_structure(value):
    """The keys of a line as :func:`_jax_line_structure` gives them."""
    if not isinstance(value, dict):
        return None
    if value and all(key.isdigit() for key in value):
        return {BATCH: _line_structure(next(iter(value.values())))}
    return {key: _line_structure(item) for key, item in value.items()}


def _jax_constants() -> dict:
    """The module-level constants of the JAX bench (``NAME = value`` and
    ``A, B = a, b``)."""
    constants = {}
    for node in ast.parse(JAX_BENCH.read_text()).body:
        if not isinstance(node, ast.Assign):
            continue
        target, value = node.targets[0], node.value
        if isinstance(target, ast.Tuple):
            pairs = zip(target.elts, value.elts)
        else:
            pairs = [(target, value)]
        for name, item in pairs:
            if isinstance(name, ast.Name) and name.id.isupper():
                constants[name.id] = ast.literal_eval(item)
    return constants


def _fixed_slope_measure(timer, repeats: int = 3) -> dict:
    """``StepTimer.measure`` without the host's clock: the warm-up call and
    each repeat's short and long runs as the real timer makes them, every
    slope :data:`FIXED_SLOPE_S`."""
    timer._run(1)
    for _ in range(repeats):
        timer._run(timer._long)
        timer._run(timer._short)
    return {"seconds_per_step": FIXED_SLOPE_S,
            "steps_per_second": 1.0 / FIXED_SLOPE_S,
            "slopes": [FIXED_SLOPE_S] * repeats}


@pytest.fixture(scope="module")
def small_line():
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(profiling.StepTimer, "measure", _fixed_slope_measure)
        return bench.run(**SMALL)


def test_line_has_the_jax_bench_keys(small_line):
    structure = _line_structure(small_line)
    extra = {key: structure["detail"].pop(key)
             for key in PORT_DETAIL_KEYS}
    assert structure == _jax_line_structure()
    assert (extra["eval_images_per_second_direct"]
            == structure["detail"]["eval_images_per_second"])
    assert json.loads(json.dumps(small_line)) == small_line


def test_chip_smoke_holds_the_line_to_the_jax_bench_keys(small_line):
    """``chip_smoke.py`` phase 14 checks the card's line against its own
    copy of the JAX bench's keys: that copy is the JAX bench's, and it
    finds a key taken out."""
    assert chip_smoke.BATCH_KEY == BATCH
    assert chip_smoke.JAX_BENCH_LINE == _jax_line_structure()
    assert not chip_smoke.missing_keys(small_line, chip_smoke.JAX_BENCH_LINE)
    broken = json.loads(json.dumps(small_line))
    del broken["detail"]["train_flops"]["train_mfu_useful_pct"]
    del broken["detail"]["eval_images_per_second"]["4"]["step_seconds"]
    assert chip_smoke.missing_keys(broken, chip_smoke.JAX_BENCH_LINE) == [
        ".detail.eval_images_per_second.4.step_seconds",
        ".detail.train_flops.train_mfu_useful_pct"]


def test_defaults_are_the_jax_bench_constants():
    constants = _jax_constants()
    defaults = {name: parameter.default for name, parameter
                in inspect.signature(bench.run).parameters.items()}
    assert (defaults["height"], defaults["width"]) == (constants["HEIGHT"],
                                                       constants["WIDTH"])
    assert defaults["maximum_disparity"] == constants["MAXIMUM_DISPARITY"]
    assert (defaults["train_maximum_disparity"]
            == constants["TRAIN_MAXIMUM_DISPARITY"])
    assert (defaults["short"], defaults["long"], defaults["repeats"]) == (
        constants["SHORT_ITERATIONS"], constants["LONG_ITERATIONS"],
        constants["REPEATS"])
    assert defaults["eval_batches"] == (2, 4)
    assert defaults["train_batches"] == (1, 2, 4)
    assert defaults["device"] == "cuda"
    assert bench.BASELINE_SECONDS == constants["BASELINE_SECONDS"]
    assert bench.FOLDED_IMPL == constants["FOLDED_IMPL"]
    assert bench.TRAIN_REMAT == constants["TRAIN_REMAT"]


@pytest.mark.parametrize("kind", ["forward", "train"])
def test_useful_macs_equal_jax_at_the_published_shapes(kind):
    seconds, train_seconds, peak = 0.05, 0.15, 989e12
    forward, train = bench.accounting(540, 960, 191, 255, seconds,
                                      train_seconds, peak)
    if kind == "forward":
        expected = jax_flops.summarize(jax_flops.forward_macs(
            576, 960, 191, folded_impl=bench.FOLDED_IMPL))["useful_gmacs"]
        got, mfu, time = forward, "mfu_useful_pct", seconds
    else:
        expected = jax_flops.training_macs(
            576, 960, 255, folded_impl=bench.FOLDED_IMPL,
            remat=bench.TRAIN_REMAT)["useful_gmacs"]
        got, mfu, time = train, "train_mfu_useful_pct", train_seconds
    assert got["useful_gmacs"] == expected
    assert got[mfu] == round(100 * expected * 2e9 / time / peak, 1)
    assert forward["peak_bf16_tflops"] == 989.0
    assert forward["folded_conv_impl"] == "banded_slab"


def _jax_bench_step(config, batch, dtype):
    """The JAX bench's step (``bench.py:311-322``) on ``batch``, jitted:
    (params, state) -> (params, state, loss); and its forward loss alone,
    and the RMSprop update on given gradients."""
    left, right, ground_truth = (jnp.asarray(array, dtype)
                                 for array in batch)
    transform = jax_optimizer.rmsprop()

    def loss_fn(params):
        similarities = jax_models.apply(params, left, right, config,
                                        compute_dtype=dtype)
        return jax_ops.subpixel_cross_entropy(
            similarities, ground_truth, disparity_step=config.disparity_step)

    def update(params, state, gradients):
        updates, state = transform.update(gradients, state)
        return jax.tree.map(lambda p, u: p - bench.LEARNING_RATE * u, params,
                            updates), state

    @jax.jit
    def step(params, state):
        loss, gradients = jax.value_and_grad(loss_fn)(params)
        return *update(params, state, gradients), loss

    return transform, step, jax.jit(loss_fn), jax.jit(update)


def _step_case(compute_dtype):
    batch, height, width, maximum_disparity = STEP_CASE
    network, rmsprop, step = bench.train_case(
        batch, height, width, maximum_disparity, seed=0, device="cpu",
        compute_dtype=compute_dtype)
    arrays = [tensor.numpy() for tensor in bench.training_batch(
        batch, height, width, maximum_disparity)]
    config = jax_models.PDSConfig(maximum_disparity=maximum_disparity,
                                  folded_conv_impl=bench.FOLDED_IMPL)
    params = weights.random_jax_params(
        models.PDSConfig(maximum_disparity=maximum_disparity), seed=0)
    return network, rmsprop, step, arrays, config, params


def _leaves(tree):
    return [np.asarray(leaf, np.float64) for leaf in jax.tree.leaves(tree)]


def test_two_bench_train_steps_are_two_jax_bench_steps():
    """float32: at each step the loss within 1e-5 relative of JAX's at the
    same weights, then the square averages and the weights equal to the
    JAX update on the step's gradients from the carried state."""
    network, rmsprop, step, arrays, config, params = _step_case(
        torch.float32)
    transform, _, loss_fn, update = _jax_bench_step(config, arrays,
                                                    jnp.float32)
    state = transform.init(params)
    for _ in range(2):
        expected_loss = float(loss_fn(params))
        loss = float(step())
        assert abs(loss - expected_loss) <= 1e-5 * abs(expected_loss)
        gradients = weights.jax_tree_of_parameters(
            network, lambda _, parameter: parameter.grad)
        params, state = update(params, state, gradients)
        trees = checkpoint.training_trees(network, rmsprop)
        for got, want in zip(_leaves(trees["opt_state"]), _leaves(state.nu)):
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
        for got, want in zip(_leaves(trees["params"]), _leaves(params)):
            np.testing.assert_allclose(got, want, atol=1e-6)


def test_bench_train_step_in_float64_is_the_jax_bench_step():
    """One step from the same weights, each package with its own float64
    gradients: the loss within 1e-5 relative, the weights within 1e-6."""
    network, rmsprop, step, arrays, config, params = _step_case(
        torch.float64)
    network.double()
    with jax.enable_x64(True):
        transform, jax_step, _, _ = _jax_bench_step(config, arrays,
                                                    jnp.float64)
        params = jax.tree.map(lambda leaf: jnp.asarray(leaf, jnp.float64),
                              params)
        expected, _, expected_loss = jax_step(params,
                                              transform.init(params))
        expected_loss = float(expected_loss)
        expected = _leaves(expected)
    loss = float(step())
    assert abs(loss - expected_loss) <= 1e-5 * abs(expected_loss)
    got = _leaves(checkpoint.training_trees(network, rmsprop)["params"])
    for a, b in zip(got, expected):
        np.testing.assert_allclose(a, b, atol=1e-6)


def test_small_run_gives_finite_positive_times_and_losses(small_line):
    detail = small_line["detail"]
    times = [small_line["value"], detail["train_step_seconds"],
             *detail["slope_samples_s"]]
    for key in ("eval_images_per_second", "eval_images_per_second_direct",
                "train_images_per_second"):
        for record in detail[key].values():
            times += [record["step_seconds"], record["images_per_second"]]
    configurations = detail["configurations"]
    assert sorted(configurations) == sorted(
        ["infer_1", "unroll_2", "unroll_4", "direct_2", "direct_4",
         "train_1", "train_2", "train_4"])
    for record in configurations.values():
        times += [record["seconds"], *record["slopes_s"]]
        # The CPU runs the plain versions, which count no launch.
        assert record["launches"] == {}
        assert record["peak_memory_bytes"] is None
    assert all(math.isfinite(time) and time > 0 for time in times), times
    for batch in (1, 2, 4):
        assert math.isfinite(configurations[f"train_{batch}"]["last_loss"])
    for name in ("infer_1", "unroll_2", "unroll_4", "direct_2", "direct_4"):
        low, high = configurations[name]["disparity_range"]
        assert configurations[name]["disparity_finite"]
        assert 0.0 <= low <= high <= 62.0
    assert detail["device"] == "cpu"
    assert detail["flops"]["mfu_useful_pct"] is None
    assert small_line["vs_baseline"] == round(0.62 / small_line["value"], 2)


def test_run_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the card-less error is not "
                    "observable")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        bench.run()


def test_a_failing_configuration_fails_the_run(monkeypatch):
    original = trainer.train_step

    def failing(network, optimizer, left, *args, **kwargs):
        if left.shape[0] == 2:
            raise RuntimeError("batch 2 does not fit")
        return original(network, optimizer, left, *args, **kwargs)

    monkeypatch.setattr(trainer, "train_step", failing)
    monkeypatch.setattr(profiling.StepTimer, "measure", _fixed_slope_measure)
    with pytest.raises(RuntimeError, match="batch 2 does not fit"):
        bench.run(**{**SMALL, "eval_batches": (2,),
                     "train_batches": (1, 2)})


@pytest.mark.parametrize("slope", [0.0, -0.020377472000291164,
                                   float("nan")])
def test_a_non_positive_slope_fails_the_measurement(monkeypatch, slope):
    """``bench._measure`` refuses a slope that is not finite and positive
    (here a CPU clock's -0.0203 s, the one a loaded host once gave)."""
    def measure(timer, repeats=3):
        timer._run(1)
        return {"seconds_per_step": slope, "steps_per_second": None,
                "slopes": [slope] * repeats}

    monkeypatch.setattr(profiling.StepTimer, "measure", measure)
    calls = []

    def step():
        calls.append(1)
        return torch.ones(1)

    with pytest.raises(RuntimeError, match="batch 1: the timer measured"):
        bench._measure(step, torch.device("cpu"), 1,
                       {"short": 1, "long": 2, "repeats": 1})
    assert len(calls) == 2  # the untimed call and the timer's warm-up


def test_bench_catches_no_exception():
    tree = ast.parse(PORT_BENCH.read_text())
    assert not [node for node in ast.walk(tree)
                if isinstance(node, ast.ExceptHandler)]


def test_main_prints_the_line(monkeypatch, capsys):
    line = {"metric": "time_per_image", "value": 0.06}
    monkeypatch.setattr(bench, "run", lambda: line)
    assert bench.main() == 0
    output = capsys.readouterr().out.splitlines()
    assert len(output) == 1 and json.loads(output[0]) == line
