"""The card's idle time put down to the port's layer spans
(:mod:`pds_bench.program_spans`) and the five readers of it, on
hand-built profiles."""

import ast
import pathlib

import pytest

from pds_bench import program_spans, registry, trace
from pds_bench.record import Record

READERS = {"serving_idle_ms": ("serving", "image"),
           "embedding_idle_ms": ("embedding", "image"),
           "matching_idle_ms": ("matching", "image"),
           "regularization_idle_ms": ("regularization", "image"),
           "trainer_idle_ms": ("trainer", "iteration")}


def _profile(device, host, window=(0.0, 1000.0), iterations=2, images=4):
    return trace.Profile(window, iterations, images, list(device),
                         list(host), {})


def _record(profile):
    return Record(kind="serve", window_seconds=1.0, window_images=4,
                  useful_flops_per_image=1.0, peak_flops=None,
                  profile=profile)


def _idle(device, host, window=(0.0, 1000.0)):
    return program_spans.idle_us_by_layer(_profile(device, host, window))


def test_idle_goes_to_the_innermost_layer_span():
    # Idle 0-100 (outside), 200-300 (predict), 300-400 (embedding inside
    # predict), 450-500 (predict again), 900-1000 (outside).
    device = [(100, 200, "k", "kernel"), (400, 450, "k", "kernel"),
              (500, 900, "k", "kernel")]
    host = [(0, 1000, "pds_bench.iteration"), (150, 880, "pds.predict"),
            (300, 420, "pds.embedding"), (310, 320, "aten::conv2d")]
    idle = _idle(device, host)
    assert idle["outside"] == pytest.approx(100 + 100)
    assert idle["serving"] == pytest.approx(100 + 50)
    assert idle["embedding"] == pytest.approx(100)
    assert idle["matching"] == idle["trainer"] == 0.0


def test_a_kernel_span_counts_to_its_enclosing_layer():
    device = [(0, 100, "k", "kernel"), (300, 1000, "k", "kernel")]
    host = [(50, 950, "pds.regularization"),
            (120, 280, "pds.kernel.conv3d_k3s1"),
            (290, 310, "pds.kernel.conv_transpose3d")]
    idle = _idle(device, host)
    assert idle["regularization"] == pytest.approx(200)
    assert idle["outside"] == 0.0


def test_a_gap_over_two_layers_is_split_between_them():
    device = [(0, 100, "k", "kernel"), (700, 1000, "k", "kernel")]
    host = [(0, 1000, "pds.train_step"), (20, 250, "pds.matching"),
            (250, 400, "pds.regularization"), (400, 650, "pds.loss")]
    idle = _idle(device, host)
    assert idle["matching"] == pytest.approx(150)
    assert idle["regularization"] == pytest.approx(150)
    assert idle["trainer"] == pytest.approx(250 + 50)


def test_spans_that_start_together_count_to_the_inner_one():
    device = [(500, 1000, "k", "kernel")]
    host = [(0, 600, "pds.train_step"), (0, 400, "pds.backward"),
            (0, 200, "pds.matching")]
    idle = _idle(device, host)
    assert idle["matching"] == pytest.approx(200)
    assert idle["trainer"] == pytest.approx(300)


@pytest.mark.parametrize("seed", range(5))
def test_layers_and_outside_sum_to_the_idle_time(seed):
    import random
    rng = random.Random(seed)
    device = []
    for _ in range(40):  # inside the window, as trace.reduce clips them
        begin = rng.uniform(0, 970)
        device.append((begin, begin + rng.uniform(0, 30), "k", "kernel"))
    names = [*program_spans.LAYERS, "pds.kernel.subpixel_map",
             "aten::add"]
    host, begin = [], 0.0
    for _ in range(6):  # roots one after another, each with nested spans
        end = begin + rng.uniform(50, 150)
        host.append((begin, end, rng.choice(["pds.predict",
                                             "pds.train_step"])))
        inner = begin + rng.uniform(0, 20)
        while inner < end - 10:
            finish = min(end, inner + rng.uniform(5, 60))
            host.append((inner, finish, rng.choice(names)))
            inner = finish + rng.uniform(0, 10)
        begin = end + rng.uniform(0, 40)
    profile = _profile(device, host)
    idle = program_spans.idle_us_by_layer(profile)
    start, end = profile.window_us
    total = (end - start) - trace.union_us(device)
    assert sum(idle.values()) == pytest.approx(total)
    assert sum(finish - begin for begin, finish in trace.gaps(profile)) \
        == pytest.approx(total)


@pytest.mark.parametrize("base", sorted(READERS))
def test_readers_per_image_or_step(base):
    layer, per = READERS[base]
    reader = registry.reader(base)
    assert reader.PROFILE
    device = [(0, 100, "k", "kernel"), (900, 1000, "k", "kernel")]
    span = {"serving": "pds.crop", "trainer": "pds.optimizer"}.get(
        layer, f"pds.{layer}")
    host = [(0, 1000, "pds_bench.iteration"), (150, 650, span)]
    value = reader.read(_record(_profile(device, host, iterations=2,
                                         images=4)))
    assert value == pytest.approx(0.5 / (4 if per == "image" else 2))


@pytest.mark.parametrize("base", sorted(READERS))
def test_readers_return_none_without_a_profile_or_the_spans(base):
    reader = registry.reader(base)
    assert reader.read(_record(None)) is None
    # A port without the spans: the traced run leaves the metric out.
    host = [(0, 1000, "pds_bench.iteration"), (10, 20, "aten::add")]
    assert reader.read(_record(_profile([(0, 5, "k", "kernel")],
                                        host))) is None


def test_every_new_metric_is_read_where_benchmark_lists_it():
    names = {f"{base}.{suffix}" for base, (_, per) in READERS.items()
             for suffix in (["train"] if per == "iteration" else
                            ["serve_b1", "serve_batch", "train"])}
    names -= {"serving_idle_ms.train"}
    for workload in ("ft3d-serve-b1", "kitti-serve-b4", "ft3d-train-b1",
                     "kitti-train-b4"):
        cell = registry.cell(workload)
        listed = {metric["name"] for metric in cell.per_layer
                  if metric["name"].split(".")[0] in READERS}
        kind = "train" if "train" in workload else (
            "serve_b1" if workload == "ft3d-serve-b1" else "serve_batch")
        assert listed == {name for name in names
                          if name.endswith("." + kind)}


def test_the_span_reader_imports_nothing_of_the_port():
    path = pathlib.Path(program_spans.__file__)
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            modules = ([alias.name for alias in node.names]
                       if isinstance(node, ast.Import) else [node.module])
            for module in modules:
                assert not module.startswith(
                    "practicaldeepstereo_nips2018_tpu"), module



@pytest.mark.parametrize("workload", ["ft3d-serve-b1", "ft3d-train-b1"])
def test_a_tiny_traced_run_reads_the_port_spans(workload, monkeypatch):
    """A cell cut to the CPU's size, traced: every new metric the cell
    lists is in its line, and with no device activity on the CPU the
    layers and outside hold the whole profiled window, most of it in the
    port's layers."""
    import time

    from pds_bench import cells, run
    from pds_bench.tests.tiny import tiny_cell
    cell = tiny_cell(workload)
    cell.traffic.update(span_iterations=1, profile_iterations=2)
    records = []
    traced = cells.traced

    def keep(*arguments):
        record, profile = traced(*arguments)
        records.append(record)
        return record, profile

    monkeypatch.setattr(cells, "traced", keep)
    outcome = run.measure(cell, 2147483659, 0.2, True, "cpu",
                          time.perf_counter())
    listed = {metric["name"] for metric in cell.per_layer
              if metric["name"].split(".")[0] in READERS}
    assert listed and listed <= set(outcome["result"]["metrics"])
    profile = records[0].profile
    idle = program_spans.idle_us_by_layer(profile)
    start, end = profile.window_us
    assert sum(idle.values()) == pytest.approx(end - start)
    assert idle["outside"] < 0.5 * (end - start)
