"""PyTorch port, ``utils/profiling.py`` and ``utils/flops.py`` on the CPU:
the step timer's slope, the Chrome trace, the memory report without a
card; the useful MACs equal to the JAX package's stage by stage and for
every remat policy (576x960 at D=191 and D=255), the port's executed MACs
and the H100's peaks."""

import json
import os
import time

import pytest
import torch

from practicaldeepstereo_nips2018_tpu.utils import flops as jax_flops
from practicaldeepstereo_nips2018_tpu_torch.utils import flops, profiling

torch.set_num_threads(1)

SIZES = [(576, 960, 191), (576, 960, 255), (384, 1280, 255)]


def test_step_timer_measures_the_slope(monkeypatch):
    """A 5 ms step, with a 50 ms cost in each measurement's wait that the
    slope cancels."""
    def step():
        time.sleep(0.005)
        return torch.ones(2)

    waits = []
    original = profiling._wait_for

    def slow_wait(output):
        waits.append(output)
        time.sleep(0.05)
        original(output)

    monkeypatch.setattr(profiling, "_wait_for", slow_wait)
    result = profiling.StepTimer(step, short=1, long=4).measure(repeats=3)
    assert 0.004 <= result["seconds_per_step"] <= 0.02, result
    assert result["steps_per_second"] == pytest.approx(
        1.0 / result["seconds_per_step"])
    assert len(waits) == 1 + 2 * 3


def test_step_timer_on_a_tensor_step():
    x = torch.ones(64, 64)
    result = profiling.StepTimer(lambda: (x @ x, {"other": x}), short=1,
                                 long=3).measure(repeats=2)
    assert 0 < result["seconds_per_step"] < 1.0


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    with profiling.trace(log_dir) as profile:
        torch.ones(32, 32) @ torch.ones(32, 32)
    with open(os.path.join(log_dir, profiling.TRACE_FILE)) as handle:
        events = json.load(handle)["traceEvents"]
    assert any("mm" in event.get("name", "") for event in events)
    assert any("mm" in event.key for event in profile.key_averages())


def test_device_memory_stats_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the CPU entry is not observable")
    assert profiling.device_memory_stats() == [{
        "device": "cpu", "bytes_in_use": None, "peak_bytes_in_use": None,
        "bytes_limit": None, "bytes_free": None}]


@pytest.mark.parametrize("height, width, maximum_disparity", SIZES)
def test_useful_macs_equal_jax_stage_by_stage(height, width,
                                              maximum_disparity):
    expected = jax_flops.forward_macs(height, width, maximum_disparity)
    for options in ({}, {"embedding_s2d": True, "factor_tail_conv1": True}):
        got = flops.forward_macs(height, width, maximum_disparity, **options)
        assert [stage.useful for stage in got] == [
            stage.useful for stage in expected]
    summary = flops.summarize(got)
    assert summary["useful_gmacs"] == jax_flops.summarize(
        expected)["useful_gmacs"]


@pytest.mark.parametrize("remat", [False, "selective", True])
@pytest.mark.parametrize("height, width, maximum_disparity", SIZES)
def test_training_macs_match_jax(height, width, maximum_disparity, remat):
    """Useful training MACs equal JAX's under every remat policy; the
    port's recompute covers the same stages at its own executed counts."""
    got = flops.training_macs(height, width, maximum_disparity,
                              remat=remat)
    expected = jax_flops.training_macs(height, width, maximum_disparity,
                                       remat=remat)
    assert got["useful_gmacs"] == expected["useful_gmacs"]
    assert got["remat"] == remat
    assert got["executed_gmacs"] == pytest.approx(
        got["forward_gmacs"] + got["backward_gmacs"]
        + got["recompute_gmacs"], abs=0.03)
    stages = {stage.name: stage for stage in flops.forward_macs(
        height, width, maximum_disparity)}
    embedding = (stages["embedding (x2 images)"].executed
                 + stages["left shortcut"].executed) / 1e9
    if remat is True:
        assert got["recompute_gmacs"] == pytest.approx(
            got["forward_gmacs"] - embedding, abs=0.03)
    elif remat is False:
        assert got["recompute_gmacs"] == 0.0


def test_executed_macs_of_the_port():
    """No folding or pairing: every stage executes its useful MACs but the
    head (one column wider) and the two options."""
    default = {stage.name: stage for stage in flops.forward_macs(
        576, 960, 191)}
    for name, stage in default.items():
        if name == "matching head (factored)":
            assert stage.executed == stage.useful + 144 * 9 * 64 * 64
        else:
            assert stage.executed == stage.useful, name
    options = {stage.name: stage for stage in flops.forward_macs(
        576, 960, 191, embedding_s2d=True, factor_tail_conv1=True)}
    first_conv = 288 * 480 * 64
    assert (options["embedding (x2 images)"].executed
            - default["embedding (x2 images)"].executed
            == 2 * first_conv * (9 * 12 - 25 * 3))
    assert (options["matching tail"].executed
            < default["matching tail"].executed)
    step = flops.training_macs(576, 960, 191)
    assert step["backward_gmacs"] == pytest.approx(
        2 * step["forward_gmacs"] - 2 * first_conv * 75 / 1e9, abs=0.01)


def test_peaks_name_the_h100():
    assert flops.peak_bf16_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert flops.peak_bf16_flops("NVIDIA H200") == 989e12
    assert flops.peak_bf16_flops("NVIDIA A100-SXM4-80GB") is None
    assert flops.peak_bf16_flops("cpu") is None
