"""Each per-layer metric's arithmetic on synthetic span and profiler
records, and the profile reduction's interval arithmetic."""

import pytest

from pds_bench import accounting, registry, trace
from pds_bench.record import Record


def _record(**fields):
    values = dict(kind="serve", window_seconds=2.0,
                  window_images=100, useful_flops_per_image=1e12,
                  peak_flops=989e12)
    values.update(fields)
    return Record(**values)


def _profile(device, host=(), under=None, iterations=4, images=4,
             window=(0.0, 1000.0)):
    return trace.Profile(window, iterations, images, list(device),
                         list(host), under or {})


@pytest.mark.parametrize("stage", ["embedding", "matching",
                                   "regularization"])
def test_stage_ms_per_image(stage):
    reader = registry.reader(f"{stage}_ms")
    calls = [{"forward_ms": 3.0}, {"forward_ms": 5.0}, {"forward_ms": 4.0}]
    record = _record(spans={stage: calls}, span_images=2)
    assert reader.read(record) == pytest.approx(6.0)
    assert reader.read(_record()) is None


def test_copy_ms_sums_memcpy_per_image():
    device = [(0, 100, "Memcpy HtoD (Pageable -> Device)", "memcpy"),
              (100, 900, "kernel", "kernel"),
              (900, 950, "Memcpy DtoH (Device -> Pageable)", "memcpy"),
              (950, 990, "Memcpy DtoD (Device -> Device)", "memcpy")]
    record = _record(profile=_profile(device, images=2))
    # Host to card and back only: the copy within the card is left out.
    assert registry.reader("copy_ms").read(record) == pytest.approx(0.075)
    no_copies = _record(profile=_profile(device[1:2]))
    assert registry.reader("copy_ms").read(no_copies) is None


@pytest.mark.parametrize("base, prefix", [
    ("backward_ms", "autograd::engine::evaluate_function"),
    ("optimizer_ms", "Optimizer.step#")])
def test_device_time_under_ranges_per_step(base, prefix):
    record = _record(kind="train", profile=_profile(
        [], under={prefix: 6000.0}, iterations=3))
    assert registry.reader(base).read(record) == pytest.approx(2.0)
    assert registry.reader(base).read(_record(kind="train")) is None


def test_idle_pct_is_the_uncovered_share_of_the_window():
    device = [(0, 300, "a", "kernel"), (200, 400, "b", "kernel"),
              (600, 700, "c", "memcpy"), (950, 1200, "d", "kernel")]
    record = _record(profile=_profile(device, window=(0.0, 1000.0)))
    # Busy: 0-400, 600-700, 950-1200 (the last clipped by reduce, not here).
    busy = trace.union_us(device)
    assert busy == pytest.approx(400 + 100 + 250)
    assert registry.reader("idle_pct").read(record) == pytest.approx(
        100 * (1 - busy / 1000))


def test_mfu_pct():
    record = _record(window_seconds=2.0, window_images=100,
                     useful_flops_per_image=1e12, peak_flops=1e15)
    assert registry.reader("mfu_pct").read(record) == pytest.approx(5.0)
    assert registry.reader("mfu_pct").read(_record(peak_flops=None)) is None


def test_mfu_pct_of_a_paced_window_reads_the_profiled_phase():
    # 4 images back to back in 0.4 s of profile; the window's 100 images in
    # 2 s are the traffic's rate, whatever the program does.
    profile = _profile([], images=4, window=(0.0, 4e5))
    record = _record(paced=True, profile=profile, peak_flops=1e15)
    assert registry.reader("mfu_pct").read(record) == pytest.approx(1.0)
    assert registry.reader("mfu_pct").read(_record(paced=True)) is None


def _conv_call(**extra):
    call = {"input_shape": (1, 8, 48, 144, 240),
            "weight_shape": (8, 8, 3, 3, 3),
            "output_shape": (1, 8, 48, 144, 240), "stride": (1, 1, 1),
            "padding": (1, 1, 1), "transposed": False, "dtype": "bfloat16",
            "forward_ms": 0.2}
    call.update(extra)
    return call


def test_conv3d_roofline_forward_and_train():
    reader = registry.reader("conv3d_roofline")
    voxels = 48 * 144 * 240
    moved = 2 * (2 * 8 * voxels + 27 * 64) + 4 * 8
    operations = 2.0 * voxels * 64 * 27
    bound_ms = max(moved / 3.35e12, operations / 989e12) * 1e3
    record = _record(spans={"conv3d_k3s1": [_conv_call(), _conv_call()]})
    assert reader.read(record) == pytest.approx(100 * bound_ms / 0.2)
    train = _record(kind="train", spans={"conv3d_k3s1": [
        _conv_call(backward_ms=0.6)]})
    assert reader.read(train) == pytest.approx(100 * 3 * bound_ms / 0.8)
    assert reader.read(_record(kind="train", spans={
        "conv3d_k3s1": [_conv_call()]})) is None


def test_upconv_roofline_counts_taps_that_touch_the_input():
    reader = registry.reader("upconv_roofline")
    call = {"input_shape": (1, 4, 96, 288, 480),
            "weight_shape": (4, 1, 3, 4, 4),
            "output_shape": (1, 1, 96, 576, 960), "stride": (1, 2, 2),
            "padding": (1, 1, 1), "transposed": True, "dtype": "bfloat16",
            "forward_ms": 0.7}
    macs = accounting.transposed_macs(call["input_shape"],
                                      call["weight_shape"], call["stride"],
                                      call["padding"])
    # Depth: 3 taps but 2 at each end; rows and columns: 4 taps but 3 at
    # each end.
    assert macs == 4 * (96 * 3 - 2) * (288 * 4 - 2) * (480 * 4 - 2)
    moved = 2 * (4 * 96 * 288 * 480 + 4 * 48 + 96 * 576 * 960) + 4
    bound_ms = max(moved / 3.35e12, 2.0 * macs / 989e12) * 1e3
    record = _record(spans={"conv_transpose3d": [call]})
    assert reader.read(record) == pytest.approx(100 * bound_ms / 0.7)


@pytest.mark.parametrize("base", ["conv3d_roofline", "upconv_roofline"])
def test_rooflines_choose_modules_by_shape(base):
    import torch
    from practicaldeepstereo_nips2018_tpu_torch.models import network
    select = next(iter(registry.reader(base).SPANS.values()))
    chosen = [path for path, module in
              network.PdsNetwork(network.PDSConfig()).named_modules()
              if select(path, module)]
    assert len(chosen) == (9 if base == "conv3d_roofline" else 6)
    assert not select("x", torch.nn.Conv3d(8, 16, 3, 2, 1))


def test_gaps_and_breakdown_name_the_open_host_operation():
    device = [(100, 200, "k1", "kernel"), (400, 500, "k2", "kernel"),
              (500, 900, "k1", "kernel")]
    host = [(0, 1000, "pds_bench.iteration"), (210, 390, "aten::copy_"),
            (250, 280, "cudaMemcpyAsync")]
    profile = _profile(device, host, window=(0.0, 1000.0))
    assert trace.gaps(profile) == [(0.0, 100), (200, 400), (900, 1000.0)]
    result = trace.breakdown(profile)
    assert result["device_ops"][0] == ["k1", pytest.approx(500e-6)]
    idle = dict((name, seconds) for name, seconds in result["idle_gaps"])
    assert idle["aten::copy_"] == pytest.approx(200e-6)
    assert idle["pds_bench.iteration"] == pytest.approx(200e-6)


def test_reduce_reads_a_cpu_profile():
    import torch
    profile = trace.profiled(lambda: torch.ones(64).sum(), cuda=False)
    reduced = trace.reduce(profile, 1, 1, ("aten::sum",))
    assert reduced.window_us[1] > reduced.window_us[0]
    assert any(name == "aten::sum" for _, _, name in reduced.host)
    assert reduced.under == {"aten::sum": 0.0}
