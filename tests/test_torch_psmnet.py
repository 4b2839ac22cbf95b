"""PyTorch port, PSMNet (``models/psmnet.py``): the network, its volume,
heads, loss and Adam step against the plain float32 reference
(``tests/psmnet_reference.py``) on seeded random weights, at 64x128 with
D=32 and pyramid pools of 16, 8, 4, 2 (so that every stride-2 level
halves evenly and every pooled branch keeps a cell); the ``blocks.py``
repairs it needed; serving and training through the port's entry points;
and its benchmark cell (``pds_bench``: yardstick, driver, readers) on the
CPU."""

import json
import math
import time

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pds_bench import cells, generator, registry, run
from pds_bench.architectures import psmnet as yardstick
from pds_bench.record import Record
from practicaldeepstereo_nips2018_tpu_torch import models
from practicaldeepstereo_nips2018_tpu_torch.models import blocks, psmnet
from practicaldeepstereo_nips2018_tpu_torch.ops import (
    conv3d, conv_transpose3d, costvolume, kernels, loss, regression)
from practicaldeepstereo_nips2018_tpu_torch.serving import InferenceSession
from practicaldeepstereo_nips2018_tpu_torch.training import (
    optimizer, trainer)
from tests import psmnet_reference as reference

HEIGHT, WIDTH, DISPARITY = 64, 128, 32
POOLS = (16, 8, 4, 2)
CONFIG = psmnet.PSMConfig(maximum_disparity=DISPARITY, pyramid_pools=POOLS)
BENCH_CONFIG = {"height": HEIGHT, "width": WIDTH, "pyramid_pools": POOLS,
                "serve_maximum_disparity": DISPARITY,
                "train_maximum_disparity": DISPARITY}
WORKLOAD = "psmnet-sf-train-b12"
SEED = 2 ** 31 + 17
# Maps and losses, float32 against float32: the port and the reference
# compute the same function in other orders (K1's plain version, the
# volume by unfold against slice copies, the loss's sum over its count
# against three means), so they part by float32 rounding: under 1e-4 px on
# a map (levels 0 .. 31), 1e-6 relative on the loss. bfloat16 compute
# moves maps by ~0.1 px, 100x over.
MAP_TOLERANCE_PX = 1e-3
LOSS_TOLERANCE = 1e-5       # relative
# Gradients and the Adam step, float64 against float64. In float32 this
# network's gradient is ill-conditioned at the tests' size: the
# reference's own float32 gradients part from its float64 ones by 0.5 %
# at the median leaf and 5 % at the worst, and the port's float32 ones
# part from the reference's float32 ones as much; in float64 the two
# agree to ~1e-13 of each gradient's largest element. A float32 (or
# bfloat16) computation anywhere in the port fails the tolerance below by
# orders of magnitude.
GRADIENT_TOLERANCE = 1e-9   # of the largest element of each gradient
# Adam's first step is ~1e-3 * sign(g); an element whose gradient is near
# its eps (1e-8) carries the gradient's rounding into the step.
STEP_TOLERANCE = 1e-10      # absolute, on parameters after one Adam step


def _weights(seed: int) -> dict[str, torch.Tensor]:
    """Every key of the port's state_dict: conv weights uniform at
    PyTorch's default bound; BatchNorm affine and running statistics drawn
    around 1 and 0, so that both modes of BatchNorm are exercised."""
    rng = torch.Generator().manual_seed(seed)
    state = {}
    for key, value in psmnet.PsmNetwork(CONFIG).state_dict().items():
        if key.endswith("num_batches_tracked"):
            state[key] = torch.tensor(0)
        elif value.ndim > 1:
            state[key] = (torch.rand(value.shape, generator=rng) * 2 - 1
                          ) / math.sqrt(value[0].numel())
        elif key.endswith("running_var") or key.endswith(".weight"):
            state[key] = 0.5 + torch.rand(value.shape, generator=rng)
        else:
            state[key] = (torch.rand(value.shape, generator=rng) - 0.5) * 0.2
    return state


def _pairs(seed: int, batch: int = 2, height: int = HEIGHT,
           width: int = WIDTH):
    rng = np.random.RandomState(seed)
    left = rng.uniform(0, 255, (batch, height, width, 3)).astype(np.float32)
    right = np.roll(left, -5, axis=2) + rng.uniform(
        -4, 4, left.shape).astype(np.float32)
    truth = rng.uniform(0, DISPARITY, (batch, height, width)
                        ).astype(np.float32)
    return left, right, truth


def _network(state, train: bool) -> psmnet.PsmNetwork:
    network = psmnet.PsmNetwork(CONFIG)
    network.load_state_dict(state)
    return network.train(train)


def _reference_maps(state, left, right, training):
    return reference.forward(
        state, reference.normalised(torch.as_tensor(left)),
        reference.normalised(torch.as_tensor(right)), DISPARITY, training,
        POOLS)


def _as_float64(state: dict) -> dict:
    return {key: value.double() if value.is_floating_point() else value
            for key, value in state.items()}


@pytest.fixture(scope="module")
def trained():
    """The port's float32 maps and loss beside the reference's, and one
    float64 train step of each from the same weights on the same batch:
    (port maps, port loss, reference maps, reference loss; port float64
    gradients, port float64 state after one Adam step, reference
    gradients, reference state after its Adam step)."""
    state = _weights(1)
    left, right, truth = _pairs(2)
    network = _network(state, True)
    maps = [value.detach() for value in psmnet.apply(
        network, left, right, CONFIG, device="cpu")]
    value = trainer.loss_and_gradients(network, left, right, truth, CONFIG,
                                       device="cpu")
    with torch.no_grad():
        expected_maps = _reference_maps(state, left, right, True)
    expected_loss = reference.loss(expected_maps, torch.as_tensor(truth),
                                   DISPARITY)

    state64 = _as_float64(state)
    network = _network(state64, True).double()
    adam = optimizer.adam(network.parameters())
    trainer.train_step(network, adam, left, right, truth, 1e-3, CONFIG,
                       torch.float64, device="cpu")
    gradients = {key: parameter.grad.clone()
                 for key, parameter in network.named_parameters()}
    after = {key: parameter.detach().clone()
             for key, parameter in network.named_parameters()}
    leaves = {key: state64[key].clone().requires_grad_(True)
              for key in gradients}
    expected_maps64 = reference.forward(
        {**state64, **leaves},
        reference.normalised(torch.as_tensor(left)).double(),
        reference.normalised(torch.as_tensor(right)).double(), DISPARITY,
        True, POOLS)
    expected_gradients = dict(zip(leaves, torch.autograd.grad(
        reference.loss(expected_maps64, torch.as_tensor(truth).double(),
                       DISPARITY), list(leaves.values()))))
    expected_after = reference.adam_step(
        {key: state64[key] for key in leaves}, expected_gradients, {}, 1)
    return (maps, float(value), expected_maps, float(expected_loss),
            gradients, after, expected_gradients, expected_after)


def test_training_maps_match_the_reference(trained):
    maps, expected = trained[0], trained[2]
    assert len(maps) == 3
    for got, want in zip(maps, expected):
        assert got.shape == (2, HEIGHT, WIDTH) and got.dtype == torch.float32
        assert float((got - want).abs().max()) <= MAP_TOLERANCE_PX
    # Three different heads, not one map three times.
    assert float((maps[0] - maps[2]).abs().max()) > 10 * MAP_TOLERANCE_PX


def test_loss_matches_the_reference(trained):
    assert trained[1] == pytest.approx(trained[3], rel=LOSS_TOLERANCE)


def test_every_gradient_matches_the_reference(trained):
    gradients, expected = trained[4], trained[6]
    assert gradients.keys() == expected.keys()
    assert len(gradients) == len(list(psmnet.PsmNetwork(CONFIG).parameters()))
    for key, want in expected.items():
        scale = float(want.abs().max())
        assert scale > 0, key
        error = float((gradients[key] - want).abs().max())
        assert error <= GRADIENT_TOLERANCE * scale, (key, error, scale)


def test_one_adam_step_matches_the_reference(trained):
    after, expected = trained[5], trained[7]
    for key, want in expected.items():
        assert float((after[key] - want).abs().max()) <= STEP_TOLERANCE, key


def test_eval_map_matches_the_reference():
    state = _weights(3)
    left, right, _ = _pairs(4)
    network = _network(state, False)
    got = psmnet.infer(network, left, right, CONFIG, device="cpu")
    with torch.no_grad():
        (want,) = _reference_maps(state, left, right, False)
    assert got.shape == (2, HEIGHT, WIDTH)
    assert float((got - want).abs().max()) <= MAP_TOLERANCE_PX
    # Eval uses the running statistics: the train-mode map differs.
    with torch.no_grad():
        train_map = _reference_maps(state, left, right, True)[2]
    assert float((got - train_map).abs().max()) > 10 * MAP_TOLERANCE_PX


def test_concatenation_volume_is_the_published_loop():
    rng = torch.Generator().manual_seed(5)
    left = torch.randn((2, 3, 4, 9), generator=rng)
    right = torch.randn((2, 3, 4, 9), generator=rng)
    for levels in (1, 5, 9, 12):
        volume = costvolume.concatenation_volume(left, right, levels)
        assert torch.equal(volume, reference.cost_volume(left, right,
                                                         levels))
    volume = costvolume.concatenation_volume(left, right, 5)
    # The zero band: level i is zero at columns w < i, in both halves.
    for level in range(5):
        assert not volume[:, :, level, :, :level].any()
        assert volume[:, :, level, :, level:].abs().min() > 0


def test_concatenation_volume_gradients_are_the_loops():
    rng = torch.Generator().manual_seed(6)
    left = torch.randn((1, 2, 3, 7), generator=rng, requires_grad=True)
    right = torch.randn((1, 2, 3, 7), generator=rng, requires_grad=True)
    weight = torch.randn((1, 4, 4, 3, 7), generator=rng)
    got = torch.autograd.grad(
        (costvolume.concatenation_volume(left, right, 4) * weight).sum(),
        (left, right))
    want = torch.autograd.grad(
        (reference.cost_volume(left, right, 4) * weight).sum(),
        (left, right))
    for a, b in zip(got, want):
        assert torch.allclose(a, b, atol=1e-6)


def test_smooth_l1_leaves_out_unknown_and_out_of_range_truth():
    truth = torch.tensor([[[1.0, 191.9, 192.0, 250.0, math.inf, 5.0]]])
    maps = [torch.tensor([[[1.5, 190.0, 0.0, 0.0, 3.0, 9.0]]])] * 3
    total, count = loss.smooth_l1_sum_and_count(maps, truth, 192)
    assert float(count) == 3
    # SL1 over the three kept pixels: 0.5 * 0.5^2, 1.9 - 0.5, 4 - 0.5.
    per_head = 0.125 + 1.4 + 3.5
    assert float(total) == pytest.approx(per_head * (0.5 + 0.7 + 1.0),
                                         rel=1e-5)
    predicted = torch.tensor([[[1.5, 190.0, 0.0, 0.0, 3.0, 9.0]]],
                             requires_grad=True)
    total, count = loss.smooth_l1_sum_and_count([predicted] * 3, truth, 192)
    (total / count).backward()
    assert torch.isfinite(predicted.grad).all()
    assert not predicted.grad[0, 0, 2:5].any()
    assert float((total / count).detach()) == pytest.approx(
        float(reference.loss([predicted.detach()] * 3, truth, 192)),
        rel=1e-6)


def test_heads_are_float32_softmax_expectations():
    cost = torch.randn((1, 1, 4, 3, 5), dtype=torch.bfloat16)
    disparity = regression.soft_argmin(cost, 16, 12, 20)
    assert disparity.dtype == torch.float32 and disparity.shape == (1, 12,
                                                                    20)
    upsampled = F.interpolate(cost.float(), (16, 12, 20), mode="trilinear",
                              align_corners=False)[:, 0]
    levels = torch.arange(16.0).view(1, -1, 1, 1)
    assert torch.allclose(disparity, (upsampled.softmax(1) * levels).sum(1))


def test_session_pads_top_and_right_and_crops_back():
    state = _weights(7)
    left, right, _ = _pairs(8, batch=2, height=60, width=100)
    session = InferenceSession(state, CONFIG, compute_dtype=None,
                               device="cpu", batched_mode="direct")
    got = session.predict(left, right)
    assert got.shape == (2, 60, 100) and got.dtype == np.float32

    def padded(image):
        x = reference.normalised(torch.as_tensor(image))
        return F.pad(x, (0, 12, 4, 0))  # to 64x112, top and right

    with torch.no_grad():
        (want,) = reference.forward(state, padded(left), padded(right),
                                    DISPARITY, False, POOLS)
    want = want[:, 4:, :100]
    assert float(np.abs(got - want.numpy()).max()) <= MAP_TOLERANCE_PX
    unrolled = InferenceSession(state, CONFIG, compute_dtype=None,
                                device="cpu").predict(left, right)
    assert float(np.abs(unrolled - got).max()) <= MAP_TOLERANCE_PX


def test_published_keys_and_parameter_count():
    network = psmnet.PsmNetwork()
    state = network.state_dict()
    for key in ("feature_extraction.firstconv.0.0.weight",
                "feature_extraction.firstconv.4.1.running_mean",
                "feature_extraction.layer2.0.downsample.0.weight",
                "feature_extraction.layer3.0.downsample.1.running_var",
                "feature_extraction.layer4.2.conv2.0.weight",
                "feature_extraction.branch1.1.0.weight",
                "feature_extraction.lastconv.2.weight",
                "dres0.2.1.bias", "dres1.2.0.weight",
                "dres2.conv1.0.0.weight", "dres2.conv5.1.running_var",
                "dres4.conv6.0.weight", "classif3.2.weight"):
        assert key in state, key
    assert "feature_extraction.layer1.0.downsample.0.weight" not in state
    assert "feature_extraction.layer4.0.downsample.0.weight" not in state
    convs = [module for module in network.modules()
             if isinstance(module, torch.nn.modules.conv._ConvNd)]
    # 61 in the tower, 28 in the 3-D part.
    assert len(convs) == 89 and all(conv.bias is None for conv in convs)
    assert state["dres2.conv5.0.weight"].shape == (64, 64, 3, 3, 3)
    assert state["dres2.conv6.0.weight"].shape == (64, 32, 3, 3, 3)
    assert state["classif1.2.weight"].shape == (1, 32, 3, 3, 3)
    count = sum(parameter.numel() for parameter in network.parameters())
    # The paper's 5.22 M parameters.
    assert count == 5224768
    assert dict(network.named_modules())["feature_extraction.layer4.0.conv1"
                                         ".0.0"].dilation == (2, 2)


def test_config_is_validated():
    with pytest.raises(ValueError, match="multiple of 16"):
        psmnet.PSMConfig(maximum_disparity=100)
    with pytest.raises(ValueError, match="four sizes"):
        psmnet.PSMConfig(pyramid_pools=(8, 4))


# -- the blocks.py repairs ---------------------------------------------------

def test_conv2d_takes_dilation_and_no_bias():
    conv = blocks.Conv2d(4, 6, 3, 1, 2, 2, bias=False)
    assert conv.bias is None
    x = torch.randn(2, 4, 9, 11)
    assert torch.allclose(conv(x), F.conv2d(x, conv.weight, None, 1, 2, 2),
                          atol=1e-6)
    assert conv(x).shape == (2, 6, 9, 11)


@pytest.mark.parametrize("stride", [1, 2])
def test_conv3d_without_bias(stride, monkeypatch):
    calls = []
    apply = conv3d.Conv3dK3S1.apply
    monkeypatch.setattr(conv3d.Conv3dK3S1, "apply",
                        lambda *args: calls.append(args) or apply(*args))
    conv = blocks.Conv3d(4, 5, 3, stride, 1, bias=False)
    x = torch.randn(2, 4, 6, 7, 8, requires_grad=True)
    y = conv(x)
    assert torch.allclose(y, F.conv3d(x, conv.weight, None, stride, 1),
                          atol=1e-5)
    assert len(calls) == (1 if stride == 1 else 0)
    if stride == 1:
        bias = calls[0][2]
        assert bias.dtype == torch.float32 and not bias.any()
        assert not bias.requires_grad
    y.sum().backward()
    assert x.grad is not None and conv.weight.grad is not None


def test_conv3d_routes():
    """One-channel convs stay on K1 (its direct kernel); a dilated or
    grouped one takes the stock conv, with its dilation, and is
    counted."""
    assert blocks.runs_k1(blocks.Conv3d(8, 1, 3, 1, 1, bias=False))
    assert blocks.runs_k1(blocks.Conv3d(1, 8, 3, 1, 1))
    assert not blocks.runs_k1(blocks.Conv3d(8, 8, 3, 1, 1, groups=2))
    kernels.fallback_counts.clear()
    conv = blocks.Conv3d(4, 8, 3, 1, 2, dilation=2, bias=False)
    assert not blocks.runs_k1(conv)
    x = torch.randn(1, 4, 6, 7, 8)
    assert torch.allclose(conv(x), F.conv3d(x, conv.weight, None, 1, 2, 2),
                          atol=1e-6)
    assert kernels.fallback_counts == {"conv3d k3x3x3 s1x1x1 4->8": 1}


@pytest.mark.parametrize("sizes", [(3, 4, 5), (2, 3, 3)])
def test_conv_transpose3d_output_padding(sizes):
    kernels.fallback_counts.clear()
    conv = blocks.ConvTranspose3d(6, 4, 3, 2, 1, output_padding=1,
                                  bias=False)
    x = torch.randn(2, 6, *sizes, requires_grad=True)
    y = conv(x)
    assert y.shape == (2, 4, *(2 * size for size in sizes))
    want = F.conv_transpose3d(x, conv.weight, None, 2, 1, 1)
    assert torch.allclose(y, want, atol=1e-6)
    assert kernels.fallback_counts == {
        "conv_transpose3d k3x3x3 s2x2x2 6->4": 1}
    (gradient,) = torch.autograd.grad(y.sum(), x)
    (expected,) = torch.autograd.grad(want.sum(), x)
    assert torch.allclose(gradient, expected, atol=1e-5)


def test_pds_keeps_its_hand_kernel_routes(monkeypatch):
    """Every stride-1 3x3x3 conv of PDS still takes K1, every transposed
    conv K3; only its stride-2 contractions take the stock conv."""
    network = models.PdsNetwork(models.PDSConfig(maximum_disparity=63))
    for module in network.modules():
        if isinstance(module, torch.nn.Conv3d):
            stride_one = module.stride == (1, 1, 1)
            assert blocks.runs_k1(module) == stride_one
        if isinstance(module, torch.nn.ConvTranspose3d):
            assert blocks.runs_k3(module)
    counts = {"k1": 0, "k3": 0}
    k1, k3 = conv3d.Conv3dK3S1.apply, conv_transpose3d.ConvTranspose3dK3.apply

    def counted(name, function):
        def call(*args):
            counts[name] += 1
            return function(*args)
        return call

    monkeypatch.setattr(conv3d.Conv3dK3S1, "apply", counted("k1", k1))
    monkeypatch.setattr(conv_transpose3d.ConvTranspose3dK3, "apply",
                        counted("k3", k3))
    kernels.fallback_counts.clear()
    image = np.random.RandomState(0).uniform(0, 255, (1, 64, 64, 3)).astype(
        np.float32)
    models.infer(network, image, image, models.PDSConfig(maximum_disparity=63),
                 device="cpu")
    # A served image's 9 K1 and 6 K3 calls (chip_smoke.py's SERVED_IMAGE).
    assert counts == {"k1": 9, "k3": 6}
    assert set(kernels.fallback_counts) == {
        "conv3d k3x3x3 s2x2x2 8->16", "conv3d k3x3x3 s2x2x2 16->32",
        "conv3d k3x3x3 s2x2x2 32->64", "conv3d k3x3x3 s2x2x2 64->128"}


def test_psmnet_fallbacks_per_step():
    kernels.fallback_counts.clear()
    left, right, truth = _pairs(9)
    network = _network(_weights(9), True)
    trainer.train_step(network, optimizer.adam(network.parameters()), left,
                       right, truth, 1e-3, CONFIG, device="cpu")
    assert dict(kernels.fallback_counts) == {
        "conv3d k3x3x3 s2x2x2 32->64": 3, "conv3d k3x3x3 s2x2x2 64->64": 3,
        "conv_transpose3d k3x3x3 s2x2x2 64->64": 3,
        "conv_transpose3d k3x3x3 s2x2x2 64->32": 3}


# -- serving and training through the port's entry points ---------------------

def test_train_step_refuses_the_volume_axis():
    class Mesh:
        volume = 2

    left, right, truth = _pairs(10)
    network = _network(_weights(10), True)
    with pytest.raises(ValueError, match="volume axis"):
        trainer.loss_and_gradients(network, left, right, truth, CONFIG,
                                   device="cpu", mesh=Mesh())


def test_adam_is_the_published_optimiser():
    adam = optimizer.adam([torch.nn.Parameter(torch.zeros(2))])
    group = adam.param_groups[0]
    assert isinstance(adam, torch.optim.Adam)
    assert (group["lr"], group["betas"], group["eps"],
            group["weight_decay"]) == (1e-3, (0.9, 0.999), 1e-8, 0)


# -- the two references and the benchmark ------------------------------------

@pytest.mark.parametrize("training", [True, False])
def test_the_two_references_agree(training):
    """``tests/psmnet_reference.py`` and the benchmark's yardstick give
    equal maps and losses on the same weights."""
    state = _weights(11)
    left, right, truth = _pairs(12)
    with torch.no_grad():
        want = _reference_maps(state, left, right, training)
        got = yardstick.maps(state, BENCH_CONFIG, torch.as_tensor(left),
                             torch.as_tensor(right), DISPARITY, training)
    assert len(got) == len(want) == (3 if training else 1)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= MAP_TOLERANCE_PX
    if training:
        truth = torch.as_tensor(truth)
        assert float(yardstick.loss(got, truth, DISPARITY)) == pytest.approx(
            float(reference.loss(want, truth, DISPARITY)),
            rel=LOSS_TOLERANCE)


def test_yardstick_layout_is_the_port_state_dict():
    layout = yardstick.weight_layout(BENCH_CONFIG)
    drawn = generator.make_weights(layout, SEED, "cpu")
    state = psmnet.PsmNetwork(CONFIG).state_dict()
    assert list(drawn) == list(state)
    for key, value in state.items():
        assert drawn[key].shape == value.shape and (
            drawn[key].dtype == value.dtype), key
    assert torch.equal(drawn["dres2.conv5.1.running_var"], torch.ones(64))
    assert drawn["classif1.0.1.num_batches_tracked"].dtype == torch.int64
    assert layout["dres2.conv5.0.weight"]["fan_in"] == 64 * 27


def _hooked_macs(network, left, right):
    """Multiply-adds of every conv call of a forward pass, read from the
    calls' shapes: every tap of every output of a conv, and the taps of a
    transposed conv that land inside its output."""
    total = []

    def hook(module, inputs, output):
        if isinstance(module, torch.nn.ConvTranspose3d):
            size = 1
            for n, out in zip(inputs[0].shape[2:], output.shape[2:]):
                size *= sum(1 for i in range(n) for t in range(3)
                            if 0 <= 2 * i - 1 + t < out)
            total.append(size * module.in_channels * module.out_channels)
        elif isinstance(module, (torch.nn.Conv2d, torch.nn.Conv3d)):
            total.append(output.numel() // output.shape[0]
                         * module.weight[0].numel())

    handles = [module.register_forward_hook(hook)
               for module in network.modules()]
    psmnet.infer(network, left, right, CONFIG, device="cpu")
    for handle in handles:
        handle.remove()
    return sum(total)


def test_useful_macs_count_the_port_convs():
    left, right, _ = _pairs(13, batch=1)
    network = _network(_weights(13), False)
    macs = yardstick.useful_macs(BENCH_CONFIG, "serve")
    assert macs == _hooked_macs(network, left, right)
    forward, first = yardstick.forward_macs(HEIGHT, WIDTH, DISPARITY, POOLS)
    assert first == 2 * (HEIGHT // 2) * (WIDTH // 2) * 27 * 32
    assert yardstick.useful_macs(BENCH_CONFIG, "train") == 3 * forward - first


def test_the_cell_finds_its_yardstick_driver_and_readers():
    cell = registry.cell(WORKLOAD)
    assert cell.chips == 1 and cell.traffic["batch"] == 12
    assert cell.config["architecture"] == "psmnet"
    assert cell.yardstick.__file__ == str(registry.PACKAGE / "architectures"
                                          / "psmnet.py")
    assert cell.driver.__file__ == str(registry.PACKAGE / "drivers" /
                                       "psmnet.py")
    assert [metric["name"] for metric in cell.end_to_end] == [
        "train_images_per_s", "setup_s"]
    names = {metric["name"] for metric in cell.per_layer}
    assert names == {f"{base}.psm_train" for base in (
        "feature_ms", "aggregation_ms", "regression_ms",
        "regression_roofline", "conv3d_roofline", "backward_ms",
        "optimizer_ms", "idle_pct", "mfu_pct", "trainer_idle_ms")}
    assert set(cell.limits["numbers"]) == {
        "loss_gap_first", "gradient_gap", "gradient_gap_median",
        "change_gap_median"}
    # At the published sizes: ~6.6 TMAC a step of 12 (forward ~184 GMAC an
    # example).
    assert 6.5e12 < 12 * yardstick.useful_macs(cell.config, "train") < 6.8e12
    for other in ("ft3d-serve-b1", "kitti-train-b4"):
        assert not {metric["name"] for metric in registry.cell(
            other).per_layer} & names


def _tiny_cell():
    cell = registry.cell(WORKLOAD)
    cell.config.update(BENCH_CONFIG, compute_dtype="float32")
    cell.config["ground_truth"] = dict(cell.config["ground_truth"],
                                       maximum=30.0)
    cell.traffic.update(batch=2, shift_range=[2, 8])
    return cell


@pytest.mark.parametrize("traced", [False, True])
def test_a_tiny_cell_runs_and_is_correct(traced):
    cell = _tiny_cell()
    outcome = run.measure(cell, SEED, 0.3, traced, "cpu",
                          time.perf_counter())
    result = outcome["result"]
    assert result["correct"] is True, outcome["info"]["numbers"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    json.dumps(result)
    if traced:
        metrics = result["metrics"]
        # What a CPU run can read: the hooks' spans (no profiler device
        # time, no peak).
        for base in ("feature_ms", "aggregation_ms", "regression_ms",
                     "regression_roofline", "conv3d_roofline"):
            assert metrics[f"{base}.psm_train"]["value"] > 0, base
    else:
        assert set(result["metrics"]) == {"train_images_per_s", "setup_s"}


@pytest.mark.parametrize("fault", ["unchanged", "altered_loss",
                                   "half_batch"])
def test_a_fault_is_not_correct(fault):
    cell = _tiny_cell()
    assert fault in cell.driver.TRAIN_FAULTS
    with cell.driver.planted(fault):
        outcome = run.measure(cell, SEED, 0.2, False, "cpu",
                              time.perf_counter())
    assert outcome["result"]["correct"] is False, outcome["info"]["numbers"]


def _with_batch_statistics(state: dict, left, right) -> dict:
    """``state`` with each BatchNorm's running statistics set to those of a
    train-mode forward on ``left``, ``right`` (as training would have left
    them), so that eval-mode maps are not the near-uniform softmax that
    running statistics at 0 and 1 give random weights."""
    network = _network(state, True)
    for module in network.modules():
        if isinstance(module, torch.nn.modules.batchnorm._BatchNorm):
            module.momentum = 1.0
    with torch.no_grad():
        psmnet.apply(network, left, right, CONFIG, device="cpu")
    return network.state_dict()


@pytest.mark.parametrize("fault", ["altered_answer", "temperature"])
def test_a_serving_fault_moves_the_map(fault):
    cell = _tiny_cell()
    config = dict(cell.config)
    left, right, _ = _pairs(14)
    state = _with_batch_statistics(cells.make_weights(
        cell.yardstick, config, SEED, "cpu"), left, right)
    predict, _ = cell.driver.serving(config, {"batched_mode": "direct"},
                                     state, "cpu")
    sound = predict(left, right)
    with cell.driver.planted(fault):
        broken = predict(left, right)
    readings = cell.yardstick.serve_readings(
        state, config, {0: left}, {0: right}, {0: sound}, DISPARITY, "cpu")
    numbers = cell.yardstick.serve_numbers(readings)
    assert numbers["map_gap_mean_px"] <= MAP_TOLERANCE_PX
    assert float(np.abs(sound - sound.mean()).mean()) > 0.1
    assert float(np.abs(broken - sound).mean()) > 0.1


def test_gradient_magnitudes_are_the_first_gradient():
    cell = _tiny_cell()
    state = cells.make_weights(cell.yardstick, cell.config, SEED, "cpu")
    training = cell.driver.Training(cell.config, state, "cpu")
    left, right, truth = (torch.as_tensor(array) for array in _pairs(15))
    training.step(left, right, truth)
    first = training.gradient_magnitudes()
    for name, parameter in training.network.named_parameters():
        assert torch.allclose(first[name], parameter.grad, atol=1e-7,
                              rtol=1e-5), name


def _record(calls, kind="train", images=4):
    return Record(kind=kind, window_seconds=1.0, window_images=images,
                  useful_flops_per_image=1e12, peak_flops=None,
                  spans=calls, span_images=images)


def test_regression_roofline_counts_the_heads_bytes():
    reader = registry.reader("regression_roofline")
    cost, disparity = (2, 1, 48, 64, 128), (2, 256, 512)
    assert reader.head_bytes(cost, disparity, False) == 4 * (
        math.prod(cost) + math.prod(disparity))
    assert reader.head_bytes(cost, disparity, True) == 4 * (
        3 * math.prod(cost) + 2 * math.prod(disparity))
    call = {"input_shape": cost, "output_shape": disparity,
            "forward_ms": 1.0, "backward_ms": 3.0}
    least_ms = 1e3 * reader.head_bytes(cost, disparity, True) / 3.35e12
    value = reader.read(_record({"regression_pass": [call, call]}))
    assert value == pytest.approx(100 * least_ms / 4.0)
    without_backward = dict(call)
    del without_backward["backward_ms"]
    assert reader.read(_record({"regression_pass": [without_backward]})
                       ) is None
    assert reader.read(_record({})) is None


@pytest.mark.parametrize("base, span", [
    ("feature_ms", "feature_extraction"), ("aggregation_ms", "aggregation"),
    ("regression_ms", "regression")])
def test_stage_readers_sum_forward_ms_per_image(base, span):
    reader = registry.reader(base)
    calls = [{"forward_ms": 2.0}, {"forward_ms": 6.0}]
    assert reader.read(_record({span: calls})) == pytest.approx(2.0)
    assert reader.read(_record({})) is None
    network = psmnet.PsmNetwork(CONFIG)
    ((name, selector),) = reader.SPANS.items()
    chosen = [path for path, module in network.named_modules()
              if (path == selector if isinstance(selector, str)
                  else selector(path, module))]
    assert chosen == {"feature_ms": ["feature_extraction"],
                      "aggregation_ms": ["dres0", "dres1", "dres2", "dres3",
                                         "dres4", "classif1", "classif2",
                                         "classif3"],
                      "regression_ms": ["regression"]}[base]
