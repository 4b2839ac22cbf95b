"""PyTorch port, K6 (PSMNet's BatchNorm): its plain version, which repeats
the kernels' arithmetic (chunked moments merged with Chan's formula, the
chunks' gradient sums), against float64 ``F.batch_norm`` and its autograd,
in train and eval mode, 2-D and 3-D, at sizes that do not divide into
chunks and at batch 1 and 12; the running statistics against
``nn.BatchNorm``'s after two steps; the chunk plan; the wrapper's checks,
which run before anything touches a card; and PSMNet's modules: the
published state_dict keys, 85 K6 modules run 145 times a train step.

The CUDA kernels run only on a card: ``chip_smoke.py`` phase 2 holds them
against the plain version there at PSMNet's shapes."""

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from practicaldeepstereo_nips2018_tpu_torch import models
from practicaldeepstereo_nips2018_tpu_torch.models import psmnet
from practicaldeepstereo_nips2018_tpu_torch.ops import batch_norm
from practicaldeepstereo_nips2018_tpu_torch.training import (
    optimizer, trainer)

torch.set_num_threads(1)

# [N, C, *spatial]: 2-D and 3-D, batch 1 and 12, odd sizes, and rows of
# several chunks with a ragged last one (20000 elements: two bfloat16
# chunks of at most 16384, three float32 ones of at most 8192).
SHAPES = [(1, 3, 7, 9), (12, 4, 5, 7), (1, 2, 3, 5, 7), (12, 3, 2, 3, 5),
          (2, 2, 20000), (12, 2, 1, 1)]
DTYPES = [torch.float32, torch.bfloat16]
MODES = [True, False]
EPS = 1e-5


def _ulp(dtype) -> float:
    return 2 ** -8 if dtype == torch.bfloat16 else 2 ** -20


def _inputs(shape, dtype, seed, mean=0.5):
    generator = torch.Generator().manual_seed(seed)
    channels = shape[1]
    x = (torch.randn(shape, generator=generator) * 3 + mean).to(dtype)
    weight = 1 + 0.3 * torch.randn(channels, generator=generator)
    bias = torch.randn(channels, generator=generator)
    running_mean = torch.randn(channels, generator=generator)
    running_var = 0.5 + torch.rand(channels, generator=generator)
    return x, weight, bias, running_mean, running_var


def _float64_reference(x, weight, bias, running_mean, running_var,
                       training, grad=None):
    """``F.batch_norm`` in float64 on the same values: ``y``, and with
    ``grad`` the gradients of x, weight and bias."""
    leaves = [t.double().requires_grad_() for t in (x, weight, bias)]
    y = F.batch_norm(leaves[0], running_mean.double(), running_var.double(),
                     leaves[1], leaves[2], training, 0.1, EPS)
    if grad is None:
        return y.detach()
    y.backward(grad.double())
    return y.detach(), [leaf.grad for leaf in leaves]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("training", MODES, ids=["train", "eval"])
def test_forward_matches_float64(shape, dtype, training):
    """``y`` within one rounding of the dtype of float64's, plus a few
    float32 roundings of the terms it sums."""
    x, weight, bias, running_mean, running_var = _inputs(shape, dtype, 0)
    y, saved = batch_norm.batch_norm_plain(
        x, weight, bias, running_mean.clone(), running_var.clone(), None,
        training, 0.1, EPS)
    expected = _float64_reference(x, weight, bias, running_mean,
                                  running_var, training)
    assert y.dtype == dtype and y.shape == x.shape
    assert saved.shape == (shape[1], 2) and saved.dtype == torch.float32
    shape_c = (1, -1) + (1,) * (x.ndim - 2)
    terms = (x.double().abs() * (weight.double() * saved[:, 1].double()
                                 ).abs().view(shape_c)
             + bias.double().abs().view(shape_c))
    gap = (y.double() - expected).abs()
    assert bool((gap <= _ulp(dtype) * expected.abs()
                 + 2 ** -20 * (terms + 1)).all())


def _backward_terms(grad, x_hat, weight, rstd, shape_c):
    """The magnitude of the terms ``dx`` sums, in float64."""
    dims = (0,) + tuple(range(2, grad.ndim))
    dy = grad.double().abs()
    return (weight.double().abs() * rstd).view(shape_c) * (
        dy + dy.mean(dims, keepdim=True)
        + x_hat.abs() * (dy * x_hat.abs()).mean(dims, keepdim=True))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("training", MODES, ids=["train", "eval"])
def test_backward_matches_float64_autograd(shape, dtype, training):
    """``BatchNorm``'s plain path: ``dx`` within one rounding of the dtype
    of float64 autograd's plus a few float32 roundings of the terms it
    sums; ``dweight`` and ``dbias`` within 1e-5 of their largest element,
    as ``chip_smoke.py`` holds K6's."""
    x, weight, bias, running_mean, running_var = _inputs(shape, dtype, 1)
    grad = (torch.randn(shape, generator=torch.Generator().manual_seed(2))
            + 0.5 + 0.25 * x.float()).to(dtype)
    leaves = [x.clone().requires_grad_(), weight.clone().requires_grad_(),
              bias.clone().requires_grad_()]
    y = batch_norm.batch_norm(*leaves, running_mean.clone(),
                              running_var.clone(), None, training, 0.1, EPS)
    assert type(y.grad_fn).__name__ == "BatchNormBackward"
    y.backward(grad)
    _, exact = _float64_reference(x, weight, bias, running_mean, running_var,
                                  training, grad)
    assert leaves[0].grad.dtype == dtype
    dims = (0,) + tuple(range(2, x.ndim))
    shape_c = (1, -1) + (1,) * (x.ndim - 2)
    x64 = x.double()
    if training:
        variance, mean = torch.var_mean(x64, dims, correction=0,
                                        keepdim=True)
    else:
        mean = running_mean.double().view(shape_c)
        variance = running_var.double().view(shape_c)
    rstd = torch.rsqrt(variance + EPS)
    terms = _backward_terms(grad, (x64 - mean) * rstd, weight,
                            rstd.flatten(), shape_c)
    gap = (leaves[0].grad.double() - exact[0]).abs()
    assert bool((gap <= _ulp(dtype) * exact[0].abs()
                 + 2 ** -20 * 8 * terms + 1e-12).all())
    for got, expected in zip((leaves[1].grad, leaves[2].grad), exact[1:]):
        assert float((got.double() - expected).abs().max()) <= (
            1e-5 * float(expected.abs().max()))


@pytest.mark.parametrize("training", MODES, ids=["train", "eval"])
@pytest.mark.parametrize("shape", [(3, 2, 4, 5), (2, 3, 2, 3, 4)], ids=str)
def test_the_function_gradchecks_in_float64(training, shape):
    """``BatchNorm``'s plain path against finite differences, every input
    that takes a gradient."""
    generator = torch.Generator().manual_seed(0)

    def leaf(*size):
        return torch.randn(size, generator=generator,
                           dtype=torch.float64).requires_grad_()

    channels = shape[1]
    x = leaf(*shape)
    weight = (1 + 0.3 * leaf(channels)).detach().requires_grad_()
    bias = leaf(channels)
    running_mean = torch.zeros(channels, dtype=torch.float64)
    running_var = torch.ones(channels, dtype=torch.float64)
    assert torch.autograd.gradcheck(
        lambda *inputs: batch_norm.BatchNorm.apply(
            *inputs, running_mean, running_var, None, training, 0.0, EPS),
        (x, weight, bias))


@pytest.mark.parametrize("dimensions", [2, 3])
@pytest.mark.parametrize("momentum", [0.1, None], ids=["0.1", "cumulative"])
@pytest.mark.parametrize("batch", [1, 12])
def test_running_statistics_after_two_steps(dimensions, momentum, batch):
    """A K6 module's running mean and variance (unbiased) and
    ``num_batches_tracked`` after two train-mode steps, as
    ``nn.BatchNorm``'s in float64; then its eval-mode output on them."""
    kind = {2: (psmnet.BatchNorm2d, nn.BatchNorm2d),
            3: (psmnet.BatchNorm3d, nn.BatchNorm3d)}[dimensions]
    ours, theirs = kind[0](4, momentum=momentum), kind[1](
        4, momentum=momentum).double()
    ours.load_state_dict(theirs.state_dict())
    shape = (batch, 4) + (5, 7, 3)[:dimensions]
    for seed in (0, 1):
        x = _inputs(shape, torch.float32, seed, mean=20.0)[0]
        ours(x)
        theirs(x.double())
    for name in ("running_mean", "running_var"):
        got, expected = getattr(ours, name), getattr(theirs, name)
        assert got.dtype == torch.float32
        assert torch.allclose(got.double(), expected, rtol=1e-5, atol=1e-6)
    assert int(ours.num_batches_tracked) == 2
    ours.eval(), theirs.eval()
    x = _inputs(shape, torch.float32, 2, mean=20.0)[0]
    assert torch.allclose(ours(x).double(), theirs(x.double()), rtol=1e-5,
                          atol=1e-5)


def test_moments_stand_a_large_mean():
    """Chan's merge of the chunks' (mean, M2) keeps a variance of 1 under a
    mean of 1000 in float32, where ``E[x^2] - E[x]^2`` loses it; rows of
    several chunks."""
    x = torch.randn((3, 2, 40000), generator=torch.Generator().manual_seed(
        0)) + 1000
    mean, variance = batch_norm.batch_moments_plain(x)
    expected_var, expected_mean = torch.var_mean(x.double(), (0, 2),
                                                 correction=0)
    assert torch.allclose(mean.double(), expected_mean, rtol=1e-6)
    assert torch.allclose(variance.double(), expected_var, rtol=1e-4)
    squares = (x * x).mean((0, 2)) - x.mean((0, 2)) ** 2
    assert float((squares.double() - expected_var).abs().max()) > 1e-2


@pytest.mark.parametrize("length", [1, 2, 7, 2048, 6144, 16384, 16385,
                                    393216, 20000])
@pytest.mark.parametrize("element_size,vector", [(2, 1), (2, 8), (4, 1),
                                                 (4, 4)])
def test_plan_covers_each_row(length, element_size, vector):
    """Every element of a row in exactly one chunk: whole vectors a
    thread, at most 32 KB a chunk, as few chunks as that allows."""
    chunk, chunks = batch_norm.plan(length, element_size, vector)
    largest = batch_norm.THREADS * batch_norm.BYTES_PER_THREAD // element_size
    assert chunk % (batch_norm.THREADS * vector) == 0
    assert chunk <= largest
    assert (chunks - 1) * chunk < length <= chunks * chunk
    assert chunks == -(-length // largest)
    covered = torch.zeros(chunks * chunk, dtype=torch.int32)
    for index in range(chunks):
        covered[index * chunk:min(length, (index + 1) * chunk)] += 1
    assert bool((covered[:length] == 1).all())


def test_cpu_tensors_take_the_plain_version():
    x, weight, bias, running_mean, running_var = _inputs(
        (2, 4, 5, 6), torch.bfloat16, 0)
    with torch.no_grad():
        got = batch_norm.batch_norm(x, weight, bias, running_mean.clone(),
                                    running_var.clone(), None, True)
    assert torch.equal(got, batch_norm.batch_norm_plain(
        x, weight, bias, running_mean.clone(), running_var.clone(), None,
        True, 0.1, EPS)[0])
    assert got.grad_fn is None


@pytest.mark.parametrize("case", ["float64", "no_bias", "weight_shape",
                                  "running_dtype", "strided", "one_running",
                                  "batches_dtype"])
def test_launch_refuses_what_the_kernels_do_not_take(case):
    """The wrapper's checks, which come before any library or card."""
    x = torch.zeros(2, 4, 6, 8, dtype=torch.bfloat16)
    weight, bias = torch.ones(4), torch.zeros(4)
    running_mean, running_var = torch.zeros(4), torch.ones(4)
    batches = torch.zeros((), dtype=torch.int64)
    if case == "float64":
        x = x.double()
    elif case == "no_bias":
        bias = None
    elif case == "weight_shape":
        weight, bias = torch.ones(3), torch.zeros(3)
    elif case == "running_dtype":
        running_mean, running_var = running_mean.double(), running_var.double()
    elif case == "strided":
        x = x.transpose(2, 3)
    elif case == "one_running":
        running_var = None
    else:
        batches = batches.int()
    with pytest.raises((TypeError, ValueError)):
        batch_norm._launch(x, weight, bias, running_mean, running_var,
                           batches, True, 0.1, EPS)


@pytest.mark.parametrize("case", ["one_value", "eval_without_statistics",
                                  "flat"])
def test_forward_refuses_what_batch_norm_does_not_define(case):
    x = torch.zeros(4, 3, 1, 1)
    running = (torch.zeros(3), torch.ones(3))
    training = True
    if case == "one_value":
        x = torch.zeros(1, 3, 1, 1)
    elif case == "eval_without_statistics":
        running, training = (None, None), False
    else:
        x = torch.zeros(4)
    with pytest.raises(ValueError):
        batch_norm._forward(x, None, None, *running, None, training, 0.1,
                            EPS)


@pytest.mark.parametrize("case", ["grad_shape", "grad_dtype",
                                  "strided_grad"])
def test_backward_launch_refuses_what_the_kernels_do_not_take(case):
    x = torch.zeros(2, 4, 6, 8, dtype=torch.bfloat16)
    grad = torch.zeros_like(x)
    if case == "grad_shape":
        grad = torch.zeros(2, 4, 6, 7, dtype=torch.bfloat16)
    elif case == "grad_dtype":
        grad = grad.float()
    else:
        grad = torch.zeros(2, 4, 8, 6, dtype=torch.bfloat16).transpose(2, 3)
    with pytest.raises(ValueError):
        batch_norm._launch_backward(grad, x, torch.ones(4),
                                    torch.zeros(4, 2), True)


# -- PSMNet's modules ----------------------------------------------------------

CONFIG = psmnet.PSMConfig(maximum_disparity=32, pyramid_pools=(16, 8, 4, 2))


def _kernel_modules(network):
    return [module for module in network.modules()
            if isinstance(module, (psmnet.BatchNorm2d, psmnet.BatchNorm3d))]


def _with_library_norms(network):
    """``network`` with each K6 module swapped for the ``nn.BatchNorm`` of
    its width and kind, as the published code builds it."""
    for name, module in list(network.named_modules()):
        for child_name, child in list(module.named_children()):
            if isinstance(child, psmnet.BatchNorm2d):
                setattr(module, child_name, nn.BatchNorm2d(
                    child.num_features))
            elif isinstance(child, psmnet.BatchNorm3d):
                setattr(module, child_name, nn.BatchNorm3d(
                    child.num_features))
    return network


def test_published_state_dict_round_trips():
    """The K6 modules keep ``nn.BatchNorm``'s keys: a state_dict of the
    published layout loads into the port and comes back bit-equal, with
    the same key set."""
    torch.manual_seed(0)
    published = _with_library_norms(psmnet.PsmNetwork(CONFIG))
    for module in published.modules():
        if isinstance(module, nn.modules.batchnorm._BatchNorm):
            with torch.no_grad():
                module.running_mean.normal_()
                module.running_var.uniform_(0.5, 1.5)
                module.num_batches_tracked.fill_(7)
    state = published.state_dict()
    network = psmnet.PsmNetwork(CONFIG)
    network.load_state_dict(state)
    again = network.state_dict()
    assert list(again) == list(state)
    assert "dres2.conv5.1.running_var" in again
    assert "feature_extraction.layer2.0.downsample.1.num_batches_tracked" in (
        again)
    assert all(torch.equal(again[key], value) for key, value in state.items())


def test_every_norm_of_psmnet_is_k6():
    """85 K6 modules (60 in the tower, 25 in the aggregation), and no other
    BatchNorm; PDS has none."""
    network = psmnet.PsmNetwork(CONFIG)
    norms = [module for module in network.modules()
             if isinstance(module, nn.modules.batchnorm._BatchNorm)]
    assert len(_kernel_modules(network)) == len(norms) == 85
    assert len(_kernel_modules(network.feature_extraction)) == 60
    pds = models.PdsNetwork(models.PDSConfig(maximum_disparity=63))
    assert not any(isinstance(module, nn.modules.batchnorm._BatchNorm)
                   for module in pds.modules())


def _counted(monkeypatch):
    """Counts the calls into K6's forward and backward entry points."""
    calls = {"forward": 0, "backward": 0}
    forward, backward = batch_norm._forward, batch_norm.batch_norm_backward

    def counted_forward(*args, **kwargs):
        calls["forward"] += 1
        return forward(*args, **kwargs)

    def counted_backward(*args, **kwargs):
        calls["backward"] += 1
        return backward(*args, **kwargs)

    monkeypatch.setattr(batch_norm, "_forward", counted_forward)
    monkeypatch.setattr(batch_norm, "batch_norm_backward", counted_backward)
    return calls


def _pair(batch=2, seed=0):
    generator = torch.Generator().manual_seed(seed)
    left = torch.rand((batch, 64, 128, 3), generator=generator) * 255
    truth = torch.rand((batch, 64, 128), generator=generator) * 30
    return left, torch.roll(left, -3, dims=2), truth


def test_a_psmnet_train_step_runs_145_norms_through_k6(monkeypatch):
    """One train step: 145 forwards (the tower's 60 on each view, the
    aggregation's 25) and 145 backwards, each module's running statistics
    moved and counted once; a served pair runs the same 145 forwards in
    eval mode, no backward, the statistics untouched."""
    torch.manual_seed(0)
    network = psmnet.PsmNetwork(CONFIG).train()
    calls = _counted(monkeypatch)
    left, right, truth = _pair()
    trainer.train_step(network, optimizer.adam(network.parameters()), left,
                       right, truth, 1e-3, CONFIG, device="cpu")
    assert calls == {"forward": 145, "backward": 145}
    modules = _kernel_modules(network)
    assert all(int(module.num_batches_tracked) == 2
               if module in _kernel_modules(network.feature_extraction)
               else int(module.num_batches_tracked) == 1
               for module in modules)
    state = {key: value.clone() for key, value in network.state_dict().items()}
    calls.update(forward=0, backward=0)
    network.eval()
    psmnet.infer(network, left[:1], right[:1], CONFIG, device="cpu")
    assert calls == {"forward": 145, "backward": 0}
    assert all(torch.equal(value, state[key])
               for key, value in network.state_dict().items())
