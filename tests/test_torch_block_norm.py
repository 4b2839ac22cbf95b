"""PyTorch port, K5 (a conv block's LeakyReLU, instance norm and residual
add): its plain version against the composition of ``models/blocks.py``
bit for bit, at the shapes of the embedding (2-D), matching (2-D, the
disparities folded into the batch) and regularization (3-D) layers; the
kernel's two passes modelled in torch (chunk moments, Chan's merge) against
float64 moments; its backward's passes modelled in torch against autograd
of the composition, and its autograd Function's plain path under a float64
``gradcheck``; the routing that decides where K5 runs and through what;
and the wrapper's checks, which run before anything touches a card.

The CUDA kernel itself runs only on a card: ``chip_smoke.py`` phase 2
holds it against the plain version there at the main path's shapes."""

import types

import pytest
import torch
from torch import nn

from practicaldeepstereo_nips2018_tpu_torch.models import blocks
from practicaldeepstereo_nips2018_tpu_torch.ops import block_norm
from practicaldeepstereo_nips2018_tpu_torch.parallel import sharding

torch.set_num_threads(1)

# [N, C, *spatial]: 2-D and 3-D, batch 1 and 4, odd lengths, rows shorter
# than one chunk and a row of four chunks (3 * 16384 + 5 elements).
SHAPES = [(1, 64, 9, 15), (4, 8, 5, 7), (1, 3, 7, 9), (2, 8, 3, 5, 7),
          (1, 4, 6, 9, 15), (1, 2, 49157)]
DTYPES = [torch.float32, torch.bfloat16]


def _tensor(shape, dtype, seed):
    generator = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=generator) * 3 + 0.5).to(dtype)


def _norm(channels, affine, seed=1):
    norm = blocks.InstanceNorm(channels if affine else None)
    if affine:
        generator = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            norm.weight.copy_(1 + 0.3 * torch.randn(channels,
                                                    generator=generator))
            norm.bias.copy_(torch.randn(channels, generator=generator))
    return norm


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("affine", [True, False], ids=["affine", "plain"])
@pytest.mark.parametrize("slope", [0.1, None], ids=["leaky", "linear"])
@pytest.mark.parametrize("added", [False, True],
                         ids=["no_residual", "residual"])
def test_plain_equals_the_composition(shape, dtype, affine, slope, added):
    x = _tensor(shape, dtype, 0)
    residual = _tensor(shape, dtype, 2) if added else None
    norm = _norm(shape[1], affine)
    expected = norm(x if slope is None else nn.LeakyReLU(slope)(x))
    if added:
        expected = expected + residual
    with torch.no_grad():
        got = block_norm.block_norm_plain(x, norm.weight, norm.bias, slope,
                                          residual, blocks.INSTANCE_NORM_EPS)
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.equal(got, expected.detach())


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", [(1, 64, 9, 15), (4, 8, 5, 7)], ids=str)
def test_plain_equals_a_residual_block(dtype, shape):
    """``second(first(x)) + x`` of a residual block, from the conv's
    output of its second block."""
    torch.manual_seed(0)
    residual_block = blocks.ResidualBlock(shape[1])
    first, second = residual_block.convolutions
    for block in (first, second):
        block[2].load_state_dict(_norm(shape[1], True).state_dict())
    x = _tensor(shape, dtype, 0)
    with torch.no_grad():
        expected = second(first(x)) + x
        assert torch.equal(residual_block(x), expected)
        norm = second[2]
        got = block_norm.block_norm_plain(
            second[0](first(x)), norm.weight, norm.bias,
            blocks.LEAKY_RELU_SLOPE, x, blocks.INSTANCE_NORM_EPS)
    assert torch.equal(got, expected)


def test_cpu_tensors_take_the_plain_version():
    x = _tensor((2, 4, 5, 6), torch.bfloat16, 0)
    norm = _norm(4, True)
    with torch.no_grad():
        assert torch.equal(
            block_norm.block_norm(x, norm.weight, norm.bias, 0.1, x),
            block_norm.block_norm_plain(x, norm.weight, norm.bias, 0.1, x))


@pytest.mark.parametrize("length", [1, 7, 2048, 11520, 16384, 16385, 34560,
                                    13271040])
@pytest.mark.parametrize("element_size,vector", [(2, 1), (2, 8), (4, 1),
                                                 (4, 4)])
def test_plan_covers_each_row(length, element_size, vector):
    chunk, chunks = block_norm.plan(length, element_size, vector)
    largest = block_norm.THREADS * block_norm.BYTES_PER_THREAD // element_size
    assert chunk % (block_norm.THREADS * vector) == 0
    assert chunk <= largest
    assert (chunks - 1) * chunk < length <= chunks * chunk
    assert chunks == -(-length // largest)


def _chunked_moments(a, chunk, chunks):
    """Per row of the float32 ``[rows, length]`` ``a``: pass 1's chunk means
    and M2 (two passes over the chunk), merged in chunk order with Chan's
    formula as pass 2 merges them."""
    rows = a.shape[0]
    count = torch.zeros(rows)
    mean = torch.zeros(rows)
    m2 = torch.zeros(rows)
    for index in range(chunks):
        part = a[:, index * chunk:(index + 1) * chunk]
        n = float(part.shape[1])
        part_mean = part.sum(dim=1) / n
        part_m2 = ((part - part_mean[:, None]) ** 2).sum(dim=1)
        total = count + n
        delta = part_mean - mean
        share = n / total
        mean = torch.where(count == 0, part_mean, mean + delta * share)
        m2 = torch.where(count == 0, part_m2,
                         m2 + part_m2 + delta * delta * count * share)
        count = total
    return mean, m2


def _rows(x, slope, vector):
    """``x``'s LeakyReLU as float32 ``[rows, length]`` and the kernels'
    ``(chunk, chunks)`` over its rows."""
    rows = x.shape[0] * x.shape[1]
    length = x.numel() // rows
    a = x if slope is None else torch.nn.functional.leaky_relu(x, slope)
    return (a.reshape(rows, length).float(),
            block_norm.plan(length, x.element_size(), vector))


def _kernel_model(x, weight, bias, slope, residual, vector):
    """The CUDA kernel's arithmetic in float32 torch: pass 1's chunk means
    and M2, pass 2's merge of a row's chunks with Chan's formula, its scale
    and offset, one rounding per step."""
    a, (chunk, chunks) = _rows(x, slope, vector)
    length = a.shape[1]
    mean, m2 = _chunked_moments(a, chunk, chunks)
    scale = 1 / torch.sqrt(m2 / length + 1e-5)
    offset = -mean * scale
    if weight is not None:
        channels = weight.repeat(x.shape[0])
        offset = offset * channels + bias.repeat(x.shape[0])
        scale = scale * channels
    y = (a * scale[:, None] + offset[:, None]).to(x.dtype).reshape(x.shape)
    return y if residual is None else y + residual


@pytest.mark.parametrize("shape", [(1, 2, 49157), (2, 3, 40000),
                                   (4, 8, 5, 7)], ids=str)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_chunked_moments_model_the_plain_version(shape, dtype):
    """Chunks and Chan's merge give the plain version's output within one
    rounding of the output dtype (the moments differ in their last bits
    from ``var_mean``'s)."""
    x = _tensor(shape, dtype, 0)
    residual = _tensor(shape, dtype, 2)
    norm = _norm(shape[1], True)
    with torch.no_grad():
        for slope, weight, bias, added in (
                (0.1, norm.weight, norm.bias, None),
                (None, None, None, residual)):
            plain = block_norm.block_norm_plain(x, weight, bias, slope,
                                                added).float()
            vector = 16 // x.element_size()
            model = _kernel_model(x, weight, bias, slope, added,
                                  vector).float()
            scale = 2 * plain.abs() + (0 if added is None
                                       else added.float().abs())
            ulp = 2 ** -7 if dtype == torch.bfloat16 else 2 ** -20
            assert bool(((model - plain).abs() <= scale * ulp + 1e-6).all())


def _backward_model(x, dy, weight, slope, vector):
    """The backward kernels' arithmetic in float32 torch: the forward's
    chunked moments; pass 1's sums of ``dy`` and ``dy * x_hat`` per chunk;
    pass 2's row sums (chunks in order) and ``dx``, rounded once; the
    affine map's gradients as sums over each channel's rows' chunks.
    Returns ``(dx, dweight, dbias)``."""
    a, (chunk, chunks) = _rows(x, slope, vector)
    rows, length = a.shape
    mean, m2 = _chunked_moments(a, chunk, chunks)
    rstd = 1 / torch.sqrt(m2 / length + 1e-5)
    x_hat = (a - mean[:, None]) * rstd[:, None]
    d = dy.reshape(rows, length).float()
    sums = torch.stack([
        torch.stack([part.sum(dim=1), (part * x_hat[:, index * chunk:(
            index + 1) * chunk]).sum(dim=1)], dim=1)
        for index, part in enumerate(d.split(chunk, dim=1))], dim=1)
    total = sums.sum(dim=1)
    scale = rstd if weight is None else rstd * weight.repeat(x.shape[0])
    g = scale[:, None] * (d - (total[:, 0] / length)[:, None]
                          - x_hat * (total[:, 1] / length)[:, None])
    if slope is not None:
        g = torch.where(x.reshape(rows, length).float() > 0, g, g * slope)
    dx = g.to(x.dtype).reshape(x.shape)
    if weight is None:
        return dx, None, None
    channels = sums.reshape(x.shape[0], x.shape[1], chunks, 2).transpose(
        0, 1).reshape(x.shape[1], -1, 2).sum(dim=1)
    return dx, channels[:, 1], channels[:, 0]


@pytest.mark.parametrize("shape", [(1, 2, 49157), (2, 3, 40000),
                                   (4, 8, 5, 7)], ids=str)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("affine", [True, False], ids=["affine", "plain"])
@pytest.mark.parametrize("slope", [0.1, None], ids=["leaky", "linear"])
@pytest.mark.parametrize("added", [False, True],
                         ids=["no_residual", "residual"])
def test_chunked_backward_models_the_composition_gradient(shape, dtype,
                                                          affine, slope,
                                                          added):
    """The backward's chunked sums and fixed-order merges give autograd of
    the composition's gradients: ``dx`` within one rounding of the dtype
    (2 ulp-of-|value| scale, as the forward's test) plus a few float32
    roundings (2^-20) of the magnitude of the terms it sums
    (``block_norm_backward_scale``); ``dweight`` and ``dbias`` within 1e-5
    of their largest element, as ``chip_smoke.py`` holds K5's; the
    residual's gradient is ``dy`` exactly."""
    x = _tensor(shape, dtype, 0)
    dy = _tensor(shape, dtype, 3)
    norm = _norm(shape[1], affine)
    residual = _tensor(shape, dtype, 2).requires_grad_() if added else None
    leaf = x.clone().requires_grad_()
    y = norm(leaf if slope is None else nn.LeakyReLU(slope)(leaf))
    if added:
        y = y + residual
    y.backward(dy)
    with torch.no_grad():
        dx, dweight, dbias = _backward_model(
            x, dy, norm.weight, slope, 16 // x.element_size())
    if added:
        assert torch.equal(residual.grad, dy)
    terms = block_norm.block_norm_backward_scale(
        dy, x, norm.weight.detach() if affine else None, slope)
    ulp = 2 ** -7 if dtype == torch.bfloat16 else 2 ** -20
    expected = leaf.grad.double()
    assert dx.dtype == dtype
    assert bool(((dx.double() - expected).abs()
                 <= ulp * 2 * expected.abs() + 2 ** -20 * terms).all())
    if affine:
        for got, parameter in ((dweight, norm.weight), (dbias, norm.bias)):
            exact = parameter.grad.double()
            assert float((got.double() - exact).abs().max()) <= (
                1e-5 * float(exact.abs().max()))


@pytest.mark.parametrize("affine", [True, False], ids=["affine", "plain"])
@pytest.mark.parametrize("slope", [0.1, None], ids=["leaky", "linear"])
@pytest.mark.parametrize("added", [False, True],
                         ids=["no_residual", "residual"])
def test_the_function_gradchecks_in_float64(affine, slope, added):
    """``BlockNorm``'s plain path (the CPU's forward and backward) against
    finite differences, every input that takes a gradient."""
    generator = torch.Generator().manual_seed(0)

    def leaf(*shape):
        return torch.randn(shape, generator=generator,
                           dtype=torch.float64).requires_grad_()

    x = leaf(2, 3, 5, 7)
    weight = (1 + 0.3 * leaf(3)).detach().requires_grad_() if affine else None
    bias = leaf(3) if affine else None
    residual = leaf(2, 3, 5, 7) if added else None
    assert torch.autograd.gradcheck(
        lambda *inputs: block_norm.BlockNorm.apply(
            inputs[0], inputs[1], inputs[2], slope, inputs[3], 1e-5),
        (x, weight, bias, residual))


def _cuda_like(requires_grad=False):
    """Stands for a CUDA tensor where only the device and the autograd flag
    are read: the predicate alone, on a host without a card."""
    return types.SimpleNamespace(device=torch.device("cuda"),
                                 requires_grad=requires_grad)


def test_runs_block_norm_without_autograd_on_cuda():
    with torch.no_grad():
        assert blocks.runs_block_norm(_cuda_like(), None)
    with torch.inference_mode():
        assert blocks.runs_block_norm(_cuda_like(), None)
    assert blocks.runs_block_norm(_cuda_like(), None)
    assert blocks.runs_block_norm(_cuda_like(True), None)


def _as_on_a_card(monkeypatch):
    """Treats CPU tensors as the card's in :func:`blocks.runs_block_norm`,
    so that K5's plain versions stand in for its kernels."""
    predicate = blocks.runs_block_norm
    monkeypatch.setattr(blocks, "runs_block_norm", lambda x, columns:
                        predicate(_cuda_like(x.requires_grad), columns))


@pytest.mark.parametrize("added", [False, True],
                         ids=["no_residual", "residual"])
def test_a_recorded_call_takes_the_function(monkeypatch, added):
    """On a card, a conv block's tail that autograd records runs through
    K5's Function, with the composition's output; one that records nothing
    is the direct call; the CPU and a W-slice take the composition."""
    block = blocks.conv2d_block(4, 4, 3)
    block[2].load_state_dict(_norm(4, True).state_dict())
    y = _tensor((2, 4, 6, 9), torch.float32, 0)
    residual = _tensor((2, 4, 6, 9), torch.float32, 2) if added else None
    composition = block.tail(y, None, residual)
    assert type(composition.grad_fn).__name__ != "BlockNormBackward"
    sliced = block.tail(y, sharding.whole(9), residual)
    assert type(sliced.grad_fn).__name__ != "BlockNormBackward"
    _as_on_a_card(monkeypatch)
    recorded = block.tail(y, None, residual)
    assert type(recorded.grad_fn).__name__ == "BlockNormBackward"
    assert torch.equal(recorded, composition)
    with torch.no_grad():
        direct = block.tail(y, None, residual)
    assert direct.grad_fn is None and torch.equal(direct, composition)
    assert type(block.tail(y, sharding.whole(9), residual).grad_fn
                ).__name__ != "BlockNormBackward"


def test_runs_no_block_norm_on_a_slice_or_the_cpu():
    columns = sharding.whole(64)
    with torch.no_grad():
        assert not blocks.runs_block_norm(_cuda_like(), columns)
        assert not blocks.runs_block_norm(torch.zeros(1, 8, 4), None)


@pytest.mark.parametrize("case", ["float64", "no_bias", "residual_shape",
                                  "strided", "weight_shape", "flat"])
def test_launch_refuses_what_the_kernel_does_not_take(case):
    """The wrapper's checks, which come before any library or card."""
    x = torch.zeros(2, 4, 6, 8, dtype=torch.bfloat16)
    weight, bias = torch.ones(4), torch.zeros(4)
    residual = None
    if case == "float64":
        x = x.double()
    elif case == "no_bias":
        bias = None
    elif case == "residual_shape":
        residual = torch.zeros(2, 4, 6, 7, dtype=torch.bfloat16)
    elif case == "strided":
        x = x.transpose(2, 3)
    elif case == "weight_shape":
        weight, bias = torch.ones(3), torch.zeros(3)
    else:
        x = torch.zeros(2, 4, dtype=torch.bfloat16)
    with pytest.raises((TypeError, ValueError)):
        block_norm._launch(x, weight, bias, 0.1, residual, 1e-5)


@pytest.mark.parametrize("case", ["grad_shape", "grad_dtype",
                                  "strided_grad"])
def test_backward_launch_refuses_what_the_kernels_do_not_take(case):
    """The backward wrapper's checks, which come before any library or
    card."""
    x = torch.zeros(2, 4, 6, 8, dtype=torch.bfloat16)
    grad = torch.zeros_like(x)
    if case == "grad_shape":
        grad = torch.zeros(2, 4, 6, 7, dtype=torch.bfloat16)
    elif case == "grad_dtype":
        grad = grad.float()
    else:
        grad = torch.zeros(2, 4, 8, 6, dtype=torch.bfloat16).transpose(2, 3)
    with pytest.raises(ValueError):
        block_norm._launch_backward(grad, x, torch.ones(4), 0.1, 1e-5, None)


def _counted_block_norm(monkeypatch):
    """Treats CPU tensors as the card's (:func:`_as_on_a_card`) and counts
    the calls into ``block_norm.block_norm``."""
    calls = []

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return original(*args, **kwargs)

    original = block_norm.block_norm
    _as_on_a_card(monkeypatch)
    monkeypatch.setattr(block_norm, "block_norm", counted)
    return calls


OPTIONS = {"default": {}, "embedding_s2d": {"embedding_s2d": True},
           "factor_tail_conv1": {"factor_tail_conv1": True},
           "matching_tail_int8": {"matching_tail_int8": True}}


@pytest.mark.parametrize("option", OPTIONS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_a_served_image_runs_37_norms_through_k5(monkeypatch, option,
                                                 dtype):
    """One call per norm of the forward (15 embedding, 4 matching, 18
    hourglass), a batch of two as one forward, under every option; the map
    equal to the composition's."""
    from practicaldeepstereo_nips2018_tpu_torch import models

    torch.manual_seed(0)
    config = models.PDSConfig(maximum_disparity=63, **OPTIONS[option])
    network = models.PdsNetwork(config)
    images = torch.rand((2, 2, 64, 64, 3), generator=torch.Generator(
    ).manual_seed(1)) * 255
    expected = models.infer(network, images[0], images[1], config, dtype,
                            "cpu")
    calls = _counted_block_norm(monkeypatch)
    got = models.infer(network, images[0], images[1], config, dtype, "cpu")
    assert len(calls) == 37
    assert torch.equal(got, expected)


def test_a_train_step_runs_every_norm_through_k5(monkeypatch):
    """Where autograd records, every conv block's norm runs K5's forward
    and backward, through its Function: 37 forwards (the 35 conv blocks'
    and the embedding's two input norms, which need no gradient) and 35
    backwards a step; the gradients are the composition's within float32
    rounding."""
    from practicaldeepstereo_nips2018_tpu_torch import models

    torch.manual_seed(0)
    config = models.PDSConfig(maximum_disparity=63)
    network = models.PdsNetwork(config)
    # 128x128: the deepest norm's rows hold 4 elements. (A row of one
    # element has x_hat = 0: its weight's true gradient is 0, which K5
    # gives exactly and the composition as rounding noise.)
    images = torch.rand((2, 1, 128, 128, 3), generator=torch.Generator(
    ).manual_seed(1)) * 255

    def gradients():
        network.zero_grad()
        similarities = models.apply(network, images[0], images[1], config,
                                    device="cpu")
        similarities.backward(torch.randn(
            similarities.shape, generator=torch.Generator().manual_seed(2)))
        return {name: parameter.grad.clone()
                for name, parameter in network.named_parameters()}

    expected = gradients()
    forwards, backwards = [], []
    forward, backward = block_norm._forward, block_norm.block_norm_backward
    _as_on_a_card(monkeypatch)
    monkeypatch.setattr(block_norm, "_forward", lambda *args: (
        forwards.append(tuple(args[0].shape)), forward(*args))[1])
    monkeypatch.setattr(block_norm, "block_norm_backward", lambda *args: (
        backwards.append(tuple(args[1].shape)), backward(*args))[1])
    got = gradients()
    assert len(forwards) == 37 and len(backwards) == 35
    assert forwards.count((1, 3, 128, 128)) == 2
    assert sorted(backwards) == sorted(
        shape for shape in forwards if shape != (1, 3, 128, 128))
    for name, value in expected.items():
        scale = float(value.abs().max())
        assert float((got[name] - value).abs().max()) <= 1e-4 * scale, name
