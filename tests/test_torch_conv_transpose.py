"""PyTorch port, K3 and K4 (the transposed 3-D convs, forward and input
gradient): the plain versions, the wrappers on CPU tensors and the autograd
Function against the JAX package's phased functions
(``folded_banded.conv_transpose3d_folded_phased``,
``anisotropic_fullsize_transpose_phased``) and their dense lhs-dilated
counterparts (``folded3d.conv_transpose3d_folded``,
``anisotropic_fullsize_transpose``) on numpy-seeded inputs and weights,
carried into JAX through the weight bridge and ``folded3d.fold``.

Float32 on the CPU; every comparison is within 1e-5 of the largest element
of the expected tensor: the functions are the same and only the order of
summation differs.

The CUDA kernels' gather scheme (per 2 x 2 block of outputs, the taps of
each output's phase and the window of inputs they reach, for any padding;
per 2 x 2 block of input-gradient positions, the window of output gradients
their taps reach) is modelled in numpy and held to the plain versions, so
that the tap arithmetic of ``csrc/conv_transpose3d.cu`` is checked here;
the card holds the kernels to the plain versions (``chip_smoke.py`` phase
2)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from practicaldeepstereo_nips2018_tpu.ops import folded3d, folded_banded
from practicaldeepstereo_nips2018_tpu.training import torch_import
from practicaldeepstereo_nips2018_tpu_torch.models import blocks
from practicaldeepstereo_nips2018_tpu_torch.ops import (
    conv_transpose3d, kernels)
from practicaldeepstereo_nips2018_tpu_torch.parallel import sharding

torch.set_num_threads(1)

ISOTROPIC = ((4, 4, 4), (2, 2, 2), (1, 1, 1))
FULLSIZE = ((3, 4, 4), (1, 2, 2), (1, 1, 1))
# (depth, cin, cout): small versions of the hourglass's 4x4x4 upsamplers.
LEVELS = [(6, 8, 4), (3, 16, 8), (2, 128, 64)]


def _case(depth, cin, cout, kernel, height=5, width=6, batch=2, seed=0):
    """Port-layout x [B, cin, D, H, W], weight [cin, cout, *kernel] and
    bias, drawn with numpy (U(+-1/sqrt(fan_in)) for the weights)."""
    rng = np.random.RandomState(seed)
    bound = 1.0 / np.sqrt(cout * np.prod(kernel))
    x = rng.uniform(-1, 1, (batch, cin, depth, height, width))
    weight = rng.uniform(-bound, bound, (cin, cout, *kernel))
    bias = rng.uniform(-bound, bound, cout)
    return [array.astype(np.float32) for array in (x, weight, bias)]


def _jax_params(weight, bias):
    """The bridge's JAX params of a port transposed conv (flip and
    ``[*k, in, out]``)."""
    return {key: jnp.asarray(value) for key, value in
            torch_import._conv_transpose_nd({"conv.weight": weight,
                                             "conv.bias": bias},
                                            "conv").items()}


def _fold(x):
    """Port [B, C, D, H, W] -> JAX folded [B, H, W, D*C]."""
    return folded3d.fold(jnp.asarray(np.moveaxis(np.asarray(x), 1, -1)))


def _unfold(folded, depth):
    """JAX folded [B, H, W, D*C] -> port [B, C, D, H, W]."""
    return np.moveaxis(np.asarray(folded3d.unfold(folded, depth)), -1, 1)


def _jax_forward(kind, params, folded, depth):
    """(phased, dense) JAX outputs in the port's layout."""
    if kind == "isotropic":
        phased = folded_banded.conv_transpose3d_folded_phased(
            params, folded, depth)
        dense, depth_out = folded3d.conv_transpose3d_folded(params, folded,
                                                            depth)
        return _unfold(phased, depth_out), _unfold(dense, depth_out)
    phased = folded_banded.anisotropic_fullsize_transpose_phased(
        params, folded, depth)
    dense = folded3d.anisotropic_fullsize_transpose(params, folded, depth)
    return (np.moveaxis(np.asarray(phased), -1, 1)[:, None],
            np.moveaxis(np.asarray(dense), -1, 1)[:, None])


def _close(got, expected):
    got, expected = np.asarray(got), np.asarray(expected)
    assert got.shape == expected.shape
    np.testing.assert_allclose(got, expected,
                               atol=1e-5 * np.abs(expected).max(), rtol=0)


def _port_forward(x, weight, bias, geometry, plain):
    _, stride, padding = geometry
    function = (conv_transpose3d.conv_transpose3d_plain if plain
                else conv_transpose3d.conv_transpose3d)
    return function(torch.from_numpy(x), torch.from_numpy(weight),
                    torch.from_numpy(bias), stride, padding).numpy()


@pytest.mark.parametrize("plain", [True, False], ids=["plain", "wrapper"])
@pytest.mark.parametrize("depth,cin,cout", LEVELS)
def test_forward_matches_jax_phased_and_dense(depth, cin, cout, plain):
    x, weight, bias = _case(depth, cin, cout, ISOTROPIC[0])
    phased, dense = _jax_forward("isotropic", _jax_params(weight, bias),
                                 _fold(x), depth)
    got = _port_forward(x, weight, bias, ISOTROPIC, plain)
    _close(got, phased)
    _close(got, dense)


@pytest.mark.parametrize("plain", [True, False], ids=["plain", "wrapper"])
def test_fullsize_forward_matches_jax_phased_and_dense(plain):
    x, weight, bias = _case(12, 4, 1, FULLSIZE[0], seed=1)
    phased, dense = _jax_forward("fullsize", _jax_params(weight, bias),
                                 _fold(x), 12)
    got = _port_forward(x, weight, bias, FULLSIZE, plain)
    _close(got, phased)
    _close(got, dense)


@pytest.mark.parametrize("kind,depth,cin,cout", [
    ("isotropic", 6, 8, 4), ("isotropic", 2, 128, 64), ("fullsize", 12, 4, 1)])
def test_gradients_match_jax_vjp_of_the_phased_functions(kind, depth, cin,
                                                         cout):
    geometry = ISOTROPIC if kind == "isotropic" else FULLSIZE
    x, weight, bias = _case(depth, cin, cout, geometry[0], seed=2)
    params = _jax_params(weight, bias)
    folded = _fold(x)
    if kind == "isotropic":
        def function(params, folded):
            return folded_banded.conv_transpose3d_folded_phased(
                params, folded, depth)
    else:
        def function(params, folded):
            return folded_banded.anisotropic_fullsize_transpose_phased(
                params, folded, depth)
    output, vjp = jax.vjp(function, params, folded)
    cotangent = np.random.RandomState(3).normal(size=output.shape).astype(
        np.float32)
    jax_params_grad, jax_folded_grad = vjp(jnp.asarray(cotangent))

    # The same cotangent in the port's layout.
    if kind == "isotropic":
        grad_output = _unfold(jnp.asarray(cotangent), 2 * depth)
    else:
        grad_output = np.moveaxis(cotangent, -1, 1)[:, None]
    leaves = [torch.from_numpy(array).requires_grad_()
              for array in (x, weight, bias)]
    result = conv_transpose3d.ConvTranspose3dK3.apply(*leaves, *geometry[1:])
    assert tuple(result.shape) == grad_output.shape
    result.backward(torch.from_numpy(np.ascontiguousarray(grad_output)))
    grad_x, grad_weight, grad_bias = (leaf.grad.numpy() for leaf in leaves)

    _close(grad_x, _unfold(jax_folded_grad, depth))
    # The port's weight gradient through the bridge's (linear) layout map.
    bridged = torch_import._conv_transpose_nd(
        {"conv.weight": grad_weight, "conv.bias": grad_bias}, "conv")
    _close(bridged["w"], jax_params_grad["w"])
    _close(bridged["b"], jax_params_grad["b"])


@pytest.mark.parametrize("kind", ["isotropic", "fullsize"])
def test_w_sliced_form_gives_the_unsliced_columns(kind):
    """A W-slice with its halo (zeros past the image's edges) and the W
    padding widened by the dropped columns, as ``blocks.ConvTranspose3d``
    runs it under the volume axis, gives the unsliced conv's columns."""
    geometry = ISOTROPIC if kind == "isotropic" else FULLSIZE
    depth, cin, cout = (4, 8, 4) if kind == "isotropic" else (6, 4, 1)
    x, weight, bias = _case(depth, cin, cout, geometry[0], width=10, seed=4)
    phased, dense = _jax_forward(kind, _jax_params(weight, bias), _fold(x),
                                 depth)
    _close(phased, dense)
    left, right, drop = sharding.transposed_conv_halo(4, 2, 1)
    assert (left, right, drop) == (1, 1, 2)
    padded = np.pad(x, [(0, 0)] * 4 + [(left, right)])
    padding = geometry[2][:2] + (geometry[2][2] + drop,)
    for first, end in ((0, 4), (4, 7), (7, 10)):
        haloed = np.ascontiguousarray(padded[..., first:end + left + right])
        got = _port_forward(haloed, weight, bias,
                            (geometry[0], geometry[1], padding), plain=False)
        _close(got, phased[..., 2 * first:2 * end])


def _window_index(a, j):
    """The window element (0, 1, 2 = m - 1, m, m + 1) that output ``a`` of
    a pair takes through its ``j``-th tap (``csrc/conv_transpose3d.cu``)."""
    return 1 - j if a == 0 else 2 - j


def _tap_index(a, j):
    return 1 + 2 * j if a == 0 else 2 * j


def _masked(values, index_h, index_w):
    """``values[..., h, w]`` at the given indices, 0 outside."""
    height, width = values.shape[-2:]
    inside = ((index_h >= 0) & (index_h < height))[:, None] & (
        (index_w >= 0) & (index_w < width))[None, :]
    gathered = values[..., np.clip(index_h, 0, height - 1), :][
        ..., np.clip(index_w, 0, width - 1)]
    return np.where(inside, gathered, 0.0)


def _gather_forward(x, weight, bias, stride, padding):
    """K3's scheme in numpy: per output depth the depth taps of its phase
    (as the kernel stages them); per thread a 2 x 2 block of outputs, each
    pair starting where ``o + pad`` is odd (so at -1 for an even pad), its
    outputs reading the 3-input window ``m - 1 .. m + 1``, ``m = (o + pad -
    1) / 2``, through the taps of :func:`_window_index` and
    :func:`_tap_index`; outputs outside the volume dropped. Float64 sums
    (the kernel's order, not its rounding)."""
    batch, cin, depth = x.shape[:3]
    _, cout, kd = weight.shape[:3]
    sd = stride[0]
    depth_out, height_out, width_out = conv_transpose3d.output_shape(
        x.shape, weight.shape, stride, padding)[2:]
    shift_h, shift_w = 1 - padding[1] % 2, 1 - padding[2] % 2
    oh = 2 * np.arange(height_out // 2 + shift_h) - shift_h
    ow = 2 * np.arange(width_out // 2 + shift_w) - shift_w
    mh, mw = (oh + padding[1] - 1) // 2, (ow + padding[2] - 1) // 2
    y = np.zeros((batch, cout, depth_out, height_out, width_out))
    for od in range(depth_out):
        ed = od + padding[0]
        td0 = ed % sd
        for jd in range(kd // sd):
            i_d = (ed - td0) // sd - jd
            if not 0 <= i_d < depth:
                continue
            for a in range(2):
                for e in range(2):
                    block = 0.0
                    for jh in range(2):
                        for jw in range(2):
                            values = _masked(
                                x[:, :, i_d], mh - 1 + _window_index(a, jh),
                                mw - 1 + _window_index(e, jw))
                            taps = weight[:, :, td0 + sd * jd,
                                          _tap_index(a, jh),
                                          _tap_index(e, jw)]
                            block = block + np.einsum("bihw,io->bohw",
                                                      values, taps)
                    rows, columns = oh + a, ow + e
                    keep_h = (rows >= 0) & (rows < height_out)
                    keep_w = (columns >= 0) & (columns < width_out)
                    y[:, :, od, rows[keep_h][:, None],
                      columns[keep_w][None, :]] += block[
                          :, :, keep_h][..., keep_w]
    return y + bias[None, :, None, None, None]


def _gather_input_grad(grad_y, weight, input_shape, stride, padding):
    """K4's scheme in numpy: per thread a 2 x 2 block of input positions
    ``2q + u``, reading the 6 x 6 window of output rows and columns ``2 *
    2q - pad + r``, ``r = t + 2u`` for each tap ``t``; positions past an odd
    edge dropped."""
    batch, cin, depth, height, width = input_shape
    _, cout, kd = weight.shape[:3]
    depth_out = grad_y.shape[2]
    ih0 = 2 * np.arange((height + 1) // 2)
    iw0 = 2 * np.arange((width + 1) // 2)
    grad_x = np.zeros(input_shape)
    for i_d in range(depth):
        for td in range(kd):
            od = stride[0] * i_d - padding[0] + td
            if not 0 <= od < depth_out:
                continue
            for u in range(2):
                for e in range(2):
                    block = 0.0
                    for th in range(4):
                        for tw in range(4):
                            values = _masked(
                                grad_y[:, :, od],
                                2 * ih0 - padding[1] + th + 2 * u,
                                2 * iw0 - padding[2] + tw + 2 * e)
                            block = block + np.einsum(
                                "bohw,io->bihw", values,
                                weight[:, :, td, th, tw])
                    rows, columns = ih0 + u, iw0 + e
                    keep_h, keep_w = rows < height, columns < width
                    grad_x[:, :, i_d, rows[keep_h][:, None],
                           columns[keep_w][None, :]] += block[
                               :, :, keep_h][..., keep_w]
    return grad_x


@pytest.mark.parametrize("kernel,stride,padding,shape", [
    ((4, 4, 4), (2, 2, 2), (1, 1, 1), (2, 8, 3, 4, 5)),
    ((4, 4, 4), (2, 2, 2), (1, 1, 3), (1, 6, 3, 4, 6)),
    ((3, 4, 4), (1, 2, 2), (1, 1, 1), (1, 4, 5, 3, 4)),
    ((3, 4, 4), (1, 2, 2), (1, 1, 3), (1, 4, 5, 3, 6)),
    ((4, 4, 4), (2, 2, 2), (0, 2, 0), (1, 3, 2, 4, 3)),
    ((3, 4, 4), (1, 2, 2), (2, 0, 2), (1, 2, 5, 5, 7)),
])
def test_kernel_gather_scheme_matches_the_plain_versions(kernel, stride,
                                                         padding, shape):
    rng = np.random.RandomState(5)
    x = rng.normal(size=shape)
    weight = rng.normal(size=(shape[1], 3, *kernel))
    bias = rng.normal(size=3)
    plain = conv_transpose3d.conv_transpose3d_plain(
        torch.from_numpy(x), torch.from_numpy(weight), torch.from_numpy(bias),
        stride, padding).numpy()
    np.testing.assert_allclose(_gather_forward(x, weight, bias, stride,
                                               padding), plain, atol=1e-10)
    grad_y = rng.normal(size=plain.shape)
    plain_grad = conv_transpose3d.conv_transpose3d_input_grad_plain(
        torch.from_numpy(grad_y), torch.from_numpy(weight), stride,
        padding).numpy()
    assert plain_grad.shape == shape
    np.testing.assert_allclose(
        _gather_input_grad(grad_y, weight, shape, stride, padding),
        plain_grad, atol=1e-10)


def test_plain_versions_round_once_in_bfloat16():
    """bfloat16 values: float32 arithmetic and one rounding, so the plain
    forward is the float32 result of the same bfloat16 values rounded."""
    x, weight, bias = (torch.from_numpy(array) for array in _case(
        3, 8, 4, ISOTROPIC[0], seed=6))
    x16, weight16 = x.bfloat16(), weight.bfloat16()
    got = conv_transpose3d.conv_transpose3d_plain(x16, weight16, bias,
                                                  *ISOTROPIC[1:])
    expected = conv_transpose3d.conv_transpose3d_plain(
        x16.float(), weight16.float(), bias, *ISOTROPIC[1:]).bfloat16()
    assert got.dtype == torch.bfloat16 and torch.equal(got, expected)


def test_wrappers_refuse_other_devices():
    x = torch.zeros((1, 4, 2, 3, 3), device="meta")
    weight = torch.zeros((4, 2, 4, 4, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device meta"):
        conv_transpose3d.conv_transpose3d(x, weight, torch.zeros(
            2, device="meta"), *ISOTROPIC[1:])
    with pytest.raises(ValueError, match="unsupported device meta"):
        conv_transpose3d.conv_transpose3d_input_grad(
            torch.zeros((1, 2, 4, 6, 6), device="meta"), weight,
            *ISOTROPIC[1:], x.shape)


@pytest.mark.parametrize("change,error,match", [
    ("float64", TypeError, "must share float32 or bfloat16"),
    ("weight_dtype", TypeError, "must share float32 or bfloat16"),
    ("strided", ValueError, "x must be contiguous"),
    ("kernel", ValueError, "takes depth kernel and stride"),
    ("stride", ValueError, "takes depth kernel and stride"),
    ("padding", ValueError, "negative padding"),
])
def test_argument_checks_refuse_what_the_kernels_do_not_take(change, error,
                                                             match):
    x = torch.zeros((1, 4, 2, 3, 6))
    weight = torch.zeros((4, 2, 4, 4, 4))
    stride, padding = (2, 2, 2), (1, 1, 1)
    if change == "float64":
        x, weight = x.double(), weight.double()
    elif change == "weight_dtype":
        weight = weight.bfloat16()
    elif change == "strided":
        x = x[..., ::2]
    elif change == "kernel":
        weight = torch.zeros((4, 2, 3, 4, 4))
    elif change == "stride":
        stride = (2, 1, 2)
    else:
        padding = (1, -1, 1)
    with pytest.raises(error, match=match):
        conv_transpose3d.check_arguments(conv_transpose3d.NAME, x, weight,
                                         stride, padding, {"x": x})


def test_block_runs_the_function_and_counts_no_launch_on_the_cpu():
    """``blocks.ConvTranspose3d`` goes through ``ConvTranspose3dK3`` with a
    float32 bias; on the CPU the plain versions count no launch."""
    torch.manual_seed(0)
    module = blocks.ConvTranspose3d(8, 4, 4, 2, 1)
    x = torch.randn((1, 8, 3, 4, 5), requires_grad=True)
    kernels.launch_counts.clear()
    y = module(x)
    assert y.grad_fn.name().startswith("ConvTranspose3dK3")
    y.sum().backward()
    assert not kernels.launch_counts
    with torch.no_grad():
        expected = torch.nn.functional.conv_transpose3d(
            x, module.weight, module.bias, 2, 1)
    np.testing.assert_allclose(y.detach().numpy(), expected.numpy(),
                               atol=1e-5 * float(expected.abs().max()))
