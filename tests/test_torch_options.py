"""PyTorch port, the ``PDSConfig`` opt-ins against the JAX package, on the
CPU with numpy-seeded weights and inputs:

* ``embedding_s2d``: the phase image and the embedded 3x3 kernel equal the
  JAX package's; the conv equals the 5x5 stride-2 one (float32 atol 1e-4,
  the oracle of ``tests/test_blocks.py``), gradients included;
* ``factor_tail_conv1``: the planes and the unpaired assembly against the
  JAX planes and paired assembly (atol 1e-4 in float32, with the 4x5
  descriptors at D=7 and disparities past the width), and the matching
  stage against ``matching.apply_folded``;
* ``matching_tail_int8``: the int32 sums bit-equal to the JAX package's
  int8 conv on the same int8 operands; the tail equal to JAX's in float64,
  where no upstream rounding noise is left to flip a quantization rounding
  (observed equal; held within 1e-6 of the largest output, against the
  2-4 % a per-disparity activation scale gives); in float32, where the
  two packages' roundings flip some quantization roundings and the flips
  cascade through the small instance norms, every difference within 2 %
  of the largest output (five times inside JAX's own int8-vs-float bound
  of 10 %, ``tests/test_matching.py``; observed up to 1.6 %) and the
  median within 0.1 % (observed up to 0.05 %; a per-disparity scale gives
  0.2-0.5 %); the examples of a batch independent;
* ``remat``: loss and gradients against remat off (loss 1e-6, gradients
  1e-4, ``tests/test_models.py``) and against JAX's remat in float64
  (1e-6 of each tensor's largest, the weight bridge's float32 rounding);
  the K1 launches a train step makes under each policy;
* the network under each option against the JAX network; serving's
  ``"direct"`` and ``"map"`` modes; the trainer's int8 refusal and its
  configuration identity check; an unknown remat policy's message.
"""

import collections
import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from practicaldeepstereo_nips2018_tpu import models as jax_models
from practicaldeepstereo_nips2018_tpu import ops as jax_ops
from practicaldeepstereo_nips2018_tpu.models import embedding as jax_embedding
from practicaldeepstereo_nips2018_tpu.models import matching as jax_matching
from practicaldeepstereo_nips2018_tpu.ops import costvolume as jax_costvolume
from practicaldeepstereo_nips2018_tpu.ops import spacetodepth as jax_s2d
from practicaldeepstereo_nips2018_tpu.training import (
    PDSTrainer as JaxPDSTrainer)
from practicaldeepstereo_nips2018_tpu_torch import models
from practicaldeepstereo_nips2018_tpu_torch.models.matching import Matching
from practicaldeepstereo_nips2018_tpu_torch.ops import (
    conv3d, costvolume, int8, loss, spacetodepth)
from practicaldeepstereo_nips2018_tpu_torch.serving import InferenceSession
from practicaldeepstereo_nips2018_tpu_torch.training import (
    checkpoint, trainer, weights)

torch.set_num_threads(1)

HEIGHT, WIDTH = 40, 120  # padded to 64x128
NARROW = dict(maximum_disparity=63, number_of_embedding_features=16,
              number_of_matching_features=16,
              number_of_embedding_residual_blocks=1,
              number_of_matching_residual_blocks=1)


def _nchw(array):
    return torch.from_numpy(np.ascontiguousarray(array)).permute(0, 3, 1, 2)


def _nhwc(tensor):
    return tensor.detach().permute(0, 2, 3, 1).numpy()


def _network(params, config, dtype=torch.float32):
    network = models.PdsNetwork(config)
    network.load_state_dict(weights.state_dict_from_jax_params(params))
    return network.to(dtype)


def _images(seed, batch=1):
    """float32 images and ground truth (the port takes both as float32)."""
    rng = np.random.RandomState(seed)
    left = rng.uniform(0, 255, (batch, HEIGHT, WIDTH, 3)).astype(np.float32)
    right = rng.uniform(0, 255, (batch, HEIGHT, WIDTH, 3)).astype(np.float32)
    ground_truth = rng.uniform(0, 60, (batch, HEIGHT, WIDTH)).astype(
        np.float32)
    ground_truth[:, :6] = np.inf
    return left, right, ground_truth


@pytest.fixture(scope="module")
def matching_setup():
    params = weights.random_jax_params(
        models.PDSConfig(maximum_disparity=63), seed=3)
    module = Matching()
    module.load_state_dict({
        key[len("_matching."):]: value
        for key, value in weights.state_dict_from_jax_params(params).items()
        if key.startswith("_matching.")})
    return module, params["matching"]


# -- embedding_s2d --------------------------------------------------------


def test_space_to_depth_matches_jax():
    x = np.random.RandomState(0).normal(size=(2, 6, 10, 3)).astype(
        np.float32)
    expected = np.asarray(jax_s2d.space_to_depth(jnp.asarray(x)))
    got = spacetodepth.space_to_depth(_nchw(x))
    assert got.shape == (2, 12, 3, 5)
    np.testing.assert_array_equal(_nhwc(got), expected)


def test_embedded_kernel_matches_jax():
    """The port's ``[cout, 12, 3, 3]`` kernel is JAX's ``[3, 3, 12, cout]``
    one, transposed, value for value."""
    weight = np.random.RandomState(1).normal(size=(5, 5, 3, 64)).astype(
        np.float32)
    expected = np.asarray(jax_s2d.embed_conv5_kernel(jnp.asarray(weight)))
    got = spacetodepth.embed_conv5_kernel(
        torch.from_numpy(weight).permute(3, 2, 0, 1))
    assert got.shape == (64, 12, 3, 3)
    np.testing.assert_array_equal(got.permute(2, 3, 1, 0).numpy(), expected)
    with pytest.raises(ValueError, match="5x5"):
        spacetodepth.embed_conv5_kernel(torch.zeros(4, 3, 3, 3))


@pytest.mark.parametrize("dtype, tolerance", [(torch.float32, 1e-4),
                                              (torch.float64, 1e-10)])
def test_s2d_conv_and_gradients_equal_the_strided_conv(dtype, tolerance):
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.normal(size=(2, 3, 12, 18))).to(dtype)
    weight = torch.from_numpy(rng.normal(size=(8, 3, 5, 5)) * 0.1).to(dtype)
    bias = torch.from_numpy(rng.normal(size=8)).to(dtype)
    grad = torch.from_numpy(rng.normal(size=(2, 8, 6, 9))).to(dtype)

    def run(function):
        leaves = [t.clone().requires_grad_() for t in (x, weight, bias)]
        output = function(*leaves)
        output.backward(grad)
        return [output.detach()] + [leaf.grad for leaf in leaves]

    got = run(spacetodepth.conv5_stride2)
    expected = run(lambda a, w, b: F.conv2d(a, w, b, stride=2, padding=2))
    for a, b in zip(got, expected):
        torch.testing.assert_close(a, b, atol=tolerance * b.abs().max(),
                                   rtol=0)


def test_embedding_s2d_matches_jax():
    config = models.PDSConfig(maximum_disparity=63)
    params = weights.random_jax_params(config, seed=4)
    network = _network(params, config)
    image = np.random.RandomState(5).uniform(0, 255, (1, 64, 64, 3)).astype(
        np.float32)
    expected = jax_embedding.apply(params["embedding"], jnp.asarray(image),
                                   s2d_front=True)
    with torch.no_grad():
        got = network._embedding(_nchw(image), s2d_front=True)
        default = network._embedding(_nchw(image))
    for a, b, c in zip(got, expected, default):
        np.testing.assert_allclose(_nhwc(a), np.asarray(b), atol=1e-4)
        torch.testing.assert_close(a, c, atol=1e-4, rtol=0)


# -- factor_tail_conv1 ----------------------------------------------------


def _descriptors(seed, height, width, batch=1):
    rng = np.random.RandomState(seed)
    return tuple(rng.normal(size=(batch, height, width, 64)).astype(
        np.float32) for _ in range(2))


def test_conv1_planes_match_jax(matching_setup):
    """The head planes conv1 factors through, against JAX's: the left
    plane, JAX's wide right plane inside the zero-padded right window, and
    the last columns of JAX's edge plane."""
    module, params = matching_setup
    left, right = _descriptors(6, 4, 5)
    maximum_disparity = 3
    jax_left, jax_right_wide, jax_edge = (
        np.asarray(plane) for plane in jax_costvolume.matching_head_planes(
            params["head"], jnp.asarray(left), jnp.asarray(right)))
    head = module._operation._matching_operation_modules[0]
    with torch.no_grad():
        left_plane, right_window, edge = costvolume.matching_head_planes(
            head.weight, head.bias, _nchw(left), _nchw(right),
            maximum_disparity)
    assert right_window.shape[-1] == 5 + maximum_disparity + 4
    assert edge.shape[-1] == maximum_disparity
    window = _nhwc(right_window)
    np.testing.assert_allclose(_nhwc(left_plane), jax_left, atol=1e-4)
    np.testing.assert_allclose(
        window[:, :, maximum_disparity + 2:maximum_disparity + 8],
        jax_right_wide, atol=1e-4)
    assert not window[:, :, :maximum_disparity + 2].any()
    assert not window[:, :, maximum_disparity + 8:].any()
    np.testing.assert_allclose(_nhwc(edge), jax_edge[:, :, -3:], atol=1e-4)


@pytest.mark.parametrize("height, width, maximum_disparity", [
    (4, 5, 7), (6, 20, 15), (4, 5, 5), (6, 20, 25), (3, 2, 7), (3, 1, 3)])
def test_factored_conv1_volume_matches_jax(matching_setup, height, width,
                                           maximum_disparity):
    """The unpaired assembly against the JAX paired one (even counts) and
    against conv1 of the direct volume, D >= W included."""
    module, params = matching_setup
    left, right = _descriptors(7, height, width)
    conv1_params = params["residual1"]["block1"]["conv"]
    jax_planes = jax_costvolume.matching_head_planes(
        params["head"], jnp.asarray(left), jnp.asarray(right))
    head = module._operation._matching_operation_modules[0]
    conv1 = module._operation._matching_operation_modules[1].convolutions[
        0][0]
    with torch.no_grad():
        planes = costvolume.matching_head_planes(
            head.weight, head.bias, _nchw(left), _nchw(right),
            maximum_disparity)
        got = costvolume.conv1_volume(conv1.weight, conv1.bias, planes,
                                      maximum_disparity)
        volume = costvolume.shift_accumulate_volume(*planes,
                                                    maximum_disparity)
        direct = conv1(volume[0])
    assert got.shape == (1, maximum_disparity + 1, 64, height, width)
    torch.testing.assert_close(got[0], direct, atol=1e-4, rtol=0)
    if (maximum_disparity + 1) % 2 == 0:
        paired = np.asarray(jax_costvolume.assemble_conv1_volume_paired(
            jax_costvolume.conv1_volume_planes(conv1_params, *jax_planes),
            maximum_disparity, width))  # [1, P, H, W, 2 C1]
        pairs = paired.shape[1]
        unpaired = paired.reshape(1, pairs, height, width, 2, 64).transpose(
            0, 1, 4, 5, 2, 3).reshape(1, 2 * pairs, 64, height, width)
        np.testing.assert_allclose(got.numpy(), unpaired, atol=1e-4)


def test_factored_conv1_volume_gradients(matching_setup):
    """Autograd through the planes and the in-place assembly gives the
    gradients of conv1 over the assembled volume (float64)."""
    module = copy.deepcopy(matching_setup[0]).double()
    head = module._operation._matching_operation_modules[0]
    conv1 = module._operation._matching_operation_modules[1].convolutions[
        0][0]
    left, right = (torch.from_numpy(a).double().permute(0, 3, 1, 2)
                   for a in _descriptors(8, 4, 6))
    grad = torch.from_numpy(np.random.RandomState(9).normal(
        size=(1, 8, 64, 4, 6)))

    def gradients(factored):
        module.zero_grad()
        leaves = [left.clone().requires_grad_(),
                  right.clone().requires_grad_()]
        planes = costvolume.matching_head_planes(head.weight, head.bias,
                                                 *leaves, 7)
        if factored:
            output = costvolume.conv1_volume(conv1.weight, conv1.bias,
                                             planes, 7)
        else:
            output = conv1(costvolume.shift_accumulate_volume(
                *planes, 7).flatten(0, 1)).view(1, 8, 64, 4, 6)
        output.backward(grad)
        return [leaf.grad for leaf in leaves] + [
            conv1.weight.grad.clone(), conv1.bias.grad.clone(),
            head.weight.grad.clone()]

    for a, b in zip(gradients(True), gradients(False)):
        torch.testing.assert_close(a, b, atol=1e-10 * b.abs().max(), rtol=0)


@pytest.mark.parametrize("height, width, maximum_disparity",
                         [(4, 5, 7), (6, 20, 15), (6, 20, 25)])
def test_matching_factor_conv1_matches_jax(matching_setup, height, width,
                                           maximum_disparity):
    module, params = matching_setup
    left, right = _descriptors(10, height, width, batch=2)
    folded = np.asarray(jax_matching.apply_folded(
        params, jnp.asarray(left), jnp.asarray(right), maximum_disparity,
        factor_conv1=True))
    expected = folded.reshape(2, height, width, maximum_disparity + 1, 8)
    with torch.no_grad():
        got = module(_nchw(left), _nchw(right), maximum_disparity,
                     factor_conv1=True)
        unfactored = module(_nchw(left), _nchw(right), maximum_disparity)
    np.testing.assert_allclose(got.permute(0, 3, 4, 1, 2).numpy(), expected,
                               atol=1e-4)
    torch.testing.assert_close(got, unfactored, atol=1e-4, rtol=0)


# -- matching_tail_int8 ---------------------------------------------------


@pytest.mark.parametrize("cout", [64, 8])
def test_int8_conv_sums_bit_equal_to_jax(cout):
    """On the same int8 operands the int32 sums are the JAX package's
    ``conv_general_dilated`` ones, bit for bit."""
    rng = np.random.RandomState(11)
    x = rng.randint(-127, 128, (4, 5, 7, 64)).astype(np.int8)
    weight = rng.randint(-127, 128, (3, 3, 64, cout)).astype(np.int8)
    expected = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(weight), window_strides=(1, 1),
        padding=[(1, 1), (1, 1)], dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))
    got = int8.int8_conv3x3(_nchw(x).contiguous(),
                            torch.from_numpy(weight).permute(3, 2, 0, 1))
    assert got.dtype == torch.int32 and got.shape == (4, 5, 7, cout)
    np.testing.assert_array_equal(got.numpy(), expected)


def test_int8_activation_scale_is_per_disparity_pair():
    x = torch.from_numpy(np.random.RandomState(12).normal(
        size=(6, 4, 3, 5)).astype(np.float32))
    x[3] *= 10.0
    quantized, scale = int8.quantize_activation(x)
    pair_max = x.abs().reshape(3, -1).amax(dim=1) / 127.0 + 1e-30
    torch.testing.assert_close(scale, pair_max.repeat_interleave(2),
                               atol=0, rtol=0)
    assert quantized.dtype == torch.int8
    assert int(quantized[2:4].abs().max()) == 127
    assert int(quantized[2].abs().max()) < 127  # entry 2 shares 3's scale
    with pytest.raises(ValueError, match="pair"):
        int8.quantize_activation(x[:5])


def _unfold_signatures(folded, batch, height, width, disparities):
    return folded.reshape(batch, height, width, disparities, 8).transpose(
        0, 3, 4, 1, 2)


@pytest.mark.parametrize("factor_conv1", [False, True])
def test_int8_tail_matches_jax_in_float64(matching_setup, factor_conv1):
    module, params = matching_setup
    rng = np.random.RandomState(13)
    left, right = (rng.normal(size=(2, 16, 24, 64)) for _ in range(2))
    params64 = jax.tree.map(lambda leaf: np.asarray(leaf, np.float64),
                            params)
    with jax.enable_x64(True):
        expected = _unfold_signatures(np.asarray(jax_matching.apply_folded(
            params64, jnp.asarray(left), jnp.asarray(right), 7,
            factor_conv1=factor_conv1, tail_int8=True)), 2, 16, 24, 8)
    module = copy.deepcopy(module).double()
    with torch.no_grad():
        got = module(_nchw(left), _nchw(right), 7, factor_conv1=factor_conv1,
                     tail_int8=True).numpy()
    assert got.dtype == np.float64
    scale = np.abs(expected).max()
    assert np.abs(got - expected).max() <= 1e-6 * scale


@pytest.mark.parametrize("factor_conv1", [False, True])
def test_int8_tail_matches_jax_in_float32(matching_setup, factor_conv1):
    module, params = matching_setup
    rng = np.random.RandomState(14)
    left, right = (rng.normal(size=(2, 16, 24, 64)).astype(np.float32)
                   for _ in range(2))

    expected = _unfold_signatures(np.asarray(jax_matching.apply_folded(
        params, jnp.asarray(left), jnp.asarray(right), 7,
        factor_conv1=factor_conv1, tail_int8=True)), 2, 16, 24, 8)
    with torch.no_grad():
        got = module(_nchw(left), _nchw(right), 7, factor_conv1=factor_conv1,
                     tail_int8=True).numpy()
    difference = np.abs(got - expected)
    scale = np.abs(expected).max()
    assert difference.max() <= 0.02 * scale
    assert np.median(difference) <= 1e-3 * scale


def test_int8_tail_is_per_example_independent(matching_setup):
    """A batch of two (the second 10x larger) gives each example's batch-1
    signatures bit for bit."""
    module, _ = matching_setup
    left, right = _descriptors(15, 16, 24, batch=2)
    left[1] *= 10.0
    right[1] *= 10.0
    with torch.no_grad():
        batched = module(_nchw(left), _nchw(right), 7, tail_int8=True)
        for index in range(2):
            single = module(_nchw(left[index:index + 1]),
                            _nchw(right[index:index + 1]), 7,
                            tail_int8=True)
            torch.testing.assert_close(batched[index:index + 1], single,
                                       atol=0, rtol=0)


# -- the network under each option ---------------------------------------


@pytest.mark.parametrize("option", ["embedding_s2d", "factor_tail_conv1",
                                    "matching_tail_int8"])
def test_network_option_matches_jax_in_float64(option):
    """Similarities of ``apply`` with the option on, port against JAX, in
    float64 (1e-9 of the largest)."""
    config = models.PDSConfig(**NARROW, **{option: True})
    params = weights.random_jax_params(config, seed=16)
    left, right, _ = _images(17)
    with jax.enable_x64(True):
        expected = np.asarray(jax_models.apply(
            jax.tree.map(lambda leaf: np.asarray(leaf, np.float64), params),
            jnp.asarray(left, jnp.float64), jnp.asarray(right, jnp.float64),
            jax_models.PDSConfig(**NARROW, **{option: True})))
    got = models.apply(_network(params, config, torch.float64), left, right,
                       config, torch.float64, device="cpu")
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.detach().numpy(), expected,
                               atol=1e-9 * np.abs(expected).max(), rtol=0)


@pytest.mark.parametrize("option", ["embedding_s2d", "factor_tail_conv1"])
def test_exact_option_keeps_loss_and_gradients(option):
    """``tests/test_models.py``'s oracle for the exact options, in float32:
    loss within 1e-5, every gradient within 1e-3 of the default's."""
    config = models.PDSConfig(**NARROW, **{option: True})
    default = models.PDSConfig(**NARROW)
    params = weights.random_jax_params(default, seed=18)
    left, right, ground_truth = _images(19)
    results = []
    for cfg in (default, config):
        network = _network(params, cfg)
        value = trainer.loss_and_gradients(network, left, right,
                                           ground_truth, cfg, device="cpu")
        results.append((float(value), [parameter.grad for parameter
                                       in network.parameters()]))
    (base_loss, base), (loss_value, gradients) = results
    assert abs(loss_value - base_loss) <= 1e-5
    assert max(float((a - b).abs().max())
               for a, b in zip(gradients, base)) <= 1e-3


# -- remat ----------------------------------------------------------------


def _k1_calls(monkeypatch):
    calls = collections.Counter()
    launch = conv3d.conv3d_k3s1

    def counted(*args, **kwargs):
        calls["k1"] += 1
        return launch(*args, **kwargs)

    monkeypatch.setattr(conv3d, "conv3d_k3s1", counted)
    return calls


@pytest.mark.parametrize("remat, k1_calls", [(False, 18), ("selective", 21),
                                             (True, 27)])
def test_remat_keeps_loss_and_gradients(monkeypatch, remat, k1_calls):
    """Loss within 1e-6 and every gradient within 1e-4 of remat off (the
    recompute repeats the same forward: equal here); K1's calls per step:
    9 forward and 9 input gradients, plus the recomputed smooths (3 under
    "selective", 9 under True)."""
    default = models.PDSConfig(**NARROW)
    config = models.PDSConfig(**NARROW, remat=remat)
    params = weights.random_jax_params(default, seed=20)
    left, right, ground_truth = _images(21)
    base = _network(params, default)
    base_loss = trainer.loss_and_gradients(base, left, right, ground_truth,
                                           default, device="cpu")
    calls = _k1_calls(monkeypatch)
    network = _network(params, config)
    value = trainer.loss_and_gradients(network, left, right, ground_truth,
                                       config, device="cpu")
    assert calls["k1"] == k1_calls
    assert abs(float(value) - float(base_loss)) <= 1e-6
    for a, b in zip(network.parameters(), base.parameters()):
        assert float((a.grad - b.grad).abs().max()) <= 1e-4


def test_infer_under_remat_checkpoints_nothing(monkeypatch):
    config = models.PDSConfig(**NARROW, remat=True)
    network = _network(weights.random_jax_params(config, seed=22), config)
    calls = _k1_calls(monkeypatch)
    left, right, _ = _images(23)
    models.infer(network, left, right, config, device="cpu")
    assert calls["k1"] == 9


@pytest.mark.parametrize("remat", [True, "selective"])
def test_remat_matches_jax_remat_in_float64(remat):
    config = models.PDSConfig(**NARROW, remat=remat)
    params = weights.random_jax_params(config, seed=24)
    left, right, ground_truth = _images(25)
    jax_config = jax_models.PDSConfig(**NARROW, remat=remat)

    def loss_fn(p):
        return jax_ops.subpixel_cross_entropy(
            jax_models.apply(p, jnp.asarray(left, jnp.float64),
                             jnp.asarray(right, jnp.float64), jax_config),
            jnp.asarray(ground_truth, jnp.float64))

    with jax.enable_x64(True):
        expected_loss, expected = jax.value_and_grad(loss_fn)(jax.tree.map(
            lambda leaf: np.asarray(leaf, np.float64), params))
        expected = [np.asarray(leaf) for leaf in jax.tree.leaves(expected)]
    network = _network(params, config, torch.float64)
    value = trainer.loss_and_gradients(network, left, right, ground_truth,
                                       config, torch.float64, device="cpu")
    assert abs(float(value) - float(expected_loss)) <= 1e-12 * abs(
        float(expected_loss))
    got = checkpoint.tree_leaves(weights.jax_tree_of_parameters(
        network, lambda _, parameter: parameter.grad))
    floor = 1e-6 * max(np.abs(leaf).max() for leaf in expected)
    for a, b in zip(got, expected):
        if np.abs(b).max() >= floor:
            assert np.abs(np.asarray(a, np.float64) - b).max() <= (
                1e-6 * np.abs(b).max())


def test_unknown_remat_policy_named():
    with pytest.raises(ValueError, match="unknown remat policy"):
        models.PDSConfig(maximum_disparity=63, remat="everything")
    with pytest.raises(ValueError, match="unknown remat policy"):
        jax_models.PDSConfig(maximum_disparity=63, remat="everything")


# -- serving, trainer -----------------------------------------------------


@pytest.fixture(scope="module")
def serving_state():
    config = models.PDSConfig(maximum_disparity=63)
    state = weights.state_dict_from_jax_params(
        weights.random_jax_params(config, seed=26))
    rng = np.random.RandomState(27)
    left = rng.uniform(0, 255, (2, 32, 48, 3)).astype(np.float32)
    right = rng.uniform(0, 255, (2, 32, 48, 3)).astype(np.float32)
    return state, left, right


@pytest.mark.parametrize("matching_tail_int8", [False, True])
def test_direct_batch_equals_its_batch1_results(serving_state,
                                                matching_tail_int8):
    """One batched forward: each image's map within 1e-4 px of its batch-1
    map (the instance norms and the int8 tail's per-pair scales keep the
    examples apart), and ``"map"`` equal to ``"unroll"``. In float64: the
    CPU's float32 convs round differently at batch 2 (1e-5 of the
    similarities here), and under int8 such noise flips quantization
    roundings, which random weights carry to whole pixels."""
    state, left, right = serving_state
    config = models.PDSConfig(maximum_disparity=63,
                              matching_tail_int8=matching_tail_int8)
    outputs = {mode: InferenceSession(state, config, torch.float64, "cpu",
                                      batched_mode=mode).predict(left, right)
               for mode in ("unroll", "map", "direct")}
    np.testing.assert_array_equal(outputs["map"], outputs["unroll"])
    np.testing.assert_allclose(outputs["direct"], outputs["unroll"],
                               atol=1e-4, rtol=0)


def test_int8_training_refused_as_in_jax(tmp_path):
    config = models.PDSConfig(maximum_disparity=63, matching_tail_int8=True)
    network = _network(weights.random_jax_params(config, 0), config)
    with pytest.raises(ValueError) as port_error:
        trainer.PDSTrainer(config, network, training_set_loader=object(),
                           device="cpu")
    with pytest.raises(ValueError) as jax_error:
        JaxPDSTrainer(jax_models.PDSConfig(maximum_disparity=63,
                                           matching_tail_int8=True),
                      {}, training_set_loader=object())
    assert str(port_error.value) == str(jax_error.value)
    assert "inference-only" in str(port_error.value)
    trainer.PDSTrainer(config, network, device="cpu")  # evaluation: allowed


def test_config_identity_check_covers_the_options(tmp_path):
    """As in the JAX package (``tests/test_training.py``): a checkpoint
    written without an option loads under ``remat`` or
    ``factor_tail_conv1`` (execution only) and is refused under
    ``embedding_s2d`` or ``matching_tail_int8``, with JAX's message."""
    config = models.PDSConfig(maximum_disparity=63)
    params = weights.random_jax_params(config, 0)
    writer = JaxPDSTrainer(jax_models.PDSConfig(maximum_disparity=63),
                           params, experiment_folder=str(tmp_path))
    writer._save_checkpoint()
    path = checkpoint.checkpoint_filename(str(tmp_path), 1)
    for option, value in (("remat", "selective"), ("remat", True),
                          ("factor_tail_conv1", True)):
        overridden = models.PDSConfig(maximum_disparity=63, **{option: value})
        trainer.PDSTrainer(overridden, _network(params, overridden),
                           device="cpu").load_checkpoint(path)
    for option in ("embedding_s2d", "matching_tail_int8"):
        overridden = models.PDSConfig(maximum_disparity=63, **{option: True})
        reader = JaxPDSTrainer(
            jax_models.PDSConfig(maximum_disparity=63, **{option: True}),
            params, experiment_folder=str(tmp_path))
        with pytest.raises(ValueError) as jax_error:
            reader.load_checkpoint(path, load_only_network=True)
        with pytest.raises(ValueError) as port_error:
            trainer.PDSTrainer(overridden, _network(params, overridden),
                               device="cpu").load_checkpoint(
                                   path, load_only_network=True)
        assert str(port_error.value) == str(jax_error.value)
        assert option in str(port_error.value)


def test_int8_tail_under_autograd():
    """The int8 tail under autograd (``apply`` keeps gradients): the loss
    is finite and the float parameters before the tail still receive
    gradients, as in the JAX package, whose rounding has zero gradient."""
    config = models.PDSConfig(**NARROW, matching_tail_int8=True)
    network = _network(weights.random_jax_params(config, seed=28), config)
    left, right, ground_truth = _images(29)
    value = loss.subpixel_cross_entropy(
        models.apply(network, left, right, config, device="cpu"),
        torch.from_numpy(ground_truth))
    value.backward()
    assert torch.isfinite(value)
    head = network._matching._operation._matching_operation_modules[0]
    assert head.weight.grad is not None
