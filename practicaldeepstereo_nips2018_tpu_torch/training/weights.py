"""The weight bridge between the JAX parameter layout and the port.

The JAX package keeps its weights as a nested dict (``models.init``):
convs ``{"w": [*k, I, O], "b": [O]}`` with transposed convs stored in the
gather convention (spatially flipped), instance norms ``{"scale", "bias"}``.
The port's :class:`~..models.network.PdsNetwork` has the reference
``PdsNetwork``'s state_dict keys and PyTorch layouts. This module maps one
onto the other, both ways; it is the reverse of the JAX package's
``training/torch_import.py`` (the port keeps its own copy of that mapping):

    _embedding._embedding_modules.{1,2}         <-> embedding.conv{1,2}
    _embedding._embedding_modules.{3,..}        <-> embedding.residual{1,..}
    _embedding._shortcut                        <-> embedding.shortcut
    _matching._operation..._modules.0           <-> matching.head
    _matching._operation..._modules.{1,..}      <-> matching.residual{1,..}
    _matching._operation..._modules.{last}      <-> matching.tail
    _regularization._smoothing                  <-> regularization.smoothing
    _regularization._contraction_blocks.{i}     <-> .contraction{i+1}
    _regularization._expansion_blocks.{i}       <-> .expansion{i+1}
    _regularization._upsample_to_{half,full}size <-> same names

    Conv          [O, I, *k]  <-> [*k, I, O]
    ConvTranspose [I, O, *k]  <-> spatially flipped [*k, I, O]
    InstanceNorm  weight/bias <-> scale/bias

:func:`load_torch_checkpoint` reads the reference's own ``.bin`` files.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from practicaldeepstereo_nips2018_tpu_torch.models.network import (
    PDSConfig, PdsNetwork)
from practicaldeepstereo_nips2018_tpu_torch.models.regularization import (
    NUMBER_OF_SCALES)

_EMBEDDING = "_embedding._embedding_modules"
_MATCHING = "_matching._operation._matching_operation_modules"


def _block(jax_path: tuple, prefix: str, conv_kind: str = "conv"):
    """Sequential(conv, LeakyReLU, InstanceNorm) entries."""
    return [(jax_path + ("conv",), f"{prefix}.0", conv_kind),
            (jax_path + ("norm",), f"{prefix}.2", "norm")]


def _residual(jax_path: tuple, prefix: str):
    return (_block(jax_path + ("block1",), f"{prefix}.convolutions.0")
            + _block(jax_path + ("block2",), f"{prefix}.convolutions.1"))


def _layout(embedding_residuals: int, matching_residuals: int) -> list:
    """(JAX path, state_dict prefix, kind) of every conv and norm, kind
    being "conv", "transpose" or "norm"."""
    entries = (_block(("embedding", "conv1"), f"{_EMBEDDING}.1")
               + _block(("embedding", "conv2"), f"{_EMBEDDING}.2"))
    for i in range(embedding_residuals):
        entries += _residual(("embedding", f"residual{i + 1}"),
                             f"{_EMBEDDING}.{3 + i}")
    entries += _block(("embedding", "shortcut"), "_embedding._shortcut")
    entries.append((("matching", "head"), f"{_MATCHING}.0", "conv"))
    for i in range(matching_residuals):
        entries += _residual(("matching", f"residual{i + 1}"),
                             f"{_MATCHING}.{1 + i}")
    entries.append((("matching", "tail"),
                    f"{_MATCHING}.{1 + matching_residuals}", "conv"))
    regularization = "_regularization"
    entries += _block(("regularization", "smoothing"),
                      f"{regularization}._smoothing")
    for i in range(NUMBER_OF_SCALES):
        contraction = f"{regularization}._contraction_blocks.{i}"
        entries += _block(("regularization", f"contraction{i + 1}", "down"),
                          f"{contraction}._downsampling_2x")
        entries += _block(("regularization", f"contraction{i + 1}",
                           "smooth"), f"{contraction}._smoothing")
        expansion = f"{regularization}._expansion_blocks.{i}"
        entries += _block(("regularization", f"expansion{i + 1}", "up"),
                          f"{expansion}._upsampling_2x", "transpose")
        entries += _block(("regularization", f"expansion{i + 1}", "smooth"),
                          f"{expansion}._smoothing")
    entries += _block(("regularization", "upsample_to_halfsize"),
                      f"{regularization}._upsample_to_halfsize", "transpose")
    entries.append((("regularization", "upsample_to_fullsize"),
                    f"{regularization}._upsample_to_fullsize", "transpose"))
    return entries


def _count(keys, pattern: str) -> int:
    return len({match.group(1) for key in keys
                if (match := re.fullmatch(pattern, key))})


def state_dict_from_jax_params(params: dict) -> dict[str, torch.Tensor]:
    """JAX-layout nested dict of arrays -> port state_dict (float32 CPU
    tensors under the reference key names)."""
    layout = _layout(
        sum(1 for name in params["embedding"] if name.startswith("residual")),
        sum(1 for name in params["matching"] if name.startswith("residual")))
    state = {}
    for jax_path, prefix, kind in layout:
        node = params
        for name in jax_path:
            node = node[name]
        if kind == "norm":
            weight, bias = np.asarray(node["scale"]), np.asarray(node["bias"])
        else:
            weight, bias = np.asarray(node["w"]), np.asarray(node["b"])
            if kind == "conv":  # [*k, I, O] -> [O, I, *k]
                weight = np.moveaxis(weight, (-1, -2), (0, 1))
            else:  # [*k, I, O] -> [I, O, *k], flipped to scatter order
                weight = np.moveaxis(weight, (-2, -1), (0, 1))
                weight = np.flip(weight, axis=tuple(range(2, weight.ndim)))
        state[f"{prefix}.weight"] = torch.from_numpy(
            np.array(weight, dtype=np.float32, order="C"))
        state[f"{prefix}.bias"] = torch.from_numpy(
            np.array(bias, dtype=np.float32, order="C"))
    return state


def jax_params_from_state_dict(state: dict) -> dict:
    """Port (or reference) state_dict -> JAX-layout nested dict of float32
    numpy arrays; the inverse of :func:`state_dict_from_jax_params`."""
    layout = _layout(
        _count(state, rf"{re.escape(_EMBEDDING)}\.(\d+)\.convolutions\..*"),
        _count(state, rf"{re.escape(_MATCHING)}\.(\d+)\.convolutions\..*"))
    params: dict = {}
    for jax_path, prefix, kind in layout:
        weight = np.asarray(state[f"{prefix}.weight"], dtype=np.float32)
        bias = np.asarray(state[f"{prefix}.bias"], dtype=np.float32)
        if kind == "norm":
            leaf = {"scale": weight, "bias": bias}
        else:
            if kind == "transpose":  # scatter [I, O, *k] -> gather order
                weight = np.flip(weight, axis=tuple(range(2, weight.ndim)))
                weight = np.moveaxis(weight, (0, 1), (-2, -1))
            else:  # [O, I, *k] -> [*k, I, O]
                weight = np.moveaxis(weight, (0, 1), (-1, -2))
            leaf = {"w": np.ascontiguousarray(weight), "b": bias}
        node = params
        for name in jax_path[:-1]:
            node = node.setdefault(name, {})
        node[jax_path[-1]] = leaf
    return params


def jax_tree_of_parameters(network: PdsNetwork, values) -> dict:
    """A JAX-layout tree of per-parameter tensors: ``values(name,
    parameter)`` -> a tensor shaped like the parameter (its gradient,
    RMSprop's ``square_avg``, the parameter itself), mapped through the
    same bridge as the weights, transposed-conv flip included. The JAX
    package keeps such trees (gradients, optax's RMSprop ``nu``) in the
    layout of its params."""
    return jax_params_from_state_dict({
        name: values(name, parameter).detach().cpu()
        for name, parameter in network.named_parameters()})


def network_shapes(config: PDSConfig = PDSConfig()) -> dict[str, tuple]:
    """state_dict key -> shape of a :class:`PdsNetwork` for ``config``
    (built on the meta device: no memory, no random draws)."""
    with torch.device("meta"):
        network = PdsNetwork(config)
    return {key: tuple(value.shape)
            for key, value in network.state_dict().items()}


def random_jax_params(config: PDSConfig = PDSConfig(),
                      seed: int = 0) -> dict:
    """JAX-layout weights drawn with numpy from ``seed``, with the bounds
    of the JAX package's ``models.init``: conv weight and bias
    U(±1/sqrt(fan_in)), where fan_in is ``I * prod(k)`` for a conv and
    ``O * prod(k)`` for a transposed conv; norm scale 1, bias 0."""
    rng = np.random.RandomState(seed)
    shapes = network_shapes(config)
    state = {}
    for key, shape in shapes.items():
        owner = key.rsplit(".", 1)[0]
        weight_shape = shapes[f"{owner}.weight"]
        if len(weight_shape) == 1:  # instance norm
            fill = np.ones if key.endswith(".weight") else np.zeros
            state[key] = fill(shape, np.float32)
            continue
        # PyTorch's fan_in is dim 1 times the kernel volume for both conv
        # ([O, I, *k]) and transposed conv ([I, O, *k]) weights.
        bound = 1.0 / np.sqrt(weight_shape[1] * np.prod(weight_shape[2:]))
        state[key] = rng.uniform(-bound, bound, shape).astype(np.float32)
    return jax_params_from_state_dict(state)


def load_torch_checkpoint(filename: str,
                          config: PDSConfig = PDSConfig()) -> PdsNetwork:
    """A :class:`PdsNetwork` (on the CPU) holding the weights of a
    reference PyTorch checkpoint: ``{"network": state_dict, ...}`` as the
    reference trainer saves it, or a bare state_dict. The key names are the
    port's own, so the state_dict loads as it is (strictly). ``config``
    gives the widths; its disparity range does not matter.

    Read with ``torch.load(weights_only=True)``: tensors and plain
    containers only, which is all the reference writes."""
    content = torch.load(filename, map_location="cpu", weights_only=True)
    state = content["network"] if "network" in content else content
    network = PdsNetwork(config)
    network.load_state_dict(state)
    return network
