"""PDS network: embedding, matching, regularization, estimator.

Port of ``practicaldeepstereo_nips2018_tpu/models/network.py``. The weights
live in :class:`PdsNetwork`, whose state_dict keys are the reference
``PdsNetwork``'s; :func:`apply` and :func:`infer` run it:

* :func:`apply` -> similarity scores (the reference's ``train()`` output);
* :func:`infer` -> sub-pixel MAP disparity map (its ``eval()`` output).

As in the JAX package, ``maximum_disparity`` is configuration, not network
state: the matching weights are shared across disparities, so one network
serves every valid range.

:func:`apply` is differentiable (the train step, ``training/trainer.py``,
takes its gradient; K1 has a backward through itself, ``ops/conv3d.py``);
:func:`infer` runs without gradients.

Given a ``mesh`` (``parallel.make_mesh``) whose ``volume`` axis is above 1,
as the JAX functions' ``mesh`` argument W-shards them, each process of a
volume group takes the whole padded example and runs every stage on its
own columns of it (``parallel/sharding.py``): :func:`apply` returns its
columns of the similarities with their range, :func:`infer` the whole
disparity map on every process.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from practicaldeepstereo_nips2018_tpu_torch.device import resolve_device
from practicaldeepstereo_nips2018_tpu_torch.models.embedding import Embedding
from practicaldeepstereo_nips2018_tpu_torch.models.matching import Matching
from practicaldeepstereo_nips2018_tpu_torch.models.regularization import (
    REMAT_POLICIES, Regularization, run_stage)
from practicaldeepstereo_nips2018_tpu_torch.ops import pad as pad_ops
from practicaldeepstereo_nips2018_tpu_torch.ops import subpixel
from practicaldeepstereo_nips2018_tpu_torch.parallel import sharding

FOLDED_CONV_IMPLS = ("dense", "banded_slab", "banded_pallas")


@dataclasses.dataclass(frozen=True)
class PDSConfig:
    """Static hyperparameters of the PDS network (the JAX ``PDSConfig``).

    ``folded_conv_impl`` names how the JAX package runs its hourglass convs;
    its three values compute one function, so it is validated and the port
    runs its one hourglass whatever the value. The opt-ins, all off by
    default:

    * ``remat``: ``False``, ``"selective"`` or ``True``; recompute the
      matching stage, the volume-sized hourglass stages and the upsamplers
      (``"selective"``) or every stage (``True``) in the backward pass
      instead of storing their activations (``models/regularization.py::
      run_stage``). Same numbers, less memory, more time.
    * ``factor_tail_conv1``: the matching tail's first conv factored
      through the cost volume's shift-assembly (exact).
    * ``embedding_s2d``: the embedding's first conv as a 3x3 conv of the
      space-to-depth image (exact, ``ops/spacetodepth.py``).
    * ``matching_tail_int8``: the matching tail's convs on int8 operands
      (``ops/int8.py``); an approximation, inference only (the trainer
      refuses it).
    """
    maximum_disparity: int = 255
    number_of_input_features: int = 3
    number_of_embedding_features: int = 64
    number_of_shortcut_features: int = 8
    number_of_embedding_residual_blocks: int = 2
    number_of_matching_features: int = 64
    number_of_signature_features: int = 8
    number_of_matching_residual_blocks: int = 2
    number_of_regularization_features: int = 8
    estimator_half_support_window: int = 4
    disparity_step: int = 2
    minimum_size: int = 64
    remat: bool | str = False
    folded_conv_impl: str = "dense"
    factor_tail_conv1: bool = False
    embedding_s2d: bool = False
    matching_tail_int8: bool = False

    def __post_init__(self):
        validate_maximum_disparity(self.maximum_disparity)
        if self.folded_conv_impl not in FOLDED_CONV_IMPLS:
            raise ValueError(
                f'unknown folded_conv_impl "{self.folded_conv_impl}"; '
                'expected "dense", "banded_slab" or "banded_pallas"')
        if self.remat not in REMAT_POLICIES:
            raise ValueError(
                f'unknown remat policy {self.remat!r}; expected False, '
                'True or "selective"')

    @property
    def matching_maximum_disparity(self) -> int:
        """Disparity range at descriptor (quarter) resolution:
        ``(maximum_disparity + 1) / 4 - 1`` (reference ``network.py:31-36``).
        """
        return (self.maximum_disparity + 1) // 4 - 1

    @property
    def number_of_similarity_levels(self) -> int:
        """Output disparity levels: even disparities only, step 2."""
        return (self.maximum_disparity + 1) // 2


def validate_maximum_disparity(maximum_disparity: int) -> None:
    """(maximum_disparity + 1) must be a multiple of 64
    (reference ``network.py:26-36``): /4 for the embedding stride and /16
    for the four stride-2 hourglass levels."""
    if (maximum_disparity + 1) % 64 != 0:
        raise ValueError(
            '"maximum_disparity" + 1 should be a multiple of 64, e.g. '
            '"maximum_disparity" can be equal to 63, 127, 191, 255...')


class PdsNetwork(nn.Module):
    """The PDS weights, with the reference ``PdsNetwork``'s module paths.

    Widths come from ``config``; its disparity range does not change the
    weights. Initial weights are PyTorch's conv default; trained or seeded
    weights come in through ``load_state_dict`` (``training/weights.py``).
    """

    def __init__(self, config: PDSConfig = PDSConfig()):
        super().__init__()
        self._embedding = Embedding(
            config.number_of_input_features,
            config.number_of_embedding_features,
            config.number_of_shortcut_features,
            config.number_of_embedding_residual_blocks)
        self._matching = Matching(
            number_of_concatenated_descriptor_features=(
                2 * config.number_of_embedding_features),
            number_of_features=config.number_of_matching_features,
            number_of_compact_matching_signature_features=(
                config.number_of_signature_features),
            number_of_residual_blocks=(
                config.number_of_matching_residual_blocks))
        self._regularization = Regularization(
            config.number_of_regularization_features)


def _as_images(image, device: torch.device) -> torch.Tensor:
    """``[B, H, W, 3]`` numpy array or tensor -> contiguous float32
    ``[B, 3, H, W]`` on ``device``.

    Always the same memory layout, whatever the caller's strides: cuDNN
    picks its algorithms by layout, and on the card a channels-last image
    took other bfloat16 roundings than a contiguous one, so the same image
    gave another disparity map when it came in a strided batch.
    """
    tensor = torch.as_tensor(image, dtype=torch.float32, device=device)
    return tensor.permute(0, 3, 1, 2).contiguous()


def _check_network_device(network: PdsNetwork, device: torch.device) -> None:
    parameter_device = next(network.parameters()).device
    if parameter_device.type != device.type:
        raise ValueError(f"the network's weights are on {parameter_device} "
                         f"but device={device}; move it with "
                         "network.to(device)")


def _forward(network: PdsNetwork, left_image, right_image,
             config: PDSConfig, compute_dtype, device, mesh):
    """(similarities ``[B, H', W', D/2]`` at the padded resolution,
    disparity last; this process's :class:`~..parallel.sharding.
    ColumnSlice`, or None when the width is not sliced)."""
    device = resolve_device(device)
    _check_network_device(network, device)
    left = pad_ops.pad_to_multiple(_as_images(left_image, device),
                                   config.minimum_size)
    right = pad_ops.pad_to_multiple(_as_images(right_image, device),
                                    config.minimum_size)
    columns = None
    if mesh is not None and mesh.volume > 1:
        columns = sharding.column_slice(mesh, left.shape[-1])
        left = sharding.slice_columns(left, columns)
        right = sharding.slice_columns(right, columns)
    if compute_dtype is not None:
        left = left.to(compute_dtype)
        right = right.to(compute_dtype)
    left_descriptor, shortcut = network._embedding(
        left, s2d_front=config.embedding_s2d, columns=columns)
    right_descriptor, _ = network._embedding(
        right, with_shortcut=False, s2d_front=config.embedding_s2d,
        columns=columns)
    # Checkpointed under both remat policies: its activations are the
    # largest of the step.
    signatures = run_stage(
        config.remat, True, network._matching, left_descriptor,
        right_descriptor, config.matching_maximum_disparity,
        config.factor_tail_conv1, config.matching_tail_int8, columns)
    # [B, D', C, H, W] -> the hourglass's NCDHW [B, C, D', H, W].
    signatures = signatures.transpose(1, 2).contiguous()
    return network._regularization(signatures, shortcut, config.remat,
                                   columns), columns


def apply_padded(network: PdsNetwork, left_image, right_image,
                 config: PDSConfig = PDSConfig(), compute_dtype=None,
                 device: str | torch.device = "cuda",
                 mesh=None) -> torch.Tensor:
    """Forward pass WITHOUT the final crop: ``[B, H', W', D/2]``
    similarities at the padded resolution, in ``compute_dtype`` (or
    float32), disparity last (a view of a disparity-major tensor); under a
    ``mesh`` with a volume axis, this process's columns of them."""
    return _forward(network, left_image, right_image, config,
                    compute_dtype, device, mesh)[0]


def apply(network: PdsNetwork, left_image, right_image,
          config: PDSConfig = PDSConfig(), compute_dtype=None,
          device: str | torch.device = "cuda", mesh=None):
    """Similarity scores (training-mode output).

    Args:
        network: the weights, on ``device``.
        left_image, right_image: ``[B, H, W, 3]`` images, 0..255 values
            (numpy or torch, taken as float32; any H, W: padded top/left
            to multiples of 64).
        config: static network configuration.
        compute_dtype: optional dtype (e.g. ``torch.bfloat16``) the padded
            images are cast to; the output is cast back to float32 (it
            stays float64 under ``torch.float64``, which the CPU runs as
            an exact reference; the kernels take float32 and bfloat16).
        device: ``"cuda"`` (default) or ``"cpu"``.
        mesh: optional ``parallel.Mesh``; with a ``volume`` axis above 1,
            every process of a volume group passes the same images.

    Returns:
        ``[B, H, W, (maximum_disparity + 1) / 2]``; index ``d`` along the
        last axis scores disparity ``2 * d`` pixels. Under a volume axis,
        ``(similarities [B, H, w, (maximum_disparity + 1) / 2], (first,
        end))``: this process's columns ``first .. end - 1`` of that
        result (the padded columns on the left all fall in the first
        process's slice, which is narrower by them).
    """
    height, width = np.shape(left_image)[1:3]
    similarities, columns = _forward(network, left_image, right_image,
                                     config, compute_dtype, device, mesh)
    similarities = similarities.to(torch.promote_types(similarities.dtype,
                                                       torch.float32))
    if columns is None:
        return pad_ops.unpad(similarities, height, width,
                             spatial_axes=(1, 2))
    # The left pad's columns lie in the first slice (at least 64 wide).
    first, end, padded_width = columns.span(similarities.shape[2])
    pad_w = padded_width - width
    dropped = max(0, pad_w - first)
    similarities = pad_ops.unpad(similarities, height,
                                 similarities.shape[2] - dropped,
                                 spatial_axes=(1, 2))
    return similarities, (first + dropped - pad_w, end - pad_w)


@torch.no_grad()
def infer(network: PdsNetwork, left_image, right_image,
          config: PDSConfig = PDSConfig(), compute_dtype=None,
          device: str | torch.device = "cuda", mesh=None) -> torch.Tensor:
    """Sub-pixel MAP disparity map ``[B, H, W]`` float32.

    The estimator runs on the PADDED similarities and the crop comes last
    (the reference's order, ``network.py:50-52``); it is per pixel, so the
    result is the same and no cropped copy of the volume is made. Under a
    ``mesh`` with a volume axis above 1 each process estimates its own
    columns and every process returns the whole map.
    """
    height, width = np.shape(left_image)[1:3]
    similarities, columns = _forward(network, left_image, right_image,
                                     config, compute_dtype, device, mesh)
    disparity = subpixel.subpixel_map(
        similarities,
        half_support_window=config.estimator_half_support_window,
        disparity_step=config.disparity_step)
    if columns is not None:
        disparity = sharding.gather_columns(disparity, columns)
    return pad_ops.unpad(disparity, height, width)
