"""PSMNet: Chang and Chen, "Pyramid Stereo Matching Network", CVPR 2018
(arXiv:1803.08669), as its published code builds it
(github.com/JiaRenChang/PSMNet: ``models/stackhourglass.py``,
``models/submodule.py``, ``main.py``), under that code's state_dict keys
(``feature_extraction.firstconv.0.0.weight``, ``dres2.conv5.1.running_var``,
``classif3.2.weight``, ...), so a published checkpoint's state_dict loads.

* The feature tower, one module run on each view: a stride-2 stem, four
  residual layers (the last dilated by 2; no ReLU after a block's add),
  spatial pyramid pooling over 64, 32, 16 and 8 (``PSMConfig.
  pyramid_pools``) upsampled bilinearly, and two convs to 32 channels at
  a quarter of the resolution.
* The concatenation volume ``[B, 64, D/4, H/4, W/4]``
  (``ops/costvolume.py::concatenation_volume``).
* Aggregation: ``dres0``, ``dres1`` (with the residual add), three stacked
  hourglasses linked through each other's skip states (the third takes the
  first's ``pre``, as the published code does) and three classifiers whose
  costs accumulate.
* Three heads (the :class:`Regression` module, ``ops/regression.py``):
  trilinear upsampling to ``[B, D, H, W]``, a softmax over disparity and
  the expected disparity, in float32. :func:`apply` gives all three (the
  training output), :func:`infer` the third.

BatchNorm everywhere, ReLU everywhere. As the rest of the port: parameters
and BatchNorm's statistics in float32, activations in the compute dtype,
each conv's weights cast to it. Every BatchNorm is a :class:`BatchNorm2d`
or :class:`BatchNorm3d`, ``nn.BatchNorm``'s parameters and buffers under
their names, normalising in float32 through K6 (``ops/batch_norm.py``),
forward and backward, in train and eval mode: 85 modules, 145 calls a
train step (the tower's 60 run once on each view). The 16 stride-1 3x3x3
convs run on K1, forward and input gradient (``models/blocks.py::Conv3d``,
``runs_k1``); the stride-2 convs and the 3x3x3 stride-2 transposed convs
take cuDNN and count in ``ops/kernels.py::fallback_counts``.

Inputs are 0..255 ``[B, H, W, 3]`` images, normalised with ImageNet's mean
and standard deviation after ``/ 255`` and zero-padded on the top and
right to multiples of 16 (``H / 4`` and ``W / 4`` halve twice in the
hourglasses); the maps are cropped back. The
spans are PDS's, with the same meaning: ``pds.prepare``,
``pds.embedding`` (each view's tower), ``pds.matching`` (the volume),
``pds.regularization`` (``dres0``-``dres4`` and the classifiers),
``pds.estimator`` (each head), ``pds.crop``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from practicaldeepstereo_nips2018_tpu_torch.device import resolve_device
from practicaldeepstereo_nips2018_tpu_torch.models import blocks
from practicaldeepstereo_nips2018_tpu_torch.models.network import (
    _as_images, _check_network_device)
from practicaldeepstereo_nips2018_tpu_torch.ops import (
    batch_norm, costvolume, loss, pad, regression)
from practicaldeepstereo_nips2018_tpu_torch.utils import profiling

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
FEATURES = 32
HEADS = 3
PADDING_MULTIPLE = 16


@dataclasses.dataclass(frozen=True)
class PSMConfig:
    """PSMNet's static hyperparameters: the disparity range ``D`` (levels
    0 .. D - 1, 192 as published) and the pyramid pooling sizes of
    ``branch1`` .. ``branch4`` (the published 64, 32, 16, 8 need images of
    at least 256 x 256; smaller pools let a smaller image through, as the
    tests run)."""
    maximum_disparity: int = 192
    pyramid_pools: tuple[int, ...] = (64, 32, 16, 8)

    def __post_init__(self):
        if self.maximum_disparity % 16 != 0:
            raise ValueError('PSMNet\'s "maximum_disparity" should be a '
                             "multiple of 16 (D / 4 halves twice in the "
                             f"hourglasses), got {self.maximum_disparity}")
        if len(self.pyramid_pools) != 4:
            raise ValueError("PSMNet pools over four sizes, got "
                             f"{self.pyramid_pools}")


class _KernelBatchNorm:
    """``nn.BatchNorm``'s forward through K6 (``ops/batch_norm.py::
    batch_norm``): the same parameters, buffers, modes and running
    statistics' update (``num_batches_tracked`` counted by the kernel)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._check_input_dim(x)
        momentum = 0.0 if self.momentum is None else self.momentum
        batches = None
        if self.training and self.track_running_stats:
            batches = self.num_batches_tracked
            if self.momentum is None and batches is not None:
                momentum = 1.0 / (float(batches) + 1.0)
        running = not self.training or self.track_running_stats
        return batch_norm.batch_norm(
            x.contiguous(), self.weight, self.bias,
            self.running_mean if running else None,
            self.running_var if running else None, batches,
            self.training or self.running_mean is None, momentum, self.eps)


class BatchNorm2d(_KernelBatchNorm, nn.BatchNorm2d):
    """``nn.BatchNorm2d`` through K6."""


class BatchNorm3d(_KernelBatchNorm, nn.BatchNorm3d):
    """``nn.BatchNorm3d`` through K6."""


def convbn(in_features: int, out_features: int, kernel_size: int,
           stride: int, padding: int, dilation: int) -> nn.Sequential:
    """``Sequential(Conv2d, BatchNorm2d)``, no bias, padded by the dilation
    where it is above 1 (``submodule.py::convbn``)."""
    return nn.Sequential(
        blocks.Conv2d(in_features, out_features, kernel_size, stride,
                      dilation if dilation > 1 else padding, dilation,
                      bias=False),
        BatchNorm2d(out_features))


def convbn_3d(in_features: int, out_features: int, stride: int = 1
              ) -> nn.Sequential:
    """``Sequential(Conv3d 3x3x3 pad 1, BatchNorm3d)``, no bias."""
    return nn.Sequential(
        blocks.Conv3d(in_features, out_features, 3, stride, 1, bias=False),
        BatchNorm3d(out_features))


def _relu() -> nn.ReLU:
    return nn.ReLU(inplace=True)


class BasicBlock(nn.Module):
    """``conv2(conv1(x)) + downsample(x)``, no ReLU after the add."""

    def __init__(self, in_features: int, planes: int, stride: int,
                 downsample: nn.Module | None, padding: int, dilation: int):
        super().__init__()
        self.conv1 = nn.Sequential(
            convbn(in_features, planes, 3, stride, padding, dilation),
            _relu())
        self.conv2 = convbn(planes, planes, 3, 1, padding, dilation)
        self.downsample = downsample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv2(self.conv1(x))
        return out + (x if self.downsample is None else self.downsample(x))


def _layer(in_features: int, planes: int, count: int, stride: int,
           dilation: int) -> nn.Sequential:
    downsample = None
    if stride != 1 or in_features != planes:
        downsample = nn.Sequential(
            blocks.Conv2d(in_features, planes, 1, stride, bias=False),
            BatchNorm2d(planes))
    return nn.Sequential(
        BasicBlock(in_features, planes, stride, downsample, 1, dilation),
        *[BasicBlock(planes, planes, 1, None, 1, dilation)
          for _ in range(count - 1)])


class FeatureExtraction(nn.Module):
    """The tower: ``[B, 3, H, W]`` -> ``[B, 32, H/4, W/4]``."""

    def __init__(self, pyramid_pools=(64, 32, 16, 8)):
        super().__init__()
        self.firstconv = nn.Sequential(
            convbn(3, 32, 3, 2, 1, 1), _relu(),
            convbn(32, 32, 3, 1, 1, 1), _relu(),
            convbn(32, 32, 3, 1, 1, 1), _relu())
        self.layer1 = _layer(32, 32, 3, 1, 1)
        self.layer2 = _layer(32, 64, 16, 2, 1)
        self.layer3 = _layer(64, 128, 3, 1, 1)
        self.layer4 = _layer(128, 128, 3, 1, 2)
        for index, size in enumerate(pyramid_pools, 1):
            self.add_module(f"branch{index}", nn.Sequential(
                nn.AvgPool2d(size, size), convbn(128, 32, 1, 1, 0, 1),
                _relu()))
        self.lastconv = nn.Sequential(
            convbn(320, 128, 3, 1, 1, 1), _relu(),
            blocks.Conv2d(128, FEATURES, 1, 1, 0, bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        raw = self.layer2(self.layer1(self.firstconv(x)))
        skip = self.layer4(self.layer3(raw))
        pooled = [F.interpolate(branch(skip), size=skip.shape[-2:],
                                mode="bilinear", align_corners=False)
                  for branch in (self.branch4, self.branch3, self.branch2,
                                 self.branch1)]
        return self.lastconv(torch.cat([raw, skip, *pooled], dim=1))


class Hourglass(nn.Module):
    """The 3-D encoder-decoder: ``forward(x, presqu, postsqu)`` -> ``(out,
    pre, post)`` (``stackhourglass.py::hourglass``)."""

    def __init__(self, features: int = FEATURES):
        super().__init__()
        wide = 2 * features
        self.conv1 = nn.Sequential(convbn_3d(features, wide, 2), _relu())
        self.conv2 = convbn_3d(wide, wide)
        self.conv3 = nn.Sequential(convbn_3d(wide, wide, 2), _relu())
        self.conv4 = nn.Sequential(convbn_3d(wide, wide), _relu())
        self.conv5 = nn.Sequential(
            blocks.ConvTranspose3d(wide, wide, 3, 2, 1, output_padding=1,
                                   bias=False),
            BatchNorm3d(wide))
        self.conv6 = nn.Sequential(
            blocks.ConvTranspose3d(wide, features, 3, 2, 1,
                                   output_padding=1, bias=False),
            BatchNorm3d(features))

    def forward(self, x: torch.Tensor, presqu: torch.Tensor | None,
                postsqu: torch.Tensor | None):
        pre = self.conv2(self.conv1(x))
        pre = F.relu(pre if postsqu is None else pre + postsqu, inplace=True)
        out = self.conv4(self.conv3(pre))
        post = F.relu(self.conv5(out) + (pre if presqu is None else presqu),
                      inplace=True)
        return self.conv6(post), pre, post


def _classifier() -> nn.Sequential:
    return nn.Sequential(convbn_3d(FEATURES, FEATURES), _relu(),
                         blocks.Conv3d(FEATURES, 1, 3, 1, 1, bias=False))


class Regression(nn.Module):
    """One head, ``ops/regression.py::soft_argmin``: a module of its own
    (with no parameters), so that hooks on it time the heads."""

    def forward(self, cost: torch.Tensor, maximum_disparity: int,
                height: int, width: int) -> torch.Tensor:
        return regression.soft_argmin(cost, maximum_disparity, height, width)


class PsmNetwork(nn.Module):
    """PSMNet's weights and BatchNorm statistics under the published keys;
    :func:`apply` and :func:`infer` run it (BatchNorm on the batch's
    statistics in ``train()`` mode, on the running ones in ``eval()``).
    ``training/trainer.py`` trains it through :meth:`training_outputs` and
    :meth:`loss_sum_and_count`."""

    def __init__(self, config: PSMConfig = PSMConfig()):
        super().__init__()
        self.feature_extraction = FeatureExtraction(config.pyramid_pools)
        self.dres0 = nn.Sequential(convbn_3d(2 * FEATURES, FEATURES),
                                   _relu(), convbn_3d(FEATURES, FEATURES),
                                   _relu())
        self.dres1 = nn.Sequential(convbn_3d(FEATURES, FEATURES), _relu(),
                                   convbn_3d(FEATURES, FEATURES))
        self.dres2 = Hourglass()
        self.dres3 = Hourglass()
        self.dres4 = Hourglass()
        self.classif1 = _classifier()
        self.classif2 = _classifier()
        self.classif3 = _classifier()
        self.regression = Regression()

    def training_outputs(self, left_image, right_image, config: PSMConfig,
                         compute_dtype=None, device="cuda"):
        """:func:`apply`: the three maps."""
        return apply(self, left_image, right_image, config, compute_dtype,
                     device)

    @staticmethod
    def loss_sum_and_count(maps, ground_truth: torch.Tensor,
                           config: PSMConfig):
        """The three heads' smooth L1 (``ops/loss.py::
        smooth_l1_sum_and_count``) over the pixels whose truth is under
        ``config.maximum_disparity``."""
        return loss.smooth_l1_sum_and_count(maps, ground_truth,
                                            config.maximum_disparity)


def _prepared(image, config: PSMConfig, compute_dtype, device
              ) -> torch.Tensor:
    images = _as_images(image, device) / 255.0
    mean = torch.tensor(IMAGENET_MEAN, device=device).view(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, device=device).view(1, 3, 1, 1)
    images = pad.pad_top_right((images - mean) / std, PADDING_MULTIPLE)
    return images if compute_dtype is None else images.to(compute_dtype)


def _aggregation(network: PsmNetwork, volume: torch.Tensor, heads: int
                 ) -> list[torch.Tensor]:
    """The last ``heads`` of the three classifiers' accumulated costs
    ``[B, 1, D/4, H/4, W/4]``."""
    cost0 = network.dres0(volume)
    cost0 = network.dres1(cost0) + cost0
    out1, pre1, post1 = network.dres2(cost0, None, None)
    out1 = out1 + cost0
    out2, _, post2 = network.dres3(out1, pre1, post1)
    out2 = out2 + cost0
    out3, _, _ = network.dres4(out2, pre1, post2)
    out3 = out3 + cost0
    cost1 = network.classif1(out1)
    cost2 = network.classif2(out2) + cost1
    cost3 = network.classif3(out3) + cost2
    return [cost1, cost2, cost3][HEADS - heads:]


def _forward(network: PsmNetwork, left_image, right_image,
             config: PSMConfig, compute_dtype, device, heads: int
             ) -> list[torch.Tensor]:
    """The last ``heads`` maps ``[B, H, W]`` float32, cropped."""
    device = resolve_device(device)
    _check_network_device(network, device)
    height, width = np.shape(left_image)[1:3]
    with profiling.span("pds.prepare"):
        left = _prepared(left_image, config, compute_dtype, device)
        right = _prepared(right_image, config, compute_dtype, device)
    with profiling.span("pds.embedding"):
        left_features = network.feature_extraction(left)
    with profiling.span("pds.embedding"):
        right_features = network.feature_extraction(right)
    with profiling.span("pds.matching"):
        volume = costvolume.concatenation_volume(
            left_features, right_features, config.maximum_disparity // 4)
    with profiling.span("pds.regularization"):
        costs = _aggregation(network, volume, heads)
    maps = []
    for cost in costs:
        with profiling.span("pds.estimator"):
            maps.append(network.regression(cost, config.maximum_disparity,
                                           *left.shape[-2:]))
    with profiling.span("pds.crop"):
        return [pad.unpad_top_right(disparity, height, width)
                for disparity in maps]


def apply(network: PsmNetwork, left_image, right_image,
          config: PSMConfig = PSMConfig(), compute_dtype=None,
          device: str | torch.device = "cuda") -> list[torch.Tensor]:
    """The three heads' maps ``[B, H, W]`` float32 (the training output;
    differentiable), BatchNorm in the network's mode.

    Args:
        network: the weights, on ``device``.
        left_image, right_image: ``[B, H, W, 3]`` images, 0..255 (numpy or
            torch, taken as float32; any H, W: padded top and right to
            multiples of 16).
        config: static configuration.
        compute_dtype: e.g. ``torch.bfloat16``, the activations' dtype
            after normalisation; the heads compute in float32.
        device: ``"cuda"`` (default) or ``"cpu"``.
    """
    return _forward(network, left_image, right_image, config, compute_dtype,
                    device, HEADS)


@torch.no_grad()
def infer(network: PsmNetwork, left_image, right_image,
          config: PSMConfig = PSMConfig(), compute_dtype=None,
          device: str | torch.device = "cuda") -> torch.Tensor:
    """The third head's map ``[B, H, W]`` float32 (the evaluation output),
    without gradients; call on a network in ``eval()`` mode to use the
    running statistics."""
    return _forward(network, left_image, right_image, config, compute_dtype,
                    device, 1)[0]
