"""Primitive network blocks: convs, instance norm, residual blocks.

Port of ``practicaldeepstereo_nips2018_tpu/models/blocks.py`` as
``nn.Module``s laid out like the reference's ``network_blocks.py``, so that
a module's state_dict keys are the reference ``PdsNetwork``'s:

* a conv block is ``Sequential(conv, LeakyReLU(0.1), InstanceNorm(affine))``
  (keys ``.0.weight``, ``.0.bias``, ``.2.weight``, ``.2.bias``): the norm
  comes AFTER the activation (reference ``network_blocks.py:47-85``);
* a residual block is two 3x3 conv blocks under ``.convolutions`` plus the
  identity (reference ``network_blocks.py:134-144``).

Parameters stay float32; each conv casts its weights to the activation
dtype, as the JAX package does, so one network serves float32 and bfloat16
compute. Instance norm takes its moments in float32 even for bfloat16
activations. Stride-1 3x3x3 convs go through the K1 kernel, forward and
input gradient (``ops/conv3d.py``); every other conv is a stock PyTorch
conv, as the JAX package left them to XLA. Initialisation is PyTorch's
conv default (kaiming-uniform with a = sqrt(5)): U(±1/sqrt(fan_in)) for
weight and bias, the same bounds as the JAX package's ``init_conv``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from practicaldeepstereo_nips2018_tpu_torch.ops import conv3d

LEAKY_RELU_SLOPE = 0.1
INSTANCE_NORM_EPS = 1e-5


def instance_norm(x: torch.Tensor, weight: torch.Tensor | None = None,
                  bias: torch.Tensor | None = None,
                  eps: float = INSTANCE_NORM_EPS) -> torch.Tensor:
    """Per (sample, channel) normalisation over all dims after the second.

    Biased variance, eps inside the square root (PyTorch ``InstanceNorm``
    semantics); moments and the affine map in float32 (float64 for float64
    ``x``, as the JAX package promotes), result in ``x``'s dtype.
    """
    x32 = x.to(torch.promote_types(x.dtype, torch.float32))
    variance, mean = torch.var_mean(x32, dim=tuple(range(2, x.ndim)),
                                    correction=0, keepdim=True)
    scale = torch.rsqrt(variance + eps)
    offset = -mean * scale
    if weight is not None:
        shape = (1, -1) + (1,) * (x.ndim - 2)
        weight, bias = weight.to(x32.dtype), bias.to(x32.dtype)
        scale = scale * weight.view(shape)
        offset = offset * weight.view(shape) + bias.view(shape)
    return (x32 * scale + offset).to(x.dtype)


class InstanceNorm(nn.Module):
    """Instance norm, affine when ``features`` is given (weight 1, bias 0)."""

    def __init__(self, features: int | None = None):
        super().__init__()
        if features is None:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)
        else:
            self.weight = nn.Parameter(torch.ones(features))
            self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return instance_norm(x, self.weight, self.bias)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` whose weights follow the activation dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight.to(x.dtype), self.bias.to(x.dtype),
                        self.stride, self.padding)


class Conv3d(nn.Conv3d):
    """``nn.Conv3d`` whose stride-1 3x3x3 pad-1 form runs on K1."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if (self.kernel_size == (3, 3, 3) and self.stride == (1, 1, 1)
                and self.padding == (1, 1, 1)):
            return conv3d.Conv3dK3S1.apply(x, self.weight.to(x.dtype),
                                           self.bias)
        return F.conv3d(x, self.weight.to(x.dtype), self.bias.to(x.dtype),
                        self.stride, self.padding)


class ConvTranspose3d(nn.ConvTranspose3d):
    """``nn.ConvTranspose3d`` whose weights follow the activation dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose3d(x, self.weight.to(x.dtype),
                                  self.bias.to(x.dtype), self.stride,
                                  self.padding)


def conv_block(conv: nn.Module) -> nn.Sequential:
    """``Sequential(conv, LeakyReLU(0.1), affine InstanceNorm)``."""
    return nn.Sequential(conv, nn.LeakyReLU(LEAKY_RELU_SLOPE),
                         InstanceNorm(conv.out_channels))


def conv2d_block(in_features: int, out_features: int, kernel_size: int,
                 stride: int = 1) -> nn.Sequential:
    return conv_block(Conv2d(in_features, out_features, kernel_size, stride,
                             kernel_size // 2))


def conv3d_block(in_features: int, out_features: int,
                 stride: int = 1) -> nn.Sequential:
    return conv_block(Conv3d(in_features, out_features, 3, stride, 1))


def conv_transpose3d_block(in_features: int,
                           out_features: int) -> nn.Sequential:
    """4x4x4 stride-2 pad-1 transposed conv block (doubles D, H, W)."""
    return conv_block(ConvTranspose3d(in_features, out_features, 4, 2, 1))


class ResidualBlock(nn.Module):
    """Two 3x3 conv blocks plus identity."""

    def __init__(self, features: int):
        super().__init__()
        self.convolutions = nn.Sequential(
            conv2d_block(features, features, 3),
            conv2d_block(features, features, 3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.convolutions(x) + x
