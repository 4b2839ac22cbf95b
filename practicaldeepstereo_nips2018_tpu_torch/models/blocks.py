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

Under the mesh's ``volume`` axis each block runs on this process's columns
of a W-sliced tensor (``columns``, ``parallel/sharding.py``): a conv takes
its halo (:func:`~..parallel.sharding.conv_halo`) and convolves with zero
padding along W only past the image's edges (the halo holds those zeros);
a transposed conv drops the outputs of its halo through its padding; an
instance norm all-reduces its moments over the volume group. The affine
maps and the activations stay local.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from practicaldeepstereo_nips2018_tpu_torch.ops import conv3d
from practicaldeepstereo_nips2018_tpu_torch.parallel import sharding

LEAKY_RELU_SLOPE = 0.1
INSTANCE_NORM_EPS = 1e-5


def instance_norm(x: torch.Tensor, weight: torch.Tensor | None = None,
                  bias: torch.Tensor | None = None,
                  eps: float = INSTANCE_NORM_EPS,
                  columns: sharding.ColumnSlice | None = None
                  ) -> torch.Tensor:
    """Per (sample, channel) normalisation over all dims after the second.

    Biased variance, eps inside the square root (PyTorch ``InstanceNorm``
    semantics); moments and the affine map in float32 (float64 for float64
    ``x``, as the JAX package promotes), result in ``x``'s dtype. With
    ``columns`` the moments are those of the whole width
    (:func:`~..parallel.sharding.moments`).
    """
    x32 = x.to(torch.promote_types(x.dtype, torch.float32))
    dims = tuple(range(2, x.ndim))
    if columns is None:
        variance, mean = torch.var_mean(x32, dim=dims, correction=0,
                                        keepdim=True)
    else:
        mean, variance = sharding.moments(x32, dims, columns)
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

    def forward(self, x: torch.Tensor,
                columns: sharding.ColumnSlice | None = None) -> torch.Tensor:
        return instance_norm(x, self.weight, self.bias, columns=columns)


def _width_padding(padding: tuple, columns) -> tuple:
    """The conv's padding, none along W on a haloed slice."""
    return padding if columns is None else padding[:-1] + (0,)


def _haloed(conv, x: torch.Tensor, columns) -> torch.Tensor:
    if columns is None:
        return x
    return sharding.halo(x, *sharding.conv_halo(
        conv.kernel_size[-1], conv.stride[-1], conv.padding[-1]), columns)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` whose weights follow the activation dtype."""

    def forward(self, x: torch.Tensor,
                columns: sharding.ColumnSlice | None = None) -> torch.Tensor:
        return F.conv2d(_haloed(self, x, columns), self.weight.to(x.dtype),
                        self.bias.to(x.dtype), self.stride,
                        _width_padding(self.padding, columns))


class Conv3d(nn.Conv3d):
    """``nn.Conv3d`` whose stride-1 3x3x3 pad-1 form runs on K1.

    K1 pads every side by 1, so on a slice it takes the 1-column halo and
    its first and last output columns are dropped."""

    def forward(self, x: torch.Tensor,
                columns: sharding.ColumnSlice | None = None) -> torch.Tensor:
        if (self.kernel_size == (3, 3, 3) and self.stride == (1, 1, 1)
                and self.padding == (1, 1, 1)):
            y = conv3d.Conv3dK3S1.apply(_haloed(self, x, columns),
                                        self.weight.to(x.dtype), self.bias)
            return y if columns is None else y[..., 1:-1]
        return F.conv3d(_haloed(self, x, columns), self.weight.to(x.dtype),
                        self.bias.to(x.dtype), self.stride,
                        _width_padding(self.padding, columns))


class ConvTranspose3d(nn.ConvTranspose3d):
    """``nn.ConvTranspose3d`` whose weights follow the activation dtype."""

    def forward(self, x: torch.Tensor,
                columns: sharding.ColumnSlice | None = None) -> torch.Tensor:
        padding = self.padding
        if columns is not None:
            left, right, drop = sharding.transposed_conv_halo(
                self.kernel_size[-1], self.stride[-1], self.padding[-1])
            x = sharding.halo(x, left, right, columns)
            padding = padding[:-1] + (padding[-1] + drop,)
        return F.conv_transpose3d(x, self.weight.to(x.dtype),
                                  self.bias.to(x.dtype), self.stride,
                                  padding)


class ConvBlock(nn.Sequential):
    """``Sequential(conv, LeakyReLU(0.1), affine InstanceNorm)``; its
    state_dict keys are ``.0.*`` (conv) and ``.2.*`` (norm)."""

    def forward(self, x: torch.Tensor,
                columns: sharding.ColumnSlice | None = None) -> torch.Tensor:
        conv, leaky_relu, norm = self
        return norm(leaky_relu(conv(x, columns)), columns)


def conv_block(conv: nn.Module) -> ConvBlock:
    return ConvBlock(conv, nn.LeakyReLU(LEAKY_RELU_SLOPE),
                     InstanceNorm(conv.out_channels))


def conv2d_block(in_features: int, out_features: int, kernel_size: int,
                 stride: int = 1) -> ConvBlock:
    return conv_block(Conv2d(in_features, out_features, kernel_size, stride,
                             kernel_size // 2))


def conv3d_block(in_features: int, out_features: int,
                 stride: int = 1) -> ConvBlock:
    return conv_block(Conv3d(in_features, out_features, 3, stride, 1))


def conv_transpose3d_block(in_features: int,
                           out_features: int) -> ConvBlock:
    """4x4x4 stride-2 pad-1 transposed conv block (doubles D, H, W)."""
    return conv_block(ConvTranspose3d(in_features, out_features, 4, 2, 1))


class ResidualBlock(nn.Module):
    """Two 3x3 conv blocks plus identity."""

    def __init__(self, features: int):
        super().__init__()
        self.convolutions = nn.Sequential(
            conv2d_block(features, features, 3),
            conv2d_block(features, features, 3))

    def forward(self, x: torch.Tensor,
                columns: sharding.ColumnSlice | None = None) -> torch.Tensor:
        first, second = self.convolutions
        return second(first(x, columns), columns) + x
