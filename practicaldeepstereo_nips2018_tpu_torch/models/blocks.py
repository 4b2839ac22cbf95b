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
input gradient (``ops/conv3d.py``); the transposed convs through K3 forward
and K4 input gradient (``ops/conv_transpose3d.py``), their bias in float32;
every other conv is a stock PyTorch conv, as the JAX package left them to
XLA, and a 3-D one counts in ``ops/kernels.py::fallback_counts``. A conv
with no bias (``bias=False``, as every PSMNet conv) takes a float32 zero
bias on K1 and K3, with no bias gradient. Where :func:`runs_block_norm`
allows (a CUDA tensor, the whole width), a conv block's LeakyReLU, norm and
residual add run as the K5 kernels (``ops/block_norm.py``), the
embedding's input norm too: through K5's autograd Function where autograd
records (a train step), as the direct call elsewhere; on the mesh's
``volume`` axis and the CPU they run as the composition below.
Initialisation is PyTorch's conv default (kaiming-uniform with a =
sqrt(5)): U(±1/sqrt(fan_in)) for weight and bias, the same bounds as the
JAX package's ``init_conv``.

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

from practicaldeepstereo_nips2018_tpu_torch.ops import (
    block_norm, conv3d, conv_transpose3d, kernels)
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
    ``x``, as the JAX package promotes), result in ``x``'s dtype
    (``ops/block_norm.py::normalize``). With ``columns`` the moments are
    those of the whole width (:func:`~..parallel.sharding.moments`).
    """
    x32 = x.to(torch.promote_types(x.dtype, torch.float32))
    dims = tuple(range(2, x.ndim))
    if columns is None:
        variance, mean = torch.var_mean(x32, dim=dims, correction=0,
                                        keepdim=True)
    else:
        mean, variance = sharding.moments(x32, dims, columns)
    return block_norm.normalize(x32, mean, variance, weight, bias, eps,
                                x.dtype)


def runs_block_norm(x: torch.Tensor,
                    columns: sharding.ColumnSlice | None) -> bool:
    """Whether a norm on ``x`` (with the LeakyReLU before it and the
    residual add after it) runs as K5: on a CUDA tensor, over the whole
    width (a W-slice's norm all-reduces its moments)."""
    return x.device.type == "cuda" and columns is None


def _block_norm(x: torch.Tensor, norm: nn.Module,
                negative_slope: float | None,
                residual: torch.Tensor | None = None) -> torch.Tensor:
    """K5 on ``x``: through its autograd Function where autograd records,
    else the direct call, which adds no Function's host work to a served
    forward."""
    arguments = (x, norm.weight, norm.bias, negative_slope, residual,
                 INSTANCE_NORM_EPS)
    recorded = (x, *norm.parameters(),
                *(() if residual is None else (residual,)))
    if torch.is_grad_enabled() and any(tensor.requires_grad
                                       for tensor in recorded):
        return block_norm.BlockNorm.apply(*arguments)
    return block_norm.block_norm(*arguments)


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
        if runs_block_norm(x, columns):
            return _block_norm(x, self, None)
        return instance_norm(x, self.weight, self.bias, columns=columns)


def _width_padding(padding: tuple, columns) -> tuple:
    """The conv's padding, none along W on a haloed slice."""
    return padding if columns is None else padding[:-1] + (0,)


def _haloed(conv, x: torch.Tensor, columns) -> torch.Tensor:
    if columns is None:
        return x
    return sharding.halo(x, *sharding.conv_halo(
        conv.kernel_size[-1], conv.stride[-1], conv.padding[-1]), columns)


def _cast_bias(conv, dtype: torch.dtype) -> torch.Tensor | None:
    return None if conv.bias is None else conv.bias.to(dtype)


def _float32_bias(conv, x: torch.Tensor) -> torch.Tensor:
    """The bias a hand kernel takes: the float32 parameter, or zeros where
    the conv has none."""
    if conv.bias is not None:
        return conv.bias
    return torch.zeros(conv.out_channels, dtype=torch.float32,
                       device=x.device)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` whose weights follow the activation dtype."""

    def forward(self, x: torch.Tensor,
                columns: sharding.ColumnSlice | None = None) -> torch.Tensor:
        return F.conv2d(_haloed(self, x, columns), self.weight.to(x.dtype),
                        _cast_bias(self, x.dtype), self.stride,
                        _width_padding(self.padding, columns), self.dilation,
                        self.groups)


def runs_k1(conv: nn.Conv3d) -> bool:
    """Whether ``conv`` runs on K1: 3x3x3, stride 1, padding 1, no dilation
    or groups. PSMNet's classifiers' last conv (32 -> 1) and its input
    gradient (1 -> 32) take K1's direct kernel, which is the faster there:
    1.42 and 2.02 ms against cuDNN's 1.83 and 3.71 at batch 12, D=192,
    256x512 in bfloat16 (``chip_smoke.py``'s ``psmnet`` phase, H100)."""
    return (conv.kernel_size == (3, 3, 3) and conv.stride == (1, 1, 1)
            and conv.padding == (1, 1, 1) and conv.dilation == (1, 1, 1)
            and conv.groups == 1)


class Conv3d(nn.Conv3d):
    """``nn.Conv3d`` whose stride-1 3x3x3 pad-1 form runs on K1
    (:func:`runs_k1`).

    K1 pads every side by 1, so on a slice it takes the 1-column halo and
    its first and last output columns are dropped."""

    def forward(self, x: torch.Tensor,
                columns: sharding.ColumnSlice | None = None) -> torch.Tensor:
        if runs_k1(self):
            y = conv3d.Conv3dK3S1.apply(_haloed(self, x, columns),
                                        self.weight.to(x.dtype),
                                        _float32_bias(self, x))
            return y if columns is None else y[..., 1:-1]
        kernels.count_fallback("conv3d", self.kernel_size, self.stride,
                               (self.in_channels, self.out_channels))
        return F.conv3d(_haloed(self, x, columns), self.weight.to(x.dtype),
                        _cast_bias(self, x.dtype), self.stride,
                        _width_padding(self.padding, columns), self.dilation,
                        self.groups)


def runs_k3(conv: nn.ConvTranspose3d) -> bool:
    """Whether ``conv`` runs on K3 and K4: H and W kernel 4, stride 2, a
    depth kernel and stride they take (``ops/conv_transpose3d.py::
    GEOMETRIES``), no output padding, dilation or groups (the PDS
    hourglass's upsamplers; PSMNet's 3x3x3 ones take cuDNN)."""
    return (conv.kernel_size[1:] == (4, 4) and conv.stride[1:] == (2, 2)
            and (conv.kernel_size[0], conv.stride[0])
            in conv_transpose3d.GEOMETRIES
            and conv.output_padding == (0, 0, 0)
            and conv.dilation == (1, 1, 1) and conv.groups == 1)


class ConvTranspose3d(nn.ConvTranspose3d):
    """``nn.ConvTranspose3d`` whose weights follow the activation dtype,
    run on K3 (forward) and K4 (input gradient) where :func:`runs_k3`
    holds, the bias float32 and added before the one rounding; elsewhere
    cuDNN's transposed conv."""

    def forward(self, x: torch.Tensor,
                columns: sharding.ColumnSlice | None = None) -> torch.Tensor:
        if not runs_k3(self):
            kernels.count_fallback("conv_transpose3d", self.kernel_size,
                                   self.stride,
                                   (self.in_channels, self.out_channels))
            return F.conv_transpose3d(
                x, self.weight.to(x.dtype), _cast_bias(self, x.dtype),
                self.stride, self.padding, self.output_padding, self.groups,
                self.dilation)
        padding = self.padding
        if columns is not None:
            left, right, drop = sharding.transposed_conv_halo(
                self.kernel_size[-1], self.stride[-1], self.padding[-1])
            x = sharding.halo(x, left, right, columns)
            padding = padding[:-1] + (padding[-1] + drop,)
        return conv_transpose3d.ConvTranspose3dK3.apply(
            x, self.weight.to(x.dtype), _float32_bias(self, x), self.stride,
            padding)


class ConvBlock(nn.Sequential):
    """``Sequential(conv, LeakyReLU(0.1), affine InstanceNorm)``; its
    state_dict keys are ``.0.*`` (conv) and ``.2.*`` (norm). Given a
    ``residual``, the block's output plus it."""

    def forward(self, x: torch.Tensor,
                columns: sharding.ColumnSlice | None = None,
                residual: torch.Tensor | None = None) -> torch.Tensor:
        return self.tail(self[0](x, columns), columns, residual)

    def tail(self, y: torch.Tensor,
             columns: sharding.ColumnSlice | None = None,
             residual: torch.Tensor | None = None) -> torch.Tensor:
        """The block after its conv, on the conv's output ``y``: LeakyReLU,
        norm and the ``residual`` add, as K5 where :func:`runs_block_norm`
        allows."""
        _, leaky_relu, norm = self
        if runs_block_norm(y, columns):
            return _block_norm(y, norm, leaky_relu.negative_slope, residual)
        y = norm(leaky_relu(y), columns)
        return y if residual is None else y + residual


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
        return second(first(x, columns), columns, residual=x)
