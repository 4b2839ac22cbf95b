"""Plain PyTorch PDS: the reference that decides ``correct``.

Written from the published network (Tulyakov, Ivanov and Fleuret,
"Practical Deep Stereo", NeurIPS 2018, arXiv:1806.01677, and its reference
code, github.com/tlkvstepan/PracticalDeepStereo_NIPS2018), in float32,
with plain ``F.conv2d``, ``F.conv3d`` and ``F.conv_transpose3d``. It
imports nothing of the measured program and takes nothing it made: the
weights come in as a dict of tensors under the reference network's
state_dict keys (:func:`parameter_shapes`), made by the benchmark.

* the embedding: instance norm of the zero-padded image (top and left, to
  multiples of 64), two 5x5 stride-2 conv blocks, residual blocks, and a
  3x3 shortcut block for the left image; a conv block is conv, LeakyReLU
  0.1, affine instance norm (biased variance, eps 1e-5 inside the root);
* the matching: for each disparity ``d`` of the quarter-resolution range,
  the head conv of the left descriptor concatenated with the right one
  shifted right by ``d`` (zero fill), residual blocks normalised per
  disparity, and the tail conv to the compact signature;
* the hourglass: a smoothing block, four contractions (a stride-2 block and
  a smoothing block; the left shortcut, and then each contraction's
  pre-smooth output, added to the next contraction's input), four
  expansions (a 4x4x4 stride-2 transposed block plus the skip, then a
  smoothing block), and two upsamplers to the full resolution;
* the sub-pixel MAP estimator, the sub-pixel cross-entropy and RMSprop.

``quantize`` stands in for a lower precision: each conv's input, weights
and output pass through it, and so their gradients (the control that
``correct`` has to fail, :func:`fp8_e4m3`; :func:`bfloat16` as a witness of
what bfloat16 alone does).
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch
import torch.nn.functional as F

LEAKY_RELU_SLOPE = 0.1
INSTANCE_NORM_EPS = 1e-5
_CONTRACTION_SCALES = (1, 2, 4, 8)
_EXPANSION_SCALES = (16, 8, 4, 2)
_FP8_MAX = 448.0

Quantize = Callable[[torch.Tensor], torch.Tensor]


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


def _round_fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.abs().amax().clamp_min(1e-30) / _FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


def _round_bfloat16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


class _Rounded(torch.autograd.Function):
    """Rounds a tensor on the way forward and its gradient on the way
    back."""

    @staticmethod
    def forward(ctx, x, rounding):
        ctx.rounding = rounding
        return rounding(x)

    @staticmethod
    def backward(ctx, gradient):
        return ctx.rounding(gradient), None


def fp8_e4m3(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale (its largest
    magnitude to 448), and its gradient the same way."""
    return _Rounded.apply(x, _round_fp8)


def bfloat16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bfloat16, and its gradient the same way."""
    return _Rounded.apply(x, _round_bfloat16)


@contextlib.contextmanager
def exact_float32():
    """TF32 off for convs and matrix products inside the block."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


# -- parameters --------------------------------------------------------------

def parameter_shapes(config: dict) -> dict[str, tuple]:
    """State_dict keys and shapes of the network that ``config`` (the
    configuration file's widths) describes, in a fixed order."""
    shapes: dict[str, tuple] = {}

    def conv(prefix, cout, cin, *kernel):
        shapes[prefix + ".weight"] = (cout, cin, *kernel)
        shapes[prefix + ".bias"] = (cout,)

    def transposed(prefix, cin, cout, *kernel):
        shapes[prefix + ".weight"] = (cin, cout, *kernel)
        shapes[prefix + ".bias"] = (cout,)

    def norm(prefix, features):
        shapes[prefix + ".weight"] = (features,)
        shapes[prefix + ".bias"] = (features,)

    def block(prefix, cout, cin, *kernel):
        conv(prefix + ".0", cout, cin, *kernel)
        norm(prefix + ".2", cout)

    inputs = config["number_of_input_features"]
    embedding = config["number_of_embedding_features"]
    shortcut = config["number_of_shortcut_features"]
    matching = config["number_of_matching_features"]
    signature = config["number_of_signature_features"]
    features = config["number_of_regularization_features"]
    modules = "_embedding._embedding_modules"
    block(f"{modules}.1", embedding, inputs, 5, 5)
    block(f"{modules}.2", embedding, embedding, 5, 5)
    for index in range(config["number_of_embedding_residual_blocks"]):
        for half in range(2):
            block(f"{modules}.{3 + index}.convolutions.{half}", embedding,
                  embedding, 3, 3)
    block("_embedding._shortcut", shortcut, embedding, 3, 3)
    modules = "_matching._operation._matching_operation_modules"
    conv(f"{modules}.0", matching, 2 * embedding, 3, 3)
    residuals = config["number_of_matching_residual_blocks"]
    for index in range(residuals):
        for half in range(2):
            block(f"{modules}.{1 + index}.convolutions.{half}", matching,
                  matching, 3, 3)
    conv(f"{modules}.{1 + residuals}", signature, matching, 3, 3)
    block("_regularization._smoothing", features, features, 3, 3, 3)
    for index, scale in enumerate(_CONTRACTION_SCALES):
        width = features * scale
        prefix = f"_regularization._contraction_blocks.{index}"
        block(f"{prefix}._downsampling_2x", 2 * width, width, 3, 3, 3)
        block(f"{prefix}._smoothing", 2 * width, 2 * width, 3, 3, 3)
    for index, scale in enumerate(_EXPANSION_SCALES):
        width = features * scale
        prefix = f"_regularization._expansion_blocks.{index}"
        transposed(f"{prefix}._upsampling_2x.0", width, width // 2, 4, 4, 4)
        norm(f"{prefix}._upsampling_2x.2", width // 2)
        block(f"{prefix}._smoothing", width // 2, width // 2, 3, 3, 3)
    transposed("_regularization._upsample_to_halfsize.0", features,
               features // 2, 4, 4, 4)
    norm("_regularization._upsample_to_halfsize.2", features // 2)
    transposed("_regularization._upsample_to_fullsize", features // 2, 1,
               3, 4, 4)
    return shapes


# -- network -----------------------------------------------------------------

def instance_norm(x: torch.Tensor, weight=None, bias=None) -> torch.Tensor:
    dims = tuple(range(2, x.ndim))
    mean = x.mean(dim=dims, keepdim=True)
    variance = ((x - mean) ** 2).mean(dim=dims, keepdim=True)
    y = (x - mean) / torch.sqrt(variance + INSTANCE_NORM_EPS)
    if weight is not None:
        shape = (1, -1) + (1,) * (x.ndim - 2)
        y = y * weight.view(shape) + bias.view(shape)
    return y


class Network:
    """The forward pass over a parameter dict, every conv's input, weights
    and output through ``quantize``."""

    def __init__(self, params: dict[str, torch.Tensor], config: dict,
                 quantize: Quantize = _identity):
        self.p = params
        self.config = config
        self.q = quantize

    def _conv(self, prefix, x, stride=1, padding=None, transposed=False):
        weight, bias = self.p[prefix + ".weight"], self.p[prefix + ".bias"]
        x, weight = self.q(x), self.q(weight)
        if transposed:
            return self.q(F.conv_transpose3d(x, weight, bias, stride,
                                             padding))
        kernel = weight.shape[-1]
        padding = kernel // 2 if padding is None else padding
        convolve = F.conv2d if weight.ndim == 4 else F.conv3d
        return self.q(convolve(x, weight, bias, stride, padding))

    def _block(self, prefix, x, stride=1, transposed=False):
        if transposed:
            y = self._conv(prefix + ".0", x, 2, 1, transposed=True)
        else:
            y = self._conv(prefix + ".0", x, stride)
        y = F.leaky_relu(y, LEAKY_RELU_SLOPE)
        return instance_norm(y, self.p[prefix + ".2.weight"],
                             self.p[prefix + ".2.bias"])

    def _residual(self, prefix, x):
        y = self._block(prefix + ".convolutions.0", x)
        return self._block(prefix + ".convolutions.1", y) + x

    def embedding(self, image: torch.Tensor, with_shortcut: bool):
        modules = "_embedding._embedding_modules"
        x = instance_norm(image)
        x = self._block(f"{modules}.1", x, stride=2)
        x = self._block(f"{modules}.2", x, stride=2)
        for index in range(self.config["number_of_embedding_residual_blocks"]):
            x = self._residual(f"{modules}.{3 + index}", x)
        shortcut = (self._block("_embedding._shortcut", x) if with_shortcut
                    else None)
        return x, shortcut

    def matching(self, left: torch.Tensor, right: torch.Tensor,
                 disparities: int, chunk: int = 16) -> torch.Tensor:
        """``[B, C, H, W]`` descriptors -> ``[B, S, disparities, H, W]``
        signatures; ``chunk`` disparities at a time."""
        modules = "_matching._operation._matching_operation_modules"
        residuals = self.config["number_of_matching_residual_blocks"]
        batch, _, height, width = left.shape
        signatures = []
        for first in range(0, disparities, chunk):
            shifted = []
            for d in range(first, min(disparities, first + chunk)):
                moved = torch.zeros_like(right)
                if d < width:
                    moved[..., d:] = right[..., :width - d]
                shifted.append(torch.cat([left, moved], dim=1))
            x = torch.stack(shifted, dim=1)  # [B, d, 2C, H, W]
            count = x.shape[1]
            x = x.reshape(batch * count, -1, height, width)
            x = self._conv(f"{modules}.0", x)
            for index in range(residuals):
                x = self._residual(f"{modules}.{1 + index}", x)
            x = self._conv(f"{modules}.{1 + residuals}", x)
            signatures.append(x.reshape(batch, count, -1, height, width))
        return torch.cat(signatures, dim=1).transpose(1, 2)

    def hourglass(self, signatures: torch.Tensor,
                  shortcut: torch.Tensor) -> torch.Tensor:
        """``[B, C, D', h, w]`` -> ``[B, 2D', 4h, 4w]`` similarities."""
        regularization = "_regularization"
        output = self._block(f"{regularization}._smoothing", signatures)
        shortcut = shortcut[:, :, None]
        skips = []
        for index in range(len(_CONTRACTION_SCALES)):
            prefix = f"{regularization}._contraction_blocks.{index}"
            skips.append(output)
            down = self._block(f"{prefix}._downsampling_2x",
                               shortcut + output, stride=2)
            output = self._block(f"{prefix}._smoothing", down)
            shortcut = down
        for index in range(len(_EXPANSION_SCALES)):
            prefix = f"{regularization}._expansion_blocks.{index}"
            up = self._block(f"{prefix}._upsampling_2x", output,
                             transposed=True)
            output = self._block(f"{prefix}._smoothing", up + skips.pop())
        half = self._block(f"{regularization}._upsample_to_halfsize", output,
                           transposed=True)
        full = self._conv(f"{regularization}._upsample_to_fullsize", half,
                          (1, 2, 2), (1, 1, 1), transposed=True)
        return full[:, 0]

    def similarities(self, left: torch.Tensor, right: torch.Tensor,
                     maximum_disparity: int) -> torch.Tensor:
        """``[B, H, W, 3]`` images (0..255) -> ``[B, (D+1)/2, H, W]``
        similarities, index ``i`` scoring disparity ``step * i``."""
        height, width = left.shape[1:3]
        multiple = self.config["minimum_size"]
        pad_h = -height % multiple
        pad_w = -width % multiple

        def padded(image):
            image = image.permute(0, 3, 1, 2).float()
            return F.pad(image, (pad_w, 0, pad_h, 0))

        left_descriptor, shortcut = self.embedding(padded(left), True)
        right_descriptor, _ = self.embedding(padded(right), False)
        signatures = self.matching(left_descriptor, right_descriptor,
                                   (maximum_disparity + 1) // 4)
        scores = self.hourglass(signatures, shortcut)
        return scores[:, :, pad_h:, pad_w:]


# -- estimator, loss, optimizer -----------------------------------------------

def subpixel_map(similarities: torch.Tensor, half_support_window: int,
                 disparity_step: int) -> torch.Tensor:
    """``[B, L, H, W]`` -> ``[B, H, W]``: the first index of the largest
    score, a softmax over the indices within the window around it, the mean
    disparity under it."""
    taps = half_support_window // disparity_step
    best = similarities.argmax(dim=1, keepdim=True)
    index = torch.arange(similarities.shape[1],
                         device=similarities.device).view(1, -1, 1, 1)
    inside = (index - best).abs() <= taps
    maximum = similarities.gather(1, best)
    weights = torch.where(inside, torch.exp(similarities - maximum),
                          torch.zeros_like(similarities))
    mean = (weights * index).sum(dim=1) / weights.sum(dim=1)
    return disparity_step * mean


def cross_entropy_sum_and_count(similarities: torch.Tensor,
                                ground_truth: torch.Tensor,
                                diversity: float, disparity_step: int):
    """Sub-pixel cross-entropy: ``[B, L, H, W]`` scores against ``[B, H,
    W]`` disparities (unknown ones infinite) -> (its sum over the known
    pixels, their count). The target over the levels is the Laplace
    ``exp(-|gt - step * i| / diversity)``, normalised."""
    known = torch.isfinite(ground_truth)
    truth = torch.where(known, ground_truth, torch.zeros_like(ground_truth))
    levels = (torch.arange(similarities.shape[1], device=similarities.device,
                           dtype=similarities.dtype) * disparity_step
              ).view(1, -1, 1, 1)
    target = torch.exp(-(truth[:, None] - levels).abs() / diversity)
    target = target / target.sum(dim=1, keepdim=True)
    cross_entropy = -(target * torch.log_softmax(similarities, dim=1)).sum(1)
    return (torch.where(known, cross_entropy,
                        torch.zeros_like(cross_entropy)).sum(),
            known.sum())


class RMSprop:
    """``avg = alpha * avg + (1 - alpha) * g^2``; ``p -= lr * g /
    (sqrt(avg) + eps)``, the average starting at zero."""

    def __init__(self, params: dict[str, torch.Tensor], alpha: float,
                 eps: float):
        self.alpha, self.eps = alpha, eps
        self.average = {key: torch.zeros_like(value)
                        for key, value in params.items()}

    @torch.no_grad()
    def step(self, params: dict[str, torch.Tensor],
             gradients: dict[str, torch.Tensor], learning_rate: float):
        for key, value in params.items():
            average = self.average[key]
            average.mul_(self.alpha).add_((1 - self.alpha)
                                          * gradients[key] ** 2)
            value.sub_(learning_rate * gradients[key]
                       / (average.sqrt() + self.eps))


def loss_and_gradients(params: dict[str, torch.Tensor], config: dict,
                       left, right, ground_truth, maximum_disparity: int,
                       diversity: float, quantize: Quantize = _identity):
    """(loss, gradients by key) of a batch: the cross-entropy over all its
    known pixels, its examples run one at a time so that the batch fits."""
    leaves = {key: value.detach().requires_grad_(True)
              for key, value in params.items()}
    network = Network(leaves, config, quantize)
    count = int(torch.isfinite(ground_truth).sum())
    total = 0.0
    for index in range(left.shape[0]):
        scores = network.similarities(left[index:index + 1],
                                      right[index:index + 1],
                                      maximum_disparity)
        example, _ = cross_entropy_sum_and_count(
            scores, ground_truth[index:index + 1], diversity,
            config["disparity_step"])
        (example / count).backward()
        total += float(example.detach())
        del scores, example
    gradients = {key: leaf.grad for key, leaf in leaves.items()}
    return total / count, gradients


def steps(params: dict[str, torch.Tensor], config: dict, batches,
          maximum_disparity: int, learning_rate: float, alpha: float,
          eps: float, diversity: float, quantize: Quantize = _identity):
    """Trains a copy of ``params`` over ``batches`` (each ``(left, right,
    ground_truth)``) with RMSprop. Returns (the loss of each step, the
    first step's gradient by key, each parameter's change after the last
    step)."""
    start = {key: value.detach().clone() for key, value in params.items()}
    current = {key: value.detach().clone() for key, value in params.items()}
    optimizer = RMSprop(current, alpha, eps)
    losses, first_gradients = [], None
    for left, right, ground_truth in batches:
        loss, gradients = loss_and_gradients(
            current, config, left, right, ground_truth, maximum_disparity,
            diversity, quantize)
        if first_gradients is None:
            first_gradients = {key: value.clone()
                               for key, value in gradients.items()}
        optimizer.step(current, gradients, learning_rate)
        losses.append(loss)
    changes = {key: current[key] - start[key] for key in params}
    return losses, first_gradients, changes
