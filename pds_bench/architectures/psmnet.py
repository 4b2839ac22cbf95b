"""The yardstick of PSMNet (``architectures/__init__.py`` says what a
yardstick provides): Chang and Chen, "Pyramid Stereo Matching Network",
CVPR 2018, arXiv:1803.08669, as its published code builds it
(github.com/JiaRenChang/PSMNet: ``models/stackhourglass.py``,
``models/submodule.py``, ``main.py``), written functionally in float32
with plain ``F.conv2d``, ``F.conv3d``, ``F.conv_transpose3d``,
``F.batch_norm`` and ``F.interpolate``, TF32 off. It imports nothing of
the port; the weights come in under the published state_dict keys
(:func:`weight_layout`).

* The tower on each view: a stride-2 stem, residual layers 1-4 (32, 64,
  128, 128 planes; 3, 16, 3, 3 blocks; the second strided, the last
  dilated by 2; no ReLU after a block's add), four pooled branches
  (``pyramid_pools``, the published 64, 32, 16, 8) upsampled bilinearly,
  and ``lastconv`` to 32 channels at a quarter of the resolution.
* The concatenation volume, filled level by level as the published code
  does.
* ``dres0``, ``dres1`` (+ residual), three hourglasses (the third takes
  the first's ``pre``), three classifiers whose costs accumulate.
* Each head: trilinear upsampling to ``[B, D, H, W]`` (``align_corners``
  False, as the bilinear pooled branches), softmax over the levels of the
  cost itself and the expected level.
* Training: BatchNorm on the batch's statistics, ``0.5 SL1(pred1) + 0.7
  SL1(pred2) + SL1(pred3)`` over the pixels whose truth is under ``D``,
  and Adam. Serving: BatchNorm on the running statistics, the third head,
  the ImageNet-normalised images zero-padded top and right to multiples
  of 16, the map cropped back.

``quantize`` stands in for a lower precision: each conv's input, weights
and output pass through it, and so their gradients.

Serving is judged per pixel of the sampled maps by the absolute gap to the
reference's map; training by the reference's Adam steps from the same
weights on the same first batches.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from pds_bench import reference

BATCH_NORM_EPS = 1e-5
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
PYRAMID_POOLS = (64, 32, 16, 8)
HEAD_WEIGHTS = (0.5, 0.7, 1.0)
# (planes, blocks, stride, dilation) of layer1 .. layer4.
LAYERS = ((32, 3, 1, 1), (64, 16, 2, 1), (128, 3, 1, 1), (128, 3, 1, 2))
FEATURES = 32
# The reference in the precisions below bfloat16's, every conv operand and
# result and their gradients rounded: the controls of ``calibrate.py``.
LOWERED = {"fp8": reference.fp8_e4m3, "bf16": reference.bfloat16}


def _exact(x: torch.Tensor) -> torch.Tensor:
    return x


def _pools(config: dict) -> tuple:
    return tuple(config.get("pyramid_pools", PYRAMID_POOLS))


# -- weights -----------------------------------------------------------------

def weight_layout(config: dict) -> dict[str, dict]:
    """Under the published keys, in their order: conv weights drawn at
    PyTorch's default bound (``fan_in`` the weight's second dimension
    times its taps); BatchNorm weight 1, bias 0, running mean 0, running
    variance 1 and ``num_batches_tracked`` int64 0."""
    layout: dict[str, dict] = {}

    def conv(key, cout, cin, *kernel):
        layout[key + ".weight"] = {"shape": (cout, cin, *kernel),
                                   "fan_in": cin * math.prod(kernel)}

    def transposed(key, cin, cout, *kernel):
        layout[key + ".weight"] = {"shape": (cin, cout, *kernel),
                                   "fan_in": cout * math.prod(kernel)}

    def norm(key, features):
        shape = (features,)
        layout[key + ".weight"] = {"shape": shape, "fill": 1.0}
        layout[key + ".bias"] = {"shape": shape, "fill": 0.0}
        layout[key + ".running_mean"] = {"shape": shape, "fill": 0.0}
        layout[key + ".running_var"] = {"shape": shape, "fill": 1.0}
        layout[key + ".num_batches_tracked"] = {"shape": (), "fill": 0,
                                                "dtype": "int64"}

    def convbn(key, cout, cin, k):
        conv(key + ".0", cout, cin, k, k)
        norm(key + ".1", cout)

    def convbn_3d(key, cout, cin):
        conv(key + ".0", cout, cin, 3, 3, 3)
        norm(key + ".1", cout)

    tower = "feature_extraction"
    for index, cin in zip((0, 2, 4), (3, 32, 32)):
        convbn(f"{tower}.firstconv.{index}", 32, cin, 3)
    inplanes = 32
    for number, (planes, count, stride, _) in enumerate(LAYERS, 1):
        for block in range(count):
            key = f"{tower}.layer{number}.{block}"
            convbn(f"{key}.conv1.0", planes, inplanes, 3)
            convbn(f"{key}.conv2", planes, planes, 3)
            if block == 0 and (stride != 1 or inplanes != planes):
                conv(f"{key}.downsample.0", planes, inplanes, 1, 1)
                norm(f"{key}.downsample.1", planes)
            inplanes = planes
    for number in range(1, len(_pools(config)) + 1):
        convbn(f"{tower}.branch{number}.1", 32, 128, 1)
    convbn(f"{tower}.lastconv.0", 128, 320, 3)
    conv(f"{tower}.lastconv.2", FEATURES, 128, 1, 1)
    wide = 2 * FEATURES
    convbn_3d("dres0.0", FEATURES, wide)
    convbn_3d("dres0.2", FEATURES, FEATURES)
    convbn_3d("dres1.0", FEATURES, FEATURES)
    convbn_3d("dres1.2", FEATURES, FEATURES)
    for hourglass in ("dres2", "dres3", "dres4"):
        convbn_3d(f"{hourglass}.conv1.0", wide, FEATURES)
        convbn_3d(f"{hourglass}.conv2", wide, wide)
        convbn_3d(f"{hourglass}.conv3.0", wide, wide)
        convbn_3d(f"{hourglass}.conv4.0", wide, wide)
        transposed(f"{hourglass}.conv5.0", wide, wide, 3, 3, 3)
        norm(f"{hourglass}.conv5.1", wide)
        transposed(f"{hourglass}.conv6.0", wide, FEATURES, 3, 3, 3)
        norm(f"{hourglass}.conv6.1", FEATURES)
    for classifier in ("classif1", "classif2", "classif3"):
        convbn_3d(f"{classifier}.0", FEATURES, FEATURES)
        conv(f"{classifier}.2", 1, FEATURES, 3, 3, 3)
    return layout


# -- the network -------------------------------------------------------------

class Network:
    """The forward pass on the weights ``p``, BatchNorm on the batch's
    statistics where ``training`` (the running ones left as they are),
    else on the running ones."""

    def __init__(self, p: dict, config: dict, training: bool,
                 quantize=_exact):
        self.p, self.training, self.q = p, training, quantize
        self.pools = _pools(config)

    def conv(self, key, x, stride=1, padding=0, dilation=1):
        q = self.q
        weight = self.p[key + ".weight"]
        convolve = F.conv2d if weight.ndim == 4 else F.conv3d
        return q(convolve(q(x), q(weight), None, stride, padding, dilation))

    def transposed(self, key, x):
        q = self.q
        return q(F.conv_transpose3d(q(x), q(self.p[key + ".weight"]), None,
                                    2, 1, 1))

    def norm(self, key, x):
        p = self.p
        running = (None, None) if self.training else (
            p[key + ".running_mean"], p[key + ".running_var"])
        return F.batch_norm(x, *running, p[key + ".weight"],
                            p[key + ".bias"], self.training, 0.1,
                            BATCH_NORM_EPS)

    def convbn(self, key, x, stride=1, padding=1, dilation=1):
        padding = dilation if dilation > 1 else padding
        return self.norm(key + ".1", self.conv(key + ".0", x, stride,
                                               padding, dilation))

    def tower(self, x):
        stem = "feature_extraction.firstconv"
        x = F.relu(self.convbn(f"{stem}.0", x, stride=2))
        x = F.relu(self.convbn(f"{stem}.2", x))
        x = F.relu(self.convbn(f"{stem}.4", x))
        raw = None
        for number, (_, count, stride, dilation) in enumerate(LAYERS, 1):
            for block in range(count):
                key = f"feature_extraction.layer{number}.{block}"
                step = stride if block == 0 else 1
                out = F.relu(self.convbn(f"{key}.conv1.0", x, step, 1,
                                         dilation))
                out = self.convbn(f"{key}.conv2", out, 1, 1, dilation)
                if f"{key}.downsample.0.weight" in self.p:
                    x = self.norm(f"{key}.downsample.1", self.conv(
                        f"{key}.downsample.0", x, step))
                x = out + x
            if number == 2:
                raw = x
        skip = x
        pooled = []
        for number in range(len(self.pools), 0, -1):
            size = self.pools[number - 1]
            branch = F.avg_pool2d(skip, size, size)
            branch = F.relu(self.convbn(
                f"feature_extraction.branch{number}.1", branch, padding=0))
            pooled.append(F.interpolate(branch, size=skip.shape[-2:],
                                        mode="bilinear",
                                        align_corners=False))
        x = torch.cat([raw, skip, *pooled], dim=1)
        x = F.relu(self.convbn("feature_extraction.lastconv.0", x))
        return self.conv("feature_extraction.lastconv.2", x)

    def convbn_3d(self, key, x, stride=1):
        return self.norm(key + ".1", self.conv(key + ".0", x, stride, 1))

    def hourglass(self, key, x, presqu, postsqu):
        out = F.relu(self.convbn_3d(f"{key}.conv1.0", x, 2))
        pre = self.convbn_3d(f"{key}.conv2", out)
        pre = F.relu(pre if postsqu is None else pre + postsqu)
        out = F.relu(self.convbn_3d(f"{key}.conv3.0", pre, 2))
        out = F.relu(self.convbn_3d(f"{key}.conv4.0", out))
        post = self.norm(f"{key}.conv5.1", self.transposed(f"{key}.conv5.0",
                                                           out))
        post = F.relu(post + (pre if presqu is None else presqu))
        out = self.norm(f"{key}.conv6.1", self.transposed(f"{key}.conv6.0",
                                                          post))
        return out, pre, post

    def classifier(self, key, x):
        return self.conv(f"{key}.2", F.relu(self.convbn_3d(f"{key}.0", x)),
                         1, 1)

    def maps(self, left, right, maximum_disparity: int) -> list:
        """``[B, 3, H, W]`` normalised, padded images -> the heads' maps
        ``[B, H, W]``: three where training, else the third."""
        features_left, features_right = self.tower(left), self.tower(right)
        batch, channels, height, width = features_left.shape
        levels = maximum_disparity // 4
        volume = features_left.new_zeros(batch, 2 * channels, levels,
                                         height, width)
        for i in range(levels):
            volume[:, :channels, i, :, i:] = features_left[:, :, :, i:]
            volume[:, channels:, i, :, i:] = features_right[
                :, :, :, :width - i]
        cost0 = F.relu(self.convbn_3d("dres0.0", volume))
        cost0 = F.relu(self.convbn_3d("dres0.2", cost0))
        cost0 = self.convbn_3d("dres1.2", F.relu(self.convbn_3d(
            "dres1.0", cost0))) + cost0
        out1, pre1, post1 = self.hourglass("dres2", cost0, None, None)
        out1 = out1 + cost0
        out2, _, post2 = self.hourglass("dres3", out1, pre1, post1)
        out2 = out2 + cost0
        out3, _, _ = self.hourglass("dres4", out2, pre1, post2)
        out3 = out3 + cost0
        cost1 = self.classifier("classif1", out1)
        cost2 = self.classifier("classif2", out2) + cost1
        cost3 = self.classifier("classif3", out3) + cost2
        costs = [cost1, cost2, cost3] if self.training else [cost3]
        size = (maximum_disparity, *left.shape[-2:])
        levels = torch.arange(maximum_disparity, dtype=torch.float32,
                              device=left.device).view(1, -1, 1, 1)
        return [(torch.softmax(F.interpolate(
            cost, size=size, mode="trilinear", align_corners=False)[:, 0],
            dim=1) * levels).sum(dim=1) for cost in costs]


def _images(image, device=None) -> torch.Tensor:
    """``[B, H, W, 3]`` 0..255 -> ``[B, 3, H', W']`` normalised, zero-padded
    top and right to multiples of 16."""
    x = torch.as_tensor(image, dtype=torch.float32, device=device).permute(
        0, 3, 1, 2) / 255.0
    mean = torch.tensor(IMAGENET_MEAN, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, device=x.device).view(1, 3, 1, 1)
    height, width = x.shape[-2:]
    return F.pad((x - mean) / std, (0, -width % 16, -height % 16, 0))


def _crop(disparity: torch.Tensor, height: int, width: int) -> torch.Tensor:
    return disparity[..., disparity.shape[-2] - height:, :width]


def maps(weights: dict, config: dict, left, right, maximum_disparity: int,
         training: bool, quantize=_exact) -> list:
    """The heads' maps ``[B, H, W]`` of ``[B, H, W, 3]`` images."""
    height, width = left.shape[1:3]
    network = Network(weights, config, training, quantize)
    return [_crop(disparity, height, width) for disparity in network.maps(
        _images(left), _images(right), maximum_disparity)]


def reference_map(weights: dict, config: dict, left, right,
                  maximum_disparity: int, quantize=_exact) -> torch.Tensor:
    """The reference's served maps ``[B, H, W]`` (eval-mode BatchNorm, the
    third head), TF32 off."""
    with torch.no_grad(), reference.exact_float32():
        return maps(weights, config, torch.as_tensor(left),
                    torch.as_tensor(right), maximum_disparity, False,
                    quantize)[0]


def serve_readings(weights: dict, config: dict, left, right, maps: dict,
                   maximum_disparity: int, device) -> dict:
    """Per pixel of the sampled maps, the absolute gap in pixels between
    the served and the float32 reference's map on the same weights and
    images."""
    gaps = []
    for key, served in maps.items():
        expected = reference_map(
            weights, config, torch.as_tensor(left[key], device=device),
            torch.as_tensor(right[key], device=device), maximum_disparity)
        gaps.append((torch.as_tensor(served, device=device) - expected
                     ).abs().flatten().cpu())
    return {"gap": torch.cat(gaps).double()}


def serve_numbers(readings: dict) -> dict:
    """The mean gap and the share of pixels whose gap is over 1 px."""
    gaps = readings["gap"]
    return {"map_gap_mean_px": float(gaps.mean()),
            "map_share_over_1px": float((gaps > 1.0).double().mean())}


def serve_diagnostics(readings: dict) -> dict:
    gaps = readings["gap"]
    return {"map_gap_max_px": float(gaps.max()),
            "map_gap_quantiles_px": torch.quantile(
                gaps.float(), torch.tensor([0.5, 0.9, 0.99])).tolist(),
            "map_share_over_0.25px": float((gaps > 0.25).double().mean()),
            "pixels": int(gaps.numel())}


def loss(predictions: list, ground_truth: torch.Tensor,
         maximum_disparity: int) -> torch.Tensor:
    """``main.py``'s loss: ``0.5 SL1(pred1) + 0.7 SL1(pred2) +
    SL1(pred3)``, each over the pixels whose truth is under ``D``."""
    mask = ground_truth < maximum_disparity
    return sum(weight * F.smooth_l1_loss(predicted[mask], ground_truth[mask])
               for weight, predicted in zip(HEAD_WEIGHTS, predictions))


def reference_steps(weights: dict, config: dict, batches,
                    maximum_disparity: int, quantize=_exact):
    """Adam over ``batches`` from ``weights``, BatchNorm on each batch's
    statistics, TF32 off: (each step's loss, the first gradient by key,
    each trained key's change)."""
    beta1, beta2 = config["adam"]["betas"]
    eps, learning_rate = config["adam"]["eps"], config["learning_rate"]
    trained = [key for key, value in weights.items()
               if value.is_floating_point() and ".running_" not in key]
    current = {key: weights[key].detach().clone() for key in trained}
    buffers = {key: value for key, value in weights.items()
               if key not in current}
    first = {key: torch.zeros_like(value) for key, value in current.items()}
    second = {key: torch.zeros_like(value) for key, value in current.items()}
    losses, first_gradients = [], None
    with reference.exact_float32():
        for step, (left, right, ground_truth) in enumerate(batches, 1):
            leaves = {key: value.requires_grad_(True)
                      for key, value in current.items()}
            value = loss(maps({**buffers, **leaves}, config, left, right,
                              maximum_disparity, True, quantize),
                         ground_truth, maximum_disparity)
            gradients = dict(zip(leaves, torch.autograd.grad(
                value, list(leaves.values()))))
            if first_gradients is None:
                first_gradients = gradients
            losses.append(float(value.detach()))
            with torch.no_grad():
                for key, gradient in gradients.items():
                    first[key].mul_(beta1).add_((1 - beta1) * gradient)
                    second[key].mul_(beta2).add_((1 - beta2) * gradient ** 2)
                    corrected = first[key] / (1 - beta1 ** step)
                    scale = torch.sqrt(second[key] / (1 - beta2 ** step))
                    current[key] = (current[key] - learning_rate * corrected
                                    / (scale + eps)).detach()
            del leaves, gradients, value
    changes = {key: current[key] - weights[key] for key in current}
    return losses, first_gradients, changes


# -- useful work -------------------------------------------------------------

def _transposed_taps(size: int) -> int:
    """Along one axis of a kernel-3, stride-2, pad-1, output-padding-1
    transposed conv of an input of ``size``: the (input, tap) pairs whose
    output lies inside the ``2 * size`` outputs."""
    return 3 * size - 1


def forward_macs(height: int, width: int, maximum_disparity: int,
                 pools=PYRAMID_POOLS) -> tuple[int, int]:
    """(useful multiply-adds of one forward pass of one pair at the padded
    size, those of the towers' first convs): every tap of every output of
    a conv, a transposed conv's taps that touch its input."""
    half = (height // 2) * (width // 2)
    quarter_h, quarter_w = height // 4, width // 4
    quarter = quarter_h * quarter_w
    first = half * 9 * 3 * 32
    tower = first + 2 * half * 9 * 32 * 32
    inplanes = 32
    for planes, count, stride, _ in LAYERS:
        pixels = half if stride == 1 and planes == 32 else quarter
        for block in range(count):
            tower += pixels * 9 * (inplanes * planes + planes * planes)
            if block == 0 and (stride != 1 or inplanes != planes):
                tower += pixels * inplanes * planes
            inplanes = planes
    tower += sum((quarter_h // size) * (quarter_w // size) * 128 * 32
                 for size in pools)
    tower += quarter * (9 * 320 * 128 + 128 * FEATURES)
    levels = maximum_disparity // 4
    volume = levels * quarter
    eighth = (levels // 2) * (quarter_h // 2) * (quarter_w // 2)
    sixteenth = (levels // 4) * (quarter_h // 4) * (quarter_w // 4)
    taps = 27
    wide = 2 * FEATURES
    aggregation = volume * taps * (wide * FEATURES + 3 * FEATURES * FEATURES)
    for _ in range(3):
        aggregation += (eighth * taps * (FEATURES * wide + wide * wide)
                        + sixteenth * taps * 2 * wide * wide)
        aggregation += (_transposed_taps(levels // 4)
                        * _transposed_taps(quarter_h // 4)
                        * _transposed_taps(quarter_w // 4) * wide * wide)
        aggregation += (_transposed_taps(levels // 2)
                        * _transposed_taps(quarter_h // 2)
                        * _transposed_taps(quarter_w // 2) * wide * FEATURES)
        aggregation += volume * taps * (FEATURES * FEATURES + FEATURES)
    return 2 * tower + aggregation, 2 * first


def useful_macs(config: dict, kind: str) -> int:
    """Useful multiply-adds of one image (one pair) at the padded size: a
    forward pass to serve; to train, the forward pass, the weight
    gradient and the input gradient of every conv but the towers' first
    (whose input is the image)."""
    height = -(-config["height"] // 16) * 16
    width = -(-config["width"] // 16) * 16
    forward, first = forward_macs(height, width,
                                  config[f"{kind}_maximum_disparity"],
                                  _pools(config))
    return forward if kind == "serve" else 3 * forward - first
