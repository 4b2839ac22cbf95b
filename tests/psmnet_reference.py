"""Plain float32 PSMNet for the tests: Chang and Chen, "Pyramid Stereo
Matching Network", CVPR 2018 (arXiv:1803.08669), as its published code
builds it (github.com/JiaRenChang/PSMNet: ``models/stackhourglass.py``,
``models/submodule.py``, ``main.py``), in plain ``F.conv2d``,
``F.conv3d``, ``F.conv_transpose3d``, ``F.batch_norm`` and
``F.interpolate`` on a dict of weights under the published state_dict
keys. It imports neither JAX nor anything of the port, and turns TF32 off.

``forward(params, left, right, maximum_disparity, training, pools)``
takes ``[B, 3, H, W]`` normalised images whose sizes are multiples of 16
and returns the heads' ``[B, H, W]`` maps (three when ``training``, with
BatchNorm on the batch's statistics, else the third, on the running
ones); :func:`loss` is ``main.py``'s and :func:`adam_step` torch's Adam
written out.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

EPS = 1e-5
MEAN = torch.tensor([0.485, 0.456, 0.406]).view(1, 3, 1, 1)
STD = torch.tensor([0.229, 0.224, 0.225]).view(1, 3, 1, 1)


def normalised(image: torch.Tensor) -> torch.Tensor:
    """``[B, H, W, 3]`` 0..255 -> ``[B, 3, H, W]``, ImageNet-normalised."""
    x = image.permute(0, 3, 1, 2).float() / 255.0
    return (x - MEAN) / STD


def _bn(p, key, x, training):
    if training:
        return F.batch_norm(x, None, None, p[f"{key}.weight"],
                            p[f"{key}.bias"], True, 0.1, EPS)
    return F.batch_norm(x, p[f"{key}.running_mean"], p[f"{key}.running_var"],
                        p[f"{key}.weight"], p[f"{key}.bias"], False, 0.1, EPS)


def _convbn(p, key, x, training, stride=1, pad=1, dilation=1):
    """``submodule.py::convbn``: pad by the dilation where it is above 1."""
    x = F.conv2d(x, p[f"{key}.0.weight"], None, stride,
                 dilation if dilation > 1 else pad, dilation)
    return _bn(p, f"{key}.1", x, training)


def _convbn_3d(p, key, x, training, stride=1):
    return _bn(p, f"{key}.1", F.conv3d(x, p[f"{key}.0.weight"], None, stride,
                                       1), training)


def _basic_block(p, key, x, training, stride, dilation):
    out = F.relu(_convbn(p, f"{key}.conv1.0", x, training, stride, 1,
                         dilation))
    out = _convbn(p, f"{key}.conv2", out, training, 1, 1, dilation)
    if f"{key}.downsample.0.weight" in p:
        x = _bn(p, f"{key}.downsample.1",
                F.conv2d(x, p[f"{key}.downsample.0.weight"], None, stride),
                training)
    return out + x


def feature_extraction(p, x, training, pools=(64, 32, 16, 8)):
    k = "feature_extraction"
    for index, stride in ((0, 2), (2, 1), (4, 1)):
        x = F.relu(_convbn(p, f"{k}.firstconv.{index}", x, training, stride))
    layers = {1: (3, 1, 1), 2: (16, 2, 1), 3: (3, 1, 1), 4: (3, 1, 2)}
    outputs = {}
    for number, (blocks, stride, dilation) in layers.items():
        for block in range(blocks):
            x = _basic_block(p, f"{k}.layer{number}.{block}", x, training,
                             stride if block == 0 else 1, dilation)
        outputs[number] = x
    skip = outputs[4]
    branches = []
    for number in (4, 3, 2, 1):
        size = pools[number - 1]
        branch = F.relu(_convbn(p, f"{k}.branch{number}.1",
                                F.avg_pool2d(skip, (size, size),
                                             (size, size)), training, 1, 0))
        branches.append(F.interpolate(branch, (skip.shape[2], skip.shape[3]),
                                      mode="bilinear", align_corners=False))
    feature = torch.cat((outputs[2], skip, *branches), 1)
    feature = F.relu(_convbn(p, f"{k}.lastconv.0", feature, training))
    return F.conv2d(feature, p[f"{k}.lastconv.2.weight"])


def cost_volume(left_features, right_features, levels):
    """The published loop, one slice copy per level and side."""
    batch, channels, height, width = left_features.shape
    cost = torch.zeros(batch, 2 * channels, levels, height, width,
                       dtype=left_features.dtype)
    for i in range(levels):
        if i > 0:
            cost[:, :channels, i, :, i:] = left_features[:, :, :, i:]
            cost[:, channels:, i, :, i:] = right_features[:, :, :, :-i]
        else:
            cost[:, :channels, i, :, :] = left_features
            cost[:, channels:, i, :, :] = right_features
    return cost.contiguous()


def _deconvbn(p, key, x, training):
    x = F.conv_transpose3d(x, p[f"{key}.0.weight"], None, 2, 1, 1)
    return _bn(p, f"{key}.1", x, training)


def hourglass(p, key, x, presqu, postsqu, training):
    out = F.relu(_convbn_3d(p, f"{key}.conv1.0", x, training, 2))
    pre = _convbn_3d(p, f"{key}.conv2", out, training)
    pre = F.relu(pre + postsqu) if postsqu is not None else F.relu(pre)
    out = F.relu(_convbn_3d(p, f"{key}.conv3.0", pre, training, 2))
    out = F.relu(_convbn_3d(p, f"{key}.conv4.0", out, training))
    skip = presqu if presqu is not None else pre
    post = F.relu(_deconvbn(p, f"{key}.conv5", out, training) + skip)
    out = _deconvbn(p, f"{key}.conv6", post, training)
    return out, pre, post


def _classif(p, key, x, training):
    x = F.relu(_convbn_3d(p, f"{key}.0", x, training))
    return F.conv3d(x, p[f"{key}.2.weight"], None, 1, 1)


def _head(cost, maximum_disparity, height, width):
    cost = F.interpolate(cost, [maximum_disparity, height, width],
                         mode="trilinear", align_corners=False)
    probabilities = F.softmax(torch.squeeze(cost, 1), dim=1)
    disparities = torch.arange(maximum_disparity,
                               dtype=torch.float32).view(1, -1, 1, 1)
    return torch.sum(probabilities * disparities, 1)


def forward(p, left, right, maximum_disparity, training,
            pools=(64, 32, 16, 8)):
    reference = feature_extraction(p, left, training, pools)
    target = feature_extraction(p, right, training, pools)
    cost = cost_volume(reference, target, maximum_disparity // 4)
    cost0 = F.relu(_convbn_3d(p, "dres0.0", cost, training))
    cost0 = F.relu(_convbn_3d(p, "dres0.2", cost0, training))
    cost0 = _convbn_3d(p, "dres1.2", F.relu(_convbn_3d(
        p, "dres1.0", cost0, training)), training) + cost0
    out1, pre1, post1 = hourglass(p, "dres2", cost0, None, None, training)
    out1 = out1 + cost0
    out2, pre2, post2 = hourglass(p, "dres3", out1, pre1, post1, training)
    out2 = out2 + cost0
    out3, pre3, post3 = hourglass(p, "dres4", out2, pre1, post2, training)
    out3 = out3 + cost0
    cost1 = _classif(p, "classif1", out1, training)
    cost2 = _classif(p, "classif2", out2, training) + cost1
    cost3 = _classif(p, "classif3", out3, training) + cost2
    height, width = left.shape[2], left.shape[3]
    if training:
        return [_head(cost, maximum_disparity, height, width)
                for cost in (cost1, cost2, cost3)]
    return [_head(cost3, maximum_disparity, height, width)]


def loss(predictions, ground_truth, maximum_disparity):
    mask = ground_truth < maximum_disparity
    output1, output2, output3 = predictions
    return (0.5 * F.smooth_l1_loss(output1[mask], ground_truth[mask])
            + 0.7 * F.smooth_l1_loss(output2[mask], ground_truth[mask])
            + F.smooth_l1_loss(output3[mask], ground_truth[mask]))


def adam_step(params, gradients, state, step, learning_rate=1e-3,
              betas=(0.9, 0.999), eps=1e-8):
    """One step of torch's Adam (no weight decay, no amsgrad) on the keys
    of ``gradients``; ``state`` holds each key's moments across steps
    (``step`` counts from 1)."""
    beta1, beta2 = betas
    updated = {}
    for key, gradient in gradients.items():
        first, second = state.setdefault(key, (torch.zeros_like(gradient),
                                               torch.zeros_like(gradient)))
        first = beta1 * first + (1 - beta1) * gradient
        second = beta2 * second + (1 - beta2) * gradient * gradient
        state[key] = (first, second)
        denominator = (second / (1 - beta2 ** step)).sqrt() + eps
        updated[key] = params[key] - (learning_rate / (1 - beta1 ** step)
                                      * first / denominator)
    return updated
