"""PSMNet's disparity regression, one head: the cost ``[B, 1, D/4, H/4,
W/4]`` upsampled trilinearly to ``[B, D, H, W]`` (``align_corners=False``),
a softmax over the ``D`` levels of the cost itself and the expected level
``sum_d d * p_d`` (Chang and Chen, "Pyramid Stereo Matching Network", CVPR
2018, arXiv:1803.08669; ``models/stackhourglass.py`` and
``models/submodule.py::disparityregression`` of
github.com/JiaRenChang/PSMNet).

In plain PyTorch and in float32 whatever the cost's lower dtype (float64
stays float64): a bfloat16 map near 190 px would step by 1 px. Each head
saves one ``[B, D, H, W]`` float32 softmax for its backward pass.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def soft_argmin(cost: torch.Tensor, maximum_disparity: int, height: int,
                width: int) -> torch.Tensor:
    """``[B, 1, D', h, w]`` cost -> ``[B, height, width]`` float32 map over
    ``maximum_disparity`` levels (0 .. maximum_disparity - 1)."""
    dtype = torch.promote_types(cost.dtype, torch.float32)
    volume = F.interpolate(cost.to(dtype), size=(maximum_disparity, height,
                                                 width),
                           mode="trilinear", align_corners=False)[:, 0]
    probabilities = torch.softmax(volume, dim=1)
    levels = torch.arange(maximum_disparity, dtype=dtype,
                          device=cost.device).view(1, -1, 1, 1)
    return (probabilities * levels).sum(dim=1)
