"""Device selection for the entry points.

The port runs on the card. The CPU is taken only when the caller names it
(the tests do, and use the plain PyTorch versions of the kernels there);
asking for ``"cuda"`` on a host without a card raises instead of carrying
on on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Returns ``torch.device(device)``; raises if it is a CUDA device and
    no card is visible."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f'device "{device}" was asked for but torch.cuda.is_available() '
            'is False; pass device="cpu" to run the plain PyTorch path')
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f'unsupported device "{device}"; expected cuda or '
                         'cpu')
    return device
