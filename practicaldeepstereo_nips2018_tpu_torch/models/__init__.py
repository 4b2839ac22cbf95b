"""PDS model family: embedding, matching, regularization, full network;
and PSMNet (``psmnet.py``)."""

from practicaldeepstereo_nips2018_tpu_torch.models.network import (
    PDSConfig,
    PdsNetwork,
    apply,
    apply_padded,
    infer,
    validate_maximum_disparity,
)
from practicaldeepstereo_nips2018_tpu_torch.models.psmnet import (
    PSMConfig,
    PsmNetwork,
)

__all__ = ["PDSConfig", "PdsNetwork", "PSMConfig", "PsmNetwork", "apply",
           "apply_padded", "infer", "validate_maximum_disparity"]
