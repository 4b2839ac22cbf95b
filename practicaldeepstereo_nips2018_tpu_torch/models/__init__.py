"""PDS model family: embedding, matching, regularization, full network."""

from practicaldeepstereo_nips2018_tpu_torch.models.network import (
    PDSConfig,
    PdsNetwork,
    apply,
    apply_padded,
    infer,
    validate_maximum_disparity,
)

__all__ = ["PDSConfig", "PdsNetwork", "apply", "apply_padded", "infer",
           "validate_maximum_disparity"]
