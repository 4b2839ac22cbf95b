"""Regularization: 3-D hourglass over the cost volume.

Port of ``practicaldeepstereo_nips2018_tpu/models/regularization.py``
(``hourglass_core`` + ``final_upsampling``, semantics of ``apply_ndhwc``)
and of the volume ops of ``ops/folded3d.py`` it runs on. The JAX package
folds disparity into the TPU's 128-wide lanes (``[B, H, W, D*C]``); here
volumes are plain NCDHW ``[B, C, D, H, W]``. Module layout of the reference
``regularization.py:74-92``:

    _smoothing                     3x3x3 block (8 -> 8)           K1
    _contraction_blocks.{0-3}
        ._downsampling_2x          stride-2 3x3x3 block f -> 2f
        ._smoothing                3x3x3 block 2f -> 2f           K1
    _expansion_blocks.{0-3}
        ._upsampling_2x            4x4x4 stride-2 transposed block f -> f/2
        ._smoothing                3x3x3 block f/2 -> f/2         K1
    _upsample_to_halfsize          4x4x4 stride-2 transposed block 8 -> 4
    _upsample_to_fullsize          raw transposed conv (3,4,4), stride
                                   (1,2,2), padding (1,1,1), 4 -> 1

Two load-bearing details (reference ``regularization.py:114-123``):

* the left-image shortcut is broadcast-added along disparity to the input
  of EVERY contraction; from level 2 on the shortcut is the previous
  level's pre-smooth ``down`` output;
* skips are the smoothed outputs before each contraction, added after each
  expansion's upsampling.

``remat`` (the JAX ``_stage_remat`` policies) recomputes stages in the
backward pass instead of storing their activations, through
``torch.utils.checkpoint``: ``"selective"`` the volume-sized ones (the
smoothing, contraction 1, expansion 4 and the two upsamplers together),
``True`` every block. Without gradients (``infer``) nothing is
checkpointed, so a served image still makes 9 K1 launches.

With ``columns`` (the mesh's ``volume`` axis) every level runs on this
process's W-slice: K1 on the 1-column halo of its input, its first and
last outputs dropped; the stride-2 convs on a halo of 1 column before the
slice; the transposed convs on 1 and 1, two output columns dropped on each
side; the shortcut and the skips are the slice's own columns. A stage that
``remat`` recomputes repeats its halos and norm all-reduces in the
backward pass, in the same order on every process. :data:`sharding_probe`
sees each stage's local width.
"""

from __future__ import annotations

import torch
import torch.utils.checkpoint
from torch import nn

from practicaldeepstereo_nips2018_tpu_torch.models import blocks

NUMBER_OF_SCALES = 4
_CONTRACTION_WIDTH_SCALES = (1, 2, 4, 8)
_EXPANSION_WIDTH_SCALES = (16, 8, 4, 2)
REMAT_POLICIES = (False, True, "selective")

# Test hook (the JAX ``sharding_probe``): when set to a callable
# ``(stage, width)``, every stage reports the W extent of the tensor this
# process holds there, so a test can tell a W-sliced hourglass from one
# that took the whole width.
sharding_probe = None


def _probe(stage: str, width: int) -> None:
    if sharding_probe is not None:
        sharding_probe(stage, width)


def run_stage(remat, volume_sized: bool, function, *inputs):
    """``function(*inputs)``, checkpointed when the ``remat`` policy covers
    the stage (``True``: every stage; ``"selective"``: the volume-sized
    ones) and autograd records. The recompute repeats a deterministic
    forward (nothing draws random numbers)."""
    if (torch.is_grad_enabled()
            and (remat is True or (remat == "selective" and volume_sized))):
        return torch.utils.checkpoint.checkpoint(
            function, *inputs, use_reentrant=False, preserve_rng_state=False)
    return function(*inputs)


class ContractionBlock(nn.Module):

    def __init__(self, features: int):
        super().__init__()
        self._downsampling_2x = blocks.conv3d_block(features, 2 * features,
                                                    stride=2)
        self._smoothing = blocks.conv3d_block(2 * features, 2 * features)

    def forward(self, x: torch.Tensor, columns=None):
        """Returns (pre-smooth ``down``, smoothed)."""
        down = self._downsampling_2x(x, columns)
        return down, self._smoothing(down, columns)


class ExpansionBlock(nn.Module):

    def __init__(self, features: int):
        super().__init__()
        self._upsampling_2x = blocks.conv_transpose3d_block(features,
                                                            features // 2)
        self._smoothing = blocks.conv3d_block(features // 2, features // 2)

    def forward(self, x: torch.Tensor, skip: torch.Tensor,
                columns=None) -> torch.Tensor:
        return self._smoothing(self._upsampling_2x(x, columns) + skip,
                               columns)


class Regularization(nn.Module):

    def __init__(self, number_of_features: int = 8):
        super().__init__()
        features = number_of_features
        self._smoothing = blocks.conv3d_block(features, features)
        self._contraction_blocks = nn.ModuleList(
            [ContractionBlock(features * scale)
             for scale in _CONTRACTION_WIDTH_SCALES])
        self._expansion_blocks = nn.ModuleList(
            [ExpansionBlock(features * scale)
             for scale in _EXPANSION_WIDTH_SCALES])
        self._upsample_to_halfsize = blocks.conv_transpose3d_block(
            features, features // 2)
        self._upsample_to_fullsize = blocks.ConvTranspose3d(
            features // 2, 1, (3, 4, 4), (1, 2, 2), (1, 1, 1))

    def hourglass_core(self, signatures: torch.Tensor,
                       shortcut_from_left_image: torch.Tensor,
                       remat=False, columns=None) -> torch.Tensor:
        """Smoothing + 4 contractions + 4 expansions at quarter
        resolution: ``[B, C, D', H, W]`` -> ``[B, C, D', H, W]``. Volume-
        sized: the smoothing, the first contraction and the last
        expansion."""
        _probe("matching_handoff", signatures.shape[-1])
        shortcut = shortcut_from_left_image[:, :, None]
        output = run_stage(remat, True, self._smoothing, signatures, columns)
        _probe("smoothing", output.shape[-1])
        skips = []
        for index, contraction in enumerate(self._contraction_blocks):
            skips.append(output)
            shortcut, output = run_stage(remat, index == 0, contraction,
                                         shortcut + output, columns)
            _probe(f"contraction{index + 1}", output.shape[-1])
        last = len(self._expansion_blocks) - 1
        for index, expansion in enumerate(self._expansion_blocks):
            output = run_stage(remat, index == last, expansion, output,
                               skips.pop(), columns)
            _probe(f"expansion{index + 1}", output.shape[-1])
        return output

    def _upsample(self, output: torch.Tensor, columns) -> torch.Tensor:
        half = self._upsample_to_halfsize(output, columns)
        _probe("upsample_to_halfsize", half.shape[-1])
        return self._upsample_to_fullsize(half, columns)[:, 0]

    def final_upsampling(self, output: torch.Tensor, remat=False,
                         columns=None) -> torch.Tensor:
        """``[B, C, D', H, W]`` -> ``[B, 2D', 4H, 4W]`` similarities; both
        upsamplers are one volume-sized stage."""
        similarities = run_stage(remat, True, self._upsample, output,
                                 columns)
        _probe("similarities", similarities.shape[-1])
        return similarities

    def forward(self, signatures: torch.Tensor,
                shortcut_from_left_image: torch.Tensor,
                remat=False, columns=None) -> torch.Tensor:
        """Regularised similarities for even disparities.

        Args:
            signatures: ``[B, C, D', H/4, W/4]`` matching signatures.
            shortcut_from_left_image: ``[B, C, H/4, W/4]``.
            remat: ``False``, ``True`` or ``"selective"``.
            columns: this process's W-slice (``parallel/sharding.py``),
                of which the two inputs hold the columns; None: the whole
                width.

        Returns:
            ``[B, H, W, 2*D']``, disparity last (element ``d`` scores
            disparity ``2*d`` pixels): a view of the disparity-major
            ``[B, 2*D', H, W]`` result, not a copy; of this process's
            columns under ``columns``.
        """
        output = self.hourglass_core(signatures, shortcut_from_left_image,
                                     remat, columns)
        return self.final_upsampling(output, remat, columns).permute(
            0, 2, 3, 1)
