"""Inference serving session: disparity prediction, numpy in and out.

Port of ``practicaldeepstereo_nips2018_tpu/serving.py::InferenceSession``:
the checkpoint -> weights plumbing (network-only restore), a warm-up per
served shape, and ``predict`` with host numpy arrays in and out
(``infer`` is the same on tensors that stay on the device).

Example:
    session = InferenceSession.from_checkpoint(
        "experiments/flyingthings3d/010_checkpoint.npz",
        PDSConfig(maximum_disparity=191))
    session.warmup(height=540, width=960)    # builds the kernels once
    disparity = session.predict(left, right)  # [B, H, W] float32

Batch > 1 runs by ``batched_mode``, the JAX session's three modes:

* ``"unroll"`` (default) and ``"map"``: one batch-1 forward per image, so a
  batch's output equals its images' batch-1 outputs. In the JAX package
  they differ in how one XLA program is compiled for the batch (unrolled
  copies or a ``lax.map`` loop); PyTorch runs eagerly and compiles
  nothing, so here the two are one path.
* ``"direct"``: one batched forward. Every stage treats the examples of a
  batch apart (instance norms, the int8 tail's per-pair scales; PSMNet's
  BatchNorm on its running statistics), so each output is its image's
  batch-1 result up to the card's roundings, which may differ with the
  batch size.

The session runs the network its configuration names: PDS for a
``PDSConfig``, PSMNet (``models/psmnet.py``: eval-mode BatchNorm, the
last head, images padded top and right to multiples of 16) for a
``PSMConfig``.
"""

from __future__ import annotations

import numpy as np
import torch

from practicaldeepstereo_nips2018_tpu_torch.device import resolve_device
from practicaldeepstereo_nips2018_tpu_torch.models import network as models
from practicaldeepstereo_nips2018_tpu_torch.models import psmnet
from practicaldeepstereo_nips2018_tpu_torch.training import checkpoint
from practicaldeepstereo_nips2018_tpu_torch.training import weights
from practicaldeepstereo_nips2018_tpu_torch.utils import profiling

BATCHED_MODES = ("unroll", "map", "direct")


class InferenceSession:
    """PDS or PSMNet disparity inference on one device."""

    def __init__(self, params: dict[str, torch.Tensor],
                 config: models.PDSConfig | psmnet.PSMConfig = (
                     models.PDSConfig()),
                 compute_dtype: torch.dtype | None = torch.bfloat16,
                 device: str | torch.device = "cuda",
                 batched_mode: str = "unroll"):
        """Args:
            params: state_dict of :class:`~.models.network.PdsNetwork`
                (reference key names; :meth:`from_checkpoint` or
                ``training.weights.state_dict_from_jax_params``), or of
                :class:`~.models.psmnet.PsmNetwork` (the published keys).
            config: static network configuration, a ``PDSConfig`` or a
                ``PSMConfig``.
            compute_dtype: compute dtype of the forward pass (bfloat16, the
                JAX session's default), or None for the image dtype.
            device: ``"cuda"`` (default) or ``"cpu"``; ``"cuda"`` without a
                card raises.
            batched_mode: ``"unroll"``, ``"map"`` or ``"direct"`` (see the
                module docstring).
        """
        if batched_mode not in BATCHED_MODES:
            raise ValueError(
                f'"batched_mode" must be "unroll", "map" or "direct", '
                f"got {batched_mode!r}")
        self._batched_mode = batched_mode
        self._device = resolve_device(device)
        if isinstance(config, psmnet.PSMConfig):
            network_class, self._infer_function = (psmnet.PsmNetwork,
                                                   psmnet.infer)
        else:
            network_class, self._infer_function = (models.PdsNetwork,
                                                   models.infer)
        with torch.device("meta"):
            network = network_class(config)
        network.load_state_dict(
            {key: value.contiguous() for key, value in params.items()},
            assign=True)
        self._network = network.to(self._device).eval()
        self._config = config
        self._compute_dtype = compute_dtype

    @classmethod
    def from_checkpoint(cls, filename: str,
                        config: models.PDSConfig = models.PDSConfig(),
                        compute_dtype: torch.dtype | None = torch.bfloat16,
                        device: str | torch.device = "cuda",
                        batched_mode: str = "unroll") -> "InferenceSession":
        """Builds a session from a JAX-written training checkpoint
        (network-only restore; optimizer state in the file is ignored)."""
        template = weights.jax_params_from_state_dict(
            {key: np.zeros(shape, np.float32)
             for key, shape in weights.network_shapes(config).items()})
        trees, _ = checkpoint.load_checkpoint(filename, {"params": template})
        return cls(weights.state_dict_from_jax_params(trees["params"]),
                   config, compute_dtype, device, batched_mode)

    def _infer(self, left, right) -> torch.Tensor:
        return self._infer_function(self._network, left, right, self._config,
                                    compute_dtype=self._compute_dtype,
                                    device=self._device)

    def warmup(self, height: int, width: int, batch: int = 1) -> None:
        """Runs one ``[batch, height, width, 3]`` request, which builds the
        kernels on first use. Call once per served shape before taking
        traffic."""
        zeros = np.zeros((batch, height, width, 3), np.float32)
        self.predict(zeros, zeros)

    def infer(self, left, right) -> torch.Tensor:
        """:meth:`predict` without the host copies: ``[B, H, W, 3]`` numpy
        arrays or tensors in (tensors already on the session's device are
        not copied), the ``[B, H, W]`` float32 map out as a tensor on the
        session's device, its work queued on the card and not waited
        for."""
        if left.ndim != 4 or tuple(left.shape) != tuple(right.shape):
            raise ValueError(f"expected two [B, H, W, 3] images of one shape, "
                             f"got {tuple(left.shape)} and "
                             f"{tuple(right.shape)}")
        if self._batched_mode == "direct":
            return self._infer(left, right)
        return torch.cat([self._infer(left[i:i + 1], right[i:i + 1])
                          for i in range(left.shape[0])])

    def predict(self, left_image, right_image) -> np.ndarray:
        """Returns the sub-pixel disparity map ``[B, H, W]`` float32.

        Args:
            left_image, right_image: ``[B, H, W, 3]`` RGB images, 0..255
                floats (any H, W: padded internally, to multiples of 64
                for PDS, of 16 for PSMNet).
        """
        with profiling.span("pds.predict"):
            disparity = self.infer(np.asarray(left_image, np.float32),
                                   np.asarray(right_image, np.float32))
            with profiling.span("pds.copy_out"):
                return disparity.cpu().numpy()

    @property
    def config(self) -> models.PDSConfig | psmnet.PSMConfig:
        return self._config
