"""Practical Deep Stereo — PyTorch and CUDA port for NVIDIA Hopper.

The PyTorch counterpart of ``practicaldeepstereo_nips2018_tpu`` (the JAX
package, which stays the reference). It computes the same functions with
PyTorch idiom: ``nn.Module``s whose state_dict keys are the reference
``PdsNetwork``'s, channels-first tensors inside, and the JAX package's
layouts (NHWC images, disparity-last similarities) at the public functions.

The two Pallas kernels of the JAX package are CUDA C++ kernels here
(``csrc/``), built with ``nvcc`` for ``sm_90a`` at first use:

* ``ops.conv3d.conv3d_k3s1`` — the stride-1 3x3x3 conv of the hourglass;
* ``ops.subpixel.subpixel_map`` — the fused sub-pixel MAP estimator.

Each has a plain PyTorch version beside it, used for tensors on the CPU;
the conv also computes its input gradient (``ops.conv3d.Conv3dK3S1``).
Entry points (``models.infer``, ``serving.InferenceSession``,
``training.trainer.train_step`` / ``eval_step``) run on the card unless the
caller passes ``device="cpu"``.

Subpackages
-----------
``ops``       padding, cost volume, the two kernels and their plain versions,
              the loss and the error metrics.
``models``    the PDS network: embedding, matching, 3-D hourglass.
``training``  weight bridge to the JAX parameter layout, checkpoints,
              RMSprop and its schedule, the train and eval steps.
``utils``     pictures of a run, profiling, FLOP counts.
"""

__version__ = "0.1.0"
