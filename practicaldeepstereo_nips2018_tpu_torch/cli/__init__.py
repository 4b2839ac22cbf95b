"""Command-line entry points, each run as
``python -m practicaldeepstereo_nips2018_tpu_torch.cli.<name>`` and each
with a ``main(argv=None)`` that can be called in-process:

``train_flyingthings3d``            train (and resume) on FlyingThings3D
``benchmark_flyingthings3d``        MAE, 3PE and time per image (PSM, CRL)
``finetune_kitti``                  fine-tune on KITTI 2012 + 2015
``export_kitti_submission``         KITTI submission PNGs
``import_torch_checkpoint``         reference ``.bin`` -> ``.npz``
``precompute_disparity_statistics`` FlyingThings3D statistics caches

They keep the flags and defaults of the JAX package's ``scripts/``. The
four that run the network add ``--device`` (default ``cuda``). Flags of
features the port does not have yet are accepted at their default only.
"""
