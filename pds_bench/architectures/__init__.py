"""Yardsticks, one module per architecture, found by name.

A configuration file names its architecture under ``"architecture"``
(``"pds"`` where it names none); ``registry.cell`` then loads
``architectures/<architecture>.py``, the yardstick, and
``drivers/<architecture>.py``, the driver of the port. A ``model_config``
change that brings a new architecture adds only new files:

* ``configs/<configuration>.json``: the sizes as they are run, with the
  keys every cell reads: ``height``, ``width``,
  ``serve_maximum_disparity`` or ``train_maximum_disparity``,
  ``learning_rate`` and ``ground_truth`` (``maximum``, ``unknown_share``)
  for training, and ``"architecture"``;
* ``architectures/<architecture>.py``: the yardstick, plain PyTorch that
  imports nothing of the port;
* ``drivers/<architecture>.py``: the port's entry points;
* ``traffic/<traffic>.json``, ``limits/<workload>.json`` and any new
  ``metrics/<base>.py``, as for any cell.

The yardstick provides:

* ``weight_layout(config)``: per state_dict key, in the order the weights
  are drawn, ``{"shape": ..., "fan_in": n}`` for a key drawn uniform over
  ``+-1 / sqrt(n)``, or ``{"shape": ..., "fill": value}`` (with
  ``"dtype"``, a ``torch`` dtype's name, where it is not float32) for a
  key filled with ``value`` (``generator.make_weights``);
* ``reference_map(weights, config, left, right, maximum_disparity,
  quantize)``: the float32 reference's served maps ``[B, H, W]`` of a
  batch of images ``[B, H, W, 3]``, each operand through ``quantize``;
* ``serve_readings(weights, config, left, right, maps, maximum_disparity,
  device)``: per pixel, what the served ``maps`` (sample index -> map)
  read against the reference; ``serve_numbers(readings)``, the numbers
  compared, and ``serve_diagnostics(readings)``, others for
  ``calibrate.py``;
* ``reference_steps(weights, config, batches, maximum_disparity,
  quantize)``: the reference trained over ``batches`` (each ``(left,
  right, ground_truth)``) from ``weights``, in float32 with TF32 off:
  (each step's loss, the first gradient by key, each key's change);
* ``useful_macs(config, kind)``: useful multiply-adds of one image in a
  ``"serve"`` or ``"train"`` cell;
* ``LOWERED``: name -> ``quantize``, the reference in lower precisions,
  the controls ``reference_<name>`` of ``calibrate.py``.

The driver provides:

* ``serving(config, traffic, weights, device, **options)``: (the
  session's ``predict``, taking ``[B, H, W, 3]`` host arrays and giving a
  ``[B, H, W]`` host map, the module tree that ``spans.Spans`` hooks);
* ``Training(config, weights, device, **options)``: ``network`` (the
  module tree), ``optimizer``, ``step(left, right, ground_truth)`` giving
  the loss as a device scalar, and ``gradient_magnitudes()``, each
  parameter's first gradient's magnitude read from the optimizer's state
  after one step;
* ``CONTROLS``: name -> the options of the port's own lower-precision
  serving path, the controls ``control_<name>`` of ``calibrate.py``;
* ``planted(name)``: a context manager that plants fault ``name`` in the
  port, and ``SERVE_FAULTS``, ``TRAIN_FAULTS``: the faults a serving and
  a training cell can have.
"""
