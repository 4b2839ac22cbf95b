"""The benchmark of the PyTorch and CUDA port of Practical Deep Stereo.

One run of one cell, on a machine with its CUDA card, from the root of a
checkout::

    python3 -m pds_bench.run --workload ft3d-serve-b1 --seed 1 \\
        --seconds 20 --trace 0

``BENCHMARK.json`` at the root names the cells, configurations and
metrics; everything else is found by those names, so a new cell, traffic,
configuration, per-layer metric or architecture is a new file and a new
entry:

* ``configs/<name>.json``: a configuration, the network's widths and the
  protocol's sizes as they are run, with what was assumed, and the
  architecture it runs (``"architecture"``, ``"pds"`` where absent);
* ``architectures/<architecture>.py`` and ``drivers/<architecture>.py``:
  the architecture's yardstick and its driver of the port
  (``architectures/__init__.py`` says what each provides);
* ``traffic/<name>.json``: a traffic mix's parameters, read by the one
  generator (``generator.py``) and driven by ``cells.py``;
* ``metrics/<name>.py``: the reader of the per-layer metrics whose names
  start with ``<name>.`` (``record.py`` says what a reader gets);
* ``limits/<workload>.json``: the numbers that decide ``correct``, each
  limit with the readings it was set from (``calibrate.py`` takes them).

``reference.py`` (PDS's plain float32 network, estimator, loss and
RMSprop), ``accounting.py`` (useful work, kernel bounds, peaks) and the
yardsticks under ``architectures/`` import nothing of the port. Tests:
``python -m pytest pds_bench/tests``; those marked ``chip`` run only where
there is a card.
"""
