"""The benchmark of ``repro_torch`` on one NVIDIA H100.

``run.py`` is the entry point.  Everything here is driven by data: a cell
of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``) and
a traffic mix (``traffic/<name>.json``), its limits for ``correct`` live
in ``limits/<cell>.json``, and each per-layer metric is read by
``metrics/<metric>.py``.  A configuration names its plain model,
``reference/<reference>.py`` (its loss and its model FLOPs), and may
group its leaves in stacks of layers (``weights.stacks``).  A new cell,
mix, metric or architecture is new files.

Nothing here imports ``jax`` or the JAX package ``repro``; the plain
float32 reference in ``reference/`` imports nothing of ``repro_torch``.
"""
