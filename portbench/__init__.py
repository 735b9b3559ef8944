"""The benchmark of ``deflate_rs_tpu_torch`` on NVIDIA GPUs.

One command runs one cell of ``BENCHMARK.json`` once and prints one JSON
line (see ``portbench/run.py``).  Everything the harness measures with is
here and is found by name: a configuration is ``configs/<name>.json``, a
traffic mix ``traffic/<name>.json``, a cell's correctness limits
``checks/<cell>.json``, a form of running the program ``drivers/<form>.py``,
an end-to-end metric ``end_to_end/<name>.py`` and a per-layer metric
``metrics/<name>.py``.  A later cell adds files; it edits none.

The harness imports neither ``jax`` nor the JAX package ``deflate_rs_tpu``;
the plain reference (``reference.py``) imports nothing of the program.
"""
