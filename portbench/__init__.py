"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``).

One run measures one cell of ``BENCHMARK.json`` once::

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The harness is driven by data.  A cell names a configuration and a
traffic mix; each is a file of its own (``configs/<name>.json``,
``traffic/<name>.json``), the traffic file names the driver that runs it
(``drivers/<driver>.py``), each per-layer metric is a reader of its own
(``metrics/<metric>.py``) and each cell's correctness limits sit in
``limits/<cell>.json``.  A later cell, mix or metric is added by adding
files and entries, not by editing these.

Nothing here imports ``jax`` or the JAX package ``repro``; the plain
references under ``reference/`` import nothing of ``repro_torch`` either.
"""
