"""The benchmark of ``metrovector_tpu_torch`` on NVIDIA H100 cards.

One command runs one cell (a configuration under a traffic mix) once::

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name from ``BENCHMARK.json`` at the repository root:
a cell names its configuration (``configs/<config>.json``) and its traffic
(``traffic/<traffic>.json``); the configuration names its generator
(``gen/``), the adapter that builds the program's engine (``program/``),
its plain reference (``reference/``) and its roofline (``roofline/``); the
traffic names its loop (``loops/``); every metric is a reader of its own
(``metrics/<metric>.py``). A cell, a traffic mix or a metric is added as new
files and new entries, without editing a file that is there.

Nothing here imports JAX or the JAX package; ``reference/`` imports nothing
of the program either.
"""
