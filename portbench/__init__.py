"""portbench: the benchmark of the PyTorch and CUDA port (``repro_torch``).

One command runs one cell of ``BENCHMARK.json`` once::

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by its name:
``configs/<config>.json``, ``traffic/<traffic>.json``,
``cells/<cell>.json``, ``metrics/<metric>.py`` and the loop a traffic
file names, ``loops/<loop>.py``.  The yardstick
(``yardstick/``: peaks, operation and byte counts) and the plain
reference (``reference/``: the weights maker and the float32 model) are
frozen with the benchmark.
"""
