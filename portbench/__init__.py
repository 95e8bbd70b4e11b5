"""portbench: the benchmark of the PyTorch and CUDA port (``repro_torch``).

One command runs one cell of ``BENCHMARK.json`` once::

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by its name:
``configs/<config>.json``, ``traffic/<traffic>.json``,
``cells/<cell>.json``, ``metrics/<metric>.py``, the loop a traffic
file names, ``loops/<loop>.py``, and the architecture a configuration
names, ``archs/<arch>.py``.  A configuration names it in its ``model``
section as ``"arch": "<arch>"`` (without the key it is ``gqa``); the key
is dropped before the port's ``ModelConfig`` is built.  An architecture
module gives the checkpoint layout the port loads, the plain float32
reference with its fp8 control, the bytes the port's page pool holds a
token and the model FLOPs of a token (``archs/__init__.py``), so a model
whose layers the harness does not know yet is added by new files alone.
The yardstick (``yardstick/``: peaks, operation and byte counts), the
plain reference (``reference/``: the weights maker and the float32
model's parts) and the architectures are frozen with the benchmark.
"""
