#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once, from the root of a checkout:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result (JSON); the numbers the
correctness check compares, each beside its limit, are the last lines of
standard error.  Without a CUDA device, or outside a checkout that holds
the port (``src/repro_torch``), it exits non-zero and prints no result.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
# the checkout's own port, and portbench as a package; not this folder
sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
    p for p in sys.path[1:] if p not in (str(ROOT), str(ROOT / "src"))]
# every build and kernel cache inside the checkout, at fixed paths (the
# port's kernel library builds under src/repro_torch/kernels/build/)
_CACHE = ROOT / ".portbench-cache"
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(_CACHE / sub)
os.environ.setdefault("OMP_NUM_THREADS", "4")

from portbench.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START, ROOT))
