#!/usr/bin/env python3
"""The ``[dryrun.sweep]`` phase of ``chip_smoke.py`` alone.

    python3 tools/dryrun_sweep.py [--wait SECONDS]

Starts ``chip_smoke.DryrunSweep`` (the dry run over all ten archs and four
shapes on the 16 x 16 and the 2 x 16 x 16 mesh, in the processes of
``chip_smoke.SWEEP_GROUPS``) and joins it with
``chip_smoke.dryrun_sweep_phase``: every cell must report with no error,
or with ``--wait S`` every 16 x 16 cell, the 2 x 16 x 16 cells still
running S seconds after the start being cut.
Prints the phase's lines.  Needs no card (meta tensors over a fake
process group), so it runs here and on the card's machine alike, under
whichever torch is installed; imports no JAX.
"""
import argparse
import pathlib
import shutil
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--wait", type=float, default=float("inf"))
    args = ap.parse_args(argv)
    import torch

    import chip_smoke as cs
    print(f"[env] torch={torch.__version__}", flush=True)
    out = pathlib.Path(tempfile.mkdtemp(prefix="dryrun_sweep_"))
    sweep = cs.DryrunSweep(out)
    try:
        cs.dryrun_sweep_phase(sweep, args.wait)
    finally:
        sweep.kill()
        shutil.rmtree(out, ignore_errors=True)
    print(f"[done] wall_s={time.perf_counter() - sweep.t0:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
