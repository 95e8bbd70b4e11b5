"""The command line: one run of one cell, its result as the last line of
standard output."""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

from portbench.harness import guard

EXIT_NO_DEVICE = 3
EXIT_FORBIDDEN = 4
EXIT_NO_PROGRAM = 5


def parse(argv):
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t_start: float, root: pathlib.Path) -> int:
    args = parse(argv)
    if args.seconds <= 0:
        print("--seconds must be positive", file=sys.stderr)
        return 2
    from portbench.harness.spec import Bench
    bench = Bench(root)
    chips = bench.cell(args.workload).chips
    bad = guard.forbidden()
    if bad:
        print(f"loaded before the run: {bad}", file=sys.stderr)
        return EXIT_FORBIDDEN
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " available", file=sys.stderr)
        return EXIT_NO_DEVICE
    try:
        import repro_torch
    except ImportError as e:
        print(f"the port is not in this checkout: {e}", file=sys.stderr)
        return EXIT_NO_PROGRAM
    here = pathlib.Path(repro_torch.__file__).resolve()
    if root / "src" not in here.parents:
        print(f"repro_torch comes from {here}, not from this checkout",
              file=sys.stderr)
        return EXIT_NO_PROGRAM
    from portbench.harness import cell
    try:
        result = cell.run(bench, args.workload, args.seed, args.seconds,
                          bool(args.trace), t_start)
    except cell.ForbiddenModules as e:
        print(str(e), file=sys.stderr)
        return EXIT_FORBIDDEN
    # again once tear-down, the reference and every metric reader have run
    bad = guard.forbidden()
    if bad:
        print(f"modules of JAX or the JAX package loaded after the window: "
              f"{bad}", file=sys.stderr)
        return EXIT_FORBIDDEN
    print(json.dumps(result))
    return 0
