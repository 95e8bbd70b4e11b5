#!/usr/bin/env python3
"""Readings that set a cell's limits, on the chip, in one process: for
each seed the cell's engine, weights and traffic at its own load for a
short window, then the check a run makes (``cell.judge``: the reference
over a sample of the finished calls, each number beside the cell file's
limit), and for the control seeds the same check with the fp8 control's
token gaps on the same prompts and tokens in the port's place.

    python3 portbench/calibrate.py --workload <cell> --seeds 101-112 \\
        --control 101,102,103 --seconds 20 [--out chiprun_out/cal.jsonl]

One JSON line a seed: the port's numbers and whether they are
``correct`` under the cell's limits, and, where asked, the control's
(which has to come out not correct).  Not run by the benchmark's own
runs.
"""
import os
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
    p for p in sys.path[1:] if p not in (str(ROOT), str(ROOT / "src"))]
os.environ.setdefault("OMP_NUM_THREADS", "4")


def seeds(text: str):
    out = []
    for part in text.split(","):
        if "-" in part[1:]:
            a, b = part.split("-", 1)
            out.extend(range(int(a), int(b) + 1))
        elif part:
            out.append(int(part))
    return out


def main(argv) -> int:
    import argparse
    import json

    from portbench.harness import cell
    from portbench.harness.spec import Bench

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", default="")
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=str(ROOT),
                    help="a benchmark root other than this checkout")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    bench = Bench(args.root)
    ctrl = set(seeds(args.control))
    for seed in seeds(args.seeds):
        s = cell.set_up(bench, args.workload, seed, args.device, warm=False)
        win, stats = cell.drive(s, args.seconds)
        cell.tear_down(s)
        data = cell.RunData(s.cell, s.model, args.seconds, 0.0, win, stats,
                            int(s.engine_cfg["page_size"]))
        got = cell.judge(data, seed, s.device, s.engine_cfg,
                         control=seed in ctrl)
        port, control = got if seed in ctrl else (got, None)

        def summary(checks):
            return {"correct": cell.correct(checks),
                    **{k: c["value"] for k, c in checks.items()}}

        row = {"workload": args.workload, "seed": seed,
               "finished": sum(r.tokens is not None for r in win.records),
               "port": summary(port),
               "control": None if control is None else summary(control)}
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
