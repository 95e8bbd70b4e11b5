#!/usr/bin/env python3
"""Find an open-loop cell's knee once, on the chip: the highest offered
rate whose backlog does not grow over a window.  One process, one
engine; each rate runs a window at the traffic file's mix, then drains.

    python3 portbench/knee.py --workload <cell> --seed 5 \\
        --rates 3,4,5,6,7,8 --seconds 30

Per rate it prints the calls due, the backlog (due but unfinished) at
the window's half and at its close, and the p50 and p90 latency of the
first and the last third of the calls by due time.  The cell's
``rate_per_s`` is then set to about 0.8 of the knee by hand.  Not run by
the benchmark's own runs.
"""
import os
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
    p for p in sys.path[1:] if p not in (str(ROOT), str(ROOT / "src"))]
os.environ.setdefault("OMP_NUM_THREADS", "4")


def backlog(records, t):
    return sum(r.due <= t and (r.done is None or r.done > t)
               for r in records)


def main(argv) -> int:
    import argparse
    import json

    from portbench.harness import cell
    from portbench.harness.spec import Bench
    from portbench.harness.stats import latencies_ms, percentile
    from portbench.harness.traffic import Traffic

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=str(ROOT),
                    help="a benchmark root other than this checkout")
    args = ap.parse_args(argv)
    s = cell.set_up(Bench(args.root), args.workload, args.seed, args.device)
    for r in [float(x) for x in args.rates.split(",")]:
        spec = dict(s.traffic.spec, rate_per_s=r, drain_s=120)
        traffic = Traffic(spec, args.seed, s.engine_cfg["token_ids"])
        win = s.loop(s.engine, traffic, args.seconds)
        recs = win.records
        lat = latencies_ms([x.due for x in recs], [x.done for x in recs],
                           win.gave_up)
        third = max(1, len(lat) // 3)
        row = {"rate": r, "due": len(recs),
               "backlog_half": backlog(recs, win.opened + args.seconds / 2),
               "backlog_close": backlog(recs, win.closed),
               "p50_first": percentile(lat[:third], 50),
               "p90_first": percentile(lat[:third], 90),
               "p50_last": percentile(lat[-third:], 50),
               "p90_last": percentile(lat[-third:], 90),
               "p90_all": percentile(lat, 90),
               "lost": sum(x.done is None for x in recs)}
        print(json.dumps(row), flush=True)
    cell.tear_down(s)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
