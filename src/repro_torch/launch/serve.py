"""Serving launcher: Halo end-to-end over a workload, on the port.

    python -m repro_torch.launch.serve --workload w5 --queries 8
    python -m repro_torch.launch.serve --workload w1 --queries 64 --mode sim

``--mode real`` (the default) runs the consolidated batch through
``RealProcessor`` over the port's engines: full-width qwen3-1.7b (random
weights from ``--seed``) under the three model names the workflows use,
on the card (``--device cuda``, the default; it raises without one), at
most 8 queries and 2 workers.  ``--device cpu`` serves the smoke config
instead, as the JAX package's launcher does.  ``--mode sim`` runs the
same plan through the discrete-event ``SimulatedProcessor`` at the
requested ``--queries`` and ``--workers``, its latencies from the cost
model: it touches no device.  The plan is solved for ``--hardware``
(``h100`` by default).
"""
from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import torch

from repro_torch.configs import get_config, get_smoke
from repro_torch.core import (CostModel, EpochDPSolver, HARDWARE, PAPER_MODELS,
                              SolverConfig, consolidate)
from repro_torch.runtime import (ProcessorConfig, RealProcessor,
                                 SimulatedProcessor)
from repro_torch.workloads import build_workload
from repro_torch.workloads.datagen import build_database
from repro_torch.workloads.tools import ToolRuntime

MODEL_NAMES = ("qwen3-14b", "qwen3-32b", "gpt-oss-20b")
MAX_QUERIES = 8
DECODE_CAP = 8


def build_cost_model(graph, cons, hardware="h100", **kw):
    batch_sizes = {}
    for nid in graph.nodes:
        m = cons.macro(nid)
        batch_sizes[nid] = (m.n_logical if graph.nodes[nid].is_llm()
                            else m.n_unique)
    return CostModel(graph, HARDWARE[hardware], PAPER_MODELS,
                     batch_sizes=batch_sizes, **kw)


def model_configs(device: str):
    """The three model names on qwen3-1.7b: full width on the card, the
    smoke config on the CPU."""
    cfg = get_smoke("qwen3-1.7b") if device == "cpu" \
        else get_config("qwen3-1.7b")
    return {m: cfg.replace(name=m) for m in MODEL_NAMES}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="w1")
    ap.add_argument("--queries", type=int, default=MAX_QUERIES)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--mode", choices=("real", "sim"), default="real")
    ap.add_argument("--hardware", default="h100")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    real = args.mode == "real"
    if real and torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise RuntimeError("serve: device 'cuda' requested but no CUDA "
                           "device is available; pass --device cpu")

    n, workers = args.queries, args.workers
    if real:
        if n > MAX_QUERIES:
            print(f"[real mode] capping --queries {n} -> {MAX_QUERIES}")
            n = MAX_QUERIES
        workers = min(workers, 2)
    graph, bindings, dbname = build_workload(args.workload, n,
                                             seed=args.seed)
    cons = consolidate(graph, bindings)
    cm = build_cost_model(graph, cons, args.hardware)
    plan = EpochDPSolver(graph.llm_dag(), cm,
                         SolverConfig(num_workers=workers)).solve()
    print(f"plan: {len(plan.epochs)} epochs, predicted "
          f"{plan.predicted_cost:.2f}s, solver "
          f"{plan.solver_seconds * 1e3:.1f}ms")
    if not real:
        rep = SimulatedProcessor(graph, cm, workers).run(cons, plan)
        print(json.dumps(rep.summary(), indent=1))
        return 0
    proc = RealProcessor(
        graph, model_configs(args.device),
        ToolRuntime(build_database(dbname)),
        config=ProcessorConfig(num_workers=workers,
                               decode_cap=DECODE_CAP, seed=args.seed,
                               hardware=args.hardware,
                               engine_kwargs={"device": args.device}))
    rep = proc.run(cons, plan)
    rep.extra.pop("results", None)
    print(json.dumps(rep.summary(), indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
