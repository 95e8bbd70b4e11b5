"""Mixed multi-template batch -> one mega-DAG -> the port's engines.

Submits an interleaved wd+wt+w4 batch through ``consolidate_multi``
(DESIGN.md §8.1) and the port's real Processor, printing the coalescing
summary: which requests merged across templates, how many plan epochs
interleave macro-nodes of different templates, and the engine's
page-sharing counters (``examples/mixed_batch.py`` does the same through
the JAX package).

    PYTHONPATH=src python examples/torch_mixed_batch.py [--device cpu]

The engines run on the card (``--device cuda``, the default; it raises
without one) or, asked for, on the CPU.
"""
import argparse
from typing import Optional, Sequence

import torch

from repro_torch.configs import get_smoke
from repro_torch.core import (EpochDPSolver, HARDWARE, PAPER_MODELS,
                              SolverConfig, CostModel, consolidate_multi)
from repro_torch.runtime import ProcessorConfig, RealProcessor
from repro_torch.workloads import build_mixed_workload
from repro_torch.workloads.datagen import build_database
from repro_torch.workloads.tools import ToolRuntime


def smoke_models_for(g):
    """Every model the graph names on the tiny smoke qwen3 (the helper of
    benchmarks/common.py, on the port)."""
    names = {g.nodes[n].model for n in g.llm_nodes()}
    return {m: get_smoke("qwen3-1.7b").replace(name=m) for m in names}


def main(argv: Optional[Sequence[str]] = None) -> None:
    """Consolidate, plan and serve the mixed batch."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise RuntimeError("torch_mixed_batch: device 'cuda' requested but "
                           "no CUDA device is available; pass --device cpu")

    # --- consolidate three templates' queries into ONE mega-DAG ----------
    batches, db = build_mixed_workload(6, seed=0)      # wd + wt + w4, 2 each
    mc = consolidate_multi(batches)
    graph = mc.template
    print("templates:", mc.template_names)
    print("mega-DAG:", len(graph.nodes), "nodes /",
          len(graph.llm_nodes()), "LLM")

    xt = mc.cross_template_summary()
    print("cross-template:", xt)
    for nid, row in sorted(mc.coalescing_summary().items()):
        if row["unique"] != row["physical"]:           # merged away
            print(f"  {nid}: {row}")

    # --- plan it as one batch (epochs may interleave templates) ----------
    cm = CostModel(graph, HARDWARE["h200"], PAPER_MODELS,
                   batch_sizes={n: len(mc.macro(n).bindings)
                                for n in graph.nodes},
                   warm_aliases=mc.warm_aliases())
    plan = EpochDPSolver(graph.llm_dag(), cm,
                         SolverConfig(num_workers=2)).solve()
    for i, e in enumerate(plan.epochs):
        tmpls = sorted({mc.template_of[v] for c in e.components for v in c})
        print(f"epoch {i}: {e.components} on workers {e.workers} "
              f"(templates {tmpls})")

    # --- run it on real continuous-batching engines ----------------------
    proc = RealProcessor(graph, smoke_models_for(graph),
                         ToolRuntime(build_database(db), latency_scale=0.0),
                         config=ProcessorConfig(
                             num_workers=2, decode_cap=3,
                             engine_kwargs={"device": args.device}))
    report = proc.run(mc, plan)
    print("makespan:", round(report.makespan, 2), "s")
    print("coalesce:", report.coalesce_stats)
    print("pages_shared:", report.extra["pages_shared"],
          "tokens_reused:", report.extra["tokens_reused"])


if __name__ == "__main__":
    main()
