"""End-to-end real run on the port: serve a small model against
batched requests.

    PYTHONPATH=src python examples/torch_batch_analytics.py [--queries 4] \\
        [--device cpu]

Runs the W5 TPCH-Trident workflow with real components: tiny PyTorch
models behind the port's InferenceEngines (continuous batching + prefix
sharing + model switching), the minidb SQL backend, signature
coalescing, and a checkpoint that the run can resume from; asserts that
the resumed run gives the same results (``examples/batch_analytics.py``
does the same through the JAX package).  The engines run on the card
(``--device cuda``, the default; it raises without one) or, asked for,
on the CPU.
"""
import argparse
import os
import tempfile
import time
from typing import Optional, Sequence

import torch

from repro_torch.configs import get_smoke
from repro_torch.core import (CostModel, EpochDPSolver, HARDWARE, PAPER_MODELS,
                              SolverConfig, consolidate)
from repro_torch.runtime import ProcessorConfig, RealProcessor
from repro_torch.workloads import build_workload
from repro_torch.workloads.datagen import build_database
from repro_torch.workloads.tools import ToolRuntime


def main(argv: Optional[Sequence[str]] = None) -> None:
    """Plan, serve, then resume from the checkpoint."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--queries", type=int, default=4)
    ap.add_argument("--workload", default="w5")
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise RuntimeError("torch_batch_analytics: device 'cuda' requested "
                           "but no CUDA device is available; pass --device "
                           "cpu")

    graph, bindings, dbname = build_workload(args.workload, args.queries)
    cons = consolidate(graph, bindings)
    db = build_database(dbname)
    tools = ToolRuntime(db, latency_scale=0.0)
    # the three serving models are hosted as tiny same-family models
    models = {m: get_smoke("qwen3-1.7b").replace(name=m)
              for m in ("qwen3-14b", "qwen3-32b", "gpt-oss-20b")}

    cm = CostModel(graph, HARDWARE["h200"], PAPER_MODELS,
                   batch_sizes={n: cons.macro(n).n_unique
                                for n in graph.nodes})
    plan = EpochDPSolver(graph.llm_dag(), cm,
                         SolverConfig(num_workers=args.workers)).solve()
    print(f"plan: {len(plan.epochs)} epochs "
          f"(solver {plan.solver_seconds*1e3:.0f} ms)")

    proc = RealProcessor(graph, models, tools,
                         config=ProcessorConfig(
                             num_workers=args.workers, decode_cap=6,
                             engine_kwargs={"device": args.device}))
    ckpt = os.path.join(tempfile.gettempdir(), "halo_example_ckpt.json")
    t0 = time.time()
    rep = proc.run(cons, plan, checkpoint_path=ckpt)
    print(f"\ncompleted {cons.n_queries} queries in {time.time()-t0:.1f}s")
    print("coalescing:", rep.coalesce_stats)
    print("model switches:", rep.extra["model_switches"],
          "| prefill tokens saved:", rep.extra["prefill_tokens_saved"])
    q0 = {k: v[:60] for k, v in rep.results().items()
          if k.startswith("0:") and "report" in k or "judge" in k}
    for k, v in sorted(q0.items())[:3]:
        print(f"  {k}: {v}...")

    # resume from checkpoint: instant
    t0 = time.time()
    rep2 = proc.run(cons, plan, resume_from=ckpt)
    assert rep2.results() == rep.results()
    print(f"resume from checkpoint: {time.time()-t0:.2f}s "
          f"({rep2.coalesce_stats['restored_results']} results restored)")


if __name__ == "__main__":
    main()
