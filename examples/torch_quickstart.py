"""Quickstart on the PyTorch port: Halo in ~40 lines.

    PYTHONPATH=src python examples/torch_quickstart.py

Declares a 4-agent workflow, binds a batch of 64 queries, plans with the
epoch DP, and simulates against the OpWise baseline, through
``repro_torch`` (``examples/quickstart.py`` does the same through the
JAX package and prints the same lines).  It touches no device.
"""
from typing import Optional, Sequence

from repro_torch.core import (CostModel, EpochDPSolver, HARDWARE, PAPER_MODELS,
                              SolverConfig, consolidate, parse_workflow)
from repro_torch.runtime import OpWiseSimulator, SimulatedProcessor

workflow = {
    "name": "revenue-investigation",
    "nodes": [
        {"id": "search", "type": "llm", "model": "qwen3-14b",
         "prompt": "Summarize {{sql: SELECT sum(quantity) FROM lineitem "
                   "WHERE shipdate <= '$date'}} for $market",
         "max_new_tokens": 48, "est_prompt_tokens": 192},
        {"id": "analyze", "type": "llm", "model": "qwen3-32b",
         "prompt": "Attribute the revenue change in ${search}.",
         "max_new_tokens": 64, "est_prompt_tokens": 256},
        {"id": "connect", "type": "llm", "model": "gpt-oss-20b",
         "prompt": "Correlate {{http: GET /news?m=$market}} with ${search}.",
         "max_new_tokens": 48, "est_prompt_tokens": 256},
        {"id": "edit", "type": "llm", "model": "qwen3-32b",
         "prompt": "Write the final report from ${analyze} and ${connect}.",
         "max_new_tokens": 96, "est_prompt_tokens": 384},
    ],
}


def main(argv: Optional[Sequence[str]] = None) -> None:
    """Parse, consolidate, plan and simulate the workflow."""
    graph = parse_workflow(workflow)                       # §3 Parser
    print("nodes:", graph.topo_order())

    bindings = [{"market": m, "date": f"199{d}-06-01"}
                for m in ("us", "eu", "apac", "latam")
                for d in range(4)] * 4
    cons = consolidate(graph, bindings)                    # 64 queries
    print("coalescing:", cons.coalescing_summary())

    batch = {n: (cons.macro(n).n_logical if graph.nodes[n].is_llm()
                 else cons.macro(n).n_unique) for n in graph.nodes}
    cm = CostModel(graph, HARDWARE["h200"], PAPER_MODELS, batch_sizes=batch)
    plan = EpochDPSolver(graph.llm_dag(), cm,
                         SolverConfig(num_workers=3)).solve()  # §4 Optimizer
    print(f"\nplan ({plan.solver_seconds*1e3:.1f} ms solve):")
    for e in plan.epochs:
        print("  epoch:", list(zip(e.components, e.workers)))

    halo = SimulatedProcessor(graph, cm, 3).run(cons, plan)    # §5 Processor
    opwise = OpWiseSimulator(graph, cm, 3).run(cons)
    print(f"\nhalo   : {halo.makespan:6.1f}s  {halo.summary()}")
    print(f"opwise : {opwise.makespan:6.1f}s  "
          f"(x{opwise.makespan/halo.makespan:.2f})")


if __name__ == "__main__":
    main()
