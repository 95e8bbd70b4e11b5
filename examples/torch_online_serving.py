"""Online serving on the PyTorch port: streaming arrivals, overlapping
plan instances.

    PYTHONPATH=src python examples/torch_online_serving.py

Streams 96 queries of W3 at 4 QPS into micro-batches of 16, with
cross-instance result caching (DB results fetched by earlier batches are
reused by later ones), then injects a mid-run worker failure and shows
the run still completing via plan redistribution, through
``repro_torch``'s discrete-event simulators (``examples/online_serving.py``
does the same through the JAX package and prints the same lines).  It
touches no device.
"""
from typing import Optional, Sequence

from repro_torch.core import (CostModel, EpochDPSolver, HARDWARE, PAPER_MODELS,
                              SolverConfig, consolidate)
from repro_torch.runtime import OnlineSimulator
from repro_torch.runtime.simulator import ClusterSimulator
from repro_torch.workloads import build_workload


# the benchmarks' helpers this example needs (benchmarks/common.py's
# setup, make_cm and halo_plan), on the port
def setup(workload: str, n: int, seed: int = 0):
    g, bindings, _ = build_workload(workload, n, seed=seed)
    return g, consolidate(g, bindings), bindings


def make_cm(g, cons, *, logical_tools=False, hardware="h200", **kw):
    batch = {}
    for nid in g.nodes:
        m = cons.macro(nid)
        # tools price their PHYSICAL count
        batch[nid] = (m.n_logical if (g.nodes[nid].is_llm() or logical_tools)
                      else len(cons.physical_signatures(nid)))
    return CostModel(g, HARDWARE[hardware], PAPER_MODELS,
                     batch_sizes=batch, warm_aliases=cons.warm_aliases(),
                     **kw)


def halo_plan(g, cons, workers=3, **cm_kw):
    cm = make_cm(g, cons, **cm_kw)
    return EpochDPSolver(g.llm_dag(), cm,
                         SolverConfig(num_workers=workers)).solve()


def main(argv: Optional[Sequence[str]] = None) -> None:
    """Stream the micro-batches, then rerun them with a worker lost."""
    g, cons, bindings = setup("w3", 96)
    plan = halo_plan(g, cons, 3)
    batches = [(consolidate(g, bindings[lo:lo + 16]), plan)
               for lo in range(0, 96, 16)]

    rep = OnlineSimulator(g, make_cm(g, cons), 3).run(batches, 4.0)
    print("online:", rep.summary())
    print(f"sustained {rep.throughput_qps():.2f} QPS over "
          f"{rep.makespan:.1f}s; tool dedup "
          f"{rep.coalesce_stats['tool_dedup_ratio']:.2f} "
          f"(cross-instance caching included)")

    # ---- fault tolerance: kill worker 1 a third of the way in ----------
    sim = ClusterSimulator(g, make_cm(g, cons), 3)
    for cb, p in batches:
        sim.add_instance(cb, p, arrival=0.0)
    sim.add_failure(rep.makespan * 0.3, worker=1)
    rep2 = sim.run()
    done = len({(r.instance, r.node) for r in rep2.records if r.kind == "llm"})
    print(f"\nwith worker-1 failure at t={rep.makespan*0.3:.1f}s: "
          f"completed {done} LLM macro-nodes across "
          f"{len(batches)} instances in {rep2.makespan:.1f}s "
          f"(failure event: {rep2.extra})")


if __name__ == "__main__":
    main()
