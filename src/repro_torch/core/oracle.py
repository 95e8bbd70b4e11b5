"""Continuous-time oracle (§6.3) — exact branch-and-bound scheduler.

The paper's oracle is a continuous-time MILP (Gurobi-class).  Offline
here, we implement the equivalent exact search directly: branch over
(ready node → worker) decisions in event order, bound with the
remaining-critical-path lower bound, and return the makespan-optimal
schedule.  Exponential — intended for the small W1/W6-scale instances
of Table 4, where the MILP itself needs hours.

A copy of the JAX package's module of the same name, with the import prefix
``repro.`` read as ``repro_torch.``; ``tests/test_torch_copies.py`` holds
the two equal.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.core.cost_model import CostModel
from repro_torch.core.graphspec import LLMDag
from repro_torch.core.plan import ExecutionPlan
from repro_torch.core.schedulers import _continuous_to_plan
from repro_torch.core.state import WorkerContext


@dataclass
class OracleResult:
    """The oracle's makespan-optimal schedule + search statistics."""

    makespan: float
    assign: Dict[str, int]
    start: Dict[str, float]
    plan: ExecutionPlan
    solver_seconds: float
    nodes_expanded: int


class BranchAndBoundOracle:
    """Exact (exponential) branch-and-bound scheduler — the Opt(S) ref."""

    def __init__(self, dag: LLMDag, cm: CostModel, num_workers: int,
                 time_limit: float = 120.0):
        self.dag = dag
        self.cm = cm
        self.W = num_workers
        self.time_limit = time_limit
        self.best = float("inf")
        self.best_sched: Optional[Tuple[Dict[str, int], Dict[str, float]]] = None
        self.expanded = 0
        self._t0 = 0.0
        # critical-path LOWER bounds: each node costed optimistically
        # (model already resident, parent lineage warm, prep overlapped) —
        # an admissible bound; fresh-context costs would over-prune
        self._cost: Dict[str, float] = {}
        for v in dag.node_ids:
            spec = dag.spec(v)
            warm_ctx = WorkerContext(model=spec.model,
                                     warm=tuple(dag.parents(v))[-2:])
            self._cost[v] = cm.t_infer(spec, warm_ctx, dag.parents(v))
        self._cp: Dict[str, float] = {}
        topo_llm = [v for v in dag.graph.topo_order() if v in set(dag.node_ids)]
        for v in reversed(topo_llm):
            succ = dag.children(v)
            self._cp[v] = self._cost[v] + (
                max(self._cp[s] for s in succ) if succ else 0.0)

    # ------------------------------------------------------------------
    def _branch(self, done: frozenset, finish: Dict[str, float],
                ready_time: List[float], ctxs: List[WorkerContext],
                assign: Dict[str, int], start: Dict[str, float],
                elapsed_max: float) -> None:
        self.expanded += 1
        if time.perf_counter() - self._t0 > self.time_limit:
            return
        if len(done) == len(self.dag.node_ids):
            if elapsed_max < self.best:
                self.best = elapsed_max
                self.best_sched = (dict(assign), dict(start))
            return
        frontier = self.dag.frontier(done)
        # lower bound: some pending node's critical path must still run
        lb = max(min(ready_time) + min(self._cp[v] for v in frontier),
                 elapsed_max)
        if lb >= self.best:
            return
        # branch on (node, worker); order workers by readiness for pruning
        for v in sorted(frontier, key=lambda x: -self._cp[x]):
            dep_ready = max((finish[p] for p in self.dag.parents(v)),
                            default=0.0)
            tried: set = set()
            for w in sorted(range(self.W), key=lambda w: ready_time[w]):
                ctx_key = (ctxs[w], round(max(ready_time[w], dep_ready), 9))
                if ctx_key in tried:          # symmetric worker pruning
                    continue
                tried.add(ctx_key)
                t, nctx = self.cm.t_node(v, ctxs[w], done)
                st = max(ready_time[w], dep_ready)
                ft = st + t
                if ft + (self._cp[v] - self._cost[v]) >= self.best:
                    continue
                assign[v], start[v], finish[v] = w, st, ft
                old_rt, old_ctx = ready_time[w], ctxs[w]
                ready_time[w], ctxs[w] = ft, nctx
                self._branch(done | {v}, finish, ready_time, ctxs,
                             assign, start, max(elapsed_max, ft))
                ready_time[w], ctxs[w] = old_rt, old_ctx
                del assign[v], start[v], finish[v]

    # ------------------------------------------------------------------
    def solve(self) -> OracleResult:
        """Exhaustive search (within time_limit) for the optimal plan."""
        self._t0 = time.perf_counter()
        self._branch(frozenset(), {}, [0.0] * self.W,
                     [WorkerContext() for _ in range(self.W)], {}, {}, 0.0)
        assert self.best_sched is not None, "oracle found no schedule"
        assign, start = self.best_sched
        plan = _continuous_to_plan(self.dag, self.cm, self.W, assign, start,
                                   "oracle")
        dt = time.perf_counter() - self._t0
        plan.solver_seconds = dt
        return OracleResult(self.best, assign, start, plan, dt, self.expanded)
