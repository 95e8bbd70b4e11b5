"""Baseline schedulers (§6.3): Random, Round-Robin (Ray-style), HEFT,
plus the OpWise stage-synchronous executor (§6.1 baselines).

All emit the same ExecutionPlan format as the DP solver so the
Processor, simulator and Opt(S) metric treat them uniformly.

A copy of the JAX package's module of the same name, with the import prefix
``repro.`` read as ``repro_torch.``; ``tests/test_torch_copies.py`` holds
the two equal.
"""
from __future__ import annotations

import random
import time
from typing import Dict, List

from repro_torch.core.cost_model import CostModel
from repro_torch.core.graphspec import LLMDag
from repro_torch.core.plan import Epoch, ExecutionPlan
from repro_torch.core.state import SystemState, WorkerContext


# ---------------------------------------------------------------------------
def random_plan(dag: LLMDag, cm: CostModel, num_workers: int,
                seed: int = 0) -> ExecutionPlan:
    """Dispatch ready nodes uniformly at random to random workers."""
    t0 = time.perf_counter()
    rng = random.Random(seed)
    state = SystemState.initial(num_workers)
    plan = ExecutionPlan(scheduler_name="random")
    total = 0.0
    while len(state.done) < len(dag.node_ids):
        frontier = dag.frontier(state.done)
        k = rng.randint(1, min(len(frontier), num_workers))
        batch = rng.sample(sorted(frontier), k)
        workers = rng.sample(range(num_workers), k)
        comps = [[v] for v in batch]
        c, ctxs, _ = cm.epoch_cost(comps, workers, state)
        plan.epochs.append(Epoch(comps, list(workers), c))
        total += c
        state = SystemState(state.done | frozenset(batch), ctxs)
    plan.predicted_cost = total
    plan.solver_seconds = time.perf_counter() - t0
    plan.validate(dag)
    return plan


# ---------------------------------------------------------------------------
def round_robin_plan(dag: LLMDag, cm: CostModel,
                     num_workers: int) -> ExecutionPlan:
    """RayServe-style decentralized round-robin over ready operators."""
    t0 = time.perf_counter()
    state = SystemState.initial(num_workers)
    plan = ExecutionPlan(scheduler_name="rr")
    total = 0.0
    next_w = 0
    while len(state.done) < len(dag.node_ids):
        frontier = dag.frontier(state.done)
        batch = frontier[:num_workers]
        workers = [(next_w + i) % num_workers for i in range(len(batch))]
        next_w = (next_w + len(batch)) % num_workers
        comps = [[v] for v in batch]
        c, ctxs, _ = cm.epoch_cost(comps, workers, state)
        plan.epochs.append(Epoch(comps, workers, c))
        total += c
        state = SystemState(state.done | frozenset(batch), ctxs)
    plan.predicted_cost = total
    plan.solver_seconds = time.perf_counter() - t0
    plan.validate(dag)
    return plan


# ---------------------------------------------------------------------------
def heft_plan(dag: LLMDag, cm: CostModel, num_workers: int) -> ExecutionPlan:
    """HEFT: upward-rank priority + greedy earliest-finish-time placement.

    Continuous-time greedy; converted to epochs afterwards (each HEFT
    "wave" of simultaneously-startable nodes becomes one epoch).  Greedy
    EFT accounts for worker state (model residency) when estimating costs,
    but — unlike the DP — never looks ahead.
    """
    t0 = time.perf_counter()

    # upward ranks with mean execution cost over a fresh-context worker
    fresh = WorkerContext()
    mean_cost = {v: cm.t_node(v, fresh, frozenset())[0] for v in dag.node_ids}
    rank: Dict[str, float] = {}

    def _upward(v: str) -> float:
        if v in rank:
            return rank[v]
        succ = dag.children(v)
        rank[v] = mean_cost[v] + (max(_upward(s) for s in succ)
                                  if succ else 0.0)
        return rank[v]

    for v in dag.node_ids:
        _upward(v)
    order = sorted(dag.node_ids, key=lambda v: -rank[v])

    ready_time = [0.0] * num_workers
    ctxs: List[WorkerContext] = [WorkerContext() for _ in range(num_workers)]
    finish: Dict[str, float] = {}
    assign: Dict[str, int] = {}
    start: Dict[str, float] = {}
    done: set = set()

    for v in order:
        best = (float("inf"), -1, 0.0, None)
        dep_ready = max((finish[p] for p in dag.parents(v)), default=0.0)
        for w in range(num_workers):
            t, nctx = cm.t_node(v, ctxs[w], frozenset(done))
            st = max(ready_time[w], dep_ready)
            eft = st + t
            if eft < best[0]:
                best = (eft, w, st, nctx)
        eft, w, st, nctx = best
        assign[v], start[v], finish[v] = w, st, eft
        ready_time[w] = eft
        ctxs[w] = nctx
        done.add(v)

    plan = _continuous_to_plan(dag, cm, num_workers, assign, start,
                               "heft")
    plan.solver_seconds = time.perf_counter() - t0
    return plan


def _continuous_to_plan(dag: LLMDag, cm: CostModel, num_workers: int,
                        assign: Dict[str, int], start: Dict[str, float],
                        name: str) -> ExecutionPlan:
    """Convert a continuous-time schedule into precedence-valid epochs."""
    plan = ExecutionPlan(scheduler_name=name)
    state = SystemState.initial(num_workers)
    remaining = sorted(dag.node_ids, key=lambda v: start[v])
    total = 0.0
    while remaining:
        used: set = set()
        comps: List[List[str]] = []
        workers: List[int] = []
        taken: List[str] = []
        for v in remaining:
            w = assign[v]
            if w in used:
                continue
            if all(p in state.done for p in dag.parents(v)):
                comps.append([v])
                workers.append(w)
                used.add(w)
                taken.append(v)
        c, ctxs, _ = cm.epoch_cost(comps, workers, state)
        total += c
        plan.epochs.append(Epoch(comps, workers, c))
        state = SystemState(state.done | frozenset(taken), ctxs)
        remaining = [v for v in remaining if v not in taken]
    plan.predicted_cost = total
    plan.validate(dag)
    return plan


# ---------------------------------------------------------------------------
def opwise_plan(dag: LLMDag, cm: CostModel, num_workers: int) -> ExecutionPlan:
    """OpWise: strict stage-wise (MapReduce/Spark-style) execution.

    All nodes of one topological level run as one maximal batch with a
    barrier before the next level — maximizing instantaneous batch size
    but forbidding cross-stage interleaving (the straggler/model-thrash
    pathology the paper measures).
    """
    t0 = time.perf_counter()
    level: Dict[str, int] = {}
    for v in dag.graph.topo_order():
        if v not in dag.node_ids:
            continue
        ps = dag.parents(v)
        level[v] = 1 + max((level[p] for p in ps), default=-1)
    n_levels = max(level.values()) + 1

    plan = ExecutionPlan(scheduler_name="opwise")
    state = SystemState.initial(num_workers)
    total = 0.0
    for lv in range(n_levels):
        nodes = [v for v in dag.node_ids if level[v] == lv]
        # one epoch per ceil(len/num_workers) wave, round-robin workers
        for i0 in range(0, len(nodes), num_workers):
            wave = nodes[i0:i0 + num_workers]
            comps = [[v] for v in wave]
            workers = list(range(len(wave)))
            c, ctxs, _ = cm.epoch_cost(comps, workers, state)
            total += c
            plan.epochs.append(Epoch(comps, workers, c))
            state = SystemState(state.done | frozenset(wave), ctxs)
    plan.predicted_cost = total
    plan.solver_seconds = time.perf_counter() - t0
    plan.validate(dag)
    return plan


SCHEDULERS = {
    "random": random_plan,
    "rr": round_robin_plan,
    "heft": heft_plan,
    "opwise": opwise_plan,
}
