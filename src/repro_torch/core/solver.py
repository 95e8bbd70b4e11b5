"""Epoch-based dynamic-programming solver (Algorithm 1; DESIGN.md §8.3).

Memoized recursion over states S = (D, H): D the completed LLM set, H
the tuple of worker contexts.  Each step enumerates feasible epoch
actions — topological cuts of the LLM DAG partitioned into chains
(weakly-connected components executed sequentially on one worker) and
injective chain→worker maps — scores them with the state-aware cost
model, and recurses on the deterministic state transition.

State-space control (the paper's "pruning to topological frontiers"):
* candidate nodes = frontier closure up to ``chain_depth`` levels, so
  dependent steps can chain inside one epoch (model residency + warm KV);
* subsets capped at ``max_epoch_nodes``;
* chain→worker assignments deduped by worker-context equivalence classes
  (two idle identical workers are interchangeable).

A copy of the JAX package's module of the same name, with the import prefix
``repro.`` read as ``repro_torch.``; ``tests/test_torch_copies.py`` holds
the two equal.
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional, Tuple

from repro_torch.core.cost_model import CostModel
from repro_torch.core.graphspec import LLMDag
from repro_torch.core.plan import Epoch, ExecutionPlan
from repro_torch.core.state import SystemState, WorkerContext


@dataclass
class SolverConfig:
    """EpochDPSolver knobs (workers, frontier depth, caps, beam)."""

    num_workers: int = 3
    chain_depth: int = 2           # frontier closure levels per epoch
    max_epoch_nodes: int = 6       # |B_e| cap
    max_states: int = 200_000      # hard safety valve on memo size
    # weight on the priority-hold term: each epoch's cost is scaled by
    # 1 + priority_hold * (pending priority mass), so time spent while
    # interactive-class nodes wait costs more than the same time after
    # they finish — priority-weighted flow time (DESIGN.md §10.3).
    # With no priorities the objective reduces to plain makespan.
    priority_hold: float = 0.5
    # beam over epoch actions per state, ranked by immediate cost with a
    # work-density tie-break; None = exact enumeration.  This is the
    # "pruning to topological frontiers" knob that keeps planning
    # near-linear in practice (§4, complexity analysis).
    beam: Optional[int] = 16


class EpochDPSolver:
    """Algorithm 1: memoized epoch DP over (done, contexts) states."""

    def __init__(self, dag: LLMDag, cost_model: CostModel,
                 config: Optional[SolverConfig] = None,
                 priorities: Optional[Dict[str, float]] = None):
        self.dag = dag
        self.cm = cost_model
        # fresh instance per solver: a module-level default would be one
        # shared mutable object across every EpochDPSolver in the process
        self.cfg = config if config is not None else SolverConfig()
        # per-node SLO priority mass (DESIGN.md §10.3): only nodes still
        # pending hold the objective, so the DP front-loads them.  Empty
        # or all-zero priorities leave every plan bitwise unchanged.
        self.prio = {n: w for n, w in (priorities or {}).items()
                     if w and n in dag.node_ids}
        self.memo: Dict[Tuple, Tuple[float, Optional[Tuple]]] = {}
        self.states_explored = 0

    # ------------------------------------------------------------------
    def _candidates(self, done: FrozenSet[str]) -> List[str]:
        """Frontier closure: nodes launchable this epoch (chains allowed)."""
        cand: List[str] = []
        d = set(done)
        for _ in range(self.cfg.chain_depth):
            level = [v for v in self.dag.frontier(frozenset(d)) if v not in cand]
            if not level:
                break
            cand.extend(level)
            d.update(level)
        return cand

    def _batches(self, done: FrozenSet[str]) -> List[FrozenSet[str]]:
        cand = self._candidates(done)
        out: List[FrozenSet[str]] = []
        max_n = min(len(cand), self.cfg.max_epoch_nodes)
        for r in range(1, max_n + 1):
            for sub in itertools.combinations(cand, r):
                batch = frozenset(sub)
                if not self.dag.is_valid_cut(done, batch):
                    continue
                comps = self.dag.components(batch)
                if len(comps) > self.cfg.num_workers:
                    continue
                out.append(batch)
        return out

    def _assignments(self, comps: List[List[str]],
                     contexts: Tuple[WorkerContext, ...]
                     ) -> List[Tuple[int, ...]]:
        """Injective component→worker maps, deduped by context classes."""
        W = len(contexts)
        # equivalence classes of workers by context
        cls: Dict[WorkerContext, List[int]] = {}
        for w, c in enumerate(contexts):
            cls.setdefault(c, []).append(w)
        reps = {w: cls[contexts[w]][0] for w in range(W)}
        seen: set = set()
        out: List[Tuple[int, ...]] = []
        for perm in itertools.permutations(range(W), len(comps)):
            key = tuple(reps[w] for w in perm)
            if key in seen:
                continue
            seen.add(key)
            out.append(perm)
        return out

    # ------------------------------------------------------------------
    def _solve(self, state: SystemState) -> Tuple[float, Optional[Tuple]]:
        if len(state.done) == len(self.dag.node_ids):
            return 0.0, None
        key = state.key()
        hit = self.memo.get(key)
        if hit is not None:
            return hit
        self.states_explored += 1
        if self.states_explored > self.cfg.max_states:
            raise RuntimeError("DP state budget exceeded; raise max_states "
                               "or lower chain_depth/max_epoch_nodes")

        # enumerate candidate actions, score the immediate epoch cost
        actions = []
        for batch in self._batches(state.done):
            comps = self.dag.components(batch)
            for workers in self._assignments(comps, state.contexts):
                c_now, ctxs, _ = self.cm.epoch_cost(comps, workers, state)
                # rank by cost per unit of work (prefer dense epochs)
                rank = c_now / max(len(batch), 1)
                actions.append((rank, c_now, comps, workers, ctxs, batch))
        actions.sort(key=lambda a: a[0])
        if self.cfg.beam is not None:
            actions = actions[:self.cfg.beam]

        # priority hold: epoch time is weighted by the priority mass
        # still pending BEFORE the epoch runs, so plans that clear
        # interactive-class nodes early score better (weighted flow
        # time).  hold == 1.0 exactly when no priorities are set, which
        # keeps batch-only plans bitwise identical to the unweighted DP.
        hold = 1.0
        if self.prio:
            hold += self.cfg.priority_hold * sum(
                w for n, w in self.prio.items() if n not in state.done)

        best = (float("inf"), None)
        for _, c_now, comps, workers, ctxs, batch in actions:
            nxt = SystemState(state.done | batch, ctxs)
            c_fut, _ = self._solve(nxt)
            total = c_now * hold + c_fut
            if total < best[0]:
                best = (total, (tuple(map(tuple, comps)),
                                tuple(workers), c_now, nxt))
        self.memo[key] = best
        return best

    # ------------------------------------------------------------------
    def solve(self, initial: Optional[SystemState] = None) -> ExecutionPlan:
        """Solve from ``initial`` (or cold start) and rebuild the plan."""
        t0 = time.perf_counter()
        state = initial or SystemState.initial(self.cfg.num_workers)
        start_done = state.done
        total, _ = self._solve(state)
        # plan reconstruction from the memo chain
        plan = ExecutionPlan(predicted_cost=total, scheduler_name="halo-dp")
        while len(state.done) < len(self.dag.node_ids):
            _, step = self.memo[state.key()]
            assert step is not None
            comps, workers, c_now, nxt = step
            plan.epochs.append(Epoch([list(c) for c in comps],
                                     list(workers), c_now))
            state = nxt
        plan.solver_seconds = time.perf_counter() - t0
        plan.validate(self.dag, start_done)
        return plan
