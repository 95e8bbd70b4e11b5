"""Discrete-event cluster simulator: the paper-scale Processor backend.

The same planning code (consolidator, cost model, DP solver) drives it and
the real backend; only task execution is simulated, with latencies from
the cost model, so it needs no card.  A copy of the JAX package's module
of the same name, with the import prefix ``repro.`` read as
``repro_torch.``; ``tests/test_torch_copies.py`` holds the two equal.
"""
from __future__ import annotations

import heapq
import math
import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.core.consolidate import ConsolidatedGraph
from repro_torch.core.cost_model import CostModel
from repro_torch.core.graphspec import GraphSpec
from repro_torch.core.plan import ExecutionPlan
from repro_torch.core.state import WorkerContext
from repro_torch.runtime.events import RunReport, TaskRecord

Key = Tuple[int, str]                      # (instance, node_id)


@dataclass
class _Instance:
    cons: ConsolidatedGraph
    plan: ExecutionPlan
    arrival: float
    done: Set[str] = field(default_factory=set)
    finished_at: float = -1.0


class ClusterSimulator:
    def __init__(self, graph: GraphSpec, cost_model: CostModel,
                 num_workers: int, cpu_slots: int = 16,
                 coalescing: bool = True, opportunistic: bool = True,
                 cross_instance_cache: bool = True,
                 lookahead: int = 24, seed: int = 0,
                 llm_jitter: float = 0.05,
                 barrier_mode: bool = False,
                 processor_batch: int = 256,
                 kv_migration: bool = True):
        self.graph = graph
        self.cm = cost_model
        self.W = num_workers
        self.cpu_slots = cpu_slots
        self.coalescing = coalescing
        self.opportunistic = opportunistic
        self.cross_instance_cache = cross_instance_cache and coalescing
        self.lookahead = lookahead
        self.seed = seed
        self.llm_jitter = llm_jitter
        # Halo's Processor migrates warm KV across workers (§5), so the
        # peer-context prefill credit the solver priced is REALIZED at
        # execution; baseline systems (langgraph/agentscope/parrot/
        # vllm-serial) do not migrate and run with this off.
        self.kv_migration = kv_migration
        # Strict stage barriers — a worker may not start an epoch-e node
        # until EVERY node of epochs < e (same instance) completed.  Used
        # for the OpWise baseline AND for the "w/o opportunistic" ablation
        # (§6.5: without it the Processor is bound to the scheduler's
        # static dispatch rate).  Halo itself runs barrier-free wavefronts.
        self.barrier_mode = barrier_mode
        # engine max batch per forward wave (Fig. 10 sensitivity)
        self.processor_batch = processor_batch

        self.instances: List[_Instance] = []
        self._failures: List[Tuple[float, int]] = []

        # static tool depth priority: hops to the nearest LLM descendant
        self._tool_depth: Dict[str, int] = {}
        for t in graph.tool_nodes():
            depth, frontier, seen = 0, [t], {t}
            found = 99
            while frontier and found == 99:
                nxt = []
                for x in frontier:
                    for c in graph.children(x):
                        if graph.nodes[c].is_llm():
                            found = depth
                        elif c not in seen:
                            seen.add(c)
                            nxt.append(c)
                frontier, depth = nxt, depth + 1
            self._tool_depth[t] = found

    # ------------------------------------------------------------------
    def add_instance(self, cons: ConsolidatedGraph, plan: ExecutionPlan,
                     arrival: float = 0.0) -> int:
        self.instances.append(_Instance(cons, plan, arrival))
        return len(self.instances) - 1

    def add_failure(self, time: float, worker: int) -> None:
        self._failures.append((time, worker))

    # ------------------------------------------------------------------
    def _n_phys(self, inst: _Instance, nid: str,
                global_sigs: Set[str]) -> Tuple[int, int]:
        """(logical, physical) request counts for a macro node.

        LLM calls are NEVER deduped (paper semantics: coalescing merges
        redundant I/O/tool operations; every query's LLM call runs —
        continuous batching amortizes them instead)."""
        m = inst.cons.macro(nid)
        if self.graph.nodes[nid].is_llm() or not self.coalescing:
            return m.n_logical, m.n_logical
        # physical_signatures already removes cross-TEMPLATE duplicates a
        # multi-template mega-DAG coalesced; the global set removes
        # cross-INSTANCE duplicates on top
        sigs = inst.cons.physical_signatures(nid)
        if self.cross_instance_cache:
            fresh = [s for s in sigs if s not in global_sigs]
            return m.n_logical, max(len(fresh), 0)
        return m.n_logical, len(sigs)

    def _rng(self, *key) -> random.Random:
        return random.Random(hash((self.seed,) + key) & 0x7FFFFFFF)

    def _tool_duration(self, inst: _Instance, nid: str, n_phys: int,
                       slots: int) -> float:
        spec = self.graph.nodes[nid]
        est = self.cm.profiler.estimate(spec)
        if n_phys == 0:
            return 1e-4                         # pure cache hit: bookkeeping
        waves = math.ceil(n_phys / max(slots, 1))
        dur = est * waves
        if spec.op == "http":                   # deterministic straggler tail
            r = self._rng("http", inst.arrival, nid).random()
            dur *= 3.0 if r < 0.10 else 1.0 + 0.3 * r
        return dur

    def _llm_duration(self, inst: _Instance, nid: str, n_phys: int,
                      ctx: WorkerContext,
                      peers: Tuple[WorkerContext, ...] = ()
                      ) -> Tuple[float, WorkerContext]:
        spec = self.graph.nodes[nid]
        llm_parents = [p for p in self.graph.parents(nid)
                       if self.graph.nodes[p].is_llm()]
        old = self.cm.batch_sizes.get(nid)
        # engine processes the macro batch in waves of processor_batch
        t = self.cm.t_model(spec, ctx)
        remaining = max(n_phys, 1)
        first = True
        while remaining > 0:
            wave = min(remaining, self.processor_batch)
            self.cm.batch_sizes[nid] = wave
            t += self.cm.t_infer(spec, ctx, llm_parents, peer_ctxs=peers)
            if not first and peers and self.cm.use_profiling:
                # ONE transfer serves every wave (the imported pages are
                # local after the first) — refund the repeated t_mig term
                t -= self.cm.prefill_plan(spec, ctx, llm_parents, peers)[1]
            first = False
            remaining -= wave
        if old is None:
            self.cm.batch_sizes.pop(nid, None)
        else:
            self.cm.batch_sizes[nid] = old
        r = self._rng("llm", inst.arrival, nid).random()
        t *= 1.0 + self.llm_jitter * r
        return t, ctx.after(nid, spec.model)

    # ------------------------------------------------------------------
    def run(self) -> RunReport:
        report = RunReport(num_workers=self.W)
        heap: List[Tuple[float, int, str, tuple]] = []
        counter = 0

        def push(t, kind, payload):
            nonlocal counter
            heapq.heappush(heap, (t, counter, kind, payload))
            counter += 1

        # per-worker state
        queue: List[List[Key]] = [[] for _ in range(self.W)]
        ptr: List[int] = [0] * self.W
        ctxs: List[WorkerContext] = [WorkerContext() for _ in range(self.W)]
        busy: List[bool] = [False] * self.W
        dead: List[bool] = [False] * self.W
        executed: Set[Key] = set()          # done or in-flight LLM nodes
        inflight: Dict[int, Key] = {}       # worker -> running node

        done: Set[Key] = set()
        free_slots = [self.cpu_slots]
        tool_ready: List[Tuple[int, float, int, str]] = []   # priority heap
        tool_inflight: Set[Key] = set()
        global_sigs: Set[str] = set()

        for t, w in self._failures:
            push(t, "fail", (w,))
        for i, inst in enumerate(self.instances):
            push(inst.arrival, "arrive", (i,))

        # epoch index per (instance, node) for barrier mode; tool nodes are
        # gated on the stage boundary before their earliest LLM child
        # (OpWise cannot interleave CPU tools with earlier GPU stages).
        epoch_of: Dict[Key, int] = {}
        epoch_nodes: Dict[Tuple[int, int], Set[str]] = {}
        if self.barrier_mode:
            for i, inst in enumerate(self.instances):
                for e_ix, ep in enumerate(inst.plan.epochs):
                    for comp in ep.components:
                        for v in comp:
                            epoch_of[(i, v)] = e_ix
                            epoch_nodes.setdefault((i, e_ix), set()).add(v)
                for tnode in self.graph.tool_nodes():
                    gates = [epoch_of[(i, c)] for c in self.graph.children(tnode)
                             if (i, c) in epoch_of]
                    if gates:
                        epoch_of[(i, tnode)] = min(gates)

        # ----------------------------------------------------------------
        def deps_done(i: int, v: str) -> bool:
            if not all((i, p) in done for p in self.graph.parents(v)):
                return False
            if self.barrier_mode and (i, v) in epoch_of:
                e_ix = epoch_of[(i, v)]
                for e_prev in range(e_ix):
                    if not all((i, u) in done
                               for u in epoch_nodes.get((i, e_prev), ())):
                        return False
            return True

        def promote_tools(t: float, i: int) -> None:
            """Queue newly-ready tool nodes (depth priority)."""
            inst = self.instances[i]
            for v in self.graph.tool_nodes():
                k = (i, v)
                if k in done or k in tool_inflight:
                    continue
                if deps_done(i, v):
                    tool_inflight.add(k)
                    heapq.heappush(tool_ready,
                                   (self._tool_depth[v], inst.arrival, i, v))

        def start_tools(t: float) -> None:
            while tool_ready and free_slots[0] > 0:
                _, _, i, v = heapq.heappop(tool_ready)
                inst = self.instances[i]
                n_log, n_phys = self._n_phys(inst, v, global_sigs)
                grab = max(min(n_phys, free_slots[0]), 1)
                free_slots[0] -= grab
                dur = self._tool_duration(inst, v, n_phys, grab)
                push(t + dur, "tool_done", (i, v, grab, n_log, n_phys, t))

        def try_start_worker(w: int, t: float, force: bool = False) -> None:
            if busy[w] or dead[w]:
                return
            q = queue[w]
            while ptr[w] < len(q) and q[ptr[w]] in executed:
                ptr[w] += 1
            if ptr[w] >= len(q):
                return
            # planned next node
            cand: Optional[Key] = None
            i0, v0 = q[ptr[w]]
            if deps_done(i0, v0):
                cand = (i0, v0)
            elif self.opportunistic or force:
                end = len(q) if force \
                    else min(len(q), ptr[w] + 1 + self.lookahead)
                for j in range(ptr[w] + 1, end):
                    i1, v1 = q[j]
                    if q[j] in executed or not deps_done(i1, v1):
                        continue
                    model = self.graph.nodes[v1].model
                    # do not disturb imminent GPU state (unless forced:
                    # the cluster would otherwise stall entirely)
                    if not force and ctxs[w].model and model != ctxs[w].model:
                        continue
                    cand = q[j]
                    break
            if cand is None:
                return
            i, v = cand
            inst = self.instances[i]
            n_log, n_phys = self._n_phys(inst, v, set())
            if n_log == 0:
                # empty template slice in a mega-DAG instance: nothing
                # to infer — retire instantly WITHOUT touching the
                # worker context (no phantom batch-1 wave or model
                # switch poisoning the consolidated-multi arm)
                busy[w] = True
                executed.add(cand)
                inflight[w] = cand
                push(t + 1e-4, "llm_done", (w, i, v, 0, t))
                return
            peers = tuple(ctxs[x] for x in range(self.W)
                          if x != w and not dead[x]) \
                if self.kv_migration else ()
            dur, nctx = self._llm_duration(inst, v, n_phys, ctxs[w], peers)
            ctxs[w] = nctx
            busy[w] = True
            executed.add(cand)
            inflight[w] = cand
            push(t + dur, "llm_done", (w, i, v, n_phys, t))

        def on_node_done(i: int, v: str, t: float) -> None:
            done.add((i, v))
            inst = self.instances[i]
            inst.done.add(v)
            if len(inst.done) == len(self.graph.nodes):
                inst.finished_at = t
                for _ in range(inst.cons.n_queries):
                    report.query_completion.append(t - 0.0)
            promote_tools(t, i)

        # ----------------------------------------------------------------
        t = 0.0
        while heap:
            t, _, kind, payload = heapq.heappop(heap)
            if kind == "arrive":
                (i,) = payload
                seqs = self.instances[i].plan.worker_sequences(self.W)
                alive = [w for w in range(self.W) if not dead[w]]
                # rotate worker assignment per instance: intra-instance
                # locality chains are preserved while concurrent instances
                # spread across the pool (cross-session load balancing)
                for w in range(self.W):
                    tgt = (w + i) % self.W
                    if dead[tgt]:
                        tgt = alive[tgt % len(alive)]
                    queue[tgt].extend((i, v) for v in seqs[w])
                promote_tools(t, i)
            elif kind == "tool_done":
                i, v, grab, n_log, n_phys, t0 = payload
                free_slots[0] += grab
                tool_inflight.discard((i, v))
                if self.cross_instance_cache:
                    global_sigs.update(
                        self.instances[i].cons.macro(v).unique_signatures)
                report.records.append(TaskRecord(
                    node=v, kind="tool", worker="cpu", start=t0, end=t,
                    batch=n_phys, instance=i,
                    info=f"logical={n_log}"))
                # online calibration with the PER-CALL latency
                waves = max(math.ceil(n_phys / max(grab, 1)), 1)
                self.cm.profiler.update(v, self.graph.nodes[v].op,
                                        ((t - t0) / waves) or 1e-4)
                on_node_done(i, v, t)
            elif kind == "llm_done":
                w, i, v, n_phys, t0 = payload
                if inflight.get(w) != (i, v):
                    continue                     # stale (worker failed)
                busy[w] = False
                del inflight[w]
                report.records.append(TaskRecord(
                    node=v, kind="llm", worker=f"gpu{w}", start=t0, end=t,
                    batch=n_phys, instance=i))
                on_node_done(i, v, t)
            elif kind == "fail":
                (w,) = payload
                if dead[w]:
                    continue
                dead[w] = True
                # reassign in-flight + remaining queue to survivors
                alive = [x for x in range(self.W) if not dead[x]]
                if not alive:
                    raise RuntimeError("all workers failed")
                moved: List[Key] = []
                if w in inflight:
                    k = inflight.pop(w)
                    executed.discard(k)
                    moved.append(k)
                    busy[w] = False
                moved += [k for k in queue[w][ptr[w]:] if k not in executed]
                queue[w] = []
                for j, k in enumerate(moved):
                    queue[alive[j % len(alive)]].append(k)
                report.extra[f"failed_worker_{w}"] = t

            # wake everything that can proceed
            start_tools(t)
            for w in range(self.W):
                try_start_worker(w, t)
            if not heap:
                # stall-breaker: nothing in flight and nothing started —
                # a failure redistribution can park a ready node behind a
                # dep-blocked head on a worker whose residency guard then
                # refuses every cross-model pull (every OTHER worker being
                # blocked on that node's output).  Rather than silently
                # dropping the tail of the batch, let stalled workers take
                # ANY dep-ready queued node, residency notwithstanding.
                for w in range(self.W):
                    try_start_worker(w, t, force=True)

        report.makespan = t
        report.num_queries = sum(i.cons.n_queries for i in self.instances)
        log = phys = 0
        for r in report.records:
            if r.kind == "tool":
                log += int(r.info.split("=")[1])
                phys += r.batch
        report.coalesce_stats = {
            "tool_logical": log, "tool_physical": phys,
            "tool_dedup_ratio": phys / max(log, 1),
        }
        return report


# ---------------------------------------------------------------------------
# convenience wrappers
# ---------------------------------------------------------------------------

class SimulatedProcessor:
    """One consolidated batch → one simulated run."""

    def __init__(self, graph: GraphSpec, cost_model: CostModel,
                 num_workers: int, **kw):
        self.sim = ClusterSimulator(graph, cost_model, num_workers, **kw)

    def run(self, cons: ConsolidatedGraph, plan: ExecutionPlan) -> RunReport:
        self.sim.add_instance(cons, plan, arrival=0.0)
        report = self.sim.run()
        report.name = plan.scheduler_name
        return report


class OnlineSimulator:
    """Streaming arrivals → micro-batches → overlapping plan instances."""

    def __init__(self, graph: GraphSpec, cost_model: CostModel,
                 num_workers: int, **kw):
        self.graph = graph
        self.cm = cost_model
        self.W = num_workers
        self.kw = kw

    def run(self, batches: Sequence[Tuple[ConsolidatedGraph, ExecutionPlan]],
            arrival_rate_qps: float) -> RunReport:
        sim = ClusterSimulator(self.graph, self.cm, self.W, **self.kw)
        t = 0.0
        for cons, plan in batches:
            sim.add_instance(cons, plan, arrival=t)
            t += cons.n_queries / arrival_rate_qps
        report = sim.run()
        report.name = "online"
        return report
