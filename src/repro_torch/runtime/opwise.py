"""OpWise baseline executor (paper §6.1), stage-synchronous and
MapReduce-style, on the simulated backend.

A copy of the JAX package's module of the same name, with the import prefix
``repro.`` read as ``repro_torch.``; ``tests/test_torch_copies.py`` holds
the two equal.
"""
from __future__ import annotations

import math
from typing import Dict, List

from repro_torch.core.consolidate import ConsolidatedGraph
from repro_torch.core.cost_model import CostModel
from repro_torch.core.graphspec import GraphSpec
from repro_torch.core.state import WorkerContext
from repro_torch.runtime.events import RunReport, TaskRecord


class OpWiseSimulator:
    def __init__(self, graph: GraphSpec, cost_model: CostModel,
                 num_workers: int, cpu_slots: int = 16,
                 coalescing: bool = True, processor_batch: int = 256):
        self.graph = graph
        self.cm = cost_model
        self.W = num_workers
        self.cpu_slots = cpu_slots
        self.coalescing = coalescing
        self.processor_batch = processor_batch

    # ------------------------------------------------------------------
    def _levels(self) -> List[List[str]]:
        level: Dict[str, int] = {}
        for v in self.graph.topo_order():
            if not self.graph.nodes[v].is_llm():
                continue
            ps = [p for p in self.graph.parents(v)
                  if self.graph.nodes[p].is_llm()]
            # LLM level also considers LLM ancestors through tool nodes
            anc = [a for a in self.graph.ancestors(v)
                   if self.graph.nodes[a].is_llm()]
            level[v] = 1 + max((level[a] for a in anc if a in level),
                               default=-1)
        out: List[List[str]] = [[] for _ in range(max(level.values()) + 1)]
        for v, lv in level.items():
            out[lv].append(v)
        return out

    def _n_phys(self, cons: ConsolidatedGraph, nid: str) -> int:
        m = cons.macro(nid)
        if self.graph.nodes[nid].is_llm():
            return m.n_logical                 # LLM calls are never deduped
        if not self.coalescing:
            return m.n_logical
        return len(cons.physical_signatures(nid))   # cross-template aware

    # ------------------------------------------------------------------
    def run(self, cons: ConsolidatedGraph) -> RunReport:
        report = RunReport(name="opwise", num_workers=self.W,
                           num_queries=cons.n_queries)
        t = 0.0
        ctxs = [WorkerContext() for _ in range(self.W)]
        done_tools: set = set()
        log_tools = phys_tools = 0

        for stage in self._levels():
            # ---- serial CPU phase: all tools feeding this stage ----------
            pend: List[str] = []
            for v in stage:
                for tnode in self.graph.tool_ancestors_between(v):
                    if tnode not in done_tools:
                        pend.append(tnode)
                        done_tools.add(tnode)
            if pend:
                tool_time = 0.0
                for tnode in pend:
                    n = self._n_phys(cons, tnode)
                    est = self.cm.profiler.estimate(self.graph.nodes[tnode])
                    dur = est * math.ceil(n / self.cpu_slots)
                    tool_time = max(tool_time, dur)    # pool runs them together
                    log_tools += cons.macro(tnode).n_logical
                    phys_tools += n
                total_work = sum(
                    self.cm.profiler.estimate(self.graph.nodes[tn])
                    * self._n_phys(cons, tn) for tn in pend)
                tool_time = max(tool_time, total_work / self.cpu_slots)
                report.records.append(TaskRecord(
                    node="+".join(pend[:3]), kind="tool", worker="cpu",
                    start=t, end=t + tool_time, batch=phys_tools))
                t += tool_time                        # BARRIER: GPUs idle

            # ---- pooled GPU phase ----------------------------------------
            # one node -> one engine/worker (same batch processor as Halo);
            # its buffered requests run as consecutive processor_batch waves
            free = [t] * self.W
            for v in stage:
                w = min(range(self.W), key=lambda x: free[x])
                spec = self.graph.nodes[v]
                llm_parents = [p for p in self.graph.parents(v)
                               if self.graph.nodes[p].is_llm()]
                n = self._n_phys(cons, v)
                old = self.cm.batch_sizes.get(v)
                start = free[w]
                total_batch = n
                while n > 0:
                    wave_n = min(self.processor_batch, n)
                    self.cm.batch_sizes[v] = wave_n
                    dur = (self.cm.t_model(spec, ctxs[w])
                           + self.cm.t_infer(spec, ctxs[w], llm_parents))
                    free[w] += dur
                    ctxs[w] = ctxs[w].after(v, spec.model)
                    n -= wave_n
                if old is None:
                    self.cm.batch_sizes.pop(v, None)
                else:
                    self.cm.batch_sizes[v] = old
                report.records.append(TaskRecord(
                    node=v, kind="llm", worker=f"gpu{w}", start=start,
                    end=free[w], batch=total_batch))
            t = max(free) if stage else t              # stage barrier

        report.makespan = t
        report.coalesce_stats = {
            "tool_logical": log_tools, "tool_physical": phys_tools,
            "tool_dedup_ratio": phys_tools / max(log_tools, 1),
        }
        return report
