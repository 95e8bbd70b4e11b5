"""RealProcessor — executes an ExecutionPlan with REAL components
(DESIGN.md §7):

the port's PyTorch models behind InferenceEngines (continuous batching, prefix
sharing, model switching), the minidb ToolRuntime, signature coalescing,
per-query wavefront tool promotion, checkpoint/restart and worker-failure
recovery.  The scheduling logic is the SAME code the simulator drives —
real mode exists to prove the semantics: coalescing, plan choice,
per-request pipelining and mid-run replanning must not change outputs
(asserted in tests).

Since the session redesign (DESIGN.md §10), ``run()`` is a thin
ONE-SHOT wrapper over ``ProcessorSession``: open a session, bootstrap
it with the consolidated batch, drain, report, close.  Streaming
callers should hold a ``ProcessorSession`` directly and ``submit()``
into it — arriving queries then graft into the running mega-DAG
instead of waiting for the next ``run()``.

Construction takes a ``ProcessorConfig``; the former 11 loose keyword
arguments are still accepted for one release behind a
``DeprecationWarning`` shim.

A copy of the JAX package's module of the same name, with the import
prefix ``repro.`` read as ``repro_torch.``.
"""
from __future__ import annotations

import warnings
from dataclasses import fields, replace
from typing import Any, Dict, List, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.core.consolidate import ConsolidatedGraph
from repro_torch.core.graphspec import GraphSpec
from repro_torch.core.plan import ExecutionPlan
from repro_torch.runtime.jobstore import save_batch_state
from repro_torch.runtime.events import RunReport
from repro_torch.runtime.executors import EngineHost
from repro_torch.runtime.session import ProcessorConfig, ProcessorSession
from repro_torch.workloads.tools import ToolRuntime

_CONFIG_FIELDS = {f.name for f in fields(ProcessorConfig)}


class RealProcessor:
    """One-shot real-mode Processor facade over ``ProcessorSession``."""

    def __init__(self, graph: GraphSpec,
                 model_configs: Dict[str, ModelConfig],
                 tools: ToolRuntime,
                 config: Optional[ProcessorConfig] = None,
                 **legacy: Any):
        if legacy:
            unknown = set(legacy) - _CONFIG_FIELDS
            if unknown:
                raise TypeError(
                    f"unknown RealProcessor arguments: {sorted(unknown)}")
            warnings.warn(
                "passing loose keyword arguments to RealProcessor is "
                "deprecated; pass config=ProcessorConfig(...) instead",
                DeprecationWarning, stacklevel=2)
            config = replace(config or ProcessorConfig(), **legacy)
        self.config = config or ProcessorConfig()
        self.model_configs = model_configs
        self.tools = tools
        self.W = self.config.num_workers
        self.cpu_slots = self.config.cpu_slots
        self.coalescing = self.config.coalescing
        self.seed = self.config.seed
        self.pipelining = self.config.pipelining
        self.engine_kwargs = self.config.engine_kwargs
        self.kv_migration = self.config.kv_migration
        self.claim_ahead = self.config.claim_ahead
        self.graph = graph
        # cap generation length in tests (CPU real mode); None = node spec
        if self.config.decode_cap is not None:
            cap = self.config.decode_cap
            nodes = [n.with_(max_new_tokens=min(n.max_new_tokens, cap))
                     if n.is_llm() else n for n in graph.nodes.values()]
            self.graph = GraphSpec(graph.name, nodes, graph.edges)

    # ------------------------------------------------------------------
    def run(self, cons: ConsolidatedGraph, plan: ExecutionPlan,
            checkpoint_path: Optional[str] = None,
            resume_from: Optional[str] = None,
            die_after: Optional[Dict[int, int]] = None,
            hosts: Optional[List[EngineHost]] = None,
            optimizer=None) -> RunReport:
        """Execute the consolidated batch as one session: bootstrap →
        drain → report.  ``RunReport.results()`` holds the per-(query,
        node) outputs.

        ``hosts`` lets an online driver keep engines (resident models,
        warm KV pages) alive across successive micro-batches; by default
        each run gets fresh hosts.  ``optimizer`` (an OnlineOptimizer)
        enables cost calibration + mid-run replanning; like ``hosts`` it
        may persist across runs so calibration compounds."""
        session = ProcessorSession(self.model_configs, self.tools,
                                   config=self.config)
        session.open(hosts=hosts, optimizer=optimizer)
        try:
            session.submit_consolidated(cons, plan, graph=self.graph,
                                        resume_from=resume_from,
                                        die_after=die_after)
            session.drain(timeout=600.0)
            if checkpoint_path:
                save_batch_state(session.state, checkpoint_path)
            return session.report()
        finally:
            session.close()
