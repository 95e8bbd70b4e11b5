"""Execution records + run reports shared by both Processor backends.

A copy of the JAX package's module of the same name, with the import prefix
``repro.`` read as ``repro_torch.``; ``tests/test_torch_copies.py`` holds
the two equal.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class TaskRecord:
    node: str
    kind: str                     # "llm" | "tool"
    worker: str                   # "gpu0".. | "cpu"
    start: float
    end: float
    batch: int = 1                # physical batch executed
    instance: int = 0             # batch-plan instance (online mode)
    info: str = ""

    @property
    def duration(self) -> float:
        return self.end - self.start


@dataclass
class RunReport:
    name: str = ""
    makespan: float = 0.0
    records: List[TaskRecord] = field(default_factory=list)
    num_queries: int = 0
    num_workers: int = 0
    coalesce_stats: Dict[str, float] = field(default_factory=dict)
    extra: Dict[str, float] = field(default_factory=dict)
    # online mode
    query_completion: List[float] = field(default_factory=list)

    # ------------------------------------------------------------------
    def results(self) -> Dict[str, str]:
        """Per-(query, node) outputs as ``"{q}:{node}" -> text`` — the
        typed accessor for what used to be ``extra["results"]`` reads.
        Empty for simulated runs (no real outputs to report)."""
        return dict(self.extra.get("results", {}))

    def migration_summary(self) -> Optional[Dict[str, float]]:
        """The KV migrator's counters for this run, or None when the run
        executed without a migrator (``kv_migration=False``)."""
        mig = self.extra.get("migration")
        return dict(mig) if mig is not None else None

    # ------------------------------------------------------------------
    def gpu_busy(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for r in self.records:
            if r.kind == "llm":
                out[r.worker] = out.get(r.worker, 0.0) + r.duration
        return out

    def gpu_seconds(self) -> float:
        """Cumulative GPU usage ∫U(t)dt — the Fig. 11 cost proxy."""
        return sum(self.gpu_busy().values())

    def cpu_seconds(self) -> float:
        return sum(r.duration for r in self.records if r.kind == "tool")

    def cpu_gpu_overlap(self) -> float:
        """Seconds during which tool (CPU) work and LLM (GPU) work ran
        concurrently — the fine-grained pipelining win (§5); 0 under a
        strict macro barrier on a linear llm→tool chain."""
        def merged(kind: str) -> List[List[float]]:
            iv = sorted([r.start, r.end] for r in self.records
                        if r.kind == kind)
            out: List[List[float]] = []
            for s, e in iv:
                if out and s <= out[-1][1]:
                    out[-1][1] = max(out[-1][1], e)
                else:
                    out.append([s, e])
            return out

        llm, tool = merged("llm"), merged("tool")
        i = j = 0
        total = 0.0
        while i < len(llm) and j < len(tool):
            s = max(llm[i][0], tool[j][0])
            e = min(llm[i][1], tool[j][1])
            if e > s:
                total += e - s
            if llm[i][1] < tool[j][1]:
                i += 1
            else:
                j += 1
        return total

    def utilization_trace(self, dt: float = 1.0) -> List[Tuple[float, float]]:
        """(t, fraction of GPU workers busy) samples."""
        if not self.records or self.num_workers == 0:
            return []
        horizon = self.makespan
        out = []
        llm = [r for r in self.records if r.kind == "llm"]
        t = 0.0
        while t < horizon:
            busy = sum(1 for r in llm if r.start < t + dt and r.end > t)
            out.append((t, min(busy / self.num_workers, 1.0)))
            t += dt
        return out

    def throughput_qps(self) -> float:
        if not self.query_completion:
            return self.num_queries / self.makespan if self.makespan else 0.0
        return len(self.query_completion) / max(self.query_completion)

    def summary(self) -> Dict[str, float]:
        return {
            "makespan_s": round(self.makespan, 3),
            "queries": self.num_queries,
            "gpu_seconds": round(self.gpu_seconds(), 3),
            "cpu_seconds": round(self.cpu_seconds(), 3),
            "qps": round(self.throughput_qps(), 4),
            **{k: (round(v, 4) if isinstance(v, float) else v)
               for k, v in self.coalesce_stats.items()},
        }
