"""System state for the epoch DP: S_e = (D_e, H_e)  (paper §4).

``WorkerContext`` is the persistent GPU-worker context h_w: the resident
model id and a compact warm-KV signature — the ordered tuple of the most
recent LLM node ids whose lineage is warm on that worker.  Both are
hashable so (D, H) keys the memo table.

``SLOClass`` is the per-request service lane (DESIGN.md §10.3): session
``submit()`` tags each query interactive or batch, the solver holds a
priority-weighted flow-time objective, and engine admission prefers the
higher class under KV-pool pressure.

A copy of the JAX package's module of the same name, with the import prefix
``repro.`` read as ``repro_torch.``; ``tests/test_torch_copies.py`` holds
the two equal.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, FrozenSet, Optional, Sequence, Tuple

# Compact representation: keep only the most recent K lineage ids.  K=2
# keeps the DP state space tractable (prefix discounts look one hop back:
# a node's parent lineage) — raising K grows states combinatorially for
# little planning value.
WARM_CAP = 2


@dataclass(frozen=True)
class WorkerContext:
    """Persistent per-worker GPU context h_w (resident model, warm KV)."""

    model: str = ""                               # resident weights m_w
    warm: Tuple[str, ...] = ()                    # kv signature u_w (recent-last)

    def after(self, node_id: str, node_model: str) -> "WorkerContext":
        """Deterministic transition after executing ``node_id``."""
        if node_model != self.model:
            return WorkerContext(model=node_model, warm=(node_id,))
        warm = tuple(w for w in self.warm if w != node_id) + (node_id,)
        return WorkerContext(model=self.model, warm=warm[-WARM_CAP:])

    def has_warm(self, node_id: str) -> bool:
        """True when ``node_id``'s lineage is warm in this context."""
        return node_id in self.warm

    def warm_parent(self, parents: Sequence[str]) -> Optional[str]:
        """First of ``parents`` whose lineage is warm in this context —
        the donor the prefix discount keys off.  With cross-worker KV
        migration, a PEER context's warm parent is also a valid donor
        (its pages can ship over the link), so the cost model probes
        this on every worker, not just the assignee."""
        for u in parents:
            if u in self.warm:
                return u
        return None


@dataclass(frozen=True)
class SLOClass:
    """A service lane for session submissions (DESIGN.md §10.3).

    ``priority`` orders lanes: a pending higher-priority request wins
    engine admission and weights the solver toward finishing its nodes
    early.  ``ttft_target_s`` / ``tpot_target_s`` are the lane's latency
    targets — reported against, never enforced by dropping work.
    """

    name: str
    priority: int = 0
    ttft_target_s: Optional[float] = None
    tpot_target_s: Optional[float] = None


#: latency-sensitive lane: preempts batch admission, never vice versa
INTERACTIVE = SLOClass("interactive", priority=1,
                       ttft_target_s=1.0, tpot_target_s=0.25)
#: throughput lane: the default for bulk analytics submissions
BATCH = SLOClass("batch", priority=0)

SLO_CLASSES: Dict[str, SLOClass] = {c.name: c for c in (INTERACTIVE, BATCH)}


@dataclass(frozen=True)
class SystemState:
    """DP state S = (completed LLM set, per-worker contexts)."""

    done: FrozenSet[str] = frozenset()
    contexts: Tuple[WorkerContext, ...] = ()

    def key(self) -> Tuple:
        """Hashable memo key."""
        return (self.done, self.contexts)

    @staticmethod
    def initial(num_workers: int) -> "SystemState":
        """The empty starting state for ``num_workers`` cold workers."""
        return SystemState(frozenset(),
                           tuple(WorkerContext() for _ in range(num_workers)))
