"""ExecutionPlan — the Optimizer's output, consumed by the Processor.

An epoch launches a set of components (chains of LLM macro-nodes), one
component per GPU worker.  The plan also exposes the per-worker node
sequences (for the Opt(S) metric) and validates precedence.

A copy of the JAX package's module of the same name, with the import prefix
``repro.`` read as ``repro_torch.``; ``tests/test_torch_copies.py`` holds
the two equal.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from repro_torch.core.graphspec import LLMDag


@dataclass
class Epoch:
    """One plan step: chains of macro-nodes, one chain per worker."""

    # parallel lists: components[i] runs (in order) on workers[i]
    components: List[List[str]]
    workers: List[int]
    predicted_cost: float = 0.0

    def assignments(self) -> List[Tuple[str, int]]:
        """(node, worker) pairs of this epoch, in chain order."""
        out = []
        for comp, w in zip(self.components, self.workers):
            out.extend((v, w) for v in comp)
        return out


@dataclass
class ExecutionPlan:
    """The Optimizer's output: an ordered list of epochs."""

    epochs: List[Epoch] = field(default_factory=list)
    predicted_cost: float = 0.0
    solver_seconds: float = 0.0
    scheduler_name: str = ""

    # ------------------------------------------------------------------
    def node_order(self) -> List[Tuple[str, int]]:
        """(node, worker) pairs across every epoch, in plan order."""
        out = []
        for e in self.epochs:
            out.extend(e.assignments())
        return out

    def worker_sequences(self, num_workers: int) -> List[List[str]]:
        """Per-worker node sequences (the Processor's claim lists)."""
        seqs: List[List[str]] = [[] for _ in range(num_workers)]
        for e in self.epochs:
            for comp, w in zip(e.components, e.workers):
                seqs[w].extend(comp)
        return seqs

    def assignment_map(self) -> Dict[str, int]:
        """node id -> planned worker."""
        return {v: w for v, w in self.node_order()}

    # ------------------------------------------------------------------
    def validate(self, dag: LLMDag, done=()) -> None:
        """Check precedence/coverage; ``done`` seeds the completed set
        for tail plans solved from a non-empty SystemState."""
        done = set(done)
        for e in self.epochs:
            batch = {v for comp in e.components for v in comp}
            if len(e.components) != len(e.workers):
                raise ValueError("components/workers length mismatch")
            if len(set(e.workers)) != len(e.workers):
                raise ValueError("a worker got two components in one epoch")
            if not dag.is_valid_cut(frozenset(done), frozenset(batch)):
                raise ValueError("epoch violates precedence")
            # intra-epoch deps must be satisfied by component order
            for comp in e.components:
                seen_comp: set = set()
                for v in comp:
                    for p in dag.parents(v):
                        if p in batch and p not in seen_comp and p not in done:
                            if p not in comp:
                                raise ValueError(
                                    f"dep {p}->{v} crosses components in epoch")
                            raise ValueError(
                                f"dep {p}->{v} out of order inside component")
                    seen_comp.add(v)
            done |= batch
        missing = set(dag.node_ids) - done
        if missing:
            raise ValueError(f"plan misses nodes: {sorted(missing)}")
