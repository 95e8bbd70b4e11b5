"""Opt(S) — GPU-locality optimality metric (§6.3).

P(S) = ordered pairs of consecutive nodes executing on the same GPU
(tagged with the GPU).  Opt(S) = max over worker permutations π of
|P(S) ∩ π(P(S*))| / |P(S*)| — the recall of the oracle's co-location
decisions, invariant to worker relabeling.

A copy of the JAX package's module of the same name, with the import prefix
``repro.`` read as ``repro_torch.``; ``tests/test_torch_copies.py`` holds
the two equal.
"""
from __future__ import annotations

import itertools
from typing import Set, Tuple

from repro_torch.core.plan import ExecutionPlan

Pair = Tuple[str, str, int]


def consecutive_pairs(plan: ExecutionPlan, num_workers: int) -> Set[Pair]:
    """P(S): (prev, next, worker) pairs of consecutive same-GPU nodes."""
    out: Set[Pair] = set()
    for w, seq in enumerate(plan.worker_sequences(num_workers)):
        for a, b in zip(seq, seq[1:]):
            out.add((a, b, w))
    return out


def optimality_score(plan: ExecutionPlan, oracle_plan: ExecutionPlan,
                     num_workers: int) -> float:
    """Opt(S): recall of the oracle's co-location decisions (§6.3)."""
    p_s = consecutive_pairs(plan, num_workers)
    p_star = consecutive_pairs(oracle_plan, num_workers)
    if not p_star:
        # the oracle never co-locates consecutively; degenerate — score by
        # matching the (empty) set exactly
        return 1.0 if not p_s else 0.0
    best = 0.0
    for perm in itertools.permutations(range(num_workers)):
        mapped = {(a, b, perm[w]) for a, b, w in p_star}
        best = max(best, len(p_s & mapped) / len(p_star))
    return best
