"""Request coalescing — canonical signatures + runtime merge table (§5).

Two layers:
* canonical_signature() normalizes an operator invocation (type + args)
  so logically identical requests map to one key — whitespace/case
  normalization for SQL, sorted query params for HTTP, stripped args for
  local functions;
* CoalesceTable merges PENDING tasks with equal signatures into one
  physical execution and fans the result out to all logical requesters.
  Used by the Processor at runtime (handles args that only materialize
  once upstream results arrive).

Coalescing is semantics-preserving by construction: only bit-identical
canonical signatures merge, so one physical run is equivalent to each
logical run.

A copy of the JAX package's module of the same name, with the import prefix
``repro.`` read as ``repro_torch.``; ``tests/test_torch_copies.py`` holds
the two equal.
"""
from __future__ import annotations

import hashlib
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

_WS = re.compile(r"\s+")
_SQL_KW = re.compile(
    r"\b(select|from|where|group by|order by|join|on|and|or|limit|as|"
    r"having|inner|left|right|outer|count|sum|avg|min|max|distinct)\b",
    re.I)


def _normalize_sql(sql: str) -> str:
    s = _WS.sub(" ", sql).strip().rstrip(";").strip()
    return _SQL_KW.sub(lambda m: m.group(0).upper(), s)


def _normalize_http(args: str) -> str:
    s = _WS.sub(" ", args).strip()
    if "?" in s:
        base, _, qs = s.partition("?")
        params = sorted(p for p in qs.split("&") if p)
        s = base + "?" + "&".join(params)
    return s


def canonical_signature(op: str, args: str, model: str = "",
                        extra: str = "") -> str:
    """Normalized identity of one operator invocation (the merge key)."""
    if op == "sql":
        body = _normalize_sql(args)
    elif op == "http":
        body = _normalize_http(args)
    else:
        body = _WS.sub(" ", args).strip()
    payload = f"{op}|{model}|{body}|{extra}"
    return hashlib.blake2b(payload.encode(), digest_size=12).hexdigest()


@dataclass
class PhysicalTask:
    """One physical tool execution and the logical requests riding it."""

    signature: str
    op: str
    args: str
    # logical requesters: (query_id, node_id) pairs waiting for the result
    requesters: List[Tuple[int, str]] = field(default_factory=list)
    result: Optional[object] = None
    done: bool = False


class CoalesceTable:  # requires: BatchState.lock
    """Merge map from logical requests to physical executions.

    Thread contract: every method (and every direct read of the table's
    maps/counters) runs under the owning ``BatchState.lock`` — the tool
    dispatcher, the pool's ``_execute`` threads and the session's
    reporting all serialize on it (DESIGN.md §11).
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.pending: Dict[str, PhysicalTask] = {}      # guarded-by: BatchState.lock
        self.completed: Dict[str, PhysicalTask] = {}    # guarded-by: BatchState.lock
        # stats
        self.logical_requests = 0           # guarded-by: BatchState.lock
        self.physical_executions = 0        # guarded-by: BatchState.lock
        self.result_cache_hits = 0          # guarded-by: BatchState.lock

    def register(self, op: str, args: str, requester: Tuple[int, str],
                 model: str = "") -> Tuple[str, bool, Optional[object]]:
        """Returns (signature, needs_execution, cached_result)."""
        self.logical_requests += 1
        sig = canonical_signature(op, args, model)
        if not self.enabled:
            # every logical request becomes its own physical execution
            sig = f"{sig}#{self.logical_requests}"
            self.pending[sig] = PhysicalTask(sig, op, args, [requester])
            self.physical_executions += 1
            return sig, True, None
        if sig in self.completed:                  # reuse of finished result
            task = self.completed[sig]
            # keep attributing logical requesters after completion: the
            # cross-template merge stats read them (a late template
            # hitting an earlier template's cached result IS a merge)
            task.requesters.append(requester)
            self.result_cache_hits += 1
            return sig, False, task.result
        if sig in self.pending:                    # merge into in-flight task
            self.pending[sig].requesters.append(requester)
            return sig, False, None
        self.pending[sig] = PhysicalTask(sig, op, args, [requester])
        self.physical_executions += 1
        return sig, True, None

    def complete(self, sig: str, result: object) -> List[Tuple[int, str]]:
        """Mark physical task done; returns all logical requesters."""
        task = self.pending.pop(sig)
        task.result = result
        task.done = True
        self.completed[sig] = task
        return list(task.requesters)

    @property
    def dedup_ratio(self) -> float:
        """physical / logical — 1.0 means nothing merged."""
        return self.physical_executions / max(self.logical_requests, 1)
