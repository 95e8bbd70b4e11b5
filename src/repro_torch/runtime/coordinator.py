"""Coordinator bookkeeping shared by the real Processor backend.

* ``BatchState`` tracks per-(query, node) results and macro-node
  completion over the consolidated batch; thread-safe; supports per-query
  wavefront promotion for tool nodes, per-request pipelining for LLM
  nodes, and macro-barrier readiness (checkpoint restore / barrier mode).
  Listeners registered with ``add_listener`` get every (query, node)
  result as it lands — the event feed driving the ToolDispatcher and the
  replanning monitor without polling.
* ``PlanBoard`` is the mutable view of an ExecutionPlan's per-worker node
  sequences.  Workers *claim* nodes in sequence order; a node is released
  only once all its LLM-DAG parents are claimed, so the global claim
  order is a topological order of the LLM DAG — which is what makes a
  mid-run replan splice (claimed prefix + re-solved tail) a valid plan.

A copy of the JAX package's module of the same name, with the import prefix
``repro.`` read as ``repro_torch.``; ``tests/test_torch_copies.py`` holds
the two equal.
"""
from __future__ import annotations

from typing import (Callable, Dict, List, Optional, Sequence, Set, Tuple)

from repro_torch.core.graphspec import GraphSpec, LLMDag
from repro_torch.core.plan import Epoch, ExecutionPlan
from repro_torch.core.state import WorkerContext
from repro_torch.debugsync import named_condition


class BatchState:
    """Thread-safe per-(query, node) result store for one batch run.

    ``queries_of`` (node id → global query indices) restricts each node
    to a subset of the batch — the multi-template mega-DAG case, where a
    namespaced node serves only its own template's query slice.  By
    default every node serves every query (single template).  A node
    with an EMPTY query set is macro-complete from the start.
    """

    def __init__(self, graph: GraphSpec, n_queries: int,
                 queries_of: Optional[Dict[str, Sequence[int]]] = None):
        self.lock = named_condition("BatchState.lock")
        self.graph = graph               # guarded-by: self.lock
        self.n = n_queries               # guarded-by: self.lock
        self.results: Dict[Tuple[int, str], str] = {}  # guarded-by: self.lock
        self.node_done_count: Dict[str, int] = {v: 0 for v in graph.nodes}  # guarded-by: self.lock
        if queries_of is None:
            self.queries_of = {v: list(range(n_queries)) for v in graph.nodes}  # guarded-by: self.lock
        else:
            self.queries_of = {v: sorted(queries_of.get(v, ()))
                               for v in graph.nodes}
        self._query_sets = {v: set(qs) for v, qs in self.queries_of.items()}  # guarded-by: self.lock
        self.expected = {v: len(qs) for v, qs in self.queries_of.items()}  # guarded-by: self.lock
        # zero-query nodes (an empty template slice) are done at birth
        self.macro_done: Set[str] = {  # guarded-by: self.lock
            v for v, n in self.expected.items() if n == 0}
        # per-query SLO priority (DESIGN.md §10.3); absent = 0 = batch
        self.query_priority: Dict[int, int] = {}  # guarded-by: self.lock
        # append-only, registered before the workers start; set_result
        # iterates a snapshot outside the lock by design
        self._listeners: List[Callable[[int, str], None]] = []

    # ------------------------------------------------------------------
    def priority_of(self, q: int) -> int:
        """SLO-lane priority of query ``q`` (0 = batch lane)."""
        with self.lock:
            return self.query_priority.get(q, 0)

    def extend(self, graph: GraphSpec, n_new: int,
               queries_of: Optional[Dict[str, Sequence[int]]] = None,
               priorities: Optional[Dict[int, int]] = None) -> None:
        """Grow the batch mid-run (a session graft; DESIGN.md §10.2).

        ``graph`` must be a supergraph of the current one: existing
        nodes keep their ids, query slices and results; new nodes (and
        the ``n_new`` new queries) are added with fresh bookkeeping.
        Zero-query new nodes are macro-complete at birth, exactly as in
        ``__init__``.
        """
        with self.lock:
            missing = set(self.graph.nodes) - set(graph.nodes)
            if missing:
                raise ValueError(
                    f"graft graph dropped existing nodes: {sorted(missing)}")
            self.graph = graph
            self.n += n_new
            for v in graph.nodes:
                if v in self.queries_of:
                    continue
                qs = sorted((queries_of or {}).get(v, ()))
                self.queries_of[v] = qs
                self._query_sets[v] = set(qs)
                self.expected[v] = len(qs)
                self.node_done_count[v] = 0
                if not qs:
                    self.macro_done.add(v)
            self.query_priority.update(priorities or {})
            self.lock.notify_all()

    # ------------------------------------------------------------------
    def add_listener(self, fn: Callable[[int, str], None]) -> None:
        """Register a per-result observer ``fn(query, node)``.

        Called after every ``set_result`` *outside* the state lock, on
        whichever thread produced the result — observers must be cheap
        and non-blocking (enqueue + wake, not work).
        """
        self._listeners.append(fn)

    def set_result(self, q: int, node: str, value: str) -> bool:
        """Record one (query, node) result. Returns True if the macro node
        just completed (all queries done)."""
        with self.lock:
            if (q, node) in self.results:
                return False
            self.results[(q, node)] = value
            self.node_done_count[node] += 1
            macro = self.node_done_count[node] == self.expected[node]
            if macro:
                self.macro_done.add(node)
            # per-result wakeup: pipelined workers wait on single-query
            # readiness, not just macro completion
            self.lock.notify_all()
        for fn in self._listeners:
            fn(q, node)
        return macro

    # requires: self.lock
    def queries_for_locked(self, node: str) -> List[int]:
        """``queries_for`` for callers already inside ``self.lock``."""
        return list(self.queries_of[node])

    def queries_for(self, node: str) -> List[int]:
        """Global query indices ``node`` serves (grows only by graft)."""
        with self.lock:
            return list(self.queries_of[node])

    def serves(self, q: int, node: str) -> bool:
        """True when query ``q`` belongs to ``node``'s template slice."""
        with self.lock:
            return q in self._query_sets[node]

    def is_macro_done(self, node: str) -> bool:
        """True once every query of ``node`` has a result."""
        with self.lock:
            return node in self.macro_done

    def macro_ready(self, node: str) -> bool:
        """All parents complete for ALL queries (LLM barrier readiness)."""
        with self.lock:
            return all(p in self.macro_done
                       for p in self.graph.parents(node))

    def query_ready(self, q: int, node: str) -> bool:
        """All parents complete for ONE query (wavefront readiness)."""
        with self.lock:
            return all((q, p) in self.results
                       for p in self.graph.parents(node))

    def wait_macro_ready(self, node: str, timeout: float = 120.0) -> None:
        with self.lock:
            ok = self.lock.wait_for(
                lambda: all(p in self.macro_done
                            for p in self.graph.parents(node)),
                timeout=timeout)
            if not ok:
                raise TimeoutError(f"deps of {node!r} never completed")

    def upstream(self, q: int) -> Dict[str, str]:
        with self.lock:
            return {node: val for (qq, node), val in self.results.items()
                    if qq == q}

    def all_done(self) -> bool:
        with self.lock:
            return len(self.macro_done) == len(self.graph.nodes)


class PlanBoard:
    """Claimable per-worker node sequences with atomic tail replacement.

    The GPU workers pull their next node from here instead of a frozen
    list, which is what lets the replanning monitor swap every worker's
    unclaimed tail mid-run.  Overflow from failed workers also routes
    through the board (claimable by any surviving worker).
    """

    def __init__(self, plan: ExecutionPlan, dag: LLMDag, num_workers: int):
        self.lock = named_condition("PlanBoard.lock")
        self.dag = dag                   # guarded-by: self.lock
        self.W = num_workers
        self.seqs: List[List[str]] = plan.worker_sequences(num_workers)  # guarded-by: self.lock
        self.claimed: List[str] = []     # guarded-by: self.lock
        self.claimed_set: Set[str] = set()  # guarded-by: self.lock
        self.claim_chain: List[List[str]] = [  # guarded-by: self.lock
            [] for _ in range(num_workers)]
        self.overflow: List[str] = []    # guarded-by: self.lock
        self.dead: Set[int] = set()      # guarded-by: self.lock
        self.splices = 0                 # guarded-by: self.lock

    # ------------------------------------------------------------------
    # requires: self.lock
    def _releasable(self, nid: str) -> bool:
        return all(p in self.claimed_set for p in self.dag.parents(nid))

    # requires: self.lock
    def _claim_locked(self, wid: int, nid: str) -> str:
        self.claimed.append(nid)
        self.claimed_set.add(nid)
        self.claim_chain[wid].append(nid)
        self.lock.notify_all()
        return nid

    def try_claim(self, wid: int) -> Optional[str]:
        """Next node for worker ``wid``: own sequence head if releasable,
        else a releasable overflow node. None if nothing claimable now."""
        with self.lock:
            while self.seqs[wid] and self.seqs[wid][0] in self.claimed_set:
                self.seqs[wid].pop(0)
            if self.seqs[wid] and self._releasable(self.seqs[wid][0]):
                return self._claim_locked(wid, self.seqs[wid].pop(0))
            for i, nid in enumerate(self.overflow):
                if nid in self.claimed_set:
                    continue
                if self._releasable(nid):
                    self.overflow.pop(i)
                    return self._claim_locked(wid, nid)
            return None

    def abandon(self, wid: int) -> None:
        """A (simulated-)failed worker returns its unclaimed tail."""
        with self.lock:
            rest = [n for n in self.seqs[wid] if n not in self.claimed_set]
            self.seqs[wid] = []
            self.dead.add(wid)
            self.overflow.extend(rest)
            self.lock.notify_all()

    def exhausted(self, wid: int) -> bool:
        """True when worker ``wid`` can never claim anything again.

        Deliberately global: an idle worker must stay parked (not exit)
        while ANY node is unclaimed, because a mid-run replan splice may
        hand it part of the new tail.
        """
        with self.lock:
            return len(self.claimed) == len(self.dag.node_ids)

    def remaining(self) -> int:
        with self.lock:
            return len(self.dag.node_ids) - len(self.claimed)

    def planned_assignments(self) -> Dict[str, int]:
        """Worker each still-unclaimed node is currently planned on —
        the 'before' side of a splice's assignment diff (overflow nodes
        have no planned worker and are omitted)."""
        with self.lock:
            return {n: w for w, seq in enumerate(self.seqs) for n in seq
                    if n not in self.claimed_set}

    # ------------------------------------------------------------------
    # requires: self.lock
    def contexts_locked(self) -> Tuple[WorkerContext, ...]:
        """Live per-worker contexts implied by each claim chain.
        Caller must hold ``self.lock``."""
        out = []
        for chain in self.claim_chain:
            ctx = WorkerContext()
            for nid in chain:
                ctx = ctx.after(nid, self.dag.spec(nid).model)
            out.append(ctx)
        return tuple(out)

    def contexts(self) -> Tuple[WorkerContext, ...]:
        with self.lock:
            return self.contexts_locked()

    # requires: self.lock
    def claimed_prefix_epochs_locked(self) -> List[Epoch]:
        """The executed prefix as singleton epochs in claim order — valid
        by construction because claims follow DAG topological order.
        Caller must hold ``self.lock``."""
        chains = self.claim_chain
        return [Epoch([[nid]],
                      [next(w for w in range(self.W)
                            if nid in chains[w])])
                for nid in self.claimed]

    def claimed_prefix_epochs(self) -> List[Epoch]:
        with self.lock:
            return self.claimed_prefix_epochs_locked()

    # requires: self.lock
    def _splice_locked(self, tail: ExecutionPlan) -> None:
        seqs = tail.worker_sequences(self.W)
        self.seqs = [[n for n in seqs[w] if n not in self.claimed_set]
                     for w in range(self.W)]
        # tail work planned onto an abandoned worker would be
        # unclaimable (try_claim only reads seqs[wid] + overflow) —
        # reroute it through overflow for the survivors
        orphaned: List[str] = []
        for w in self.dead:
            orphaned.extend(self.seqs[w])
            self.seqs[w] = []
        self.overflow = [n for n in self.overflow
                         if n not in self.claimed_set
                         and not any(n in s for s in self.seqs)
                         and n not in orphaned] + orphaned
        self.splices += 1
        self.lock.notify_all()

    def splice(self, tail: ExecutionPlan) -> None:
        """Replace every worker's unclaimed tail with ``tail``'s sequences.

        The caller must have solved ``tail`` from an initial SystemState
        whose done-set equals the current claimed set.
        """
        with self.lock:
            self._splice_locked(tail)

    def graft(self, dag: LLMDag, tail: ExecutionPlan) -> None:
        """Atomically adopt a grown LLM DAG and splice in its re-solved
        tail (a session graft; DESIGN.md §10.2).

        ``dag`` must contain every already-claimed node (claims and claim
        chains survive); the tail covers the unclaimed remainder —
        including the freshly grafted nodes — so parked workers wake with
        claimable work the moment the splice publishes.
        """
        with self.lock:
            missing = self.claimed_set - set(dag.node_ids)
            if missing:
                raise ValueError(
                    f"graft DAG dropped claimed nodes: {sorted(missing)}")
            self.dag = dag
            self._splice_locked(tail)
