"""Session-style streaming Processor API (DESIGN.md §10).

A ``ProcessorSession`` deletes the micro-batch boundary: ``open()``
starts the worker/dispatcher loop ONCE, and every later ``submit()``
grafts the arriving queries into the RUNNING mega-DAG instead of
waiting for the next ``RealProcessor.run()`` call (DESIGN.md §10.1).
A graft (DESIGN.md §10.2):

1. consolidates the new (template, bindings) pair into the live
   ``MultiConsolidatedGraph`` via its incremental ``graft()`` — the new
   nodes join the EXISTING signature table (tool requests an in-flight
   node already issued are aliased, not re-run) and the existing
   warm-KV alias groups;
2. grows the live ``BatchState`` (new queries + nodes after birth);
3. re-solves the remaining LLM DAG from the board's live
   (claimed, contexts) state and splices the new tail via
   ``PlanBoard.graft`` — parked workers wake with claimable work, and
   the engines admit the grafted requests mid-decode;
4. returns per-query ``QueryHandle`` futures.

Per-request SLO classes (DESIGN.md §10.3) ride along: ``submit(...,
slo="interactive")`` tags the queries with the lane's priority, which
flows into the solver's priority-weighted epoch packing AND the
engines' priority admission — an interactive request preempts
batch-lane admission under KV-pool pressure, never vice versa.

``RealProcessor.run()`` is a thin one-shot wrapper over this class:
open → submit_consolidated → drain → report → close.

The counterpart of the JAX package's module of the same name, over the
port's engines.  It differs in one place: ``ProcessorConfig.hardware``
names the profile the cost model plans on (``"h100"``, the card the port
serves on), where the JAX module plans on ``"h200"`` always.  Hosts that
``open()`` makes run on the card (``engine_kwargs`` may name another
device) and raise without one.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, List, Optional, Sequence

from repro_torch.configs.base import ModelConfig
from repro_torch.core import HARDWARE, PAPER_MODELS
from repro_torch.core.coalesce import CoalesceTable
from repro_torch.core.consolidate import (ConsolidatedGraph,
                                          MultiConsolidatedGraph,
                                          consolidate_multi)
from repro_torch.core.cost_model import CostModel
from repro_torch.core.graphspec import GraphSpec
from repro_torch.core.plan import ExecutionPlan
from repro_torch.core.solver import EpochDPSolver, SolverConfig
from repro_torch.core.state import SLO_CLASSES, SLOClass, SystemState
from repro_torch.debugsync import named_lock
from repro_torch.runtime.coordinator import BatchState, PlanBoard
from repro_torch.runtime.events import RunReport, TaskRecord
from repro_torch.runtime.executors import (EngineHost, GPUWorkerThread,
                                           ToolDispatcher)
from repro_torch.runtime.faults import FaultInjector, FaultPlan
from repro_torch.runtime.jobstore import (JobStore, load_batch_state,
                                          signature_map)
from repro_torch.runtime.migrate import KVMigrator
from repro_torch.workloads.tools import ToolRuntime

# engine counters that accumulate monotonically (reported as per-run
# deltas so persistent hosts don't leak prior runs into each report)
_ENGINE_COUNTERS = ("prefill_tokens_saved", "admission_waves",
                    "priority_jumps", "pages_shared", "tokens_reused",
                    "coalesced_requests", "decode_tokens",
                    "pages_migrated_in", "pages_migrated_out",
                    "migrate_seconds", "h2d_bytes", "d2h_bytes",
                    "view_rebuilds")


@dataclass
class ProcessorConfig:
    """Construction knobs shared by ``RealProcessor`` and
    ``ProcessorSession`` (the former 11 loose ``__init__`` kwargs).

    ``priority_admission=False`` is the FIFO A/B control: SLO classes
    are accepted but their priorities are zeroed, so engine admission
    and epoch packing reduce exactly to the unweighted behaviour.
    """

    num_workers: int = 2
    cpu_slots: int = 8
    coalescing: bool = True
    seed: int = 0
    # cap generation length in tests (CPU real mode); None = node spec
    decode_cap: Optional[int] = None
    pipelining: bool = True
    engine_kwargs: Optional[Dict[str, Any]] = None
    # migrate moved nodes' warm KV on plan splices (off = A/B control)
    kv_migration: bool = True
    # workers claim at most this many incomplete nodes ahead (None =
    # unlimited) so pipelined claims can't outrun completions and
    # starve the mid-run replanning window
    claim_ahead: Optional[int] = None
    # feed SLO-class priorities into solver packing + engine admission;
    # False = FIFO control arm (DESIGN.md §10.3)
    priority_admission: bool = True
    # durable signature journal (DESIGN.md §12.2): completed results are
    # journaled incrementally and replayed on the next run at this path,
    # so a killed batch resumes without re-executing finished signatures
    jobstore_path: Optional[str] = None
    jobstore_fsync_every: int = 32
    # deterministic fault injection (DESIGN.md §12.3); None = off
    faults: Optional[FaultPlan] = None
    # bounded re-dispatch of TransientToolError tool calls
    tool_retries: int = 2
    # the cost model's hardware profile (a key of core.HARDWARE).  The
    # one field the JAX package's ProcessorConfig lacks: it plans on
    # "h200" always; the port serves on an H100
    hardware: str = "h100"


class QueryHandle:
    """Per-query future returned by ``ProcessorSession.submit()``
    (DESIGN.md §10.1), mirroring the engine's ``RequestHandle``.

    ``result()`` blocks for the query's full per-node output dict;
    ``ttft()`` is the session-level time-to-first-token proxy — seconds
    from submit to the query's FIRST LLM node result landing;
    ``add_done_callback`` fires when every node the query serves has a
    result (inline if already done).
    """

    def __init__(self, query: int, slo: SLOClass, nodes: Sequence[str],
                 llm_nodes: Sequence[str], state: BatchState,
                 submit_t: float):
        self.query = query
        self.slo = slo
        self._state = state
        self._submit_t = submit_t
        self._llm = set(llm_nodes)
        self._remaining = set(nodes)                # guarded-by: self._lock
        self._lock = named_lock("QueryHandle._lock")
        self._event = threading.Event()
        self._first_llm_t: Optional[float] = None   # guarded-by: self._lock
        # error latch: written once under _lock, read freely after the
        # completion event fires (the event is the publication barrier)
        self._error: Optional[BaseException] = None     # swap-only
        self._callbacks: List[Callable[["QueryHandle"], None]] = []  # guarded-by: self._lock
        if not self._remaining:                 # empty template slice
            self._event.set()

    # ------------------------------------------------------- plumbing
    def _note(self, node: str) -> None:
        """One (query, node) result landed (idempotent per node)."""
        with self._lock:
            if node not in self._remaining:
                return
            self._remaining.discard(node)
            if node in self._llm and self._first_llm_t is None:
                self._first_llm_t = time.perf_counter()
            done = not self._remaining
            cbs = list(self._callbacks) if done else []
        if done:
            self._event.set()
            for fn in cbs:
                fn(self)

    def _fail(self, err: BaseException) -> None:
        with self._lock:
            if self._error is None:
                self._error = err
            cbs = list(self._callbacks)
        self._event.set()
        for fn in cbs:
            fn(self)

    # ------------------------------------------------------------ API
    def done(self) -> bool:
        """True once every node result landed (or the session failed)."""
        return self._event.is_set()

    def exception(self) -> Optional[BaseException]:
        """The session error that failed this query, if any."""
        return self._error

    def add_done_callback(self,
                          fn: Callable[["QueryHandle"], None]) -> None:
        """Call ``fn(self)`` on completion; inline if already done."""
        with self._lock:
            if not self._event.is_set():
                self._callbacks.append(fn)
                return
        fn(self)

    def result(self, timeout: float = 600.0) -> Dict[str, str]:
        """Block for this query's ``{node_id: output}`` dict."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"query {self.query} incomplete after {timeout}s")
        if self._error is not None:
            raise self._error
        with self._state.lock:
            return {node: val
                    for (q, node), val in self._state.results.items()
                    if q == self.query}

    def ttft(self) -> Optional[float]:
        """Seconds from submit to the first LLM-node result (the
        session-level TTFT proxy scored against the SLO class's
        ``ttft_target_s``); None until a first token lands."""
        with self._lock:
            if self._first_llm_t is None:
                return None
            return self._first_llm_t - self._submit_t

    def first_result_at(self) -> Optional[float]:
        """``time.perf_counter()`` stamp of the first LLM-node result —
        lets a driver score TTFT against an ARRIVAL clock it owns (e.g.
        a query that queued behind a batch boundary before submit)."""
        with self._lock:
            return self._first_llm_t


class ProcessorSession:
    """Long-lived streaming Processor: one worker/dispatcher loop,
    many ``submit()`` calls grafted into the running mega-DAG
    (DESIGN.md §10.1).
    """

    def __init__(self, model_configs: Dict[str, ModelConfig],
                 tools: ToolRuntime,
                 config: Optional[ProcessorConfig] = None):
        self.config = config or ProcessorConfig()
        self.model_configs = model_configs
        self.tools = tools
        self.W = self.config.num_workers
        # lifecycle
        self._opened = False
        self._started = False
        self._closed = False
        self._stop = threading.Event()
        # serializes submits (bootstrap/graft) against the monitor's
        # replan heartbeat; also guards the session topology refs below
        self._graft_lock = named_lock("ProcessorSession._graft_lock")
        # error latch: swapped in by the monitor/worker side, read by
        # the submitting side (drain re-raises it)
        self._error: Optional[BaseException] = None     # swap-only
        # populated by open()/bootstrap
        self.hosts: Optional[List[EngineHost]] = None
        self._own_hosts = False
        self.optimizer = None
        self._cons: Optional[ConsolidatedGraph] = None  # guarded-by: self._graft_lock
        self.graph: Optional[GraphSpec] = None      # guarded-by: self._graft_lock
        self.state: Optional[BatchState] = None
        self.board: Optional[PlanBoard] = None
        self.dispatcher: Optional[ToolDispatcher] = None
        self.workers: List[GPUWorkerThread] = []
        self.migrator: Optional[KVMigrator] = None
        self.jobstore: Optional[JobStore] = None    # swap-only
        self.injector: Optional[FaultInjector] = None
        # (query, node) -> journal key; whole-dict swap on graft so the
        # journal listener reads it lock-free
        self._sig_of: Dict = {}                     # swap-only
        self._monitor: Optional[threading.Thread] = None
        self._rlock = named_lock("ProcessorSession._rlock")
        self._records: List[TaskRecord] = []        # guarded-by: self._rlock
        self._t0 = 0.0
        self._cm: Optional[CostModel] = None        # guarded-by: self._graft_lock
        self._solver_config = SolverConfig(num_workers=self.W)
        self._node_prio: Dict[str, float] = {}      # guarded-by: self._graft_lock
        self._handles: Dict[int, QueryHandle] = {}  # guarded-by: self._graft_lock
        self._plan_name = ""                        # guarded-by: self._graft_lock
        self._restored = 0                          # guarded-by: self._graft_lock
        self._base_counters: Dict[str, int] = {}    # guarded-by: self._graft_lock
        self._base_replans = 0                      # guarded-by: self._graft_lock
        self.grafts = 0                             # guarded-by: self._graft_lock

    # --------------------------------------------------------- lifecycle
    def open(self, hosts: Optional[List[EngineHost]] = None,
             optimizer=None) -> "ProcessorSession":
        """Attach (or create) engine hosts and an optional
        ``OnlineOptimizer``; the worker/dispatcher loop starts lazily on
        the first submission.  Persistent ``hosts`` keep resident models
        and warm KV pages across sessions; the optimizer's calibration
        likewise compounds."""
        if self._opened:
            raise RuntimeError("session already open")
        self._own_hosts = hosts is None
        if hosts is None:
            hosts = [EngineHost(self.model_configs, seed=self.config.seed,
                                engine_kwargs=self.config.engine_kwargs)
                     for _ in range(self.W)]
        if len(hosts) != self.W:
            raise ValueError(f"need {self.W} hosts, got {len(hosts)}")
        self.hosts = hosts
        self.optimizer = optimizer
        self._opened = True
        return self

    def __enter__(self) -> "ProcessorSession":
        if not self._opened:
            self.open()
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -------------------------------------------------------- submission
    def _capped(self, template: GraphSpec) -> GraphSpec:
        cap = self.config.decode_cap
        if cap is None:
            return template
        nodes = [n.with_(max_new_tokens=min(n.max_new_tokens, cap))
                 if n.is_llm() else n for n in template.nodes.values()]
        return GraphSpec(template.name, nodes, template.edges)

    def _slo(self, slo) -> SLOClass:
        if isinstance(slo, SLOClass):
            return slo
        try:
            return SLO_CLASSES[slo]
        except KeyError:
            raise ValueError(f"unknown SLO class {slo!r} "
                             f"(have: {sorted(SLO_CLASSES)})") from None

    def submit(self, template: GraphSpec,
               bindings: Sequence[Dict[str, str]],
               slo="batch") -> List[QueryHandle]:
        """Consolidate ``bindings`` over ``template`` INTO the running
        mega-DAG and return one ``QueryHandle`` per query.

        The first call bootstraps the session (consolidate + solve +
        start workers); every later call grafts (DESIGN.md §10.2): the
        new queries share the live signature table and warm aliases, the
        remaining DAG is re-solved with the live worker contexts, and
        the spliced tail reaches the engines mid-decode.  ``slo`` picks
        the service lane (DESIGN.md §10.3).
        """
        if not self._opened:
            raise RuntimeError("open() the session before submitting")
        if self._closed:
            raise RuntimeError("session is closed")
        slo_cls = self._slo(slo)
        with self._graft_lock:
            if not self._started:
                cons = consolidate_multi([(self._capped(template),
                                           bindings)])
                return self._bootstrap(cons, plan=None, slo=slo_cls)
            return self._graft(template, bindings, slo_cls)

    def submit_consolidated(self, cons: ConsolidatedGraph,
                            plan: Optional[ExecutionPlan] = None, *,
                            graph: Optional[GraphSpec] = None,
                            resume_from: Optional[str] = None,
                            die_after: Optional[Dict[int, int]] = None,
                            slo="batch") -> List[QueryHandle]:
        """Bootstrap the session from an ALREADY consolidated batch (the
        one-shot ``RealProcessor.run()`` path): an optional pre-solved
        ``plan``, a ``decode_cap``-rewritten ``graph`` override, a
        checkpoint to resume from, and simulated worker failures."""
        if not self._opened:
            raise RuntimeError("open() the session before submitting")
        with self._graft_lock:
            if self._started:
                raise RuntimeError(
                    "submit_consolidated only bootstraps; use submit() "
                    "to graft into a running session")
            return self._bootstrap(cons, plan, slo=self._slo(slo),
                                   graph=graph, resume_from=resume_from,
                                   die_after=die_after)

    # ------------------------------------------------------- bootstrap
    def _priority(self, slo_cls: SLOClass) -> int:
        return slo_cls.priority if self.config.priority_admission else 0

    # requires: self._graft_lock
    def _build_cm(self) -> CostModel:
        return CostModel(self.graph, HARDWARE[self.config.hardware],
                         PAPER_MODELS,
                         batch_sizes=self._cons.batch_sizes(),
                         use_migration=self.config.kv_migration,
                         warm_aliases=self._cons.warm_aliases())

    # requires: self._graft_lock
    def _register_handles(self, queries: Sequence[int],
                          slo_cls: SLOClass) -> List[QueryHandle]:
        now = time.perf_counter()
        out = []
        for q in queries:
            nodes = [nid for nid in self.graph.nodes
                     if self.state.serves(q, nid)]
            llm = [nid for nid in nodes if self.graph.nodes[nid].is_llm()]
            h = QueryHandle(q, slo_cls, nodes, llm, self.state, now)
            self._handles[q] = h
            out.append(h)
        # results that already landed (checkpoint restore, or a race
        # with the listener) are replayed; _note is idempotent per node
        with self.state.lock:
            landed = [(q, node) for (q, node) in self.state.results
                      if q in self._handles]
        for q, node in landed:
            self._handles[q]._note(node)
        return out

    # runs-on: any
    def _on_result(self, q: int, node: str) -> None:
        h = self._handles.get(q)
        if h is not None:
            h._note(node)

    # runs-on: any
    def _journal_result(self, q: int, node: str) -> None:
        """BatchState listener → durable journal: every landed result is
        recorded under its consolidation signature (fires OUTSIDE the
        state lock, so re-acquiring it to read the value is safe)."""
        key = self._sig_of.get((q, node))
        if key is None:
            return                  # node without a signature mapping
        with self.state.lock:
            val = self.state.results.get((q, node))
        if val is not None:
            self.jobstore.record(key, node, str(val))

    # requires: self._graft_lock
    def _bootstrap(self, cons: ConsolidatedGraph,
                   plan: Optional[ExecutionPlan], slo: SLOClass,
                   graph: Optional[GraphSpec] = None,
                   resume_from: Optional[str] = None,
                   die_after: Optional[Dict[int, int]] = None
                   ) -> List[QueryHandle]:
        cfg = self.config
        self._cons = cons
        self.graph = graph if graph is not None else cons.template
        self.state = BatchState(self.graph, cons.n_queries,
                                queries_of=cons.queries_map())
        prio = self._priority(slo)
        with self.state.lock:
            self.state.query_priority = {q: prio
                                         for q in range(cons.n_queries)}
        if prio:
            self._node_prio = {nid: float(prio)
                               for nid in self.graph.llm_nodes()}
        if resume_from:
            self._restored = load_batch_state(self.state, resume_from)
        if cfg.faults is not None:
            self.injector = FaultInjector(cfg.faults)
        if cfg.jobstore_path:
            # open + replay BEFORE the journal listener attaches: the
            # restore's own set_result events must not be re-journaled
            self.jobstore = JobStore(cfg.jobstore_path,
                                     fsync_every=cfg.jobstore_fsync_every)
            self._sig_of = signature_map(cons)
            self._restored += self.jobstore.restore_into(self.state,
                                                         self._sig_of)
            self.state.add_listener(self._journal_result)

        self._t0 = time.perf_counter()
        if self.optimizer is not None:
            self.optimizer.bind_graph(self.graph)
            self.optimizer.solver_config.num_workers = self.W
            # replans must price placement moves the way THIS session
            # executes them: no migration credit when migration is off
            self.optimizer.cm.use_migration = cfg.kv_migration
            self._cm = self.optimizer.cm
            self._base_replans = self.optimizer.replans
            if self._node_prio:
                self.optimizer.node_priorities = dict(self._node_prio)
        else:
            self._cm = self._build_cm()
        if plan is None:
            plan = EpochDPSolver(self.graph.llm_dag(), self._cm,
                                 replace(self._solver_config),
                                 priorities=self._node_prio).solve()
        self._plan_name = plan.scheduler_name
        self.board = PlanBoard(plan, self.graph.llm_dag(), self.W)
        if self.optimizer is not None:
            self.optimizer.attach_plan(plan)

        self.dispatcher = ToolDispatcher(
            self.graph, self.state, cons.bindings, self.tools,
            self._records, self._rlock, self._t0,
            cpu_slots=cfg.cpu_slots, coalescing=cfg.coalescing,
            optimizer=self.optimizer, persistent=True,
            faults=self.injector, tool_retries=cfg.tool_retries)
        self.dispatcher.start()

        self._base_counters = self._engine_totals(self.hosts)
        for h in self.hosts:                    # per-session watermark
            for e in h.engines():
                e.reset_peak_batch()

        if cfg.kv_migration:
            # no optimizer -> no replanning, but workers still pull warm
            # lineage from peers at claim time (cost-model decision
            # falls back to migrate-on-hit without a cm)
            self.migrator = KVMigrator(
                self.graph, self.hosts,
                cost_model=(self.optimizer.cm
                            if self.optimizer is not None else None))

        # explicit die_after wins; the fault plan's kill_worker fills in
        # the rest (both routes end in PlanBoard.abandon + overflow)
        die = dict(die_after or {})
        if self.injector is not None:
            for w in range(self.W):
                after = self.injector.die_after(w)
                if after is not None:
                    die.setdefault(w, after)
        self.workers = [
            GPUWorkerThread(w, self.board, self.graph, self.state,
                            cons.bindings, self.hosts[w], self._records,
                            self._rlock, self._t0,
                            die_after=die.get(w),
                            pipelining=cfg.pipelining,
                            optimizer=self.optimizer,
                            migrator=self.migrator,
                            claim_ahead=cfg.claim_ahead,
                            stop_event=self._stop,
                            faults=self.injector)
            for w in range(self.W)]
        self.state.add_listener(self._on_result)
        handles = self._register_handles(range(cons.n_queries), slo)
        if self.optimizer is not None:
            # admission-time pass: a queued (forced) splice — or a plan
            # already known-drifted from a prior run's calibration —
            # re-places work and migrates warm KV before any claim
            self.optimizer.maybe_replan(self.board,
                                        migrator=self.migrator)
        for wk in self.workers:
            wk.start()
        self._monitor = threading.Thread(target=self._monitor_loop,
                                         daemon=True,
                                         name="session-monitor")
        self._monitor.start()
        self._started = True
        return handles

    # runs-on: session-monitor
    def _monitor_loop(self) -> None:
        """Error watch + the replanning heartbeat (drift evaluation runs
        on this thread, exactly like the one-shot monitor loop)."""
        while not self._stop.is_set():
            err = next((wk.error for wk in self.workers if wk.error),
                       None) or self.dispatcher.error
            if err is not None and self._error is None:
                self._error = err
                with self.state.lock:
                    self.state.lock.notify_all()
            if self.optimizer is not None and self._error is None:
                # never replan concurrently with an in-progress graft:
                # the board's DAG and the optimizer's may briefly
                # disagree mid-graft, and a splice solved against the
                # wrong one would publish unclaimable nodes
                if self._graft_lock.acquire(blocking=False):
                    try:
                        self.optimizer.maybe_replan(
                            self.board, migrator=self.migrator)
                    except BaseException as e:
                        self._error = self._error or e
                        with self.state.lock:
                            self.state.lock.notify_all()
                    finally:
                        self._graft_lock.release()
            self._stop.wait(timeout=0.05)

    # ------------------------------------------------------------ graft
    # requires: self._graft_lock
    def _graft(self, template: GraphSpec,
               bindings: Sequence[Dict[str, str]],
               slo_cls: SLOClass) -> List[QueryHandle]:
        """Graft new queries into the running mega-DAG (DESIGN.md
        §10.2).  Caller holds ``_graft_lock``."""
        if not isinstance(self._cons, MultiConsolidatedGraph):
            raise RuntimeError(
                "grafting needs a multi-consolidated session (bootstrap "
                "via submit(), not a single-template batch)")
        err = self._error
        if err is not None:
            raise err
        new_ids, offset = self._cons.graft([(self._capped(template),
                                             bindings)])
        graph = self._cons.template
        n_new = len(bindings)
        prio = self._priority(slo_cls)
        queries = list(range(offset, offset + n_new))

        # 1. state grows first: workers/dispatcher must find the new
        #    queries' bookkeeping before any new node becomes claimable
        self.state.extend(graph, n_new,
                          queries_of=self._cons.queries_map(),
                          priorities={q: prio for q in queries})
        self.graph = graph
        for wk in self.workers:
            wk.rebind(graph)
        if self.migrator is not None:
            self.migrator.graph = graph
        if self.jobstore is not None:
            # grafted queries may repeat journaled signatures: swap in
            # the grown map, replay hits (the journal listener ignores
            # its own replay via the store's replaying set)
            self._sig_of = signature_map(self._cons)
            self._restored += self.jobstore.restore_into(self.state,
                                                         self._sig_of)

        # 2. cost-model adoption: grown batch sizes, merged warm-alias
        #    groups, accumulated SLO priority mass
        if prio:
            self._node_prio.update(
                {nid: float(prio) for nid in new_ids
                 if graph.nodes[nid].is_llm()})
        if self.optimizer is not None:
            self.optimizer.adopt_graft(graph, self._cons.batch_sizes(),
                                       self._cons.warm_aliases(),
                                       self._node_prio)
            self._cm = self.optimizer.cm
        else:
            self._cm = self._build_cm()

        # 3. re-solve the remaining DAG from the LIVE system state:
        #    claimed nodes are done, worker contexts carry their warm KV
        new_dag = graph.llm_dag()
        with self.board.lock:
            done = frozenset(self.board.claimed_set)
            contexts = self.board.contexts_locked()
        tail = EpochDPSolver(
            new_dag, self._cm, replace(self._solver_config),
            priorities=self._node_prio,
        ).solve(initial=SystemState(done, contexts))

        # 4. migrate warm KV for moved old nodes, then publish: parked
        #    workers wake on the board notify with claimable work
        if self.migrator is not None:
            self.migrator.migrate_for_splice(self.board, tail)
        self.board.graft(new_dag, tail)
        self.dispatcher.rebind(graph)
        self.grafts += 1

        # 5. keep the drift monitor coherent: the live plan becomes
        #    claimed-prefix + grafted tail, with the prefix marked
        #    evaluated (history has no solver-predicted cost)
        base = self._plan_name or "halo-dp"
        self._plan_name = base if base.endswith("+graft") \
            else base + "+graft"
        if self.optimizer is not None:
            prefix = self.board.claimed_prefix_epochs()
            spliced = ExecutionPlan(epochs=prefix + tail.epochs,
                                    predicted_cost=tail.predicted_cost,
                                    scheduler_name=self._plan_name)
            spliced.validate(new_dag)
            self.optimizer.attach_plan(spliced, fresh=False,
                                       evaluated_prefix=len(prefix))
        return self._register_handles(queries, slo_cls)

    # ------------------------------------------------------------ drain
    def drain(self, timeout: float = 600.0) -> None:
        """Block until every submitted query's every node has a result
        (or the session failed)."""
        if not self._started:
            return
        state = self.state
        with state.lock:
            state.lock.wait_for(
                lambda: (len(state.macro_done) == len(state.graph.nodes)
                         or self._error is not None
                         or any(wk.error for wk in self.workers)
                         or self.dispatcher.error is not None),
                timeout=timeout)
        err = self._error \
            or next((wk.error for wk in self.workers if wk.error), None) \
            or self.dispatcher.error
        if err is not None:
            raise err
        with state.lock:
            missing = set(state.graph.nodes) - state.macro_done
        if missing:
            raise RuntimeError(f"run incomplete; missing {sorted(missing)}")

    def close(self) -> None:
        """Stop workers, dispatcher and monitor; join every thread; shut
        down session-owned hosts.  Idempotent; leaks no threads."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        if self.board is not None:
            with self.board.lock:
                self.board.lock.notify_all()
        if self.state is not None:
            with self.state.lock:
                self.state.lock.notify_all()
        for wk in self.workers:
            wk.join(timeout=60)
        if self.dispatcher is not None:
            self.dispatcher.stop()
            self.dispatcher.join(timeout=60)
        if self._monitor is not None:
            self._monitor.join(timeout=60)
        if self.jobstore is not None:       # after joins: no more writes
            self.jobstore.close()
        if self._own_hosts and self.hosts is not None:
            for h in self.hosts:
                h.shutdown()

    # ---------------------------------------------------------- report
    @staticmethod
    def _engine_totals(hosts: List[EngineHost]) -> Dict[str, int]:
        engines = [e for h in hosts for e in h.engines()]
        out = {k: sum(getattr(e.stats, k) for e in engines)
               for k in _ENGINE_COUNTERS}
        out["model_switches"] = sum(h.switches for h in hosts)
        return out

    @staticmethod
    # requires: BatchState.lock
    def _cross_template_stats(cons: ConsolidatedGraph,
                              table: CoalesceTable) -> Dict[str, int]:
        """Runtime cross-template coalescing: physical tool executions
        whose logical requesters span >= 2 templates (the merges only a
        multi-template mega-DAG makes possible)."""
        merged_tasks = 0
        merged_requests = 0
        tasks = list(table.completed.values()) + list(table.pending.values())
        for task in tasks:
            if not task.requesters:
                continue
            # only requesters from a DIFFERENT template than the one
            # whose request ran the physical execution count as
            # cross-template merges — same-template coalescing on a
            # spanning task is ordinary dedup, not a mega-DAG win
            owner = cons.template_of[task.requesters[0][1]]
            crossed = sum(1 for _, nid in task.requesters
                          if cons.template_of[nid] != owner)
            if crossed:
                merged_tasks += 1
                merged_requests += crossed
        return {"cross_template_merged_tasks": merged_tasks,
                "cross_template_merged_requests": merged_requests}

    def report(self) -> RunReport:
        """Build the RunReport for everything this session executed so
        far (same layout as the one-shot ``RealProcessor.run()``:
        coalescing stats, per-run engine-counter deltas, splice/replan
        and migration summaries, plus session-only ``grafts``)."""
        if not self._started:
            raise RuntimeError("nothing submitted yet")
        cons, dispatcher = self._cons, self.dispatcher
        plan_name = self._plan_name or "halo-session"
        if self.optimizer is not None and self.optimizer.plan is not None:
            plan_name = self.optimizer.plan.scheduler_name
        report = RunReport(
            name=plan_name, makespan=time.perf_counter() - self._t0,
            records=self._records, num_queries=cons.n_queries,
            num_workers=self.W)
        with self.state.lock:           # the table is guarded by it
            report.coalesce_stats = {
                "tool_logical": dispatcher.table.logical_requests,
                "tool_physical": dispatcher.table.physical_executions,
                "tool_dedup_ratio": dispatcher.table.dedup_ratio,
                "restored_results": self._restored,
            }
            if cons.n_templates > 1:
                report.coalesce_stats.update(
                    self._cross_template_stats(cons, dispatcher.table))
            results = dict(self.state.results)
        report.extra["results"] = {           # type: ignore[assignment]
            f"{q}:{node}": val
            for (q, node), val in sorted(results.items())}
        # per-run deltas against the at-open totals: persistent hosts
        # must not re-report earlier sessions' counts
        totals = self._engine_totals(self.hosts)
        for key, cur in totals.items():
            report.extra[key] = max(cur - self._base_counters.get(key, 0),
                                    0)
        engines = [e for h in self.hosts for e in h.engines()]
        # per-run gauge: watermarks were reset at bootstrap, so the max
        # is THIS session's peak concurrency, not an earlier run's
        report.extra["peak_batch"] = max(
            (e.stats.peak_batch for e in engines), default=0)
        report.extra["cpu_gpu_overlap_s"] = round(
            report.cpu_gpu_overlap(), 6)
        with self.board.lock:
            report.extra["plan_splices"] = self.board.splices
        report.extra["grafts"] = self.grafts
        if self.jobstore is not None:
            report.extra["jobstore"] = (      # type: ignore[assignment]
                self.jobstore.summary())
        if self.injector is not None:
            report.extra["faults"] = (        # type: ignore[assignment]
                self.injector.summary())
            with dispatcher._retry_lock:
                report.extra["tool_retries"] = dispatcher.retries_used
        if self.optimizer is not None:
            report.extra["replans"] = (self.optimizer.replans
                                       - self._base_replans)
            report.extra["calibration"] = (   # type: ignore[assignment]
                self.optimizer.calibration_summary())
        if self.migrator is not None:
            report.extra["migration"] = (     # type: ignore[assignment]
                self.migrator.summary())
        return report
