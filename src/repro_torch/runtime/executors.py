"""Executors for the real Processor backend (DESIGN.md §7.1).

* EngineHost — a worker's model slot: at most one resident continuous-
  batching engine; ``submit()`` feeds requests into the engine's
  persistent loop (admitted mid-decode) and returns handles.
* GPUWorkerThread — a stateful GPU executor: claims its planned nodes
  from the PlanBoard and, in pipelined mode, submits each query's
  request the moment THAT query's deps land and publishes each result
  the moment its request retires (per-handle callbacks) — no macro
  barrier; barrier mode (``pipelining=False``) keeps the historical
  wait-all semantics for A/B comparison.
* ToolDispatcher — bounded CPU pool with per-query wavefront promotion,
  depth-priority ordering and signature coalescing; event-driven (woken
  by per-result listeners, incremental candidate scan) instead of a
  periodic full rescan.

The counterpart of the JAX package's module of the same name, serving
the port's ``InferenceEngine``.  Only ``EngineHost`` differs: it takes
the engines' ``weights`` (the port's random init draws differently from
the JAX init, so a caller that wants the JAX engines' outputs hands in
their bridged weights), loads them at every model switch, and refuses
to start without a card unless ``engine_kwargs`` names another device.
"""
from __future__ import annotations

import queue as _q
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.coalesce import CoalesceTable
from repro_torch.core.graphspec import GraphSpec
from repro_torch.core.parser import render
from repro_torch.debugsync import named_lock
from repro_torch.engine.engine import InferenceEngine, RequestHandle
from repro_torch.engine.tokenizer import detokenize, tokenize
from repro_torch.runtime.coordinator import BatchState, PlanBoard
from repro_torch.runtime.events import TaskRecord
from repro_torch.runtime.faults import FaultInjector, TransientToolError
from repro_torch.workloads.tools import ToolRuntime


class EngineHost:
    """One worker's model slot: at most one resident engine."""

    PROMPT_LOG_CAP = 16          # recent prompts kept per node (migration)

    def __init__(self, model_configs: Dict[str, ModelConfig], seed: int = 0,
                 engine_kwargs: Optional[Dict[str, Any]] = None,
                 weights: Optional[
                     Callable[[str], Dict[str, torch.Tensor]]] = None):
        self.model_configs = model_configs
        self.seed = seed
        self.engine_kwargs = dict(engine_kwargs or {})
        device = torch.device(self.engine_kwargs.get("device", "cuda"))
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "EngineHost: device 'cuda' requested but no CUDA device is "
                "available; pass engine_kwargs={'device': 'cpu'} to run on "
                "the CPU")
        # a loader: model name -> state_dict (``dict.get`` of a map will
        # do); None keeps each engine's random init from ``seed``
        self.weights = weights
        # guards engine creation: the worker thread (engine_for) and the
        # migrator (engine_for_import, monitor thread) may first-touch
        # the same model concurrently during a mid-run splice
        self._engines_lock = named_lock("EngineHost._engines_lock")
        self._engines: Dict[str, InferenceEngine] = {}  # guarded-by: self._engines_lock
        # resident/switch bookkeeping belongs to the one worker thread
        # that owns this host's model slot — the migrator and monitor
        # go through engine_for_import, which never switches residency
        self.resident: Optional[str] = None             # guarded-by: gpu-worker
        self.switches = 0                               # guarded-by: gpu-worker
        self.switch_seconds = 0.0                       # guarded-by: gpu-worker
        # node -> recent prompt token tuples served here; the KVMigrator
        # reads this to know WHICH warm prefixes a replan strands when it
        # moves the node to another worker.  Persists with the host
        # across micro-batch runs (like the engines' warm pages).
        self._log_lock = named_lock("EngineHost._log_lock")
        self._prompt_log: Dict[str, List[tuple]] = {}   # guarded-by: self._log_lock

    def _get_engine(self, model: str) -> InferenceEngine:
        with self._engines_lock:
            if model not in self._engines:
                self._engines[model] = InferenceEngine(
                    self.model_configs[model], seed=self.seed,
                    **self.engine_kwargs)
            return self._engines[model]

    # runs-on: gpu-worker
    def engine_for(self, model: str) -> InferenceEngine:
        eng = self._get_engine(model)
        if self.resident != model:
            prev = (self.peek_engine(self.resident)
                    if self.resident is not None else None)
            if prev is not None:
                # unload/load run OUTSIDE _engines_lock: they move real
                # params and must not block the migrator's peek
                prev.unload()
                self.switches += 1
            # unload() sent the weights to "meta": load them at every
            # switch, not only the first
            self.switch_seconds += eng.load(
                self.weights(model) if self.weights else None)
            self.resident = model
        return eng

    def peek_engine(self, model: str) -> Optional[InferenceEngine]:
        """The engine for ``model`` if one ever ran here, else None."""
        with self._engines_lock:
            return self._engines.get(model)

    def engine_for_import(self, model: str) -> InferenceEngine:
        """Get (or create) ``model``'s engine WITHOUT making it resident:
        importing migrated KV pages must not trigger a model switch —
        pages and the radix tree live outside the loaded params."""
        return self._get_engine(model)

    # ------------------------------------------------------- prompt log
    def log_prompts(self, nid: str, prompts) -> None:
        """Record the token prompts ``nid`` just submitted here."""
        with self._log_lock:
            log = self._prompt_log.setdefault(nid, [])
            for p in prompts:
                t = tuple(int(x) for x in p)
                if t in log:
                    log.remove(t)                # refresh recency
                log.append(t)
            del log[:-self.PROMPT_LOG_CAP]

    def prompts_for(self, nid: str) -> List[tuple]:
        with self._log_lock:
            return list(self._prompt_log.get(nid, ()))

    # runs-on: gpu-worker
    def submit(self, model: str, prompts: Sequence[Sequence[int]], *,
               max_new_tokens: int = 16, temperature: float = 0.0,
               extras: Optional[List[Dict[str, Any]]] = None,
               priorities: Optional[Sequence[int]] = None,
               ) -> List[RequestHandle]:
        """Submit prompts into the resident engine's persistent loop.

        Non-blocking: the requests join the engine's running decode batch
        (continuous batching); callers wait on the returned handles.
        ``priorities`` (per-prompt, default all-0) feed the engine's
        SLO-lane admission (DESIGN.md §10.3).
        """
        eng = self.engine_for(model)
        extras = extras or [{} for _ in prompts]
        prios = priorities or [0] * len(prompts)
        return [eng.submit(p, max_new_tokens=max_new_tokens,
                           temperature=temperature, extra=e, priority=pr)
                for p, e, pr in zip(prompts, extras, prios)]

    def engines(self) -> List[InferenceEngine]:
        """Snapshot of every engine ever created on this host."""
        with self._engines_lock:
            return list(self._engines.values())

    def shutdown(self) -> None:
        """Stop every engine's loop thread (stats stay readable)."""
        for eng in self.engines():
            eng.shutdown()


class GPUWorkerThread(threading.Thread):
    def __init__(self, wid: int, board: PlanBoard, graph: GraphSpec,
                 state: BatchState, bindings: Sequence[dict],
                 host: EngineHost, records: List[TaskRecord],
                 records_lock: threading.Lock, t0: float,
                 die_after: Optional[int] = None, pipelining: bool = True,
                 optimizer=None, migrator=None,
                 claim_ahead: Optional[int] = None,
                 stop_event: Optional[threading.Event] = None,
                 faults: Optional[FaultInjector] = None):
        super().__init__(daemon=True, name=f"gpu{wid}")
        self.wid = wid
        self.board = board
        self.graph = graph                              # swap-only
        self.state = state
        self.bindings = bindings
        self.host = host
        self.records = records              # guarded-by: self.records_lock
        self.records_lock = records_lock    # lock-alias: ProcessorSession._rlock
        self.t0 = t0
        self.die_after = die_after
        self.pipelining = pipelining
        self.optimizer = optimizer
        self.migrator = migrator
        self.faults = faults
        # claim throttling: claim at most this many not-yet-completed
        # nodes ahead (None = unlimited).  Pipelined submission races
        # claims far ahead of completions, collapsing the replanning
        # window to nothing; a small K keeps late-batch drift replans
        # able to re-place real work.
        self.claim_ahead = claim_ahead
        # session mode: when set, the worker parks on an empty board
        # (never exits on exhaustion — a graft may hand it new work) and
        # only returns once the event fires (DESIGN.md §10.1)
        self.stop_event = stop_event
        self.executed = 0                               # guarded-by: gpu-worker
        self.error: Optional[BaseException] = None      # swap-only
        self._outstanding: List[RequestHandle] = []     # guarded-by: gpu-worker
        self._my_claims: List[str] = []                 # guarded-by: gpu-worker

    # runs-on: any
    def rebind(self, graph: GraphSpec) -> None:
        """Adopt a grafted supergraph (atomic reference swap; node specs
        already claimed are identical in the new graph)."""
        self.graph = graph

    # ------------------------------------------------------------------
    # runs-on: any
    def _fail(self, err: BaseException) -> None:
        if self.error is None:
            self.error = err
        with self.state.lock:
            self.state.lock.notify_all()

    def _pending_queries(self, nid: str) -> List[int]:
        with self.state.lock:
            return [q for q in self.state.queries_for(nid)
                    if (q, nid) not in self.state.results]

    # ----------------------------------------------------- barrier mode
    def _run_node_barrier(self, nid: str) -> None:
        spec = self.graph.nodes[nid]
        if self.state.is_macro_done(nid):
            return                                   # restored from checkpoint
        # the board releases claims on parents-CLAIMED, so this wait is
        # real in barrier mode — give it the same 600s budget as every
        # other dependency wait
        self.state.wait_macro_ready(nid, timeout=600.0)
        queries = self.state.queries_for(nid)   # this node's template slice
        if not queries:
            return
        eng = self.host.engine_for(spec.model)
        prompts = []
        for q in queries:
            text = render(spec.prompt, self.bindings[q],
                          self.state.upstream(q))
            prompts.append(tokenize(text, eng.cfg.vocab_size))
        self.host.log_prompts(nid, prompts)
        ts = time.perf_counter() - self.t0
        handles = self.host.submit(
            spec.model, prompts, max_new_tokens=spec.max_new_tokens,
            temperature=spec.temperature,
            priorities=[self.state.priority_of(q) for q in queries])
        outs = [h.result() for h in handles]
        te = time.perf_counter() - self.t0
        with self.records_lock:
            self.records.append(TaskRecord(
                node=nid, kind="llm", worker=f"gpu{self.wid}",
                start=ts, end=te, batch=len(prompts)))
        if self.optimizer is not None:
            self.optimizer.observe_llm(nid, len(prompts), te - ts,
                                       f"gpu{self.wid}", span=(ts, te))
        for q, toks in zip(queries, outs):
            self.state.set_result(q, nid, detokenize(toks))

    # --------------------------------------------------- pipelined mode
    def _run_node_pipelined(self, nid: str) -> None:
        """Submit ``nid``'s per-query requests as each query's deps land;
        publish each result from the handle's completion callback.

        Returns once every query is SUBMITTED (not completed): the worker
        moves on to its next node while this one is still decoding, so
        same-model successors join the running continuous batch.
        """
        spec = self.graph.nodes[nid]
        state = self.state
        todo = self._pending_queries(nid)        # checkpoint-restored skipped
        if not todo:
            return
        node_track = {"done": 0, "expected": len(todo)}
        tlock = threading.Lock()
        eng = None
        pending = set(todo)
        deadline = time.monotonic() + 600.0
        while pending:
            if self.stop_event is not None and self.stop_event.is_set():
                return                       # session closing mid-node
            if time.monotonic() > deadline:
                raise TimeoutError(f"deps of {nid!r} never completed")
            wave = self._settle_ready_wave(nid, pending)
            if not wave:
                with state.lock:
                    state.lock.wait(timeout=0.05)
                continue
            if eng is None:
                # first ready query pays the (measured) model switch
                eng = self.host.engine_for(spec.model)
            # one TaskRecord per submission wave: a wave's span is real
            # engine-busy time, whereas one node-wide record would count
            # the gaps spent waiting for later queries' deps as GPU work
            # (inflating overlap and poisoning calibration samples)
            wave_track = {"done": 0, "expected": len(wave),
                          "start": time.perf_counter() - self.t0}
            wave_prompts = []
            for q in wave:
                text = render(spec.prompt, self.bindings[q],
                              state.upstream(q))
                toks = tokenize(text, eng.cfg.vocab_size)
                wave_prompts.append(toks)
                h = eng.submit(toks,
                               max_new_tokens=spec.max_new_tokens,
                               temperature=spec.temperature,
                               priority=state.priority_of(q))
                h.add_done_callback(
                    self._on_request_done(nid, q, node_track, wave_track,
                                          tlock))
                self._outstanding.append(h)
                pending.discard(q)
            self.host.log_prompts(nid, wave_prompts)

    def _settle_ready_wave(self, nid: str, pending: set) -> List[int]:
        """Queries of ``nid`` ready right now, after a short settle loop.

        Same-decode-step completions upstream land microseconds apart;
        without settling they would trickle into the engine one by one
        and fragment the partial batch (and, on the JIT path, recompile
        per batch shape).  Bounded at ~20 ms — still far finer-grained
        than the macro barrier it replaces.  When the engines run their
        own grace-window admission (``admission_window`` engine kwarg),
        the window subsumes this loop and the wave submits immediately.
        """
        ready = {q for q in pending if self.state.query_ready(q, nid)}
        if not ready:
            return []
        if self.host.engine_kwargs.get("admission_window", 0) > 0:
            return sorted(ready)         # engine-side window batches these
        for _ in range(10):
            time.sleep(0.002)
            grown = {q for q in pending if self.state.query_ready(q, nid)}
            if grown == ready:
                break
            ready = grown
        return sorted(ready)

    # runs-on: any
    def _on_request_done(self, nid: str, q: int, node_track: dict,
                         wave_track: dict, tlock: threading.Lock):
        """Per-handle callback: publish this query's result immediately
        (its tool tasks wake without waiting on batch stragglers)."""
        def _cb(h: RequestHandle) -> None:
            try:
                self._publish(h, nid, q, node_track, wave_track, tlock)
            except BaseException as e:     # engine swallows callback raises
                self._fail(e)
        return _cb

    # runs-on: any
    def _publish(self, h: RequestHandle, nid: str, q: int,
                 node_track: dict, wave_track: dict,
                 tlock: threading.Lock) -> None:
        err = h.exception()
        if err is not None:
            self._fail(err)
            return
        toks = h.result(timeout=1.0)
        te = time.perf_counter() - self.t0
        with tlock:
            wave_track["done"] += 1
            node_track["done"] += 1
            wave_done = wave_track["done"] == wave_track["expected"]
            node_done = node_track["done"] == node_track["expected"]
        if wave_done:                     # record before the final publish
            ts = wave_track["start"]
            with self.records_lock:
                self.records.append(TaskRecord(
                    node=nid, kind="llm", worker=f"gpu{self.wid}",
                    start=ts, end=te, batch=wave_track["expected"]))
            if self.optimizer is not None:
                self.optimizer.observe_llm(
                    nid, wave_track["expected"], te - ts,
                    f"gpu{self.wid}", node_complete=node_done,
                    span=(ts, te))
        self.state.set_result(q, nid, detokenize(toks))

    # ------------------------------------------------------------------
    def _drain_outstanding(self) -> None:
        for h in self._outstanding:
            try:
                h.result(timeout=600)
            except BaseException as e:
                if self.error is None:
                    self.error = e
        self._outstanding.clear()

    def _claims_in_flight(self) -> int:
        """My claimed nodes whose macro result has not landed yet."""
        with self.state.lock:
            return sum(1 for n in self._my_claims
                       if n not in self.state.macro_done)

    def _finished(self) -> bool:
        """One-shot mode ends with the batch; session mode (stop_event
        set) parks through exhaustion and ends only on the event."""
        if self.stop_event is not None:
            return self.stop_event.is_set()
        return self.state.all_done()

    # runs-on: gpu-worker
    def run(self) -> None:
        """Claim nodes off the board until nothing is left for us; pick
        up failed peers' overflow work the moment it is claimable.  In
        session mode an idle worker parks instead of exiting: a graft's
        splice (which notifies the board lock) can hand it new work at
        any time (DESIGN.md §10.1)."""
        try:
            while not self._finished():
                if (self.die_after is not None
                        and self.executed >= self.die_after):
                    self.board.abandon(self.wid)     # simulated failure
                    break
                if (self.claim_ahead is not None and self.error is None
                        and self._claims_in_flight() >= self.claim_ahead):
                    # throttle: wait for one of our claimed nodes to
                    # complete before taking the next (already-claimed
                    # work keeps decoding — only NEW claims wait)
                    with self.state.lock:
                        self.state.lock.wait(timeout=0.05)
                    continue
                nid = self.board.try_claim(self.wid)
                if nid is None:
                    if self.stop_event is None and \
                            self.board.exhausted(self.wid):
                        break                        # nothing left for us
                    with self.board.lock:
                        self.board.lock.wait(timeout=0.05)
                    continue
                self._my_claims.append(nid)
                if self.faults is not None:
                    # injected slowdown: stall before submitting so the
                    # perturbation shifts real decode/claim ordering
                    delay = self.faults.engine_delay(self.wid, nid)
                    if delay > 0.0:
                        time.sleep(delay)
                if self.migrator is not None:
                    # claim-time KV pull: warm lineage on a peer worker
                    # (parent ran there, or a prior micro-batch did)
                    # lands here before this node's first wave submits
                    self.migrator.migrate_node_from_peers(nid, self.wid)
                if self.pipelining:
                    self._run_node_pipelined(nid)
                else:
                    self._run_node_barrier(nid)
                self.executed += 1
            self._drain_outstanding()
        except BaseException as e:                    # surfaced by Processor
            self._fail(e)


class ToolDispatcher(threading.Thread):
    """Promotes per-query tool tasks as their deps land; coalesces by
    canonical signature; executes on a bounded pool (backpressure).

    Event-driven: a BatchState listener feeds every landed (query, node)
    result into a queue; each event only wakes the *children* tool tasks
    of that result (incremental scan) instead of re-walking the whole
    O(nodes × queries) grid on a timer.
    """

    _FULL_SCAN_EVERY = 40          # safety-net sweeps (~10 s apart)

    def __init__(self, graph: GraphSpec, state: BatchState,
                 bindings: Sequence[dict], tools: ToolRuntime,
                 records: List[TaskRecord], records_lock: threading.Lock,
                 t0: float, cpu_slots: int = 8, coalescing: bool = True,
                 optimizer=None, persistent: bool = False,
                 faults: Optional[FaultInjector] = None,
                 tool_retries: int = 2):
        super().__init__(daemon=True, name="tool-dispatcher")
        self.graph = graph                              # swap-only
        # session mode: outlive batch completion (a graft may add work);
        # the owner is responsible for stop()
        self.persistent = persistent
        self._force_scan = threading.Event()
        self.state = state
        self.bindings = bindings
        self.tools = tools
        self.records = records              # guarded-by: self.records_lock
        self.records_lock = records_lock    # lock-alias: ProcessorSession._rlock
        self.t0 = t0
        self.optimizer = optimizer
        self.faults = faults
        self.tool_retries = max(int(tool_retries), 0)
        self.pool = ThreadPoolExecutor(max_workers=cpu_slots)
        self.table = CoalesceTable(enabled=coalescing)
        self.dispatched: set = set()            # guarded-by: tool-dispatcher
        self.stop_flag = threading.Event()
        self.error: Optional[BaseException] = None      # swap-only
        self._retry_lock = named_lock("ToolDispatcher._retry_lock")
        self.retries_used = 0                   # guarded-by: self._retry_lock
        self._events: "_q.SimpleQueue" = _q.SimpleQueue()
        self._wake = threading.Event()
        self._depth = {t: len(graph.ancestors(t))       # swap-only
                       for t in graph.tool_nodes()}
        self._tool_children = {                         # swap-only
            nid: [c for c in graph.children(nid)
                  if not graph.nodes[c].is_llm()]
            for nid in graph.nodes}
        state.add_listener(self._on_result)

    # ------------------------------------------------------------------
    # runs-on: any
    def _on_result(self, q: int, node: str) -> None:
        """BatchState listener — runs on the producing thread; enqueue
        and wake only (no dispatch work here)."""
        self._events.put((q, node))
        self._wake.set()

    def stop(self) -> None:
        self.stop_flag.set()
        self._wake.set()

    # runs-on: any
    def rebind(self, graph: GraphSpec) -> None:
        """Adopt a grafted supergraph and force a full dispatch sweep.

        Grafted ROOT tool nodes have no upstream result to trigger the
        incremental event path, so the next loop iteration runs a full
        ``_scan`` over the (grown) shared-identity bindings list.  The
        derived indices are rebuilt before the graph swap publishes."""
        depth = {t: len(graph.ancestors(t)) for t in graph.tool_nodes()}
        children = {nid: [c for c in graph.children(nid)
                          if not graph.nodes[c].is_llm()]
                    for nid in graph.nodes}
        self._depth = depth
        self._tool_children = children
        self.graph = graph
        self._force_scan.set()
        self._wake.set()

    # ------------------------------------------------------------------
    # runs-on: cpu-pool
    def _execute(self, sig: str, op: str, args: str, origin: str,
                 attempt: int = 1) -> None:
        try:
            ts = time.perf_counter() - self.t0
            if self.faults is not None:
                self.faults.tool_call(sig, op)
            result, _ = self.tools.execute(op, args)
            te = time.perf_counter() - self.t0
        except TransientToolError as e:
            # bounded retry: transient (injected or real network-blip
            # style) failures re-enter the pool instead of killing the
            # run; only exhaustion surfaces as a session error
            if attempt <= self.tool_retries and \
                    not self.stop_flag.is_set():
                with self._retry_lock:
                    self.retries_used += 1
                try:
                    self.pool.submit(self._execute, sig, op, args, origin,
                                     attempt + 1)
                    return
                except RuntimeError:
                    # pool shut down between the stop_flag check and the
                    # resubmit: fall through so the failure surfaces as
                    # the session error and waiters wake instead of
                    # timing out on a result that will never land
                    pass
            self.error = e
            with self.state.lock:
                self.state.lock.notify_all()
            return
        except BaseException as e:          # non-transient: fail the run
            self.error = e
            with self.state.lock:
                self.state.lock.notify_all()
            return
        try:
            with self.state.lock:
                requesters = self.table.complete(sig, result)
            with self.records_lock:
                # ``origin`` keeps the record attributable even when a
                # coalesced signature completes with no live requesters
                self.records.append(TaskRecord(
                    node=origin, kind="tool", worker="cpu", start=ts,
                    end=te, batch=max(len(requesters), 1), info=op))
            if self.optimizer is not None:
                self.optimizer.observe_tool(origin, op, te - ts)
            for q, nid in requesters:
                self.state.set_result(q, nid, str(result))
        except BaseException as e:
            self.error = e
            with self.state.lock:
                self.state.lock.notify_all()

    def _maybe_dispatch(self, q: int, nid: str) -> bool:
        """Dispatch one (query, tool) task if ready. Returns True if it
        was dispatched (or served from the coalesce cache) just now."""
        key = (q, nid)
        if key in self.dispatched or not self.state.serves(q, nid):
            return False
        with self.state.lock:
            if key in self.state.results:
                self.dispatched.add(key)                 # checkpointed
                return False
        if not self.state.query_ready(q, nid):
            return False
        self.dispatched.add(key)
        spec = self.graph.nodes[nid]
        args = render(spec.args, self.bindings[q], self.state.upstream(q))
        with self.state.lock:
            sig, needs_exec, cached = self.table.register(
                spec.op, args, (q, nid))
        if cached is not None:
            self.state.set_result(q, nid, str(cached))
        elif needs_exec:
            self.pool.submit(self._execute, sig, spec.op, args, nid)
        return True

    def _scan(self) -> int:
        """Full sweep: dispatch every ready (query, tool) task.  Used at
        startup (roots + checkpoint-restored deps) and as a low-frequency
        safety net; steady-state promotion is event-driven."""
        n = 0
        tool_nodes = sorted(self.graph.tool_nodes(),
                            key=lambda t: self._depth[t])    # depth priority
        for nid in tool_nodes:
            for q in self.state.queries_for(nid):
                if self._maybe_dispatch(q, nid):
                    n += 1
        return n

    def _drain_events(self) -> int:
        """Incremental promotion: only the tool children of freshly
        landed results are candidates."""
        batch = []
        try:
            while True:
                batch.append(self._events.get_nowait())
        except _q.Empty:
            pass
        cand = {(q, c) for q, node in batch
                for c in self._tool_children.get(node, ())}
        n = 0
        for q, nid in sorted(cand,
                             key=lambda t: (self._depth[t[1]], t[0], t[1])):
            if self._maybe_dispatch(q, nid):
                n += 1
        return n

    # runs-on: tool-dispatcher
    def run(self) -> None:
        try:
            self._scan()
            idle = 0
            while not self.stop_flag.is_set() and \
                    (self.persistent or not self.state.all_done()):
                if self._wake.wait(timeout=0.25):
                    self._wake.clear()
                    idle = 0
                else:
                    idle += 1
                self._drain_events()
                if self._force_scan.is_set():        # a graft landed
                    self._force_scan.clear()
                    idle = 0
                    self._scan()
                if idle >= self._FULL_SCAN_EVERY:
                    idle = 0
                    self._scan()
        except BaseException as e:
            self.error = e
            with self.state.lock:
                self.state.lock.notify_all()
        finally:
            self.pool.shutdown(wait=True)
