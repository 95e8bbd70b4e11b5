"""Online cost calibration + mid-batch replanning (paper §5's feedback
loop from the Processor back into the Optimizer; DESIGN.md §7.2).

``OnlineOptimizer`` sits between the real executors and the planning
stack:

* every completed tool task feeds ``OperatorProfiler.update()`` (the
  EXPLAIN/EWMA terms of T_prep);
* every completed LLM macro-node feeds ``HardwareCalibration`` — the
  observed latency is split into its predicted prefill/decode shares and
  the roofline's effective ``mfu``/``bw_eff`` knobs are re-fit, then
  substituted back into the live CostModel;
* after each plan epoch fully completes, the observed epoch cost (same
  mu/lambda blend the solver scored) is compared against the epoch's
  predicted cost; past ``drift_threshold`` the remaining LLM DAG is
  re-solved from the live SystemState (claimed nodes + per-worker
  contexts) and the new tail is spliced into the PlanBoard.

The spliced plan (claimed prefix as singleton epochs + re-solved tail)
is validated against the DAG before splicing — replanning can only ever
reorder *unclaimed* work, so outputs are untouched (asserted in tests).

A copy of the JAX package's module of the same name, with the import prefix
``repro.`` read as ``repro_torch.``; ``tests/test_torch_copies.py`` holds
the two equal.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.core.cost_model import CostModel, HardwareCalibration
from repro_torch.core.plan import Epoch, ExecutionPlan
from repro_torch.core.solver import EpochDPSolver, SolverConfig
from repro_torch.core.state import SystemState
from repro_torch.debugsync import named_lock
from repro_torch.runtime.coordinator import PlanBoard


class OnlineOptimizer:
    """Continuously calibrated cost model + mid-run replanner."""

    def __init__(self, cost_model: CostModel,
                 solver_config: Optional[SolverConfig] = None,
                 drift_threshold: float = 0.35,
                 calibration_alpha: float = 0.5,
                 max_replans: int = 8):
        self.cm = cost_model
        # the live LLM DAG: rebound whole by bind_graph/adopt_graft,
        # read lock-free by the replan path (one coherent snapshot)
        self.dag = cost_model.graph.llm_dag()       # swap-only
        self.solver_config = solver_config or SolverConfig()
        self.drift_threshold = drift_threshold
        self.calib = HardwareCalibration(cost_model.hw,
                                         alpha=calibration_alpha)
        self.max_replans = max_replans
        # serializes calibration/observation state: workers observe from
        # their own threads while the monitor loop evaluates drift
        self.lock = named_lock("OnlineOptimizer.lock")
        # plan bookkeeping
        self.plan: Optional[ExecutionPlan] = None   # guarded-by: self.lock
        self._epoch_nodes: List[List[str]] = []     # guarded-by: self.lock
        self._evaluated: set = set()                # guarded-by: self.lock
        # nid -> (worker, seconds); waves of unfinished nodes
        self._llm_obs: Dict[str, tuple] = {}        # guarded-by: self.lock
        self._llm_partial: Dict[str, tuple] = {}    # guarded-by: self.lock
        # outcomes
        self.replans = 0                            # guarded-by: self.lock
        self.epoch_drifts: List[Dict[str, float]] = []  # guarded-by: self.lock
        # |pred-obs|/obs per LLM node
        self.predicted_errors: List[float] = []     # guarded-by: self.lock
        self.spliced_plan: Optional[ExecutionPlan] = None  # guarded-by: self.lock
        self._queued_tail: Optional[ExecutionPlan] = None  # guarded-by: self.lock
        # per-node SLO priority mass (session grafts set this); drift
        # replans re-solve with the same weights the graft solve used,
        # so a replan never silently drops the interactive lanes
        self.node_priorities: Dict[str, float] = {}  # guarded-by: self.lock

    # ------------------------------------------------------------------
    def bind_graph(self, graph) -> None:
        """Point the cost model at the graph the Processor actually
        executes.  RealProcessor rewrites ``max_new_tokens`` onto a copy
        when ``decode_cap`` is set; calibrating against the caller's
        uncapped graph would price decode work that never runs."""
        if self.cm.graph is graph:
            return
        if set(self.cm.graph.nodes) != set(graph.nodes):
            raise ValueError(
                "optimizer cost model was built for a different workflow "
                f"({self.cm.graph.name!r} vs {graph.name!r})")
        with self.lock:
            self.cm.graph = graph
            self.dag = graph.llm_dag()

    def adopt_graft(self, graph, batch_sizes: Dict[str, int],
                    warm_aliases: Optional[Dict[str, tuple]] = None,
                    node_priorities: Optional[Dict[str, float]] = None
                    ) -> None:
        """Point the live cost model at a grafted SUPERGRAPH mid-run
        (DESIGN.md §10.2).

        Unlike ``bind_graph`` the node set is allowed to GROW: a session
        graft extends the running mega-DAG, and subsequent drift replans
        must price the new nodes too.  Calibration state (roofline knobs,
        tool EWMAs) and per-node observations persist — that continuity
        is the point of grafting into a live session instead of starting
        a fresh run.
        """
        missing = set(self.cm.graph.nodes) - set(graph.nodes)
        if missing:
            raise ValueError(
                f"graft graph dropped existing nodes: {sorted(missing)}")
        with self.lock:
            self.cm.graph = graph
            self.dag = graph.llm_dag()
            self.cm.batch_sizes = dict(batch_sizes)
            if warm_aliases is not None:
                self.cm.warm_aliases = dict(warm_aliases)
            if node_priorities is not None:
                self.node_priorities = dict(node_priorities)

    def attach_plan(self, plan: ExecutionPlan, fresh: bool = True,
                    evaluated_prefix: int = 0) -> None:
        """Start tracking ``plan``'s epochs.

        ``fresh=True`` (a new run) clears the per-run node observations;
        ``fresh=False`` (a mid-run splice) keeps them.  A splice passes
        ``evaluated_prefix`` = its claimed-prefix length: those singleton
        epochs are history with no solver-predicted cost (Epoch defaults
        to 0.0), so evaluating drift on them would divide by ~0 and
        re-trigger replanning forever.  Calibration state (roofline
        knobs, tool EWMAs) always persists — that is the whole point of
        reusing one optimizer across micro-batches.
        """
        with self.lock:
            self.plan = plan
            if fresh:
                self._llm_obs = {}
                self._llm_partial = {}
            self._epoch_nodes = [
                [v for comp in e.components for v in comp]
                for e in plan.epochs]
            self._evaluated = set(range(evaluated_prefix)) | {
                i for i, nodes in enumerate(self._epoch_nodes)
                if nodes and all(n in self._llm_obs for n in nodes)}

    # --------------------------------------------------- observations
    def observe_tool(self, node_id: str, op: str, seconds: float) -> None:
        with self.lock:
            self.cm.profiler.update(node_id, op, seconds)

    @staticmethod
    def _union_seconds(spans: List[tuple]) -> float:
        """Total length of the union of (start, end) intervals —
        concurrent waves of one continuous batch must not double-count
        the shared busy time."""
        total = 0.0
        hi = float("-inf")
        for s, e in sorted(spans):
            if s > hi:
                total += e - s
                hi = e
            elif e > hi:
                total += e - hi
                hi = e
        return total

    def observe_llm(self, node_id: str, batch: int, seconds: float,
                    worker: str = "", node_complete: bool = True,
                    span: Optional[tuple] = None) -> None:
        """Measured LLM latency → roofline knob re-fit.

        Pipelined workers report once per submission wave (``batch`` =
        wave size, ``node_complete`` only on the node's last wave); the
        barrier path reports the whole macro-node at once.  Epoch drift
        is evaluated on a node only once it is complete, over the UNION
        of its waves' ``span`` intervals (waves can overlap inside one
        continuous batch).  Calibration treats each wave's sample
        independently — concurrent waves share the engine, so individual
        samples are noisy and the EWMA does the smoothing.
        """
        spec = self.cm.graph.nodes[node_id]
        with self.lock:
            tp, td = self.cm.infer_breakdown(spec, batch)
            if tp + td > 0 and seconds > 0:
                self.predicted_errors.append(
                    abs((tp + td) - seconds) / seconds)
            self.calib.observe(tp, td, seconds)
            self.cm.hw = self.calib.profile()
            _, spans, plain = self._llm_partial.get(node_id,
                                                    (worker, [], 0.0))
            if span is not None:
                spans = spans + [tuple(span)]
            else:                       # span-less callers: plain summing
                plain += seconds
            if node_complete:
                self._llm_partial.pop(node_id, None)
                self._llm_obs[node_id] = (
                    worker, plain + self._union_seconds(spans))
            else:
                self._llm_partial[node_id] = (worker, spans, plain)

    # ----------------------------------------------------- replanning
    # requires: self.lock
    def _observed_epoch_cost(self, nodes: List[str]) -> float:
        """Observed per-worker busy times scored with the SAME blend the
        solver used for the prediction (CostModel.epoch_blend)."""
        busy: Dict[str, float] = {}
        for n in nodes:
            w, s = self._llm_obs[n]
            busy[w] = busy.get(w, 0.0) + s
        return self.cm.epoch_blend(list(busy.values()))

    def queue_splice(self, tail: ExecutionPlan) -> None:
        """Queue an explicit tail plan to splice on the next
        ``maybe_replan`` call, bypassing the drift trigger.

        This is the FORCED-replan hook (A/B benchmarks, migration
        tests, admission-time re-placement from a prior micro-batch's
        calibration): the tail's placement replaces every worker's
        unclaimed sequence, and any node it moves across workers gets
        its warm KV lineage migrated first when a migrator is active.
        """
        with self.lock:
            self._queued_tail = tail

    def maybe_replan(self, board: PlanBoard, migrator=None) -> bool:
        """Evaluate drift on freshly completed epochs; replan past the
        threshold.  Called from the Processor's monitor loop (and once
        before workers start, which is when a queued splice fires).

        ``migrator`` (a KVMigrator) migrates moved nodes' warm KV
        lineage before the splice publishes the new assignments."""
        with self.lock:
            queued, self._queued_tail = self._queued_tail, None
        if queued is not None:
            return self._apply_tail(board, queued, migrator)
        with self.lock:
            if self.plan is None or self.replans >= self.max_replans:
                return False
            trigger = False
            for i, nodes in enumerate(self._epoch_nodes):
                if i in self._evaluated or not nodes:
                    continue
                if not all(n in self._llm_obs for n in nodes):
                    continue
                self._evaluated.add(i)
                obs = self._observed_epoch_cost(nodes)
                pred = self.plan.epochs[i].predicted_cost
                drift = abs(obs - pred) / max(pred, 1e-9)
                self.epoch_drifts.append(
                    {"epoch": i, "predicted": pred, "observed": obs,
                     "drift": drift})
                if drift > self.drift_threshold:
                    trigger = True
        if not trigger:
            return False
        return self._replan(board, migrator)

    def _replan(self, board: PlanBoard, migrator=None) -> bool:
        """Re-solve the unclaimed DAG from the live state and splice."""
        with board.lock:                          # one consistent snapshot
            done = frozenset(board.claimed_set)
            contexts = board.contexts_locked()
        if len(done) == len(self.dag.node_ids):
            return False                          # nothing left to replan
        with self.lock:                 # a graft may grow these mid-solve
            prios = dict(self.node_priorities)
        solver = EpochDPSolver(self.dag, self.cm, self.solver_config,
                               priorities=prios)
        tail = solver.solve(initial=SystemState(done, contexts))
        return self._apply_tail(board, tail, migrator)

    def _apply_tail(self, board: PlanBoard, tail: ExecutionPlan,
                    migrator=None) -> bool:
        """Validate ``tail`` against the live claimed prefix, migrate
        moved nodes' warm KV, and splice the tail into the board."""
        with board.lock:
            claimed = set(board.claimed_set)
            prefix = board.claimed_prefix_epochs_locked()
        if len(claimed) == len(self.dag.node_ids):
            return False                          # nothing left to move
        # drop nodes claimed since the tail was solved/queued (the board
        # would filter them anyway; validation must see each node once)
        epochs = []
        for e in tail.epochs:
            comps = [[n for n in comp if n not in claimed]
                     for comp in e.components]
            keep = [(c, w) for c, w in zip(comps, e.workers) if c]
            if keep:
                epochs.append(Epoch([c for c, _ in keep],
                                    [w for _, w in keep],
                                    e.predicted_cost))
        tail = ExecutionPlan(epochs, tail.predicted_cost,
                             scheduler_name=tail.scheduler_name)
        with self.lock:                 # attach_plan may swap the plan
            plan = self.plan
        base = (plan.scheduler_name if plan is not None else "") \
            or "halo-dp"
        spliced = ExecutionPlan(
            epochs=prefix + tail.epochs,
            predicted_cost=tail.predicted_cost,
            scheduler_name=base + "+replan")
        spliced.validate(self.dag)                # splice validity
        if migrator is not None:
            # migrate BEFORE publishing the new assignments: the moved
            # node's first wave on its new worker must find warm pages
            migrator.migrate_for_splice(board, tail)
        board.splice(tail)
        with self.lock:
            self.replans += 1
            self.spliced_plan = spliced
        self.attach_plan(spliced, fresh=False, evaluated_prefix=len(prefix))
        return True

    # ------------------------------------------------------- reporting
    def calibration_summary(self) -> Dict[str, float]:
        with self.lock:
            out = self.calib.deltas()
            out["tool_keys"] = self.cm.profiler.calibrated_keys()
            out["tool_observations"] = self.cm.profiler.observations
            if self.predicted_errors:
                out["first_llm_error"] = round(self.predicted_errors[0], 4)
                out["last_llm_error"] = round(self.predicted_errors[-1], 4)
            return out
