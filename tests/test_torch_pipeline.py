"""Per-request CPU-GPU pipelining, online calibration and replanning, on
the port's runtime (the scenarios of ``tests/test_pipeline.py``).

Results are published per request, tools start while the same
macro-batch still decodes, the roofline knobs calibrate from measured
latencies, mid-run replans splice valid plans, and none of it changes
what a run produces: the pipelined, barrier and replanned runs agree with
each other and with the JAX package's pipelined run on the same bridged
weights (``get_smoke("qwen3-1.7b")`` in float32, CPU).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.engine.engine import InferenceEngine as JaxEngine  # noqa: E402
from repro.runtime import ProcessorConfig as JaxConfig  # noqa: E402
from repro.runtime import RealProcessor as JaxProcessor  # noqa: E402
from repro.workloads import build_workload as jax_workload  # noqa: E402
from repro.workloads.datagen import build_database as jax_db  # noqa: E402
from repro.workloads.tools import ToolRuntime as JaxTools  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core import (CostModel, EpochDPSolver, HARDWARE,  # noqa: E402
                              HardwareCalibration, LLMProfile, PAPER_MODELS,
                              SolverConfig, consolidate)
from repro_torch.core.graphspec import GraphSpec, NodeSpec, NodeType  # noqa: E402
from repro_torch.core.state import WorkerContext  # noqa: E402
from repro_torch.runtime import (OnlineOptimizer, ProcessorConfig,  # noqa: E402
                                 RealProcessor)
from repro_torch.runtime.coordinator import PlanBoard  # noqa: E402
from repro_torch.runtime.executors import EngineHost  # noqa: E402
from repro_torch.workloads import build_workload  # noqa: E402
from repro_torch.workloads.datagen import build_database  # noqa: E402
from repro_torch.workloads.tools import ToolRuntime  # noqa: E402

DECODE_CAP = 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    """The JAX engine's float32 init, bridged into a port state_dict."""
    eng = JaxEngine(jax_smoke("qwen3-1.7b").replace(dtype="float32"), seed=0)
    eng.load()
    cfg = get_smoke("qwen3-1.7b").replace(dtype="float32")
    sd = params_from_jax(jax.tree.map(np.asarray, eng.params), cfg)
    eng.shutdown()
    return cfg, sd


def _setup(wname, n, workers=2):
    g, bindings, dbname = build_workload(wname, n, seed=0)
    cons = consolidate(g, bindings)
    b = {}
    for nid in g.nodes:
        m = cons.macro(nid)
        b[nid] = m.n_logical if g.nodes[nid].is_llm() else m.n_unique
    cm = CostModel(g, HARDWARE["h200"], PAPER_MODELS, batch_sizes=b)
    plan = EpochDPSolver(g.llm_dag(), cm,
                         SolverConfig(num_workers=workers)).solve()
    return g, cons, dbname, cm, plan


def _models(g, cfg):
    return {m: cfg.replace(name=m)
            for m in {g.nodes[x].model for x in g.llm_nodes()}}


def _hosts(g, weights, engine_kwargs=None, n=2):
    cfg, sd = weights
    kw = {"device": "cpu", **(engine_kwargs or {})}
    return [EngineHost(_models(g, cfg), seed=0, engine_kwargs=kw,
                       weights=lambda m: sd) for _ in range(n)]


def _run(g, cons, plan, dbname, weights, latency_scale=0.0,
         engine_kwargs=None, hosts=None, pipelining=True, optimizer=None,
         die_after=None):
    """One port run on bridged-weight hosts (fresh unless given)."""
    own = hosts is None
    hosts = hosts or _hosts(g, weights, engine_kwargs)
    cfg = ProcessorConfig(num_workers=2, decode_cap=DECODE_CAP,
                          hardware="h200", pipelining=pipelining,
                          engine_kwargs={"device": "cpu",
                                         **(engine_kwargs or {})})
    proc = RealProcessor(g, _models(g, weights[0]),
                         ToolRuntime(build_database(dbname),
                                     latency_scale=latency_scale),
                         config=cfg)
    try:
        return proc.run(cons, plan, hosts=hosts, optimizer=optimizer,
                        die_after=die_after)
    finally:
        if own:
            for h in hosts:
                h.shutdown()


# ---------------------------------------------------------------------------
# per-request pipelining
# ---------------------------------------------------------------------------

def test_tool_starts_before_macro_batch_finishes(weights):
    """max_batch=2 with 4 queries forces two admission waves for ``gen``:
    wave-1 queries' tools run during wave-2 decode."""
    g, cons, dbname, _, plan = _setup("wt", 4)
    rep = _run(g, cons, plan, dbname, weights, latency_scale=1.0,
               engine_kwargs={"max_batch": 2})
    gen_end = max(r.end for r in rep.records
                  if r.kind == "llm" and r.node == "gen")
    first_tool = min(r.start for r in rep.records if r.kind == "tool")
    assert first_tool < gen_end, (first_tool, gen_end)
    assert rep.extra["cpu_gpu_overlap_s"] > 0


def _jax_pipelined_results():
    g, bindings, dbname = jax_workload("wt", 4, seed=0)
    from repro.core import (CostModel as JCM, EpochDPSolver as JS,
                            HARDWARE as JHW, PAPER_MODELS as JPM,
                            SolverConfig as JSC, consolidate as jcons)
    cons = jcons(g, bindings)
    b = {nid: (cons.macro(nid).n_logical if g.nodes[nid].is_llm()
               else cons.macro(nid).n_unique) for nid in g.nodes}
    plan = JS(g.llm_dag(), JCM(g, JHW["h200"], JPM, batch_sizes=b),
              JSC(num_workers=2)).solve()
    models = {m: jax_smoke("qwen3-1.7b").replace(dtype="float32", name=m)
              for m in {g.nodes[x].model for x in g.llm_nodes()}}
    return JaxProcessor(g, models, JaxTools(jax_db(dbname),
                                            latency_scale=0.0),
                        config=JaxConfig(num_workers=2,
                                         decode_cap=DECODE_CAP)
                        ).run(cons, plan).results()


def test_pipelined_outputs_bitwise_match_barrier_replan_and_jax(weights):
    """Temperature-0 outputs are invariant to pipelining AND to forced
    mid-run replanning, and equal the JAX package's."""
    g, cons, dbname, _, plan = _setup("wt", 4)
    base = _run(g, cons, plan, dbname, weights, pipelining=False)
    piped = _run(g, cons, plan, dbname, weights, pipelining=True)
    assert piped.results() == base.results()

    _, _, _, cm, _ = _setup("wt", 4)
    opt = OnlineOptimizer(cm, drift_threshold=0.0)
    replanned = _run(g, cons, plan, dbname, weights, pipelining=True,
                     optimizer=opt)
    assert replanned.results() == base.results()
    assert replanned.extra["replans"] == replanned.extra["plan_splices"]
    assert piped.results() == _jax_pipelined_results()


# ---------------------------------------------------------------------------
# calibration + replanning
# ---------------------------------------------------------------------------

def test_calibration_convergence():
    g, _, _, cm, _ = _setup("wt", 4)
    spec = g.nodes["gen"]
    tp0, td0 = cm.infer_breakdown(spec, 4)
    true_seconds = 3.0 * (tp0 + td0)
    calib = HardwareCalibration(cm.hw)
    errors = []
    for _ in range(8):
        tp, td = cm.infer_breakdown(spec, 4)
        errors.append(abs((tp + td) - true_seconds) / true_seconds)
        calib.observe(tp, td, true_seconds)
        cm.hw = calib.profile()
    assert errors[-1] < 0.05
    assert errors[-1] < errors[0]
    assert all(b <= a + 1e-12 for a, b in zip(errors, errors[1:]))
    d = calib.deltas()
    assert d["samples"] == 8 and d["mfu_eff"] != d["mfu_base"]


def test_replan_splice_is_valid_plan():
    g, cons, dbname, cm, plan = _setup("w1", 4)
    dag = g.llm_dag()
    assert len(plan.epochs) >= 2
    board = PlanBoard(plan, dag, 2)
    opt = OnlineOptimizer(cm, drift_threshold=0.0)
    opt.solver_config.num_workers = 2
    opt.attach_plan(plan)
    e0 = plan.epochs[0]
    for comp, w in zip(e0.components, e0.workers):
        for nid in comp:
            assert board.try_claim(w) == nid
            opt.observe_llm(nid, cons.n_queries, 123.0, f"gpu{w}")
    assert opt.maybe_replan(board) is True
    assert opt.replans == 1 and board.splices == 1
    opt.spliced_plan.validate(dag)
    planned = set(board.claimed) | {n for seq in board.seqs for n in seq}
    assert planned == set(dag.node_ids)
    assert opt.epoch_drifts and opt.epoch_drifts[0]["drift"] > 0


def test_splice_routes_dead_worker_tail_to_overflow():
    g, cons, dbname, cm, plan = _setup("w1", 2)
    dag = g.llm_dag()
    board = PlanBoard(plan, dag, 2)
    board.abandon(0)
    board.splice(plan)
    assert board.seqs[0] == []
    assert set(board.overflow) | set(board.seqs[1]) == set(dag.node_ids)
    assert board.try_claim(1) is not None


def test_worker_failure_recovery_completes(weights):
    g, cons, dbname, _, plan = _setup("w+", 2)
    rep = _run(g, cons, plan, dbname, weights, die_after={0: 1})
    assert len(rep.results()) == 2 * len(g.nodes)


def test_wave_span_union_does_not_double_count():
    u = OnlineOptimizer._union_seconds
    assert u([(10.0, 15.0), (11.0, 15.5), (20.0, 21.0)]) == 6.5
    assert u([]) == 0.0
    g, _, _, cm, _ = _setup("wt", 2)
    opt = OnlineOptimizer(cm)
    opt.observe_llm("gen", 1, 5.0, "gpu0", node_complete=False,
                    span=(10.0, 15.0))
    opt.observe_llm("gen", 1, 4.5, "gpu0", node_complete=True,
                    span=(11.0, 15.5))
    assert opt._llm_obs["gen"] == ("gpu0", 5.5)


def test_operator_profiler_feedback_via_optimizer():
    g, _, _, cm, _ = _setup("wt", 2)
    opt = OnlineOptimizer(cm)
    opt.observe_tool("verify", "http", 0.25)
    opt.observe_tool("verify", "http", 0.35)
    est = cm.profiler.estimate(g.nodes["verify"])
    assert 0.25 <= est <= 0.35
    assert cm.profiler.observations == 2


# ---------------------------------------------------------------------------
# bugfix pins
# ---------------------------------------------------------------------------

def test_cost_model_weights_not_shared_between_instances():
    _, _, _, cm1, _ = _setup("wt", 2)
    cm1.weights.mu = 0.123
    _, _, _, cm2, _ = _setup("wt", 2)
    assert cm2.weights.mu != 0.123
    assert cm1.weights is not cm2.weights


def test_solver_config_not_shared_between_instances():
    g, cons, _, cm, _ = _setup("wt", 2)
    s1 = EpochDPSolver(g.llm_dag(), cm)
    s1.cfg.beam = 1
    s2 = EpochDPSolver(g.llm_dag(), cm)
    assert s2.cfg.beam != 1
    assert s1.cfg is not s2.cfg


def test_whole_prefix_credit_reachable_for_recurrent_archs():
    nodes = [NodeSpec("a", NodeType.LLM, model="rec", est_prompt_tokens=100),
             NodeSpec("b", NodeType.LLM, model="rec", est_prompt_tokens=100)]
    g = GraphSpec("t", nodes, [("a", "b")])
    rec = LLMProfile.from_params("rec", 1e9, 8, 4, 64,
                                 supports_partial_prefix=False)
    ctx = WorkerContext(model="rec", warm=("a",))
    cm = CostModel(g, HARDWARE["h200"], {"rec": rec},
                   avg_context_tokens=128.0)
    assert cm.effective_prefill_tokens(g.nodes["b"], ctx, ["a"]) == 0.0
    cm2 = CostModel(g, HARDWARE["h200"], {"rec": rec},
                    avg_context_tokens=64.0)
    assert cm2.effective_prefill_tokens(g.nodes["b"], ctx, ["a"]) == 100.0


def test_persistent_host_stats_report_per_run_deltas(weights):
    """Two micro-batches on the same hosts: each report carries only its
    own counts."""
    g, cons, dbname, _, plan = _setup("w+", 3)
    hosts = _hosts(g, weights)
    try:
        r1 = _run(g, cons, plan, dbname, weights, hosts=hosts)
        r2 = _run(g, cons, plan, dbname, weights, hosts=hosts)
        engines = [e for h in hosts for e in h._engines.values()]
        for key in ("admission_waves", "tokens_reused", "pages_shared"):
            total = sum(getattr(e.stats, key) for e in engines)
            assert r1.extra[key] + r2.extra[key] == total, key
        assert r1.extra["admission_waves"] > 0
        # the warm second run serves the same outputs from shared pages
        assert r2.results() == r1.results()
        assert r2.extra["prefill_tokens_saved"] > 0
    finally:
        for h in hosts:
            h.shutdown()


def test_tool_records_attributed_to_real_nodes(weights):
    g, cons, dbname, _, plan = _setup("wt", 3)
    rep = _run(g, cons, plan, dbname, weights)
    tool_nodes = set(g.tool_nodes())
    recs = [r for r in rep.records if r.kind == "tool"]
    assert recs
    assert all(r.node in tool_nodes for r in recs)
