"""Cross-worker KV-cache migration on the port (the scenarios of
``tests/test_migration.py``), plus the admission, coalescing and
reporting pins that rode along.

Cache level: export/import move the same KV and conserve pages.  Engine
level: a migrated prefix is a real warm donor whose outputs equal a
never-migrated engine's.  Planner level: ``t_migrate`` prices remote warm
lineage.  Runtime level: a forced replan across warm hosts migrates pages,
saves prefill, and leaves outputs unchanged, equal to the JAX package's
run on the same bridged weights (``get_smoke("qwen3-1.7b")`` in float32,
CPU).
"""
from dataclasses import replace

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
                              LLMProfile, PAPER_MODELS, SolverConfig,
                              consolidate)
from repro_torch.core.graphspec import GraphSpec, NodeSpec, NodeType  # noqa: E402
from repro_torch.core.plan import Epoch, ExecutionPlan  # noqa: E402
from repro_torch.core.state import WorkerContext  # noqa: E402
from repro_torch.engine.engine import InferenceEngine  # noqa: E402
from repro_torch.engine.kvcache import PagedKVCache  # noqa: E402
from repro_torch.runtime import (OnlineOptimizer, ProcessorConfig,  # noqa: E402
                                 RealProcessor)
from repro_torch.runtime.coordinator import PlanBoard  # noqa: E402
from repro_torch.runtime.executors import EngineHost  # noqa: E402
from repro_torch.runtime.migrate import KVMigrator  # noqa: E402
from repro_torch.workloads import build_workload  # noqa: E402
from repro_torch.workloads.datagen import build_database  # noqa: E402
from repro_torch.workloads.tools import ToolRuntime  # noqa: E402

CPU = {"device": "cpu"}


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


def _cfg():
    return get_smoke("qwen3-1.7b").replace(dtype="float32")


# ---------------------------------------------------------------------------
# cache level
# ---------------------------------------------------------------------------

def test_kvcache_export_import_round_trip_and_conservation():
    src = PagedKVCache(num_layers=2, num_pages=16, page_size=4,
                       kv_heads=2, head_dim=8, device="cpu")
    rng = np.random.default_rng(0)
    k = rng.standard_normal((2, 10, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 10, 2, 8)).astype(np.float32)
    seq = src.add_sequence(k, v)

    ke, ve = src.export_sequence(seq, 7)
    assert ke.shape == (2, 7, 2, 8)
    np.testing.assert_array_equal(ke, k[:, :7])
    # the exported block is a copy: writing the source pages leaves it
    src.k[:, src.sequences[seq].page_ids[0]] += 1.0
    np.testing.assert_array_equal(ke, k[:, :7])

    dst = PagedKVCache(num_layers=2, num_pages=16, page_size=4,
                       kv_heads=2, head_dim=8, device="cpu")
    free_before = len(dst.free_pages)
    seq2 = dst.import_sequence(ke, ve)
    assert dst.sequences[seq2].length == 7
    assert len(dst.free_pages) == free_before - 2        # ceil(7/4) pages
    kg, vg = dst.gather(seq2)
    np.testing.assert_array_equal(kg.numpy(), k[:, :7])
    np.testing.assert_array_equal(vg.numpy(), v[:, :7])

    dst.free_sequence(seq2)
    src.free_sequence(seq)
    assert len(dst.free_pages) == dst.num_pages
    assert (dst.refcount == 0).all() and (src.refcount == 0).all()
    assert src.pages_in_use == 0 and len(src.free_pages) == src.num_pages


def test_kvcache_import_rejects_mismatched_layout():
    dst = PagedKVCache(num_layers=2, num_pages=8, page_size=4,
                       kv_heads=2, head_dim=8, device="cpu")
    bad = np.zeros((1, 4, 2, 8), np.float32)
    with pytest.raises(ValueError):
        dst.import_sequence(bad, bad)


# ---------------------------------------------------------------------------
# engine level
# ---------------------------------------------------------------------------

def _engine(**kw):
    eng = InferenceEngine(_cfg(), seed=0, device="cpu", **kw)
    eng.load()
    return eng


def test_engine_migration_round_trip_bitwise_identity():
    prompt = list(range(10, 24))
    src = _engine(page_size=8)
    try:
        out_src = src.generate([prompt], max_new_tokens=6)[0]
        depth = src.probe_prefix(prompt)
        assert depth == len(prompt)
        tokens, k, v = src.export_prefix(prompt)
        assert list(tokens) == prompt[:depth]
        assert src.stats.pages_migrated_out == 0
    finally:
        src.shutdown()

    dst = _engine(page_size=8)
    try:
        pages = dst.import_prefix(tokens, k, v, migrate_seconds=0.5)
        assert pages == 2
        assert dst.stats.pages_migrated_in == 2
        assert dst.stats.migrate_seconds == 0.5
        assert dst.import_prefix(tokens, k, v) == 0      # already resident
        out_dst = dst.generate([prompt], max_new_tokens=6)[0]
        assert out_dst == out_src
        assert dst.stats.prefix_hits == 1
        assert dst.stats.prefill_tokens_saved == len(prompt) - 1
        dst.release_warm()
        assert dst.kv.pages_in_use == 0 and not dst.kv.sequences
    finally:
        dst.shutdown()

    ref = _engine(page_size=8)
    try:
        assert ref.generate([prompt], max_new_tokens=6)[0] == out_src
    finally:
        ref.shutdown()


def test_engine_import_skips_when_pool_has_no_headroom():
    eng = _engine(page_size=8, num_pages=4)
    try:
        eng.generate([list(range(10, 18))], max_new_tokens=2)
        warm_before = dict(eng._warm)
        assert warm_before
        layers, heads, dh = eng.model.paged_kv_layout()
        k = np.zeros((layers, 40, heads, dh), np.float32)   # 5 pages > pool
        assert eng.import_prefix(list(range(100, 140)), k, k) == 0
        assert eng.stats.pages_migrated_in == 0
        assert dict(eng._warm) == warm_before
    finally:
        eng.shutdown()


# ---------------------------------------------------------------------------
# planner level
# ---------------------------------------------------------------------------

def _two_node_graph():
    nodes = [NodeSpec("a", NodeType.LLM, model="qwen3-14b",
                      est_prompt_tokens=256),
             NodeSpec("b", NodeType.LLM, model="qwen3-14b",
                      est_prompt_tokens=256)]
    return GraphSpec("mig", nodes, [("a", "b")])


def test_cost_model_migration_credit_and_decision():
    g = _two_node_graph()
    cm = CostModel(g, HARDWARE["h100"], PAPER_MODELS,
                   avg_context_tokens=128.0)
    v = g.nodes["b"]
    cold = WorkerContext(model="qwen3-14b")
    warm_peer = WorkerContext(model="qwen3-14b", warm=("a",))
    eff0, mig0 = cm.prefill_plan(v, cold, ["a"])
    assert eff0 == 256.0 and mig0 == 0.0
    eff1, mig1 = cm.prefill_plan(v, cold, ["a"], peer_ctxs=(warm_peer,))
    assert eff1 == 256.0 - 128.0
    assert mig1 == cm.t_migrate(v, 128.0) > 0.0
    eff2, mig2 = cm.prefill_plan(v, warm_peer, ["a"],
                                 peer_ctxs=(warm_peer,))
    assert eff2 == eff1 and mig2 == 0.0
    t_cold = cm.t_node("b", cold, frozenset({"a"}))[0]
    t_peer = cm.t_node("b", cold, frozenset({"a"}),
                       peer_ctxs=(warm_peer,))[0]
    t_local = cm.t_node("b", warm_peer, frozenset({"a"}))[0]
    assert t_local < t_peer < t_cold
    assert cm.migration_wins(v, 128.0)


def test_cost_model_migration_loses_on_slow_link():
    g = _two_node_graph()
    hw = replace(HARDWARE["h100"], link_bw=1e3)
    cm = CostModel(g, hw, PAPER_MODELS, avg_context_tokens=128.0)
    v = g.nodes["b"]
    warm_peer = WorkerContext(model="qwen3-14b", warm=("a",))
    eff, mig = cm.prefill_plan(v, WorkerContext(model="qwen3-14b"),
                               ["a"], peer_ctxs=(warm_peer,))
    assert eff == 256.0 and mig == 0.0
    assert not cm.migration_wins(v, 128.0)


def test_cost_model_no_migration_credit_for_recurrent_state():
    nodes = [NodeSpec("a", NodeType.LLM, model="rec", est_prompt_tokens=100),
             NodeSpec("b", NodeType.LLM, model="rec", est_prompt_tokens=100)]
    g = GraphSpec("rec", nodes, [("a", "b")])
    rec = LLMProfile.from_params("rec", 1e9, 8, 4, 64,
                                 supports_partial_prefix=False)
    cm = CostModel(g, HARDWARE["h100"], {"rec": rec},
                   avg_context_tokens=128.0)
    warm_peer = WorkerContext(model="rec", warm=("a",))
    eff, mig = cm.prefill_plan(g.nodes["b"], WorkerContext(model="rec"),
                               ["a"], peer_ctxs=(warm_peer,))
    assert eff == 100.0 and mig == 0.0


# ---------------------------------------------------------------------------
# runtime level
# ---------------------------------------------------------------------------

def _batch_sizes(g, cons):
    return {nid: (cons.macro(nid).n_logical if g.nodes[nid].is_llm()
                  else cons.macro(nid).n_unique) for nid in g.nodes}


def _make_cm(g, cons):
    return CostModel(g, HARDWARE["h200"], PAPER_MODELS,
                     batch_sizes=_batch_sizes(g, cons))


def _swapped_tail(plan, g, workers):
    """Every LLM node moved to the next worker, singleton epochs."""
    amap = plan.assignment_map()
    llm = set(g.llm_dag().node_ids)
    topo = [v for v in g.topo_order() if v in llm]
    return ExecutionPlan(
        [Epoch([[n]], [(amap[n] + 1) % workers]) for n in topo],
        scheduler_name="forced-swap")


def _migration_ab(weights, n=2, workers=2, decode_cap=3):
    """Warm persistent hosts, then re-run under a forced splice that moves
    every node across workers, with and without KV migration."""
    cfg, sd = weights
    g, bindings, db = build_workload("w+", n, seed=0)
    cons = consolidate(g, bindings)
    plan = EpochDPSolver(g.llm_dag(), _make_cm(g, cons),
                         SolverConfig(num_workers=workers)).solve()
    models = {m: cfg.replace(name=m)
              for m in {g.nodes[x].model for x in g.llm_nodes()}}
    reps = {}
    for migration in (True, False):
        proc = RealProcessor(
            g, models, ToolRuntime(build_database(db), latency_scale=0.0),
            config=ProcessorConfig(num_workers=workers,
                                   decode_cap=decode_cap, seed=0,
                                   hardware="h200", kv_migration=migration,
                                   engine_kwargs=CPU))
        hosts = [EngineHost(models, seed=0, engine_kwargs=CPU,
                            weights=lambda m: sd) for _ in range(workers)]
        try:
            warm = proc.run(cons, plan, hosts=hosts)
            opt = OnlineOptimizer(_make_cm(g, cons), drift_threshold=1e9)
            opt.queue_splice(_swapped_tail(plan, g, workers))
            reps[migration] = proc.run(cons, plan, hosts=hosts,
                                       optimizer=opt)
        finally:
            for h in hosts:
                h.shutdown()
    return reps[True], reps[False], warm


def _jax_results(n=2, decode_cap=3):
    from repro.core import (CostModel as JCM, EpochDPSolver as JS,
                            HARDWARE as JHW, PAPER_MODELS as JPM,
                            SolverConfig as JSC, consolidate as jcons)
    g, bindings, db = jax_workload("w+", n, seed=0)
    cons = jcons(g, bindings)
    plan = JS(g.llm_dag(), JCM(g, JHW["h200"], JPM,
                               batch_sizes=_batch_sizes(g, cons)),
              JSC(num_workers=2)).solve()
    models = {m: jax_smoke("qwen3-1.7b").replace(dtype="float32", name=m)
              for m in {g.nodes[x].model for x in g.llm_nodes()}}
    return JaxProcessor(g, models, JaxTools(jax_db(db), latency_scale=0.0),
                        config=JaxConfig(num_workers=2,
                                         decode_cap=decode_cap)
                        ).run(cons, plan).results()


def test_forced_replan_migrates_and_saves_prefill_bitwise_identical(weights):
    rep_on, rep_off, warm = _migration_ab(weights)
    assert rep_on.extra["plan_splices"] == 1
    assert rep_on.extra["replans"] == 1
    assert rep_on.extra["pages_migrated_in"] > 0
    assert (rep_on.extra["pages_migrated_out"]
            == rep_on.extra["pages_migrated_in"])
    assert rep_on.migration_summary()["pages_migrated"] > 0
    assert rep_on.migration_summary()["nodes_moved"] > 0
    assert rep_on.migration_summary()["migrate_seconds"] > 0
    assert (rep_on.extra["prefill_tokens_saved"]
            > rep_off.extra["prefill_tokens_saved"])
    assert rep_off.extra.get("pages_migrated_in", 0) == 0
    assert rep_on.results() == rep_off.results() == warm.results() \
        == _jax_results()


def test_migrator_assignment_diff_only_reports_real_moves():
    g, bindings, _ = build_workload("w+", 2, seed=0)
    dag = g.llm_dag()
    plan = ExecutionPlan([Epoch([["draft", "refine", "final"]], [0])])
    board = PlanBoard(plan, dag, 2)
    assert board.try_claim(0) == "draft"
    tail = ExecutionPlan([Epoch([["draft"]], [1]),
                          Epoch([["refine"]], [1]),
                          Epoch([["final"]], [0])])
    mig = KVMigrator(g, hosts=[None, None])
    assert mig.assignment_diff(board, tail) == [("refine", 0, 1)]


# ---------------------------------------------------------------------------
# bugfix pins
# ---------------------------------------------------------------------------

def test_same_wave_duplicates_coalesce_at_admission():
    p = list(range(30, 40))
    eng = _engine()
    try:
        o1, o2 = eng.generate([p, p], max_new_tokens=1)
        assert o1 == o2
        assert eng.stats.coalesced_requests == 1
        assert eng.stats.prefill_tokens == len(p)
        assert eng.stats.prefix_hits == 0
    finally:
        eng.shutdown()


def test_impossible_page_demand_fails_fast_with_diagnostic():
    eng = _engine(page_size=8, num_pages=16, max_seq_len=4096)
    try:
        ok = eng.submit(list(range(10, 18)), max_new_tokens=24)
        huge = eng.submit(list(range(600)), max_new_tokens=8)
        with pytest.raises(MemoryError, match="never|cannot"):
            huge.result(timeout=60)
        assert ok.result(timeout=120)
    finally:
        eng.shutdown()


def test_peak_batch_reported_per_run(weights):
    cfg, sd = weights
    g, bindings, db = build_workload("w+", 3, seed=0)
    cons = consolidate(g, bindings)
    plan = EpochDPSolver(g.llm_dag(), _make_cm(g, cons),
                         SolverConfig(num_workers=2)).solve()
    models = {m: cfg.replace(name=m)
              for m in {g.nodes[x].model for x in g.llm_nodes()}}
    proc = RealProcessor(g, models,
                         ToolRuntime(build_database(db), latency_scale=0.0),
                         config=ProcessorConfig(num_workers=2, decode_cap=2,
                                                engine_kwargs=CPU))
    hosts = [EngineHost(models, seed=0, engine_kwargs=CPU,
                        weights=lambda m: sd) for _ in range(2)]
    try:
        r1 = proc.run(cons, plan, hosts=hosts)
        r2 = proc.run(consolidate(g, bindings[:1]), plan, hosts=hosts)
        assert r1.extra["peak_batch"] >= 2
        assert r2.extra["peak_batch"] == 1
    finally:
        for h in hosts:
            h.shutdown()
