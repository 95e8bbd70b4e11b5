"""Multi-template mega-DAG consolidation on the port (the scenarios of
``tests/test_multi_template.py`` that need no simulated backend).

The port's copy of ``core/consolidate.py`` keeps colliding node ids apart,
merges a template submitted twice like a single consolidation, degrades to
disjoint islands without overlap, survives empty template slices, plans
epochs that interleave templates and credits cross-template warm aliases.
Through the port's real engines one mega-DAG run gives the outputs of
running each template's slice on its own, and equals the JAX package's
mega-DAG run on the same bridged weights (``get_smoke("qwen3-1.7b")`` in
float32, CPU).  On the simulated backend an empty template slice costs
nothing, and the port's simulator gives the JAX package's makespan and
records, bitwise, on the same plan.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.core import consolidate as jax_consolidate  # noqa: E402
from repro.core import consolidate_multi as jax_consolidate_multi  # noqa
from repro.core import parse_workflow as jax_parse  # noqa: E402
from repro.engine.engine import InferenceEngine as JaxEngine  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core import (CostModel, EpochDPSolver, HARDWARE,  # noqa: E402
                              PAPER_MODELS, SolverConfig, consolidate,
                              consolidate_multi, parse_workflow)
from repro_torch.core.state import WorkerContext  # noqa: E402
from repro_torch.runtime import (ProcessorConfig, RealProcessor,  # noqa
                                 SimulatedProcessor)
from repro_torch.runtime.coordinator import BatchState  # noqa: E402
from repro_torch.runtime.executors import EngineHost  # noqa: E402
from repro_torch.runtime.migrate import KVMigrator  # noqa: E402
from repro_torch.workloads import build_mixed_workload  # noqa: E402
from repro_torch.workloads.datagen import build_database  # noqa: E402
from repro_torch.workloads.tools import ToolRuntime  # noqa: E402

WF_A = {"name": "A", "nodes": [
    {"id": "a", "type": "llm", "model": "qwen3-14b",
     "prompt": "Alpha $p with {{sql: SELECT x FROM t WHERE k='$p'}}"},
    {"id": "b", "type": "llm", "model": "qwen3-14b", "prompt": "Blend ${a}"},
]}
WF_SHARED = {"name": "S", "nodes": [
    {"id": "a", "type": "llm", "model": "qwen3-32b",
     "prompt": "Sigma $p via {{sql: SELECT x FROM t WHERE k='$p'}}"},
    {"id": "b", "type": "llm", "model": "qwen3-32b", "prompt": "Sum ${a}"},
]}
WF_B = {"name": "B", "nodes": [
    {"id": "a", "type": "llm", "model": "qwen3-32b",
     "prompt": "Beta $q via {{sql: SELECT y FROM u WHERE j='$q'}}"},
    {"id": "b", "type": "llm", "model": "qwen3-32b", "prompt": "Mix ${a}"},
]}
CPU = {"device": "cpu"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cm(g, cons):
    return CostModel(g, HARDWARE["h200"], PAPER_MODELS,
                     batch_sizes={n: len(cons.macro(n).bindings)
                                  for n in g.nodes},
                     warm_aliases=cons.warm_aliases())


def _plan(g, cons, workers):
    return EpochDPSolver(g.llm_dag(), _cm(g, cons),
                         SolverConfig(num_workers=workers)).solve()


def _halo_cm(g, cons):
    """The benchmarks' cost model (``benchmarks.common.make_cm``): tools
    priced at their physical count."""
    batch = {nid: (cons.macro(nid).n_logical if g.nodes[nid].is_llm()
                   else len(cons.physical_signatures(nid)))
             for nid in g.nodes}
    return CostModel(g, HARDWARE["h200"], PAPER_MODELS, batch_sizes=batch,
                     warm_aliases=cons.warm_aliases())


def _halo_plan(g, cons, workers):
    """The benchmarks' plan, on ``_halo_cm``."""
    return EpochDPSolver(g.llm_dag(), _halo_cm(g, cons),
                         SolverConfig(num_workers=workers)).solve()


# ---------------------------------------------------------------- structure
def test_namespacing_keeps_colliding_ids_distinct():
    ga, gs = parse_workflow(WF_A), parse_workflow(WF_SHARED)
    mc = consolidate_multi([(ga, [{"p": "x"}]), (gs, [{"p": "x"}])])
    g = mc.template
    for nid in ("t0/a", "t1/a", "t0/b", "t1/b", "t0/a__sql0", "t1/a__sql0"):
        assert nid in g.nodes
    assert mc.template_of["t0/a"] == 0 and mc.template_of["t1/a"] == 1
    assert "${t1/a}" in g.nodes["t1/b"].prompt
    qm = mc.queries_map()
    assert qm["t0/a"] == [0] and qm["t1/a"] == [1]
    xt = mc.cross_template_summary()
    assert xt["cross_template_deduped"] == 1
    assert mc.physical_signatures("t0/a__sql0") and \
        not mc.physical_signatures("t1/a__sql0")


def test_identical_template_twice_matches_single_consolidate():
    g = parse_workflow(WF_A)
    b1 = [{"p": "x"}, {"p": "y"}]
    b2 = [{"p": "x"}]
    mc = consolidate_multi([(g, b1), (g, b2)])
    single = consolidate(g, b1 + b2)
    assert mc.n_queries == single.n_queries
    for base in g.nodes:
        merged_unique = set(mc.macro(f"t0/{base}").unique_signatures) \
            | set(mc.macro(f"t1/{base}").unique_signatures)
        assert len(merged_unique) == single.macro(base).n_unique, base
        if not g.nodes[base].is_llm():
            phys = len(mc.physical_signatures(f"t0/{base}")) \
                + len(mc.physical_signatures(f"t1/{base}"))
            assert phys == len(single.physical_signatures(base)), base
    assert "t1/a" in mc.warm_aliases()["t0/a"]


def test_zero_overlap_degrades_to_disjoint_sum():
    ga, gb = parse_workflow(WF_A), parse_workflow(WF_B)
    ba = [{"p": "x"}, {"p": "y"}]
    bb = [{"q": "u"}, {"q": "v"}]
    mc = consolidate_multi([(ga, ba), (gb, bb)])
    assert mc.cross_template_summary()["cross_template_deduped"] == 0
    assert mc.cross_template_summary()["merged_signatures"] == 0
    assert mc.warm_aliases() == {}
    serial = {w: _plan(ga, consolidate(ga, ba), w).predicted_cost
              + _plan(gb, consolidate(gb, bb), w).predicted_cost
              for w in (1, 2)}
    multi = {w: _plan(mc.template, mc, w).predicted_cost for w in (1, 2)}
    assert abs(multi[1] - serial[1]) < 0.15
    assert multi[2] < serial[2]


def test_empty_template_slice_no_division_by_zero():
    ga, gb = parse_workflow(WF_A), parse_workflow(WF_B)
    mc = consolidate_multi([(ga, []), (gb, [{"q": "u"}])])
    assert mc.macro("t0/a").n_logical == 0
    assert mc.static_dedup_ratio("t0/a") == 1.0
    summary = mc.coalescing_summary()
    assert summary["t0/a"] == {"logical": 0, "unique": 0, "physical": 0,
                               "dedup_ratio": 1.0}
    mc2 = consolidate_multi([(ga, [{"p": "x"}]), (ga, [{"p": "x"}])])
    row = mc2.coalescing_summary()["t1/a__sql0"]
    assert row["unique"] == 1 and row["physical"] == 0
    assert 0.0 < mc2.static_dedup_ratio("t1/a__sql0") <= 1.0
    state = BatchState(mc.template, mc.n_queries,
                       queries_of=mc.queries_map())
    assert "t0/a" in state.macro_done and "t1/a" not in state.macro_done


# ---------------------------------------------------------------- planning
def test_epoch_plan_interleaves_templates():
    batches, _ = build_mixed_workload(6, seed=0, parts=("wd", "wt"))
    mc = consolidate_multi(batches)
    g = mc.template
    plan = _halo_plan(g, mc, workers=2)
    interleaved = sum(
        1 for e in plan.epochs
        if len({mc.template_of[v] for comp in e.components
                for v in comp}) >= 2)
    assert interleaved >= 1
    assert sorted(n for n, _ in plan.node_order()) == sorted(
        g.llm_dag().node_ids)


def test_warm_alias_gives_cross_template_prefix_credit():
    g = parse_workflow(WF_A)
    mc = consolidate_multi([(g, [{"p": "x"}]), (g, [{"p": "x"}])])
    cm = _cm(mc.template, mc)
    spec = mc.template.nodes["t1/b"]
    warm = WorkerContext(model=spec.model, warm=("t0/a",))
    cold = WorkerContext(model=spec.model, warm=())
    assert cm.t_infer(spec, warm, ["t1/a"]) < cm.t_infer(spec, cold,
                                                         ["t1/a"])


def test_colliding_ids_with_different_specs_never_merge():
    t1 = parse_workflow({"name": "T1", "nodes": [
        {"id": "a", "type": "llm", "model": "qwen3-14b", "prompt": "Go $p"},
        {"id": "t", "type": "tool", "op": "sql",
         "args": "SELECT x FROM movies WHERE k=${a}", "deps": ["a"]}]})
    t2 = parse_workflow({"name": "T2", "nodes": [
        {"id": "a", "type": "llm", "model": "qwen3-14b", "prompt": "Run $p"},
        {"id": "t", "type": "tool", "op": "http",
         "args": "GET http://api/other?ref=${a}", "deps": ["a"]}]})
    mc = consolidate_multi([(t1, [{"p": "x"}]), (t2, [{"p": "x"}])])
    assert mc.physical_signatures("t1/t")
    assert mc.cross_template_summary()["cross_template_deduped"] == 0
    t3 = parse_workflow({"name": "T3", "nodes": [
        {"id": "a", "type": "llm", "model": "qwen3-14b", "prompt": "Go $p"},
        {"id": "t", "type": "tool", "op": "sql",
         "args": "SELECT x FROM movies WHERE k=${a}", "deps": ["a"]}]})
    t4 = parse_workflow({"name": "T4", "nodes": [
        {"id": "a", "type": "llm", "model": "qwen3-14b", "prompt": "No $p"},
        {"id": "t", "type": "tool", "op": "sql",
         "args": "SELECT x FROM movies WHERE k=${a}", "deps": ["a"]}]})
    mc2 = consolidate_multi([(t3, [{"p": "x"}]), (t4, [{"p": "x"}])])
    assert mc2.physical_signatures("t1/t")
    assert mc2.cross_template_summary()["cross_template_deduped"] == 0
    mc3 = consolidate_multi([(t3, [{"p": "x"}]), (t3, [{"p": "x"}])])
    assert not mc3.physical_signatures("t1/t")
    assert mc3.cross_template_summary()["cross_template_deduped"] == 1


def test_warm_alias_requires_identical_upstream_lineage():
    def wf(name, research):
        return parse_workflow({"name": name, "nodes": [
            {"id": "x", "type": "llm", "model": "qwen3-14b",
             "prompt": research},
            {"id": "b", "type": "llm", "model": "qwen3-14b",
             "prompt": "Summarize ${x}"}]})
    mc = consolidate_multi([(wf("U1", "Research cats $p"), [{"p": "x"}]),
                            (wf("U2", "Research dogs $p"), [{"p": "x"}])])
    assert "t0/b" not in mc.warm_aliases()
    same = wf("U1", "Research cats $p")
    mc2 = consolidate_multi([(same, [{"p": "x"}]), (same, [{"p": "y"}])])
    assert "t1/b" in mc2.warm_aliases()["t0/b"]


def test_mixed_workload_builder():
    batches, db = build_mixed_workload(7, seed=0)
    assert db == "finewiki"
    assert [len(b) for _, b in batches] == [3, 2, 2]
    with pytest.raises(ValueError):
        build_mixed_workload(4, parts=("w1", "w3"))
    mc = consolidate_multi(batches)
    assert mc.cross_template_summary()["cross_template_deduped"] >= 1


def test_migrator_probes_warm_alias_lineage():
    g = parse_workflow(WF_A)
    mc = consolidate_multi([(g, [{"p": "x"}]), (g, [{"p": "x"}])])
    cm = _cm(mc.template, mc)

    class _Host:
        def prompts_for(self, nid):
            return {"t0/a": [(1, 2)], "t0/b": [(3, 4)]}.get(nid, [])

    mig = KVMigrator(mc.template, [_Host()], cost_model=cm)
    prompts = mig._lineage_prompts("t1/b", _Host())
    assert (1, 2) in prompts and (3, 4) in prompts


def test_lineage_digest_linear_on_fanin_heavy_template():
    nodes = [{"id": "x0", "type": "llm", "model": "qwen3-14b",
              "prompt": "Seed $p"}]
    for i in range(1, 29):
        prev = f"x{i - 1}"
        nodes.append({"id": f"a{i}", "type": "llm", "model": "qwen3-14b",
                      "prompt": f"L ${{{prev}}}"})
        nodes.append({"id": f"b{i}", "type": "llm", "model": "qwen3-14b",
                      "prompt": f"R ${{{prev}}}"})
        nodes.append({"id": f"x{i}", "type": "llm", "model": "qwen3-14b",
                      "prompt": f"Join ${{a{i}}} ${{b{i}}}"})
    g = parse_workflow({"name": "diamond", "nodes": nodes})
    mc = consolidate_multi([(g, [{"p": "x"}]), (g, [{"p": "y"}])])
    assert "t1/x28" in mc.warm_aliases()["t0/x28"]


# ----------------------------------------------------------- real engines
def _jax_multi_results(n, parts):
    from repro.core import (CostModel as JCM, EpochDPSolver as JS,
                            HARDWARE as JHW, PAPER_MODELS as JPM,
                            SolverConfig as JSC, consolidate_multi as jmulti)
    from repro.runtime import ProcessorConfig as JConfig
    from repro.runtime import RealProcessor as JProcessor
    from repro.workloads import build_mixed_workload as jmixed
    from repro.workloads.datagen import build_database as jdb
    from repro.workloads.tools import ToolRuntime as JTools
    batches, db = jmixed(n, seed=0, parts=parts)
    mc = jmulti(batches)
    g = mc.template
    batch = {nid: (mc.macro(nid).n_logical if g.nodes[nid].is_llm()
                   else len(mc.physical_signatures(nid))) for nid in g.nodes}
    plan = JS(g.llm_dag(), JCM(g, JHW["h200"], JPM, batch_sizes=batch,
                               warm_aliases=mc.warm_aliases()),
              JSC(num_workers=2)).solve()
    models = {m: jax_smoke("qwen3-1.7b").replace(dtype="float32", name=m)
              for m in {g.nodes[x].model for x in g.llm_nodes()}}
    return JProcessor(g, models, JTools(jdb(db), latency_scale=0.0),
                      config=JConfig(num_workers=2, decode_cap=3)
                      ).run(mc, plan).results()


def test_real_multi_vs_per_template_serial_bitwise_and_jax():
    """One mega-DAG run through the port's engines equals each template's
    slice run on its own, and the JAX package's mega-DAG run."""
    eng = JaxEngine(jax_smoke("qwen3-1.7b").replace(dtype="float32"), seed=0)
    eng.load()
    cfg = get_smoke("qwen3-1.7b").replace(dtype="float32")
    sd = params_from_jax(jax.tree.map(np.asarray, eng.params), cfg)
    eng.shutdown()
    parts = ("wd", "wt")

    def run(g, cons, plan, db):
        models = {m: cfg.replace(name=m)
                  for m in {g.nodes[x].model for x in g.llm_nodes()}}
        hosts = [EngineHost(models, seed=0, engine_kwargs=CPU,
                            weights=lambda m: sd) for _ in range(2)]
        try:
            return RealProcessor(
                g, models, ToolRuntime(build_database(db),
                                       latency_scale=0.0),
                config=ProcessorConfig(num_workers=2, decode_cap=3,
                                       hardware="h200", engine_kwargs=CPU)
            ).run(cons, plan, hosts=hosts)
        finally:
            for h in hosts:
                h.shutdown()

    batches, db = build_mixed_workload(4, seed=0, parts=parts)
    mc = consolidate_multi(batches)
    rep = run(mc.template, mc, _halo_plan(mc.template, mc, 2), db)
    assert set(rep.coalesce_stats) >= {"cross_template_merged_tasks",
                                       "cross_template_merged_requests"}
    multi_results = rep.results()
    assert len(multi_results) == sum(
        len(tb) * len(tg.nodes) for tg, tb in batches)
    assert multi_results == _jax_multi_results(4, parts)

    off = 0
    for k, (tg, tb) in enumerate(batches):
        cons = consolidate(tg, tb)
        r = run(tg, cons, _halo_plan(tg, cons, 2), db)
        for key, val in r.results().items():
            q, node = key.split(":", 1)
            mkey = f"{int(q) + off}:t{k}/{node}"
            assert multi_results[mkey] == val, mkey
        off += len(tb)


def test_empty_slice_costs_nothing_in_simulator():
    """An empty template slice's LLM macro-nodes are not simulated as
    batch-1 inferences with phantom model switches; the run is priced
    like template A alone.  Both runs equal the JAX simulator's, bitwise,
    on the same plan."""
    from benchmarks.common import make_cm as jax_make_cm
    from repro import core as J
    from repro.runtime import SimulatedProcessor as JaxSimulated

    def jax_plan(g, cons, workers):
        cm = J.CostModel(g, J.HARDWARE["h200"], J.PAPER_MODELS,
                         batch_sizes={n: len(cons.macro(n).bindings)
                                      for n in g.nodes},
                         warm_aliases=cons.warm_aliases())
        return J.EpochDPSolver(g.llm_dag(), cm,
                               J.SolverConfig(num_workers=workers)).solve()

    binds = [{"p": "x"}, {"p": "y"}]
    reps = {}
    for side, parse, multi, single, sim, cm, plan in (
            ("jax", jax_parse, jax_consolidate_multi, jax_consolidate,
             JaxSimulated, jax_make_cm, jax_plan),
            ("port", parse_workflow, consolidate_multi, consolidate,
             SimulatedProcessor, _halo_cm, _plan)):
        ga, gb = parse(WF_A), parse(WF_B)
        mc = multi([(ga, binds), (gb, [])])
        ca = single(ga, binds)
        reps[side] = [sim(g, cm(g, c), 2).run(c, plan(g, c, 2))
                      for g, c in ((mc.template, mc), (ga, ca))]
    for rep, jrep in zip(reps["port"], reps["jax"]):
        assert rep.makespan == jrep.makespan
        assert [dataclasses.astuple(r) for r in rep.records] == \
            [dataclasses.astuple(r) for r in jrep.records]
    rep, alone = reps["port"]
    for r in rep.records:
        if r.node.startswith("t1/") and r.kind == "llm":
            assert r.batch == 0 and (r.end - r.start) < 0.01, r
    assert rep.makespan < alone.makespan * 1.2 + 0.1
