"""The port's Processor against the JAX package's, on the CPU: the slice
as a whole.

The same workloads go through the JAX ``RealProcessor`` and the port's,
with the same plan (each side's ``EpochDPSolver`` on the ``h200`` profile,
which must agree), on ``get_smoke("qwen3-1.7b")`` in float32 with the same
weights: the JAX init, bridged into every port host.  ``results()`` must
be equal exactly, token for token, and so must ``coalesce_stats``.
Within the port the results must not move with tool coalescing,
pipelining or the engine's dense-view arm (``paged_decode=False``).

The simulated backend's cases of ``tests/test_runtime.py`` run on both
packages' copies of ``SimulatedProcessor`` and ``OpWiseSimulator``, each
on its own side's plan (equal to the other's): the makespan and every
record must be equal, bitwise.  The simulator keys its jitter by Python's
salted ``hash``, so the two are compared within one process, and the
launchers' ``--mode sim`` in two processes under one ``PYTHONHASHSEED``.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.core import CostModel as JaxCostModel  # noqa: E402
from repro.core import EpochDPSolver as JaxSolver  # noqa: E402
from repro.core import HARDWARE as JAX_HARDWARE  # noqa: E402
from repro.core import PAPER_MODELS as JAX_MODELS  # noqa: E402
from repro.core import SolverConfig as JaxSolverConfig  # noqa: E402
from repro.core import consolidate as jax_consolidate  # noqa: E402
from repro.engine.engine import InferenceEngine as JaxEngine  # noqa: E402
from repro.runtime import ProcessorConfig as JaxConfig  # noqa: E402
from repro.runtime import OpWiseSimulator as JaxOpWise  # noqa: E402
from repro.runtime import RealProcessor as JaxProcessor  # noqa: E402
from repro.runtime import SimulatedProcessor as JaxSimulated  # noqa: E402
from repro.workloads import build_workload as jax_workload  # noqa: E402
from repro.workloads.datagen import build_database as jax_db  # noqa: E402
from repro.workloads.tools import ToolRuntime as JaxTools  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core import (CostModel, EpochDPSolver, HARDWARE,  # noqa: E402
                              PAPER_MODELS, SolverConfig, consolidate)
from repro_torch.runtime import (OpWiseSimulator, ProcessorConfig,  # noqa
                                 RealProcessor, SimulatedProcessor)
from repro_torch.runtime.executors import EngineHost  # noqa: E402
from repro_torch.workloads import build_workload  # noqa: E402
from repro_torch.workloads.datagen import build_database  # noqa: E402
from repro_torch.workloads.tools import ToolRuntime  # noqa: E402

WORKERS = 2
DECODE_CAP = 3                       # as tests/test_runtime.py
CASES = {"w5": 4, "w+": 3}           # workload -> queries
PORT_ARMS = {"coalescing_off": ({"coalescing": False}, {}),
             "pipelining_off": ({"pipelining": False}, {}),
             "dense_view": ({}, {"paged_decode": False})}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU shapes gain nothing from torch's thread pool, and its
    spinning threads would slow the tests other workers run meanwhile."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch_sizes(g, cons):
    return {nid: (cons.macro(nid).n_logical if g.nodes[nid].is_llm()
                  else cons.macro(nid).n_unique) for nid in g.nodes}


def _epochs(plan):
    return [(e.components, e.workers) for e in plan.epochs]


@pytest.fixture(scope="module")
def weights():
    """The JAX engine's float32 init, bridged into a port state_dict."""
    eng = JaxEngine(jax_smoke("qwen3-1.7b").replace(dtype="float32"), seed=0)
    eng.load()
    cfg = get_smoke("qwen3-1.7b").replace(dtype="float32")
    sd = params_from_jax(jax.tree.map(np.asarray, eng.params), cfg)
    eng.shutdown()
    return cfg, sd


@pytest.fixture(scope="module")
def jax_runs():
    """Each case through the JAX RealProcessor once: (plan, report)."""
    out = {}
    for wname, n in CASES.items():
        g, bindings, db = jax_workload(wname, n, seed=0)
        cons = jax_consolidate(g, bindings)
        cm = JaxCostModel(g, JAX_HARDWARE["h200"], JAX_MODELS,
                          batch_sizes=_batch_sizes(g, cons))
        plan = JaxSolver(g.llm_dag(), cm,
                         JaxSolverConfig(num_workers=WORKERS)).solve()
        models = {m: jax_smoke("qwen3-1.7b").replace(dtype="float32", name=m)
                  for m in {g.nodes[x].model for x in g.llm_nodes()}}
        rep = JaxProcessor(g, models, JaxTools(jax_db(db), latency_scale=0.0),
                           config=JaxConfig(num_workers=WORKERS,
                                            decode_cap=DECODE_CAP)
                           ).run(cons, plan)
        out[wname] = (plan, rep)
    return out


def _port_run(weights, wname, config_kw=None, engine_kw=None):
    cfg, sd = weights
    g, bindings, db = build_workload(wname, CASES[wname], seed=0)
    cons = consolidate(g, bindings)
    cm = CostModel(g, HARDWARE["h200"], PAPER_MODELS,
                   batch_sizes=_batch_sizes(g, cons))
    plan = EpochDPSolver(g.llm_dag(), cm,
                         SolverConfig(num_workers=WORKERS)).solve()
    models = {m: cfg.replace(name=m)
              for m in {g.nodes[x].model for x in g.llm_nodes()}}
    engine_kwargs = {"device": "cpu", **(engine_kw or {})}
    hosts = [EngineHost(models, seed=0, engine_kwargs=engine_kwargs,
                        weights=lambda m: sd) for _ in range(WORKERS)]
    try:
        rep = RealProcessor(
            g, models, ToolRuntime(build_database(db), latency_scale=0.0),
            config=ProcessorConfig(num_workers=WORKERS,
                                   decode_cap=DECODE_CAP, hardware="h200",
                                   engine_kwargs=engine_kwargs,
                                   **(config_kw or {}))).run(
                cons, plan, hosts=hosts)
    finally:
        for h in hosts:
            h.shutdown()
    return plan, rep


@pytest.fixture(scope="module")
def port_runs(weights):
    return {wname: _port_run(weights, wname) for wname in CASES}


def _tokens(text):
    """Token ids: detokenize's "t<id>" words read back."""
    return [int(w[1:]) for w in text.split()]


@pytest.mark.parametrize("wname", sorted(CASES))
def test_plan_equals_jax(wname, jax_runs, port_runs):
    jplan, _ = jax_runs[wname]
    plan, _ = port_runs[wname]
    assert _epochs(plan) == _epochs(jplan)
    assert plan.predicted_cost == pytest.approx(jplan.predicted_cost,
                                                rel=1e-12)


@pytest.mark.parametrize("wname", sorted(CASES))
def test_results_equal_jax_token_for_token(wname, jax_runs, port_runs):
    _, jrep = jax_runs[wname]
    _, rep = port_runs[wname]
    g = build_workload(wname, CASES[wname], seed=0)[0]
    assert len(rep.results()) == CASES[wname] * len(g.nodes)
    assert rep.results() == jrep.results()
    llm = [k for k in rep.results() if g.nodes[k.split(":", 1)[1]].is_llm()]
    assert llm
    for k in llm:
        toks = _tokens(rep.results()[k])
        assert toks == _tokens(jrep.results()[k]), k
        assert len(toks) == DECODE_CAP, k
    assert rep.coalesce_stats == jrep.coalesce_stats
    assert rep.extra["grafts"] == 0 and rep.extra["decode_tokens"] > 0


@pytest.mark.parametrize("arm", sorted(PORT_ARMS))
@pytest.mark.parametrize("wname", sorted(CASES))
def test_port_results_do_not_move_with_the_arm(wname, arm, weights,
                                               jax_runs, port_runs):
    config_kw, engine_kw = PORT_ARMS[arm]
    _, rep = _port_run(weights, wname, config_kw, engine_kw)
    assert rep.results() == port_runs[wname][1].results() \
        == jax_runs[wname][1].results()
    if arm == "coalescing_off":
        stats = rep.coalesce_stats
        assert stats["tool_physical"] == stats["tool_logical"]
    if arm == "dense_view":
        assert rep.extra["view_rebuilds"] > 0
    else:
        assert rep.extra["view_rebuilds"] == 0


def test_launcher_serves_on_the_cpu_when_asked(capsys):
    """``repro_torch.launch.serve --device cpu`` runs the batch on the smoke
    config and prints the run's summary."""
    import json

    from repro_torch.launch import serve
    assert serve.main(["--workload", "w+", "--queries", "12",
                       "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "capping --queries 12 -> 8" in out
    summary = json.loads(out[out.index("{"):])
    assert summary["queries"] == 8 and summary["makespan_s"] > 0
    assert all(c.dtype == get_smoke("qwen3-1.7b").dtype
               and c.d_model == get_smoke("qwen3-1.7b").d_model
               for c in serve.model_configs("cpu").values())
    assert set(serve.model_configs("cuda")) == set(serve.MODEL_NAMES)
    assert serve.model_configs("cuda")["qwen3-32b"].num_layers == 28


# ------------------------------------------------------- the simulated backend

SIDES = {
    "jax": dict(workload=jax_workload, consolidate=jax_consolidate,
                cost_model=JaxCostModel, hardware=JAX_HARDWARE,
                models=JAX_MODELS, solver=JaxSolver,
                solver_config=JaxSolverConfig, simulated=JaxSimulated,
                opwise=JaxOpWise),
    "port": dict(workload=build_workload, consolidate=consolidate,
                 cost_model=CostModel, hardware=HARDWARE,
                 models=PAPER_MODELS, solver=EpochDPSolver,
                 solver_config=SolverConfig, simulated=SimulatedProcessor,
                 opwise=OpWiseSimulator)}


def _sim_case(side, wname="w1", n=64, workers=3):
    """A side's (graph, consolidated batch, cost-model factory, plan), as
    ``tests/test_runtime.py`` sets them up."""
    p = SIDES[side]
    g, bindings, _ = p["workload"](wname, n, seed=0)
    cons = p["consolidate"](g, bindings)

    def cm(logical=False):
        b = {nid: (cons.macro(nid).n_logical
                   if g.nodes[nid].is_llm() or logical
                   else cons.macro(nid).n_unique) for nid in g.nodes}
        return p["cost_model"](g, p["hardware"]["h200"], p["models"],
                               batch_sizes=b)

    plan = p["solver"](g.llm_dag(), cm(),
                       p["solver_config"](num_workers=workers)).solve()
    return g, cons, cm, plan


def _sim_runs(run, **case):
    """``run(side, graph, cons, cm, plan)`` on both sides, whose plans
    must agree; returns the port's report after holding it to JAX's:
    makespan, records, coalescing and extras equal."""
    reps = {}
    for side in SIDES:
        g, cons, cm, plan = _sim_case(side, **case)
        reps[side] = (plan, run(side, g, cons, cm, plan))
    (jplan, jrep), (plan, rep) = reps["jax"], reps["port"]
    assert _epochs(plan) == _epochs(jplan)
    assert rep.makespan == jrep.makespan
    assert [dataclasses.astuple(r) for r in rep.records] == \
        [dataclasses.astuple(r) for r in jrep.records]
    assert rep.coalesce_stats == jrep.coalesce_stats
    assert rep.extra == jrep.extra
    return rep


def test_simulator_completes_all_nodes():
    def run(side, g, cons, cm, plan):
        return SIDES[side]["simulated"](g, cm(), 3).run(cons, plan)

    rep = _sim_runs(run)
    g = _sim_case("port")[0]
    assert {r.node for r in rep.records if r.kind == "llm"} == \
        set(g.llm_nodes())
    assert {r.node for r in rep.records if r.kind == "tool"} == \
        set(g.tool_nodes())
    assert rep.makespan > 0


def test_coalescing_reduces_tool_work():
    def with_c(side, g, cons, cm, plan):
        return SIDES[side]["simulated"](g, cm(), 3).run(cons, plan)

    def without(side, g, cons, cm, plan):
        return SIDES[side]["simulated"](g, cm(logical=True), 3,
                                        coalescing=False).run(cons, plan)

    a, b = _sim_runs(with_c), _sim_runs(without)
    assert a.coalesce_stats["tool_physical"] < \
        b.coalesce_stats["tool_physical"]
    assert a.makespan < b.makespan


def test_opwise_slower_than_halo():
    def halo(side, g, cons, cm, plan):
        return SIDES[side]["simulated"](g, cm(), 3).run(cons, plan)

    def opwise(side, g, cons, cm, plan):
        return SIDES[side]["opwise"](g, cm(), 3).run(cons)

    assert _sim_runs(opwise, n=256).makespan > \
        _sim_runs(halo, n=256).makespan


def test_simulated_worker_failure_completes():
    def run(side, g, cons, cm, plan):
        sp = SIDES[side]["simulated"](g, cm(), 3)
        sp.sim.add_failure(1.0, 1)
        return sp.run(cons, plan)

    rep = _sim_runs(run)
    assert {r.node for r in rep.records if r.kind == "llm"} == \
        set(_sim_case("port")[0].llm_nodes())
    assert "failed_worker_1" in rep.extra


def test_launcher_sim_mode_prints_the_jax_launchers_summary():
    """``--mode sim`` at 64 queries (no cap), with no card visible and the
    JAX launcher's workers and hardware: the same summary as
    ``python -m repro.launch.serve --mode sim``."""
    root = pathlib.Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONHASHSEED="0", CUDA_VISIBLE_DEVICES="",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=str(root / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    args = ["--mode", "sim", "--workload", "w1", "--queries", "64",
            "--workers", "3", "--hardware", "h200"]
    out = {}
    for pkg in ("repro", "repro_torch"):
        res = subprocess.run([sys.executable, "-m", f"{pkg}.launch.serve",
                              *args], env=env, capture_output=True,
                             text=True, timeout=300, check=True)
        text = res.stdout
        assert "capping" not in text
        out[pkg] = json.loads(text[text.index("{"):])
    assert out["repro_torch"] == out["repro"]
    assert out["repro_torch"]["queries"] == 64
