"""Deterministic fault injection on the port's runtime (the scenarios of
``tests/test_faults.py``): seeded chaos runs complete with the clean run's
outputs by riding the recovery machinery (dispatcher retries for tool
faults, PlanBoard overflow for a lost worker, ordinary scheduling for
engine delays), and the clean run equals the JAX package's session on the
same bridged weights (``get_smoke("qwen3-1.7b")`` in float32, CPU).

``REPRO_FAULT_SEED`` picks the seed, 1 when unset.
"""
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.engine.engine import InferenceEngine as JaxEngine  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.runtime import (FaultInjector, FaultPlan,  # noqa: E402
                                 ProcessorConfig, ProcessorSession,
                                 TransientToolError)
from repro_torch.runtime.executors import EngineHost  # noqa: E402
from repro_torch.workloads import build_workload  # noqa: E402
from repro_torch.workloads.datagen import build_database  # noqa: E402
from repro_torch.workloads.tools import ToolRuntime  # noqa: E402

SEED = int(os.environ.get("REPRO_FAULT_SEED", "1"))
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


def _models(g, cfg):
    return {m: cfg.replace(name=m)
            for m in {g.nodes[x].model for x in g.llm_nodes()}}


def _run(g, db, bindings, weights, **cfg_kw):
    """(report, dead-worker set) for one full session run on
    bridged-weight hosts."""
    cfg, sd = weights
    models = _models(g, cfg)
    hosts = [EngineHost(models, seed=0, engine_kwargs=CPU,
                        weights=lambda m: sd) for _ in range(2)]
    sess = ProcessorSession(models, ToolRuntime(build_database(db)),
                            config=ProcessorConfig(
                                num_workers=2, decode_cap=3, seed=0,
                                hardware="h200", engine_kwargs=CPU,
                                **cfg_kw))
    sess.open(hosts=hosts)
    try:
        sess.submit(g, bindings)
        sess.drain(400)
        rep = sess.report()
        with sess.board.lock:
            dead = set(sess.board.dead)
    finally:
        sess.close()
        for h in hosts:
            h.shutdown()
    return rep, dead


@pytest.fixture(scope="module")
def clean(weights):
    g, bindings, db = build_workload("wt", 6, seed=0)
    return _run(g, db, bindings, weights)[0]


# ---------------------------------------------------------------------------
# plan / injector plumbing
# ---------------------------------------------------------------------------

def test_fault_plan_from_env():
    env = {"REPRO_FAULT_SEED": "7", "REPRO_FAULT_TOOL_RATE": "0.25",
           "REPRO_FAULT_KILL": "0:1, 2:3",
           "REPRO_FAULT_DELAY_S": "0.05", "REPRO_FAULT_DELAY_RATE": "0.5"}
    p = FaultPlan.from_env(env)
    assert p.seed == 7 and p.tool_fail_rate == 0.25
    assert p.kill_worker == {0: 1, 2: 3}
    assert p.engine_delay_s == 0.05 and p.engine_delay_rate == 0.5
    assert FaultPlan.from_env({}) is None
    with pytest.raises(ValueError, match="REPRO_FAULT_KILL"):
        FaultPlan.from_env({"REPRO_FAULT_SEED": "1",
                            "REPRO_FAULT_KILL": "zero:one"})


def test_injector_rolls_deterministic():
    plan = FaultPlan(seed=SEED, tool_fail_rate=0.5)
    a, b = FaultInjector(plan), FaultInjector(plan)
    sites = [f"sql|q{i}" for i in range(64)]
    rolls_a = [a._roll("tool", s) for s in sites]
    rolls_b = [b._roll("tool", s) for s in reversed(sites)]
    assert rolls_a == list(reversed(rolls_b))
    other = FaultInjector(FaultPlan(seed=SEED + 1, tool_fail_rate=0.5))
    assert rolls_a != [other._roll("tool", s) for s in sites]


def test_injector_bounds_failures_per_signature():
    inj = FaultInjector(FaultPlan(seed=SEED, tool_fail_rate=1.0,
                                  max_tool_failures=2))
    fails = 0
    for _ in range(5):
        try:
            inj.tool_call("sig-x", "sql")
        except TransientToolError:
            fails += 1
    assert fails == 2
    assert inj.summary()["tool_faults_injected"] == 2


# ---------------------------------------------------------------------------
# chaos runs
# ---------------------------------------------------------------------------

def _jax_clean_results():
    from repro.runtime import ProcessorConfig as JConfig
    from repro.runtime import ProcessorSession as JSession
    from repro.workloads import build_workload as jwl
    from repro.workloads.datagen import build_database as jdb
    from repro.workloads.tools import ToolRuntime as JTools
    g, bindings, db = jwl("wt", 6, seed=0)
    models = {m: jax_smoke("qwen3-1.7b").replace(dtype="float32", name=m)
              for m in {g.nodes[x].model for x in g.llm_nodes()}}
    sess = JSession(models, JTools(jdb(db)),
                    config=JConfig(num_workers=2, decode_cap=3, seed=0))
    sess.open()
    try:
        sess.submit(g, bindings)
        sess.drain(400)
        return sess.report().extra["results"]
    finally:
        sess.close()


def test_clean_run_equals_jax(clean):
    assert clean.extra["results"] == _jax_clean_results()


def test_tool_faults_recover_via_retry(weights, clean):
    g, bindings, db = build_workload("wt", 6, seed=0)
    plan = FaultPlan(seed=SEED, tool_fail_rate=0.9, max_tool_failures=2)
    rep, _ = _run(g, db, bindings, weights, faults=plan, tool_retries=3)
    assert rep.extra["faults"]["tool_faults_injected"] > 0
    assert rep.extra["tool_retries"] > 0
    assert rep.extra["results"] == clean.extra["results"]


def test_worker_loss_mid_epoch_recovers(weights, clean):
    g, bindings, db = build_workload("wt", 6, seed=0)
    plan = FaultPlan(seed=SEED, kill_worker={0: 1})
    rep, dead = _run(g, db, bindings, weights, faults=plan)
    assert dead == {0}
    assert rep.extra["results"] == clean.extra["results"]
    assert len(rep.extra["results"]) == 6 * len(g.nodes)


def test_engine_delays_perturb_not_corrupt(weights, clean):
    g, bindings, db = build_workload("wt", 6, seed=0)
    plan = FaultPlan(seed=SEED, engine_delay_s=0.05, engine_delay_rate=1.0)
    rep, _ = _run(g, db, bindings, weights, faults=plan)
    assert rep.extra["faults"]["engine_delays_injected"] > 0
    assert rep.extra["results"] == clean.extra["results"]


def test_retry_exhaustion_surfaces_cleanly():
    before = set(threading.enumerate())
    g, bindings, db = build_workload("wt", 4, seed=0)
    plan = FaultPlan(seed=SEED, tool_fail_rate=1.0, max_tool_failures=10)
    cfg = ProcessorConfig(num_workers=2, decode_cap=3, seed=0,
                          faults=plan, tool_retries=1, engine_kwargs=CPU)
    sess = ProcessorSession(
        _models(g, get_smoke("qwen3-1.7b").replace(dtype="float32")),
        ToolRuntime(build_database(db)), config=cfg)
    sess.open()
    try:
        sess.submit(g, bindings)
        with pytest.raises(TransientToolError):
            sess.drain(120)
    finally:
        sess.close()
    sess.close()
    leaked = [t for t in set(threading.enumerate()) - before if t.is_alive()]
    assert not leaked, f"failed session leaked threads: {leaked}"
