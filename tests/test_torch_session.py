"""Session serving on the port's runtime (the scenarios of
``tests/test_session.py``): streaming graft into the running mega-DAG
behind ``ProcessorSession``.

A mid-run graft changes when queries run, never what they produce (and
the one-shot batch equals the JAX package's session on the same bridged
weights, ``get_smoke("qwen3-1.7b")`` in float32, CPU); grafted queries
hit the shared signature table; ``slo="interactive"`` beats FIFO on TTFT;
``drain()``/``close()`` leak no thread; the ``ProcessorConfig`` shim; and
the port's one new field, the cost model's ``hardware`` profile.
"""
import statistics
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.engine.engine import InferenceEngine as JaxEngine  # noqa: E402
from repro.runtime import ProcessorConfig as JaxConfig  # noqa: E402
from repro.runtime import ProcessorSession as JaxSession  # noqa: E402
from repro.workloads import build_workload as jax_workload  # noqa: E402
from repro.workloads.datagen import build_database as jax_db  # noqa: E402
from repro.workloads.tools import ToolRuntime as JaxTools  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core import HARDWARE  # noqa: E402
from repro_torch.core.graphspec import GraphSpec, NodeSpec, NodeType  # noqa: E402
from repro_torch.runtime import (ProcessorConfig, ProcessorSession,  # noqa: E402
                                 RealProcessor)
from repro_torch.runtime.executors import EngineHost  # noqa: E402
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


def _models(g, cfg=None):
    cfg = cfg or get_smoke("qwen3-1.7b").replace(dtype="float32")
    return {m: cfg.replace(name=m)
            for m in {g.nodes[x].model for x in g.llm_nodes()}}


def _session(g, db, **cfg_kw):
    cfg = ProcessorConfig(num_workers=cfg_kw.pop("num_workers", 2),
                          decode_cap=cfg_kw.pop("decode_cap", 3),
                          seed=0, engine_kwargs=CPU, **cfg_kw)
    return ProcessorSession(_models(g), ToolRuntime(build_database(db)),
                            config=cfg)


def _bridged_hosts(g, weights, n=2):
    cfg, sd = weights
    return [EngineHost(_models(g, cfg), seed=0, engine_kwargs=CPU,
                       weights=lambda m: sd) for _ in range(n)]


def _normalized(results):
    """{(query, base-node-id): text}, the ``t{k}/`` namespace stripped."""
    out = {}
    for key, val in results.items():
        q, node = key.split(":", 1)
        out[(int(q), node.split("/", 1)[1] if "/" in node else node)] = val
    return out


def _jax_one_shot(g_name, n):
    g, bindings, db = jax_workload(g_name, n, seed=0)
    models = {m: jax_smoke("qwen3-1.7b").replace(dtype="float32", name=m)
              for m in {g.nodes[x].model for x in g.llm_nodes()}}
    sess = JaxSession(models, JaxTools(jax_db(db)),
                      config=JaxConfig(num_workers=2, decode_cap=3, seed=0))
    sess.open()
    try:
        sess.submit(g, bindings)
        sess.drain(400)
        return sess.report().results()
    finally:
        sess.close()


# ---------------------------------------------------------------------------
def test_graft_bitwise_vs_one_shot_and_jax(weights):
    """4 queries then 2 grafted mid-run give EXACTLY the outputs of all 6
    up front, which equal the JAX package's one-shot session."""
    g, bindings, db = build_workload("wt", 6, seed=0)
    arms = {}
    for arm in ("one_shot", "graft"):
        hosts = _bridged_hosts(g, weights)
        sess = _session(g, db, hardware="h200")
        sess.open(hosts=hosts)
        try:
            if arm == "one_shot":
                handles = sess.submit(g, bindings)
            else:
                handles = sess.submit(g, bindings[:4])
                handles += sess.submit(g, bindings[4:], slo="interactive")
            sess.drain(400)
            arms[arm] = (sess.report(), handles)
        finally:
            sess.close()
            for h in hosts:
                h.shutdown()
    rep_one, _ = arms["one_shot"]
    rep_graft, handles = arms["graft"]
    assert rep_one.extra["grafts"] == 0 and rep_graft.extra["grafts"] == 1
    assert all(h.done() and h.exception() is None for h in handles)
    a, b = _normalized(rep_one.results()), _normalized(rep_graft.results())
    assert a == b and len(a) == 24
    for handle in handles[4:]:
        for node, val in handle.result(timeout=5).items():
            assert b[(handle.query, node.split("/", 1)[1])] == val
    assert a == _normalized(_jax_one_shot("wt", 6))


def test_graft_hits_shared_signature_table():
    g, bindings, db = build_workload("wt", 6, seed=0)
    sess = _session(g, db)
    sess.open()
    try:
        sess.submit(g, bindings[:4])
        sess.submit(g, bindings[:2], slo="interactive")   # 4,5 == 0,1
        sess.drain(400)
        rep = sess.report()
        summary = sess._cons.cross_template_summary()
    finally:
        sess.close()
    assert summary["cross_template_deduped"] > 0
    assert rep.coalesce_stats["cross_template_merged_tasks"] > 0
    res = rep.results()
    for dup, orig in ((4, 0), (5, 1)):
        for node in ("count", "gen", "verify", "final"):
            assert res[f"{dup}:t1/{node}"] == res[f"{orig}:t0/{node}"]


def test_interactive_ttft_beats_fifo():
    """With the batch lane saturating one small engine, interactive grafts
    admitted priority-first see lower TTFT than the FIFO control."""
    _, _, db = build_workload("wt", 2, seed=0)
    g = GraphSpec("probe", [NodeSpec(
        id="gen", type=NodeType.LLM, model="qwen3-14b",
        prompt="Summarize topic $topic in detail",
        max_new_tokens=256)], [])
    bindings = [{"topic": f"subject-{i}"} for i in range(14)]
    models = _models(g)
    tools = ToolRuntime(build_database(db))
    hosts = [EngineHost(models, seed=0,
                        engine_kwargs={**CPU, "max_batch": 2})]

    def arm(priority_admission):
        cfg = ProcessorConfig(num_workers=1, decode_cap=3, seed=0,
                              priority_admission=priority_admission,
                              engine_kwargs=CPU)
        sess = ProcessorSession(models, tools, config=cfg)
        sess.open(hosts=hosts)
        try:
            sess.submit(g, bindings[:12], slo="batch")
            time.sleep(0.05)
            handles = sess.submit(g, bindings[12:], slo="interactive")
            sess.drain(200)
            rep = sess.report()
            return [h.ttft() for h in handles], rep
        finally:
            sess.close()

    try:
        arm(True)
        arm(False)
        means = None
        for _ in range(3):
            ttft_prio, rep_prio = arm(True)
            ttft_fifo, rep_fifo = arm(False)
            assert rep_prio.extra["priority_jumps"] > 0
            assert rep_fifo.extra["priority_jumps"] == 0
            assert all(t is not None for t in ttft_prio + ttft_fifo)
            means = (statistics.mean(ttft_prio),
                     statistics.mean(ttft_fifo))
            if means[0] < means[1]:
                break
        else:
            pytest.fail(f"priority TTFT never beat FIFO in 3 runs: "
                        f"prio={means[0]:.3f}s fifo={means[1]:.3f}s")
    finally:
        for h in hosts:
            h.shutdown()


def test_session_close_leaks_no_threads():
    before = set(threading.enumerate())
    g, bindings, db = build_workload("wt", 4, seed=0)
    sess = _session(g, db)
    sess.open()
    try:
        handles = sess.submit(g, bindings[:2])
        sess.submit(g, bindings[2:])
        sess.drain(400)
        assert all(h.done() for h in handles)
    finally:
        sess.close()
    sess.close()
    leaked = [t for t in set(threading.enumerate()) - before if t.is_alive()]
    assert not leaked, f"session leaked threads: {leaked}"


def test_close_clean_after_worker_death_mid_drain():
    before = set(threading.enumerate())
    g, bindings, db = build_workload("wt", 4, seed=0)
    sess = _session(g, db)
    sess.open()

    def _explode(model):
        raise RuntimeError("injected engine failure")
    for host in sess.hosts:
        host.engine_for = _explode
    try:
        sess.submit(g, bindings)
        with pytest.raises(RuntimeError, match="injected engine failure"):
            sess.drain(120)
    finally:
        sess.close()
    sess.close()
    leaked = [t for t in set(threading.enumerate()) - before if t.is_alive()]
    assert not leaked, f"failed session leaked threads: {leaked}"


def test_close_clean_when_submit_rejects():
    before = set(threading.enumerate())
    g, bindings, db = build_workload("wt", 2, seed=0)
    sess = _session(g, db)
    sess.open()
    with pytest.raises(ValueError, match="unknown SLO class"):
        sess.submit(g, bindings, slo="no-such-lane")
    sess.close()
    sess.close()
    leaked = [t for t in set(threading.enumerate()) - before if t.is_alive()]
    assert not leaked, f"never-started session leaked threads: {leaked}"
    with pytest.raises(RuntimeError, match="closed"):
        sess.submit(g, bindings)


def test_processor_config_shim():
    g, _, db = build_workload("wt", 2, seed=0)
    models = _models(g)
    tools = ToolRuntime(build_database(db))
    with pytest.warns(DeprecationWarning):
        proc = RealProcessor(g, models, tools, num_workers=3, decode_cap=5)
    assert proc.config.num_workers == 3 and proc.W == 3
    assert proc.config.decode_cap == 5
    with pytest.raises(TypeError, match="unknown RealProcessor arguments"):
        RealProcessor(g, models, tools, worker_count=3)
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        proc = RealProcessor(g, models, tools,
                             config=ProcessorConfig(num_workers=2))
    assert proc.config.num_workers == 2


@pytest.mark.parametrize("hardware", ["h100", "h200"])
def test_the_plan_is_solved_for_the_configured_hardware(hardware):
    """The port plans on the H100 profile unless told otherwise; the JAX
    package's ProcessorConfig has no such field (it plans on h200)."""
    assert ProcessorConfig().hardware == "h100"
    assert not hasattr(JaxConfig(), "hardware")
    g, bindings, db = build_workload("w+", 2, seed=0)
    kw = {} if hardware == "h100" else {"hardware": hardware}
    sess = _session(g, db, **kw)
    sess.open()
    try:
        sess.submit(g, bindings)
        sess.drain(400)
        assert sess._cm.hw is HARDWARE[hardware]
    finally:
        sess.close()
