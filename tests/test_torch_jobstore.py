"""The durable job store on the port's runtime (the scenarios of
``tests/test_jobstore.py``): the signature journal, kill-tolerant loading,
session resume with zero re-execution, and ``load_batch_state``'s
diagnostics.  The resumed run's outputs equal the first run's, and both
equal the JAX package's run on the same bridged weights
(``get_smoke("qwen3-1.7b")`` in float32, CPU).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.engine.engine import InferenceEngine as JaxEngine  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core import (CostModel, EpochDPSolver, HARDWARE,  # noqa: E402
                              PAPER_MODELS, SolverConfig)
from repro_torch.core.consolidate import consolidate  # noqa: E402
from repro_torch.core.graphspec import GraphSpec  # noqa: E402
from repro_torch.runtime import ProcessorConfig, RealProcessor  # noqa: E402
from repro_torch.runtime.coordinator import BatchState  # noqa: E402
from repro_torch.runtime.executors import EngineHost  # noqa: E402
from repro_torch.runtime.jobstore import (CheckpointError, JobStore,  # noqa: E402
                                          load_batch_state, save_batch_state,
                                          signature_map)
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


# ---------------------------------------------------------------------------
# signature map
# ---------------------------------------------------------------------------

def test_signature_map_stable_across_reconsolidation():
    g, bindings, _ = build_workload("wt", 6, seed=0)
    m1 = signature_map(consolidate(g, bindings))
    m2 = signature_map(consolidate(g, bindings))
    assert m1 == m2
    assert set(q for q, _ in m1) == set(range(6))
    assert len(m1) == 6 * len(g.nodes)


def test_signature_map_dedup_shares_keys():
    g, bindings, _ = build_workload("wt", 4, seed=0)
    dup = list(bindings) + [bindings[0]]
    m = signature_map(consolidate(g, dup))
    for nid in g.nodes:
        assert m[(4, nid)] == m[(0, nid)]
    assert any(m[(1, nid)] != m[(0, nid)] for nid in g.nodes)


def test_signature_map_sampled_llm_keys_are_per_query():
    g, bindings, _ = build_workload("wt", 3, seed=0)
    hot = [n.with_(temperature=0.8) if n.is_llm() else n
           for n in g.nodes.values()]
    g_hot = GraphSpec(g.name, hot, g.edges)
    dup = [bindings[0], bindings[0]]
    m = signature_map(consolidate(g_hot, dup))
    for nid in g_hot.llm_nodes():
        assert m[(0, nid)] != m[(1, nid)]
    for nid in g_hot.tool_nodes():
        assert m[(0, nid)] == m[(1, nid)]


# ---------------------------------------------------------------------------
# the journal
# ---------------------------------------------------------------------------

def test_journal_roundtrip_and_fanout_dedup(tmp_path):
    p = str(tmp_path / "j.jsonl")
    js = JobStore(p)
    js.record("k1", "n", "v1")
    js.record("k1", "n", "v1")
    js.record("k2", "n", "v2")
    js.close()
    js2 = JobStore(p)
    assert js2.lookup("k1") == "v1" and js2.lookup("k2") == "v2"
    assert js2.summary()["restored_signatures"] == 2
    js2.record("k1", "n", "v1")
    assert js2.summary()["re_executed_signatures"] == 1
    js2.close()


def test_journal_torn_tail_dropped(tmp_path):
    p = str(tmp_path / "j.jsonl")
    js = JobStore(p, fsync_every=1)
    js.record("k1", "n", "v1")
    js.record("k2", "n", "v2")
    js.close()
    with open(p, "a") as f:
        f.write('{"k": "k3", "n": "n", "v": "v3", "c": "tr')
    js2 = JobStore(p)
    assert js2.lookup("k1") == "v1" and js2.lookup("k3") is None
    assert js2.summary()["dropped_lines"] == 1
    js2.close()


def test_journal_append_after_torn_tail_stays_loadable(tmp_path):
    p = str(tmp_path / "j.jsonl")
    js = JobStore(p, fsync_every=1)
    js.record("k1", "n", "v1")
    js.close()
    with open(p, "a") as f:
        f.write('{"k": "k2", "n": "n", "v": "v2", "c": "tr')
    js2 = JobStore(p)
    assert js2.summary()["dropped_lines"] == 1
    js2.record("k2", "n", "v2-redone")
    js2.record("k3", "n", "v3")
    js2.close()
    js3 = JobStore(p)
    assert js3.lookup("k1") == "v1"
    assert js3.lookup("k2") == "v2-redone"
    assert js3.lookup("k3") == "v3"
    assert js3.summary()["dropped_lines"] == 0
    js3.close()


def test_journal_missing_final_newline_repaired(tmp_path):
    p = str(tmp_path / "j.jsonl")
    js = JobStore(p, fsync_every=1)
    js.record("k1", "n", "v1")
    js.close()
    with open(p, "rb+") as f:
        f.seek(-1, 2)
        f.truncate()
    js2 = JobStore(p)
    assert js2.lookup("k1") == "v1"
    js2.record("k2", "n", "v2")
    js2.close()
    js3 = JobStore(p)
    assert js3.lookup("k1") == "v1" and js3.lookup("k2") == "v2"
    assert js3.summary()["dropped_lines"] == 0
    js3.close()


def test_journal_record_after_close_is_noop(tmp_path):
    p = str(tmp_path / "j.jsonl")
    js = JobStore(p)
    js.record("k1", "n", "v1")
    js.close()
    js.record("k2", "n", "v2")
    js.close()
    js2 = JobStore(p)
    assert js2.lookup("k1") == "v1" and js2.lookup("k2") is None
    js2.close()


def test_journal_mid_file_corruption_raises(tmp_path):
    p = str(tmp_path / "j.jsonl")
    js = JobStore(p)
    js.record("k1", "n", "v1")
    js.close()
    lines = open(p).readlines()
    lines.insert(1, "garbage not json\n")
    with open(p, "w") as f:
        f.writelines(lines)
    with pytest.raises(CheckpointError, match="not the torn tail"):
        JobStore(p)


def test_journal_checksum_guards_value(tmp_path):
    p = str(tmp_path / "j.jsonl")
    js = JobStore(p, fsync_every=1)
    js.record("k1", "n", "v1")
    js.close()
    lines = open(p).readlines()
    entry = json.loads(lines[-1])
    entry["v"] = "tampered"
    lines[-1] = json.dumps(entry) + "\n"
    with open(p, "w") as f:
        f.writelines(lines)
    js2 = JobStore(p)
    assert js2.lookup("k1") is None
    assert js2.summary()["dropped_lines"] == 1
    js2.close()


# ---------------------------------------------------------------------------
# session resume
# ---------------------------------------------------------------------------

def _jax_results():
    from repro.core import (CostModel as JCM, EpochDPSolver as JS,
                            HARDWARE as JHW, PAPER_MODELS as JPM,
                            SolverConfig as JSC, consolidate as jcons)
    from repro.runtime import ProcessorConfig as JConfig
    from repro.runtime import RealProcessor as JProcessor
    from repro.workloads import build_workload as jwl
    from repro.workloads.datagen import build_database as jdb
    from repro.workloads.tools import ToolRuntime as JTools
    g, bindings, db = jwl("wt", 6, seed=0)
    cons = jcons(g, bindings)
    b = {nid: (cons.macro(nid).n_logical if g.nodes[nid].is_llm()
               else cons.macro(nid).n_unique) for nid in g.nodes}
    plan = JS(g.llm_dag(), JCM(g, JHW["h200"], JPM, batch_sizes=b),
              JSC(num_workers=2)).solve()
    models = {m: jax_smoke("qwen3-1.7b").replace(dtype="float32", name=m)
              for m in {g.nodes[x].model for x in g.llm_nodes()}}
    return JProcessor(g, models, JTools(jdb(db), latency_scale=0.0),
                      config=JConfig(num_workers=2, decode_cap=3)
                      ).run(cons, plan).extra["results"]


def test_session_resume_zero_reexecution_and_jax(tmp_path):
    """A batch run to completion with a jobstore, then again against the
    same journal: everything restores, nothing re-executes or decodes, and
    the outputs equal the first run's and the JAX package's."""
    eng = JaxEngine(jax_smoke("qwen3-1.7b").replace(dtype="float32"), seed=0)
    eng.load()
    cfg = get_smoke("qwen3-1.7b").replace(dtype="float32")
    sd = params_from_jax(jax.tree.map(np.asarray, eng.params), cfg)
    eng.shutdown()
    js = str(tmp_path / "journal.jsonl")

    def run():
        g, bindings, db = build_workload("wt", 6, seed=0)
        cons = consolidate(g, bindings)
        b = {nid: (cons.macro(nid).n_logical if g.nodes[nid].is_llm()
                   else cons.macro(nid).n_unique) for nid in g.nodes}
        plan = EpochDPSolver(g.llm_dag(),
                             CostModel(g, HARDWARE["h200"], PAPER_MODELS,
                                       batch_sizes=b),
                             SolverConfig(num_workers=2)).solve()
        models = {m: cfg.replace(name=m)
                  for m in {g.nodes[x].model for x in g.llm_nodes()}}
        hosts = [EngineHost(models, seed=0, engine_kwargs=CPU,
                            weights=lambda m: sd) for _ in range(2)]
        try:
            return RealProcessor(
                g, models, ToolRuntime(build_database(db), latency_scale=0.0),
                config=ProcessorConfig(num_workers=2, decode_cap=3, seed=0,
                                       hardware="h200", engine_kwargs=CPU,
                                       jobstore_path=js)
            ).run(cons, plan, hosts=hosts)
        finally:
            for h in hosts:
                h.shutdown()

    r1 = run()
    s1 = r1.extra["jobstore"]
    assert s1["completed_signatures"] > 0
    assert s1["re_executed_signatures"] == 0
    r2 = run()
    s2 = r2.extra["jobstore"]
    assert s2["re_executed_signatures"] == 0
    assert s2["restored_results"] == 6 * 4
    assert r2.extra["decode_tokens"] == 0
    assert r1.extra["results"] == r2.extra["results"] == _jax_results()


# ---------------------------------------------------------------------------
# load_batch_state hardening
# ---------------------------------------------------------------------------

def _state(n=4):
    g, _, _ = build_workload("w+", n, seed=0)
    return g, BatchState(g, n)


def test_load_batch_state_rejects_unknown_node(tmp_path):
    g, st = _state()
    st.set_result(0, "draft", "r0")
    p = str(tmp_path / "ck.json")
    save_batch_state(st, p)
    payload = json.load(open(p))
    payload["results"].append([1, "no_such_node", "x"])
    json.dump(payload, open(p, "w"))
    fresh = BatchState(g, 4)
    with pytest.raises(CheckpointError) as ei:
        load_batch_state(fresh, p)
    msg = str(ei.value)
    assert "no_such_node" in msg and p in msg and "draft" in msg
    assert "stale checkpoint" in msg
    with fresh.lock:
        assert not fresh.results


def test_load_batch_state_rejects_non_json(tmp_path):
    g, st = _state()
    p = str(tmp_path / "ck.json")
    with open(p, "w") as f:
        f.write("{truncated")
    with pytest.raises(CheckpointError, match="not valid JSON"):
        load_batch_state(st, p)


def test_load_batch_state_rejects_wrong_shape(tmp_path):
    g, st = _state()
    p = str(tmp_path / "ck.json")
    json.dump({"wrong": 1}, open(p, "w"))
    with pytest.raises(CheckpointError, match="found keys"):
        load_batch_state(st, p)


def test_load_batch_state_rejects_malformed_entry(tmp_path):
    g, st = _state()
    p = str(tmp_path / "ck.json")
    json.dump({"n_queries": 4, "results": [["not-a-triple"]]},
              open(p, "w"))
    with pytest.raises(CheckpointError, match="entry 0"):
        load_batch_state(st, p)


def test_checkpoint_shim_reexports():
    from repro_torch.runtime import checkpoint
    assert checkpoint.save_batch_state is save_batch_state
    assert checkpoint.load_batch_state is load_batch_state
    assert checkpoint.CheckpointError is CheckpointError
