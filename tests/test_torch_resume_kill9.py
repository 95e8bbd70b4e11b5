"""kill -9 mid-batch, then resume, on the port's runtime (the scenario of
``tests/test_resume_kill9.py``).

A child process (this file's ``__main__`` branch) runs one real ``wt``
batch on the port's engines with a durable jobstore and prints a JSON
summary.  The test runs it three ways: uninterrupted, SIGKILLed
mid-batch, and resumed against the killed run's journal.  The resumed run
re-executes no journaled signature and its outputs equal the
uninterrupted run's, which equal the JAX package's run on the same
bridged weights (``get_smoke("qwen3-1.7b")`` in float32, CPU).
"""
import json
import os
import signal
import subprocess
import sys
import time

import pytest

pytest.importorskip("torch")

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_QUERIES = 6
DECODE_CAP = 3


def _child(journal: str, weights_path: str) -> None:
    """One port batch with a jobstore at ``journal``, on the state_dict
    saved at ``weights_path``; prints the results and the journal's
    summary as JSON."""
    import torch
    from repro_torch.configs import get_smoke
    from repro_torch.core import (CostModel, EpochDPSolver, HARDWARE,
                                  PAPER_MODELS, SolverConfig, consolidate)
    from repro_torch.runtime import ProcessorConfig, RealProcessor
    from repro_torch.runtime.executors import EngineHost
    from repro_torch.workloads import build_workload
    from repro_torch.workloads.datagen import build_database
    from repro_torch.workloads.tools import ToolRuntime
    torch.set_num_threads(1)
    sd = torch.load(weights_path)
    cfg = get_smoke("qwen3-1.7b").replace(dtype="float32")
    g, bindings, db = build_workload("wt", N_QUERIES, seed=0)
    cons = consolidate(g, bindings)
    b = {nid: (cons.macro(nid).n_logical if g.nodes[nid].is_llm()
               else cons.macro(nid).n_unique) for nid in g.nodes}
    plan = EpochDPSolver(g.llm_dag(),
                         CostModel(g, HARDWARE["h200"], PAPER_MODELS,
                                   batch_sizes=b),
                         SolverConfig(num_workers=2)).solve()
    models = {m: cfg.replace(name=m)
              for m in {g.nodes[x].model for x in g.llm_nodes()}}
    cpu = {"device": "cpu"}
    hosts = [EngineHost(models, seed=0, engine_kwargs=cpu,
                        weights=lambda m: sd) for _ in range(2)]
    try:
        rep = RealProcessor(
            g, models,
            ToolRuntime(build_database(db),
                        latency_scale=3.0),     # slow http: killable window
            config=ProcessorConfig(num_workers=2, decode_cap=DECODE_CAP,
                                   seed=0, hardware="h200",
                                   engine_kwargs=cpu, jobstore_path=journal,
                                   jobstore_fsync_every=1)
        ).run(cons, plan, hosts=hosts)
    finally:
        for h in hosts:
            h.shutdown()
    print(json.dumps({"results": rep.extra["results"],
                      "jobstore": rep.extra["jobstore"]}))


def _child_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(_REPO, "src")]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    return env


def _argv(journal, weights_path):
    return [sys.executable, os.path.abspath(__file__), journal, weights_path]


def _run_child(journal, weights_path, timeout=240):
    out = subprocess.run(_argv(journal, weights_path), env=_child_env(),
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _data_lines(path):
    try:
        with open(path) as f:
            return sum(1 for line in f if '"k"' in line)
    except FileNotFoundError:
        return 0


def _bridged_weights_and_jax_results(path):
    """Save the JAX engine's float32 init, bridged, at ``path``; return
    the JAX package's results for the child's batch."""
    import numpy as np
    import torch
    import jax
    from repro.configs import get_smoke as jax_smoke
    from repro.core import (CostModel, EpochDPSolver, HARDWARE,
                            PAPER_MODELS, SolverConfig, consolidate)
    from repro.engine.engine import InferenceEngine
    from repro.runtime import ProcessorConfig, RealProcessor
    from repro.workloads import build_workload
    from repro.workloads.datagen import build_database
    from repro.workloads.tools import ToolRuntime
    from repro_torch.bridge import params_from_jax
    from repro_torch.configs import get_smoke
    jcfg = jax_smoke("qwen3-1.7b").replace(dtype="float32")
    eng = InferenceEngine(jcfg, seed=0)
    eng.load()
    torch.save(params_from_jax(jax.tree.map(np.asarray, eng.params),
                               get_smoke("qwen3-1.7b").replace(
                                   dtype="float32")), path)
    eng.shutdown()
    g, bindings, db = build_workload("wt", N_QUERIES, seed=0)
    cons = consolidate(g, bindings)
    b = {nid: (cons.macro(nid).n_logical if g.nodes[nid].is_llm()
               else cons.macro(nid).n_unique) for nid in g.nodes}
    plan = EpochDPSolver(g.llm_dag(),
                         CostModel(g, HARDWARE["h200"], PAPER_MODELS,
                                   batch_sizes=b),
                         SolverConfig(num_workers=2)).solve()
    models = {m: jcfg.replace(name=m)
              for m in {g.nodes[x].model for x in g.llm_nodes()}}
    return RealProcessor(g, models, ToolRuntime(build_database(db),
                                                latency_scale=0.0),
                         config=ProcessorConfig(num_workers=2,
                                                decode_cap=DECODE_CAP)
                         ).run(cons, plan).extra["results"]


def test_kill9_resume_bitwise_and_zero_reexecution(tmp_path):
    weights_path = str(tmp_path / "weights.pt")
    jax_results = _bridged_weights_and_jax_results(weights_path)

    # arm 1: uninterrupted baseline, equal to the JAX package's run
    baseline = _run_child(str(tmp_path / "baseline.jsonl"), weights_path)
    assert baseline["jobstore"]["re_executed_signatures"] == 0
    assert baseline["results"] == jax_results

    # arm 2: SIGKILL once >= 2 results hit the journal
    journal = str(tmp_path / "killed.jsonl")
    child = subprocess.Popen(_argv(journal, weights_path),
                             env=_child_env(), stdout=subprocess.PIPE,
                             stderr=subprocess.DEVNULL)
    try:
        deadline = time.monotonic() + 180
        while _data_lines(journal) < 2:
            if child.poll() is not None:
                pytest.fail("child finished before it could be killed; "
                            "no mid-batch window to test")
            if time.monotonic() > deadline:
                pytest.fail("journal never reached 2 results")
            time.sleep(0.02)
        child.send_signal(signal.SIGKILL)
        child.wait(timeout=60)
    finally:
        if child.poll() is None:
            child.kill()
        child.stdout.close()
    assert child.returncode == -signal.SIGKILL
    journaled = _data_lines(journal)
    assert journaled >= 2

    # arm 3: resume against the killed run's journal
    resumed = _run_child(journal, weights_path)
    js = resumed["jobstore"]
    assert js["re_executed_signatures"] == 0
    assert js["restored_signatures"] >= journaled - 1   # minus torn tail
    assert js["restored_results"] > 0
    assert resumed["results"] == baseline["results"]


if __name__ == "__main__":
    _child(sys.argv[1], sys.argv[2])
