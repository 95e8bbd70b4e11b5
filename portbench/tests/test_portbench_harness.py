"""Whole runs on the CPU at a tiny size, from a benchmark root defined
only in a fixture: the harness finds its configuration, traffic, cell
and metric files by name.  The look for a card is skipped; the rest of a
run is driven, and with the timed path broken underneath ``correct``
comes out false."""
import json
import os
import pathlib
import shutil
import subprocess
import sys
import time

import pytest
import torch

from portbench.harness import cell
from portbench.harness.spec import Bench
from portbench.tests.fixtures import GAP, make_root

pytest.importorskip("repro_torch")
PB = pathlib.Path(__file__).resolve().parents[1]
ROOT = PB.parent


@pytest.fixture
def bench(tmp_path):
    return Bench(make_root(tmp_path))


def test_a_cell_from_fixture_files_only(bench, tmp_path):
    c = bench.cell("moe.closed")
    assert c.config["model"]["moe"]["num_experts"] == 8
    assert "shared" not in c.traffic["segments"][0] and c.serve["max_batch"] == 4
    assert [m["name"] for m in bench.metrics("dense.open", False)] == \
        ["call_p90_ms", "setup_s"]
    assert [m["name"] for m in bench.metrics("dense.closed", True)] == \
        ["prefix_hit_share.batch"]
    assert bench.metrics("dense.open", True) == []
    # a metric added as a file under the root's portbench/metrics
    (tmp_path / "portbench" / "metrics").mkdir()
    (tmp_path / "portbench" / "metrics" / "calls_x2.py").write_text(
        "def read(run):\n    return 2.0\n")
    assert bench.reader("calls_x2.batch")(None) == 2.0


def test_a_loop_from_a_file_only(bench, tmp_path):
    """A traffic file that names a loop defined only under the root's
    portbench/loops drives the window through it, with no edit of the
    harness."""
    loops = tmp_path / "portbench" / "loops"
    loops.mkdir()
    (loops / "twice.py").write_text(
        "from portbench.loops import closed\n"
        "def run(engine, traffic, seconds, **kw):\n"
        "    traffic.spec['outstanding'] = 2 * traffic.spec['outstanding']\n"
        "    return closed.run(engine, traffic, seconds, **kw)\n")
    spec = json.loads((tmp_path / "portbench" / "traffic" /
                       "tiny_unique.json").read_text())
    (tmp_path / "portbench" / "traffic" / "tiny_unique.json").write_text(
        json.dumps(dict(spec, loop="twice")))
    r = cell.run(bench, "moe.closed", 91, 3.0, False, time.perf_counter(),
                 device="cpu")
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0


@pytest.mark.parametrize("name", ["dense.closed", "moe.closed",
                                  "dense.open", "moe.nodes"])
def test_a_sound_run_is_correct(bench, name):
    r = cell.run(bench, name, 2**31 + 77, 6.0, False, time.perf_counter(),
                 device="cpu")
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    e2e = "call_p90_ms" if name.endswith("open") else "calls_per_s"
    assert set(r["metrics"]) == {e2e, "setup_s"}
    assert list(r)[-1] == "checks"


def _broken(monkeypatch, fault):
    orig = cell.set_up

    def set_up(*a, **kw):
        s = orig(*a, **kw)
        model = s.engine.model
        step = model.paged_decode_step
        calls = {"n": 0}

        def decode(tokens, k_pages, v_pages, *rest, **kw2):
            calls["n"] += 1
            if fault == "state":
                # the step's KV lands in a copy: the pool is left unchanged
                return step(tokens, k_pages.clone(), v_pages.clone(),
                            *rest, **kw2)
            logits, k, v = step(tokens, k_pages, v_pages, *rest, **kw2)
            if calls["n"] % 2 == 0:
                # one token of every row altered where it is produced
                logits = logits.clone()
                logits[:, 7] = logits.max() + 10.0
            return logits, k, v

        model.paged_decode_step = decode
        return s

    monkeypatch.setattr(cell, "set_up", set_up)


@pytest.mark.parametrize("fault", ["token", "state"])
def test_a_broken_step_is_not_correct(bench, monkeypatch, fault):
    _broken(monkeypatch, fault)
    r = cell.run(bench, "dense.closed", 4242, 6.0, False, time.perf_counter(),
                 device="cpu")
    assert not r["correct"]
    checks = r["checks"]
    assert checks["compared_calls"]["value"] >= checks["compared_calls"]["limit"]
    assert r["checks"]["logit_gap"]["value"] > GAP


def _cli(cwd, *extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "CUDA_VISIBLE_DEVICES")}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "ds67b.halo_nodes", "--seed", "5", "--seconds", "1",
         "--trace", "0", *extra], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300)


def test_no_card_no_result():
    out = _cli(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_benchmark_files_alone_are_not_a_run(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(PB, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _cli(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_a_tiny_cell_runs_on_the_card(bench):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = cell.run(bench, "moe.closed", 12, 2.0, True, time.perf_counter(),
                 device="cuda")
    assert r["correct"], r["checks"]
    assert r["device"]["busy_s"] > 0
    json.dumps(r)
