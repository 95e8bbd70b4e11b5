"""The readers of the engine loop's spans and host counters.

Each reads only the window's ``EngineStats`` deltas: on a synthetic run
they give the ratios their files state, and where the program has no
spans (the keys a program without them reports) they give None.  A CPU
window of a tiny cell shows the deltas reach them through the harness."""
import pathlib

import pytest

from portbench.harness import cell
from portbench.harness.cell import RunData
from portbench.harness.spec import Bench
from portbench.tests.fixtures import make_root

ROOT = pathlib.Path(__file__).resolve().parents[2]
NAMES = ("admit_host_ms_per_call.batch", "decode_host_ms_per_step.batch",
         "decode_model_host_ms.batch", "prefill_model_host_ms_per_ktok.batch",
         "host_syncs_per_call.batch")

# what an engine without spans reports over a window
PARENT = {"prefill_tokens": 29050, "prefill_tokens_saved": 0,
          "decode_tokens": 48000, "coalesced_requests": 0,
          "admission_waves": 480, "d2h_bytes": 192000}


def _child_keys(root, seconds):
    out = {}
    for c, s in seconds.items():
        name = f"{root}.{c}"
        out.update({f"span_s.{name}": s, f"span_self_s.{name}": s,
                    f"span_n.{name}": 100.0})
    return out


def _spans():
    """100 admissions (one deferred) and 500 decode steps."""
    stats = dict(PARENT, host_syncs=2500, admit_deferrals=1)
    admit_kids = {"pick": 0.2, "seed": 0.1, "match": 0.05, "pages": 0.05,
                  "view": 0.5, "model": 3.0, "pool": 0.3, "tree": 0.1,
                  "sync": 1.0}
    stats.update(_child_keys("engine.admit", admit_kids))
    stats["span_n.engine.admit.model"] = 99.0
    stats.update({"span_s.engine.admit": 5.5, "span_self_s.engine.admit":
                  0.1, "span_n.engine.admit": 600.0,
                  "span_s.engine.admit.request": 5.2,
                  "span_self_s.engine.admit.request": 0.1,
                  "span_n.engine.admit.request": 100.0})
    decode_kids = {"tables": 2.0, "model": 20.0, "sample": 0.5,
                   "sync": 4.0, "retire": 1.0}
    stats.update(_child_keys("engine.decode", decode_kids))
    stats.update({"span_s.engine.decode": 27.75,
                  "span_self_s.engine.decode": 0.25,
                  "span_n.engine.decode": 500.0})
    return stats


EXPECTED = {
    # self seconds of admit, request, pick, seed, match, pages, view,
    # pool, tree over 99 prefills
    "admit_host_ms_per_call.batch":
        1000 * (0.1 + 0.1 + 0.2 + 0.1 + 0.05 + 0.05 + 0.5 + 0.3 + 0.1) / 99,
    "decode_host_ms_per_step.batch": 1000 * (0.25 + 2.0 + 0.5 + 1.0) / 500,
    "decode_model_host_ms.batch": 1000 * 20.0 / 500,
    "prefill_model_host_ms_per_ktok.batch": 1000 * 3.0 / 29.05,
    "host_syncs_per_call.batch": 2500 / 99,
}


def _run(stats):
    return RunData(cell=None, model={}, seconds=51.0, setup_s=20.0,
                   window=None, stats=stats, page_size=8)


@pytest.fixture(scope="module")
def bench():
    return Bench(ROOT)


@pytest.mark.parametrize("name", NAMES)
def test_reader_on_a_synthetic_window(bench, name):
    assert bench.reader(name)(_run(_spans())) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", NAMES)
def test_reader_without_spans_is_none(bench, name):
    assert bench.reader(name)(_run(dict(PARENT))) is None
    # spans present but no call in the window: nothing to divide by
    idle = {k: (0.0 if k.startswith("span") else v)
            for k, v in _spans().items()}
    idle["prefill_tokens"] = 0
    assert bench.reader(name)(_run(idle)) is None


def test_the_readers_are_declared_for_the_cell(bench):
    declared = {m["name"]: m for m in bench.metrics("ds67b.halo_nodes", True)}
    for name in NAMES:
        assert declared[name]["moves"] == "calls_per_s"
        assert declared[name]["better"] == "lower"


def test_a_cpu_window_reaches_the_readers(tmp_path):
    """A tiny cell's window on the CPU: the engine's span deltas come
    through ``drive``, and each reader gives a positive number."""
    pytest.importorskip("repro_torch")
    fixture = Bench(make_root(tmp_path))
    s = cell.set_up(fixture, "dense.closed", 2**31 + 5, device="cpu")
    try:
        win, stats = cell.drive(s, 2.0)
    finally:
        cell.tear_down(s)
    run = RunData(s.cell, s.model, 2.0, 0.0, win, stats, 8)
    assert stats["span_n.engine.decode"] > 0 and stats["host_syncs"] > 0
    for name in NAMES:
        value = Bench(ROOT).reader(name)(run)
        assert value is not None and value > 0, name
