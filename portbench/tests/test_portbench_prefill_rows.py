"""``prefill_rows_per_call.batch``: the rows of the engine's chunk-prefill
calls over its prefill calls.  On a synthetic window it gives that ratio;
where the program counts no rows (an engine that prefills one row a
call and has no ``prefill_rows``) or has no prefill span, None; a CPU
window of a tiny cell, whose closed loop submits several calls at once,
reads at least one row a call."""
import pathlib

import pytest

from portbench.harness import cell
from portbench.harness.cell import RunData
from portbench.harness.spec import Bench
from portbench.tests.fixtures import make_root

ROOT = pathlib.Path(__file__).resolve().parents[2]
NAME = "prefill_rows_per_call.batch"


def _run(stats):
    return RunData(cell=None, model={}, seconds=51.0, setup_s=20.0,
                   window=None, stats=stats, page_size=8)


@pytest.fixture(scope="module")
def read():
    return Bench(ROOT).reader(NAME)


@pytest.mark.parametrize("rows,calls,want", [(100, 40, 2.5), (7, 7, 1.0),
                                             (96, 10, 9.6)])
def test_rows_over_prefill_calls(read, rows, calls, want):
    stats = {"prefill_rows": rows, "span_n.engine.admit.model": calls,
             "prefill_tokens": 29050}
    assert read(_run(stats)) == pytest.approx(want)


@pytest.mark.parametrize("stats", [
    {"span_n.engine.admit.model": 40, "prefill_tokens": 29050},
    {"prefill_rows": 100, "prefill_tokens": 29050},
    {"prefill_rows": 0, "span_n.engine.admit.model": 0},
], ids=["no_row_counter", "no_span", "no_call"])
def test_none_where_a_count_is_absent(read, stats):
    assert read(_run(stats)) is None


def test_declared_for_the_cell():
    declared = {m["name"]: m for m in
                Bench(ROOT).metrics("ds67b.halo_nodes", True)}
    m = declared[NAME]
    assert (m["moves"], m["better"], m["layer"], m["unit"]) == \
        ("calls_per_s", "higher", "scheduler", "rows")


def test_a_cpu_window_reaches_the_reader(tmp_path, read):
    pytest.importorskip("repro_torch")
    fixture = Bench(make_root(tmp_path))
    s = cell.set_up(fixture, "dense.closed", 2**31 + 7, device="cpu")
    try:
        win, stats = cell.drive(s, 2.0)
    finally:
        cell.tear_down(s)
    run = RunData(s.cell, s.model, 2.0, 0.0, win, stats, 8)
    assert stats["prefill_rows"] > 0
    assert read(run) >= 1.0
