"""The reader of the decode step's CUDA-graph replays
(``decode_graph_share``): replays over decode steps on a synthetic
window, None on a program that has no such counter, declared for both
cells, and 0 over a CPU window, where the step runs eagerly."""
import pathlib

import pytest

from portbench.harness import cell
from portbench.harness.cell import RunData
from portbench.harness.spec import Bench
from portbench.tests.fixtures import make_root

ROOT = pathlib.Path(__file__).resolve().parents[2]
NAMES = {"decode_graph_share.batch": "ds67b.halo_nodes",
         "decode_graph_share.dsv2": "dsv2.halo_nodes"}


def _run(stats):
    return RunData(cell=None, model={}, seconds=51.0, setup_s=20.0,
                   window=None, stats=stats, page_size=8)


@pytest.fixture(scope="module")
def bench():
    return Bench(ROOT)


@pytest.mark.parametrize("name", sorted(NAMES))
def test_replays_over_decode_steps(bench, name):
    read = bench.reader(name)
    steps = {"span_n.engine.decode": 400.0, "decode_tokens": 38400}
    assert read(_run(dict(steps, decode_graph_replays=396))) == \
        pytest.approx(0.99)
    # the parent's program: no such counter
    assert read(_run(steps)) is None
    # no decode step in the window: nothing to divide by
    assert read(_run({"span_n.engine.decode": 0.0,
                      "decode_graph_replays": 0})) is None


@pytest.mark.parametrize("name", sorted(NAMES))
def test_declared_for_its_cell_alone(bench, name):
    declared = {m["name"]: m for m in bench.metrics(NAMES[name], True)}
    assert declared[name]["moves"] == "calls_per_s"
    assert declared[name]["layer"] == "model step"
    other = set(NAMES.values()) - {NAMES[name]}
    assert name not in {m["name"] for m in bench.metrics(other.pop(), True)}
    assert name not in {m["name"] for m in bench.metrics(NAMES[name], False)}


def test_a_cpu_window_reads_no_replay(tmp_path):
    pytest.importorskip("repro_torch")
    fixture = Bench(make_root(tmp_path))
    s = cell.set_up(fixture, "dense.closed", 2**31 + 7, device="cpu")
    try:
        win, stats = cell.drive(s, 2.0)
    finally:
        cell.tear_down(s)
    run = RunData(s.cell, s.model, 2.0, 0.0, win, stats, 8)
    assert stats["span_n.engine.decode"] > 0
    for name in NAMES:
        assert Bench(ROOT).reader(name)(run) == 0.0, name
