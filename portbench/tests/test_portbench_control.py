"""The control, at a size a test run holds: the reference computed with
float8 products in the port's place comes out not correct through the
check a run makes (``cell.judge``, the cell file's limits), where the
port's bf16 serving comes out correct.  (At the cells' own sizes the
same verdicts come from ``portbench/calibrate.py`` on the card.)  The
calls are the traffic's first six, served whole, so the served tokens do
not depend on timing."""
import contextlib
import io
import json
import pathlib

import pytest

from portbench.harness import cell, driver
from portbench.harness.spec import Bench
from portbench.tests.fixtures import make_root

pytest.importorskip("repro_torch")
PB = pathlib.Path(__file__).resolve().parents[1]


def _served(bench, name, seed):
    with contextlib.redirect_stderr(io.StringIO()):
        s = cell.set_up(bench, name, seed, "cpu", warm=False)
        calls = [s.traffic.call(i) for i in range(6)]
        handles = [s.engine.submit(c.prompt, max_new_tokens=c.max_new,
                                   temperature=0.0) for c in calls]
        recs = [driver.Record(c, due=0.0, done=1.0, tokens=h.result())
                for c, h in zip(calls, handles)]
        cell.tear_down(s)
    data = cell.RunData(s.cell, s.model, 1.0, 0.0,
                        driver.Window(recs, 0.0, 2.0, 2.0), {}, 8)
    return data, s


@pytest.mark.parametrize("seed", [31, 32, 33])
@pytest.mark.parametrize("name", ["dense.closed", "moe.nodes"])
def test_the_fp8_control_is_not_correct(tmp_path, name, seed):
    bench = Bench(make_root(tmp_path))
    data, s = _served(bench, name, seed)
    port, ctrl = cell.judge(data, seed, s.device, s.engine_cfg,
                            control=True)
    assert cell.correct(port), port
    assert not cell.correct(ctrl), ctrl
    # the control fails by its gap alone: the counts are the port's
    assert [k for k, c in ctrl.items() if not c["pass"]] \
        in (["logit_gap"], ["logit_gap_mean"])


@pytest.mark.parametrize("cell_file", sorted(
    p.name for p in (PB / "cells").glob("*.json")))
def test_each_cell_file_s_limits_are_what_judge_compares(tmp_path,
                                                         cell_file):
    """A checked-in cell's limits, put in a fixture cell of the same
    family, are the numbers judge compares, and the port's served calls
    pass them."""
    limits = json.loads((PB / "cells" / cell_file).read_text())["correct"]
    bench = Bench(make_root(tmp_path))
    name = "moe.nodes" if cell_file.startswith("dsmoe") else "dense.closed"
    data, s = _served(bench, name, 41)
    data.cell.serve["correct"] = dict(limits, reference_calls=6)
    checks = cell.judge(data, 41, s.device, s.engine_cfg)
    gap = "logit_gap_mean" if "logit_gap_mean" in limits else "logit_gap"
    assert checks[gap]["limit"] == limits[gap]
    assert cell.correct(checks), checks
