"""Rates, percentiles and the due-time rule, with a stall in the window."""
import threading
import time

import numpy as np
import pytest

from portbench.loops import closed, open as open_loop
from portbench.harness.stats import latencies_ms, percentile, rate
from portbench.harness.traffic import Traffic


@pytest.mark.parametrize("n", [1, 2, 7, 100])
def test_percentile_matches_numpy(n):
    xs = list(np.random.default_rng(n).exponential(1.0, n))
    for q in (50, 90, 95):
        assert percentile(xs, q) == pytest.approx(np.percentile(xs, q))


def test_unfinished_calls_count_until_the_harness_gave_up():
    lat = latencies_ms([0.0, 1.0, 2.0], [0.5, None, 2.25], gave_up=10.0)
    assert lat == pytest.approx([500.0, 9000.0, 250.0])
    assert rate(30, 10.0) == 3.0


class _Handle:
    def __init__(self):
        self._cbs, self._done, self._tokens = [], False, None

    def add_done_callback(self, fn):
        if self._done:
            fn(self)
        else:
            self._cbs.append(fn)

    def finish(self, tokens):
        self._tokens, self._done = tokens, True
        for fn in self._cbs:
            fn(self)

    def exception(self):
        return None

    def result(self, timeout=None):
        return self._tokens


class FakeEngine:
    """Serves each call after ``service`` seconds, one at a time; while
    ``stall`` = (start, end) seconds after the first submit, serves
    nothing."""

    def __init__(self, service, stall=None):
        self.service, self.stall = service, stall
        self.queue, self.cv = [], threading.Condition()
        self.t0 = None
        self.stop = False
        self.thread = threading.Thread(target=self._loop, daemon=True)
        self.thread.start()

    def submit(self, prompt, max_new_tokens, temperature):
        h = _Handle()
        with self.cv:
            if self.t0 is None:
                self.t0 = time.perf_counter()
            self.queue.append((h, max_new_tokens))
            self.cv.notify()
        return h

    def _loop(self):
        while True:
            with self.cv:
                while not self.queue and not self.stop:
                    self.cv.wait()
                if self.stop:
                    return
                h, n = self.queue.pop(0)
            if self.stall is not None:
                now = time.perf_counter() - self.t0
                if self.stall[0] <= now < self.stall[1]:
                    time.sleep(self.stall[1] - now)
            time.sleep(self.service)
            h.finish([1] * n)

    def close(self):
        with self.cv:
            self.stop = True
            self.cv.notify()
        self.thread.join(timeout=5)


OPEN = {"loop": "open", "rate_per_s": 40.0, "block": 16, "drain_s": 5.0,
        "segments": [{"tokens": 4}], "max_new_tokens": [2]}


def _p90(stall):
    eng = FakeEngine(0.004, stall)
    try:
        win = open_loop.run(eng, Traffic(OPEN, 5, (0, 10)), 1.0)
    finally:
        eng.close()
    recs = win.records
    assert win.drained and all(r.done is not None for r in recs)
    return percentile(latencies_ms([r.due for r in recs],
                                   [r.done for r in recs], win.gave_up), 90)


def test_a_stall_in_the_window_moves_p90():
    """Calls due during a stall wait for it: timed from their due time,
    their latencies carry the stall, so the tail moves by about its
    length."""
    calm = _p90(None)
    stalled = _p90((0.3, 0.6))
    assert calm < 100.0
    assert stalled > calm + 150.0


def test_closed_loop_replaces_each_finished_call():
    eng = FakeEngine(0.002)
    spec = {"loop": "closed", "outstanding": 3, "block": 8,
            "segments": [{"tokens": 4}], "max_new_tokens": [2]}
    try:
        win = closed.run(eng, Traffic(spec, 1, (0, 10)), 0.3)
    finally:
        eng.close()
    assert not win.drained
    done = [r for r in win.records if r.done is not None
            and r.done <= win.closed]
    assert len(done) > 20
    # outstanding calls stay at 3: one submitted for each finished
    assert len(win.records) - len(done) <= 3 + 1
    assert [r.call.index for r in win.records] == \
        list(range(len(win.records)))
