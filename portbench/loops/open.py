"""Open loop: call i is submitted at its due time (the traffic's
arrivals at ``rate_per_s``).  After the window closes no call is
submitted and the harness waits for every submitted call, at most
``drain_s`` (the traffic file's, default 60) seconds past the close."""
from __future__ import annotations

import time
from typing import List

from portbench.harness.driver import Record, Window, submit


def run(engine, traffic, seconds: float, clock=time.perf_counter,
        on_open=None, on_close=None) -> Window:
    drain_s = float(traffic.spec.get("drain_s", 60.0))
    records: List[Record] = []
    if on_open is not None:
        on_open()
    opened = clock()
    close = opened + seconds
    i = 0
    while True:
        call = traffic.call(i)
        due = opened + call.due
        if due >= close:
            break
        time.sleep(max(0.0, due - clock()))
        rec = Record(call, due=due, submitted=clock())
        records.append(rec)
        submit(engine, rec, clock)
        i += 1
    time.sleep(max(0.0, close - clock()))
    closed = clock()
    if on_close is not None:
        on_close()
    deadline = closed + drain_s
    while clock() < deadline and any(r.done is None for r in records):
        time.sleep(0.05)
    return Window(records, opened, closed, clock(), drained=True)
