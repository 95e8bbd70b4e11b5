"""Closed loop: ``outstanding`` calls are submitted when the window
opens and each call that finishes inside the window is replaced at once,
from its callback.  Calls still running at the close are not waited for."""
from __future__ import annotations

import threading
import time
from typing import List

from portbench.harness.driver import Record, Window, submit


def run(engine, traffic, seconds: float, clock=time.perf_counter,
        on_open=None, on_close=None) -> Window:
    lock = threading.Lock()
    records: List[Record] = []
    state = {"next": 0}
    if on_open is not None:
        on_open()
    opened = clock()
    close = opened + seconds

    def submit_next() -> None:
        with lock:
            i = state["next"]
            state["next"] += 1
        now = clock()
        rec = Record(traffic.call(i), due=now, submitted=now)
        records.append(rec)
        submit(engine, rec, clock, then=replace)

    def replace(rec: Record) -> None:
        if rec.done < close:
            submit_next()

    for _ in range(int(traffic.spec["outstanding"])):
        submit_next()
    time.sleep(max(0.0, close - clock()))
    end = clock()
    if on_close is not None:
        on_close()
    return Window(list(records), opened, end, end)
