"""What a loop records over one window, and how it learns of a finished
call: ``submit(prompt, max_new_tokens=..., temperature=0.0)`` on the
engine, with completion taken from the handle's ``add_done_callback``,
``exception`` and ``result``.

The loops themselves are files of their own, ``loops/<name>.py``, found
by the name a traffic file gives under ``loop``.  Each has ``run(engine,
traffic, seconds, clock=time.perf_counter, on_open=None,
on_close=None) -> Window``: it calls ``on_open`` just before the window
opens and ``on_close`` just after it closes, before any wait for late
calls.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from portbench.harness.traffic import Call


@dataclass
class Record:
    call: Call
    due: float                          # host clock, seconds
    submitted: float = 0.0
    done: Optional[float] = None
    tokens: Optional[List[int]] = None
    error: Optional[str] = None


@dataclass
class Window:
    records: List[Record]
    opened: float
    closed: float
    gave_up: float                      # when the harness stopped waiting
    drained: bool = False               # every call submitted was waited
                                        # for: each counts, timed from due


def submit(engine, rec: Record, clock, then=None) -> None:
    """Submit ``rec``'s call; when it finishes, fill in the record and
    call ``then(rec)``."""
    def done(handle) -> None:
        rec.done = clock()
        err = handle.exception()
        if err is not None:
            rec.error = repr(err)
        else:
            rec.tokens = list(handle.result(timeout=0))
        if then is not None:
            then(rec)

    handle = engine.submit(rec.call.prompt, max_new_tokens=rec.call.max_new,
                           temperature=0.0)
    handle.add_done_callback(done)
