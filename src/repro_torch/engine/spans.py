"""Host spans of the engine loop: count, total and self time by name.

Each ``InferenceEngine`` owns one ``SpanRecorder`` (in its
``EngineStats``), used only by the engine-loop thread: spans sit at call
sites in code that runs there, never in helpers that the step-gap methods
(``probe_prefix``, ``export_prefix``, ``import_prefix``) share from caller
threads.  A span's self time is its total less the totals of the spans
opened inside it.

The names are fixed (``SPAN_NAMES``) and an unknown one raises, so the
per-name totals are dicts made once that never change size: another
thread may read them (``EngineStats.as_dict``) while the loop runs.

Totals are always kept: two ``perf_counter_ns`` reads and a little list
work a span.  While a torch profiler runs in the process, each span also
enters ``torch.profiler.record_function(name)``, with the request id as
its argument where one is given or inherited from the enclosing span, so
the profiler puts the program's spans and the device's kernels on one
clock.  With no profiler running ``record_function`` is never entered:
it costs several microseconds even then.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

SPAN_NAMES = (
    "engine.idle",              # the loop waiting with no work
    "engine.step",              # one scheduler iteration
    "engine.admit",             # one admission pass
    "engine.admit.pick",        # scans of the pending queue, coalescing
    "engine.admit.request",     # one admitted (or deferred) request
    "engine.admit.seed",        # the prompt CRCs and torch.Generator
    "engine.admit.match",       # the radix tree's donor search
    "engine.admit.pages",       # page reservation, warm evictions
    "engine.admit.view",        # the chunk view and the input uploads
    "engine.admit.model",       # the prefill's host enqueue
    "engine.admit.pool",        # KV rows into the page pool
    "engine.admit.tree",        # radix-tree insertion
    "engine.admit.sync",        # the first token's read from the device
    "engine.decode",            # one decode step
    "engine.decode.tables",     # page tables, lengths, tokens, uploads
    "engine.decode.model",      # the step's host enqueue
    "engine.decode.sample",     # the sampler's enqueue
    "engine.decode.sync",       # the sampled ids' read from the device
    "engine.decode.retire",     # per-slot bookkeeping and retirement
)


class _Span:
    __slots__ = ("_rec", "_name", "_arg", "_t0", "_child_ns", "_rf")

    def __init__(self, rec: "SpanRecorder", name: str, arg):
        self._rec = rec
        self._name = name
        self._arg = arg
        self._child_ns = 0
        self._rf = None

    def __enter__(self) -> "_Span":
        stack = self._rec._open
        if self._arg is None and stack:
            self._arg = stack[-1]._arg
        if _autograd_profiler._is_profiler_enabled:
            self._rf = torch.profiler.record_function(
                self._name, None if self._arg is None else str(self._arg))
            self._rf.__enter__()
        stack.append(self)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        dt = time.perf_counter_ns() - self._t0
        rec = self._rec
        stack = rec._open
        stack.pop()
        name = self._name
        rec.count[name] += 1
        rec.total_ns[name] += dt
        rec.self_ns[name] += dt - self._child_ns
        if stack:
            stack[-1]._child_ns += dt
        if self._rf is not None:
            self._rf.__exit__(None, None, None)


class SpanRecorder:
    """Per-name count, total and self time of the engine loop's spans."""

    def __init__(self):
        self.count: Dict[str, int] = dict.fromkeys(SPAN_NAMES, 0)
        self.total_ns: Dict[str, int] = dict.fromkeys(SPAN_NAMES, 0)
        self.self_ns: Dict[str, int] = dict.fromkeys(SPAN_NAMES, 0)
        self._open: List[_Span] = []        # the loop thread's open spans

    def span(self, name: str, arg: Optional[object] = None) -> _Span:
        """A context manager timing ``name``; ``arg`` (a request id) goes
        to the profiler's span, and to the spans opened inside it."""
        if name not in self.count:
            raise KeyError(f"unknown engine span {name!r}")
        return _Span(self, name, arg)

    def as_dict(self) -> Dict[str, float]:
        """``span_s.<name>`` and ``span_self_s.<name>`` in seconds and
        ``span_n.<name>``, for every name."""
        out: Dict[str, float] = {}
        for name in SPAN_NAMES:
            out["span_s." + name] = self.total_ns[name] / 1e9
            out["span_self_s." + name] = self.self_ns[name] / 1e9
            out["span_n." + name] = float(self.count[name])
        return out
