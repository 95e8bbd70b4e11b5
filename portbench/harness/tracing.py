"""The traced run's instruments: wrappers on the model's two entry points
and the profiler over the window.  Installed only with ``--trace 1``.

Each call of ``engine.model.paged_decode_step`` and
``engine.model.prefill_with_cache`` inside the window is timed by CUDA
events and recorded with its shapes (rows and their lengths; cached
positions and real chunk tokens), read from the arguments the entry
point names ``lengths``, and ``cache`` and ``valid_len``, however they
are passed (so a pool passed as one tensor or as two makes no
difference), under a host span
``portbench.decode_step`` or ``portbench.prefill``.  The profiler gives
every device interval; from them come the busy seconds, each kernel's
device time, and the idle gaps, named by the host span they fall in
(``engine_host`` when the engine loop is outside every span: the
scheduler's bookkeeping, page tables, sampling).  The page pool's
methods and the model's ``paged_cache_view`` get host spans of their own
(``kv.<method>``, ``paged_cache_view``), so idle time spent in them is
named too.
"""
from __future__ import annotations

import bisect
import inspect
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import torch

_PREFIX = "portbench."
_WINDOW = "portbench.window"
_KV_METHODS = ("add_sequence", "extend_sequence", "gather",
               "prepare_appends", "commit_appends", "free_sequence")
_NAME_CHARS = 120


def merge(intervals: Sequence[Tuple[float, float]], lo: float, hi: float
          ) -> List[Tuple[float, float]]:
    """The union of ``intervals`` clipped to [lo, hi], sorted, disjoint."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def gaps(busy: Sequence[Tuple[float, float]], lo: float, hi: float
         ) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] that ``busy`` (merged) leaves free."""
    out, t = [], lo
    for s, e in busy:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if t < hi:
        out.append((t, hi))
    return out


def label_gaps(idle: Sequence[Tuple[float, float]],
               spans: Sequence[Tuple[float, float, str]],
               default: str = "engine_host") -> Dict[str, List[float]]:
    """Each idle stretch's length, filed under the host span that holds
    its midpoint.  The spans are the engine loop's, one at a time, so the
    latest to start before the midpoint is the only one that can hold
    it."""
    spans = sorted(spans)
    starts = [s for s, _, _ in spans]
    out: Dict[str, List[float]] = defaultdict(list)
    for s, e in idle:
        mid = 0.5 * (s + e)
        j = bisect.bisect_right(starts, mid) - 1
        name = spans[j][2] if j >= 0 and spans[j][1] >= mid else default
        out[name].append(e - s)
    return out


@dataclass
class DecodeCall:
    ms: float
    lengths: List[int]


@dataclass
class PrefillCall:
    ms: float
    pos0: List[int]
    n: List[int]


@dataclass
class Trace:
    window_s: float
    busy_s: float
    decode: List[DecodeCall]
    prefill: List[PrefillCall]
    kernel_s: Dict[str, float]            # device seconds by kernel name
    idle: Dict[str, List[float]] = field(default_factory=dict)

    def kernel_seconds(self, pattern: str) -> float:
        return sum(s for n, s in self.kernel_s.items() if pattern in n)

    def breakdown(self) -> dict:
        ops = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:10]
        gap_rows = []
        for name, xs in self.idle.items():
            gap_rows.append([name, sum(xs)])
            gap_rows.append([name + ".longest", max(xs)])
        gap_rows.sort(key=lambda r: -r[1])
        return {"device_ops": [[n[:_NAME_CHARS], s] for n, s in ops],
                "idle_gaps": gap_rows[:10]}


def _events():
    """A start and an end CUDA event, to record around one call."""
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def _spanned(name: str, orig):
    def call(*args, **kw):
        with torch.profiler.record_function(_PREFIX + name):
            return orig(*args, **kw)
    return call


class Tracer:
    """Wraps ``engine.model``'s entry points and ``engine.kv``'s methods
    (the pool exists once the warm-up has run) by instance attributes.
    A traced run needs the card: its timings are CUDA events and the
    profiler's device activity."""

    def __init__(self, engine):
        self.active = False
        self._decode: List[Tuple[tuple, List[int]]] = []
        self._prefill: List[Tuple[tuple, List[int], List[int]]] = []
        model = engine.model
        for name, wrap in (("paged_decode_step", self._wrap_decode),
                           ("prefill_with_cache", self._wrap_prefill)):
            setattr(model, name, wrap(getattr(model, name)))
        model.paged_cache_view = _spanned("paged_cache_view",
                                          model.paged_cache_view)
        if engine.kv is not None:
            for name in _KV_METHODS:
                setattr(engine.kv, name,
                        _spanned("kv." + name, getattr(engine.kv, name)))
        self.prof = None
        self._span = None

    def _wrap_decode(self, orig):
        sig = inspect.signature(orig)

        def paged_decode_step(*args, **kw):
            if not self.active:
                return orig(*args, **kw)
            lengths = sig.bind(*args, **kw).arguments["lengths"]
            t = _events()
            with torch.profiler.record_function(_PREFIX + "decode_step"):
                t[0].record()
                out = orig(*args, **kw)
                t[1].record()
            self._decode.append((t, lengths.tolist()))
            return out
        return paged_decode_step

    def _wrap_prefill(self, orig):
        sig = inspect.signature(orig)

        def prefill_with_cache(*args, **kw):
            if not self.active:
                return orig(*args, **kw)
            bound = sig.bind(*args, **kw).arguments
            tokens, valid_len = bound["tokens"], bound.get("valid_len")
            pos0 = bound["cache"]["length"].tolist()
            n = (valid_len.tolist() if valid_len is not None
                 else [tokens.shape[1]] * tokens.shape[0])
            t = _events()
            with torch.profiler.record_function(_PREFIX + "prefill"):
                t[0].record()
                out = orig(*args, **kw)
                t[1].record()
            self._prefill.append((t, pos0, n))
            return out
        return prefill_with_cache

    def start(self) -> None:
        self.prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        self.prof.__enter__()
        self._span = torch.profiler.record_function(_WINDOW)
        self._span.__enter__()
        self.active = True

    def stop(self) -> None:
        self.active = False
        self._span.__exit__(None, None, None)
        torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)

    def reduce(self) -> Trace:
        """Read the profiler's events.  Raises if it saw no device event:
        a traced run never reports a device number it did not measure."""
        dev, spans, window = [], [], None
        kernel_s: Dict[str, float] = defaultdict(float)
        cuda_type = torch.autograd.DeviceType.CUDA
        for e in self.prof.profiler.kineto_results.events():
            s = e.start_ns()
            end = s + e.duration_ns()
            if e.device_type() == cuda_type:
                dev.append((s, end))
                kernel_s[e.name()] += (end - s) / 1e9
            elif e.name() == _WINDOW:
                window = (s, end)
            elif e.name().startswith(_PREFIX):
                spans.append((s, end, e.name()[len(_PREFIX):]))
        if window is None:
            raise RuntimeError("the profiler lost the window's span")
        if not dev:
            raise RuntimeError("the profiler recorded no device event in "
                               "the traced window")
        lo, hi = window
        busy = merge(dev, lo, hi)
        idle_ns = label_gaps(gaps(busy, lo, hi), spans)
        return Trace(
            window_s=(hi - lo) / 1e9,
            busy_s=sum(e - s for s, e in busy) / 1e9,
            decode=[DecodeCall(a.elapsed_time(b), ln)
                    for (a, b), ln in self._decode],
            prefill=[PrefillCall(a.elapsed_time(b), p, n)
                     for (a, b), p, n in self._prefill],
            kernel_s=dict(kernel_s),
            idle={k: [x / 1e9 for x in v] for k, v in idle_ns.items()})
