"""Tool operators: SQL (minidb), HTTP (simulated external API), pyfn.

Each execution returns a string (what gets interpolated into downstream
prompts) and reports its wall time to the OperatorProfiler.  HTTP
latency is deterministic per-URL (hash-derived) so runs are reproducible
and stragglers are stable; ``latency_scale`` lets tests run at 0 cost.

A copy of the JAX package's module of the same name, with the import prefix
``repro.`` read as ``repro_torch.``; ``tests/test_torch_copies.py`` holds
the two equal.
"""
from __future__ import annotations

import hashlib
import time
from typing import Callable, Dict, Optional, Tuple

from repro_torch.workloads.minidb import MiniDB


def _http_latency(url: str) -> float:
    h = int.from_bytes(hashlib.blake2b(url.encode(), digest_size=4).digest(),
                       "little")
    return 0.02 + (h % 1000) / 1000.0 * 0.08       # 20–100 ms, deterministic


class ToolRuntime:
    """Executes tool-node ops against the backing database / fake net."""

    def __init__(self, db: MiniDB, latency_scale: float = 1.0,
                 functions: Optional[Dict[str, Callable[[str], str]]] = None):
        self.db = db
        self.latency_scale = latency_scale
        self.functions = dict(functions or {})
        self.functions.setdefault("wordcount", lambda s: str(len(s.split())))
        self.functions.setdefault("upper", lambda s: s.upper())
        # stats
        self.calls: Dict[str, int] = {"sql": 0, "http": 0, "pyfn": 0}
        self.seconds: Dict[str, float] = {"sql": 0.0, "http": 0.0, "pyfn": 0.0}

    # ------------------------------------------------------------------
    def execute(self, op: str, args: str) -> Tuple[str, float]:
        """Run one tool op. Returns (result string, wall seconds)."""
        t0 = time.perf_counter()
        if op == "sql":
            rows = self.db.execute(args)
            result = "; ".join(",".join(str(c) for c in r) for r in rows[:50])
            result = result or "(no rows)"
        elif op == "http":
            lat = _http_latency(args) * self.latency_scale
            if lat > 0:
                time.sleep(lat)
            body = hashlib.blake2b(args.encode(), digest_size=6).hexdigest()
            result = f"http:{body}"
        elif op == "pyfn":
            name, _, arg = args.partition("(")
            arg = arg.rstrip(")")
            fn = self.functions.get(name.strip())
            result = fn(arg) if fn else f"(unknown fn {name!r})"
        else:
            raise ValueError(f"unknown tool op {op!r}")
        dt = time.perf_counter() - t0
        self.calls[op] = self.calls.get(op, 0) + 1
        self.seconds[op] = self.seconds.get(op, 0.0) + dt
        return result, dt

    # ------------------------------------------------------------------
    def explain_hook(self) -> Callable[[str], float]:
        return self.db.explain
