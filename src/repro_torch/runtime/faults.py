"""Deterministic fault injection for the runtime (DESIGN.md §12.3).

A ``FaultPlan`` names WHERE failures may strike (tool calls, worker
loss, engine slowdown) and a seed; a ``FaultInjector`` turns the plan
into deterministic per-site decisions — the roll for a given
(seed, site, key) is a pure hash, so two runs with the same plan
inject the *same* faults at the *same* points regardless of thread
interleaving.  That determinism is what makes chaos tests assertable:
a seeded run either recovers bitwise-identically or the regression is
real.

Three injection sites, all riding existing recovery machinery:

* ``tool_call`` — raises ``TransientToolError`` for the first
  ``max_tool_failures`` attempts of an unlucky signature; the
  ``ToolDispatcher`` retries (``tool_retries``), so any plan with
  ``tool_retries > max_tool_failures`` is guaranteed to complete.
* ``kill_worker`` — maps worker id → executed-node count after which
  the worker abandons (``PlanBoard.abandon``); surviving workers pick
  up the overflow exactly as they would a real thread death.
* ``engine_delay`` — seconds of sleep before an unlucky (worker,
  node) submission, perturbing timing to shake out ordering races and
  (with an optimizer attached) trigger drift replans.

``FaultPlan.from_env`` reads the ``REPRO_FAULT_*`` variables so the CI
chaos matrix is just an env sweep.

A copy of the JAX package's module of the same name, with the import prefix
``repro.`` read as ``repro_torch.``; ``tests/test_torch_copies.py`` holds
the two equal.
"""
from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass, field
from typing import Dict, Mapping, Optional

from repro_torch.debugsync import named_lock


class TransientToolError(RuntimeError):
    """An injected, retryable tool failure (network blip stand-in)."""


def _parse_kill(spec: str) -> Dict[int, int]:
    """``"0:1,2:3"`` → {worker 0 dies after 1 node, worker 2 after 3}."""
    out: Dict[int, int] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        try:
            wid, after = part.split(":")
            out[int(wid)] = int(after)
        except ValueError:
            raise ValueError(
                f"bad REPRO_FAULT_KILL entry {part!r}; expected "
                "'wid:after' pairs like '0:1,2:3'") from None
    return out


@dataclass(frozen=True)
class FaultPlan:
    """What may fail and how often (all decisions derive from ``seed``)."""

    seed: int = 0
    # probability an eligible tool-call attempt raises TransientToolError
    tool_fail_rate: float = 0.0
    # an unlucky signature fails at most this many attempts, so retries
    # beyond it always succeed (bounds injected failures per site)
    max_tool_failures: int = 1
    # worker id -> executed-node count after which it abandons
    kill_worker: Dict[int, int] = field(default_factory=dict)
    # seconds of pre-submission delay for unlucky (worker, node) pairs
    engine_delay_s: float = 0.0
    engine_delay_rate: float = 0.0

    @classmethod
    def from_env(cls, env: Optional[Mapping[str, str]] = None
                 ) -> Optional["FaultPlan"]:
        """Build a plan from ``REPRO_FAULT_*`` variables; None when
        ``REPRO_FAULT_SEED`` is unset (fault injection off)."""
        env = os.environ if env is None else env
        seed = env.get("REPRO_FAULT_SEED")
        if seed is None:
            return None
        return cls(
            seed=int(seed),
            tool_fail_rate=float(env.get("REPRO_FAULT_TOOL_RATE", "0")),
            max_tool_failures=int(env.get("REPRO_FAULT_TOOL_MAX", "1")),
            kill_worker=_parse_kill(env.get("REPRO_FAULT_KILL", "")),
            engine_delay_s=float(env.get("REPRO_FAULT_DELAY_S", "0")),
            engine_delay_rate=float(env.get("REPRO_FAULT_DELAY_RATE", "0")),
        )


class FaultInjector:
    """Turns a ``FaultPlan`` into deterministic injection decisions."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._lock = named_lock("FaultInjector._lock")
        # signature -> tool-call attempts seen so far
        self._attempts: Dict[str, int] = {}     # guarded-by: self._lock
        self.tool_faults = 0                    # guarded-by: self._lock
        self.delays_injected = 0                # guarded-by: self._lock

    def _roll(self, site: str, key: str) -> float:
        """Uniform [0, 1) from (seed, site, key) — pure, so every run
        with this plan rolls the same number at the same point."""
        payload = f"{self.plan.seed}|{site}|{key}".encode()
        digest = hashlib.blake2b(payload, digest_size=8).digest()
        return int.from_bytes(digest, "big") / 2.0 ** 64

    # ------------------------------------------------------------ sites
    def tool_call(self, sig: str, op: str) -> None:
        """Raise ``TransientToolError`` if this attempt of ``sig`` is
        unlucky.  Attempts beyond ``max_tool_failures`` always pass, so
        dispatcher retries are guaranteed to eventually succeed."""
        p = self.plan
        if p.tool_fail_rate <= 0.0:
            return
        with self._lock:
            attempt = self._attempts.get(sig, 0) + 1
            self._attempts[sig] = attempt
            if attempt > p.max_tool_failures:
                return
            if self._roll("tool", sig) >= p.tool_fail_rate:
                return
            self.tool_faults += 1
        raise TransientToolError(
            f"injected fault: {op} attempt {attempt} of {sig!r} "
            f"(seed {p.seed})")

    def engine_delay(self, wid: int, nid: str) -> float:
        """Seconds to stall worker ``wid`` before submitting ``nid``
        (0.0 when this pair is lucky)."""
        p = self.plan
        if p.engine_delay_s <= 0.0 or p.engine_delay_rate <= 0.0:
            return 0.0
        if self._roll("delay", f"{wid}|{nid}") >= p.engine_delay_rate:
            return 0.0
        with self._lock:
            self.delays_injected += 1
        return p.engine_delay_s

    def die_after(self, wid: int) -> Optional[int]:
        """Executed-node budget for ``wid`` (None = never dies)."""
        return self.plan.kill_worker.get(wid)

    # ---------------------------------------------------------- summary
    def summary(self) -> Dict[str, int]:
        with self._lock:
            return {"seed": self.plan.seed,
                    "tool_faults_injected": self.tool_faults,
                    "engine_delays_injected": self.delays_injected,
                    "workers_killed": len(self.plan.kill_worker)}
