"""Debug-mode lock-order verifier (DESIGN.md §11).

A copy of ``repro.debugsync``: the port imports nothing of the JAX
package, so it carries its own.

``named_lock(name)`` / ``named_condition(name)`` are drop-in factories
for ``threading.Lock()`` / ``threading.Condition()`` used at every lock
creation site in the threaded runtime.  The ``name`` is the lock's
canonical identity, ``ClassName.attr`` — the same identity the static
lock-discipline checker (``tools/analysis``) uses for its acquisition-
order graph, and the checker verifies the string matches the attribute
the lock is assigned to, so the static and runtime views can never
drift apart.

With ``REPRO_DEBUG_SYNC`` unset (the default, and production) the
factories return plain ``threading`` primitives: zero overhead, zero
behavior change.  With ``REPRO_DEBUG_SYNC=1`` they return checking
wrappers that record, per thread, the stack of currently-held named
locks and, globally, every observed happens-before edge A→B ("B was
acquired while A was held") with a witness traceback.  An acquisition
that would close a cycle in that edge set — i.e. some thread
previously acquired these locks in the opposite order — raises
``LockOrderError`` immediately, with both witness stacks, instead of
leaving a latent deadlock to strike under production timing.  The
nightly CI job runs the full test suite with the verifier on.

Conditions are built over a checking proxy around an ``RLock`` so that
``Condition.wait()``'s release/re-acquire cycle is tracked correctly
(the held-stack entry is popped for the duration of the wait and
re-pushed on wakeup, without re-recording edges that were already
proven).
"""
from __future__ import annotations

import os
import threading
import traceback


def enabled() -> bool:
    """True when the runtime lock-order verifier is switched on."""
    return os.environ.get("REPRO_DEBUG_SYNC", "") == "1"


class LockOrderError(AssertionError):
    """Two threads acquired the same pair of locks in opposite orders."""


def _here() -> str:
    # drop the last two frames (this helper + the registry method)
    return "".join(traceback.format_stack(limit=8)[:-2])


class _OrderRegistry:
    """Global happens-before edges + per-thread held-lock stacks."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._witness: dict = {}       # (a, b) -> stack str proving a→b
        self._succ: dict = {}          # a -> set of b with edge a→b
        self._tls = threading.local()

    # -- per-thread held stack -------------------------------------
    def _stack(self) -> list:
        st = getattr(self._tls, "held", None)
        if st is None:
            st = self._tls.held = []
        return st

    def held(self) -> list:
        """Names currently held by this thread (outermost first)."""
        return list(self._stack())

    def push(self, name: str) -> None:
        self._stack().append(name)

    def push_many(self, name: str, n: int) -> None:
        self._stack().extend([name] * n)

    def pop(self, name: str) -> None:
        st = self._stack()
        for i in range(len(st) - 1, -1, -1):
            if st[i] == name:
                del st[i]
                return

    def pop_all(self, name: str) -> int:
        st = self._stack()
        n = st.count(name)
        if n:
            self._tls.held = [h for h in st if h != name]
        return n

    # -- edge recording / cycle detection --------------------------
    def _reaches(self, src: str, dst: str) -> bool:
        seen, frontier = set(), [src]
        while frontier:
            node = frontier.pop()
            if node == dst:
                return True
            if node in seen:
                continue
            seen.add(node)
            frontier.extend(self._succ.get(node, ()))
        return False

    def check_acquire(self, name: str) -> None:
        """Validate + record edges held→name.  Call BEFORE acquiring."""
        held = self._stack()
        if name in held:               # re-entrant (Condition's RLock)
            return
        outer = set(held)
        if not outer:
            return
        with self._mu:
            for a in outer:
                if name in self._succ.get(a, ()):
                    continue           # edge already proven
                if self._reaches(name, a):
                    prior = self._witness.get((name, a))
                    path = "" if prior is None else (
                        f"\n--- prior witness for {name!r}"
                        f" before {a!r} ---\n{prior}")
                    raise LockOrderError(
                        f"lock-order inversion: acquiring {name!r} while "
                        f"holding {a!r}, but the reverse order was "
                        f"observed earlier (edge set now cyclic).\n"
                        f"--- this acquisition ---\n{_here()}{path}")
                self._succ.setdefault(a, set()).add(name)
                self._witness[(a, name)] = _here()

    def snapshot_edges(self) -> set:
        with self._mu:
            return {(a, b) for a, bs in self._succ.items() for b in bs}


_REGISTRY = _OrderRegistry()


def registry() -> _OrderRegistry:
    """The process-wide order registry (for tests/diagnostics)."""
    return _REGISTRY


class _CheckedLock:
    """Order-checking proxy over a ``threading`` lock primitive.

    Also implements the private Condition plumbing (``_is_owned`` /
    ``_release_save`` / ``_acquire_restore``) by delegating to the
    inner primitive while keeping the held-stack honest across
    ``Condition.wait()``.
    """

    def __init__(self, name: str, inner) -> None:
        self.name = name
        self._inner = inner

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        _REGISTRY.check_acquire(self.name)
        got = self._inner.acquire(blocking, timeout)
        if got:
            _REGISTRY.push(self.name)
        return got

    def release(self) -> None:
        self._inner.release()
        _REGISTRY.pop(self.name)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __repr__(self) -> str:
        return f"<_CheckedLock {self.name!r} over {self._inner!r}>"

    # -- Condition support (inner must be an RLock) ----------------
    def _is_owned(self):
        return self._inner._is_owned()

    def _release_save(self):
        n = _REGISTRY.pop_all(self.name)
        return (self._inner._release_save(), n)

    def _acquire_restore(self, saved) -> None:
        state, n = saved
        self._inner._acquire_restore(state)
        _REGISTRY.push_many(self.name, n)


def named_lock(name: str):
    """A ``threading.Lock`` whose canonical name is ``Class.attr``."""
    if not enabled():
        return threading.Lock()
    return _CheckedLock(name, threading.Lock())


def named_condition(name: str):
    """A ``threading.Condition`` whose lock carries ``Class.attr``."""
    if not enabled():
        return threading.Condition()
    return threading.Condition(_CheckedLock(name, threading.RLock()))
