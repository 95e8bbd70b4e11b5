"""What the op-cost counter (``repro_torch.launch.op_cost``) needs from the
code it counts, kept below the models and kernels so that they need not
import the launch layer.

* ``active()`` is the innermost active counter, or None.  A counter
  registers itself here while it is entered (``enter``/``leave``) and
  gives ``region(n)`` and ``charge(flops, nbytes)``.
* ``steps(n)`` is the counterpart of XLA's ``known_trip_count``: with no
  active counter it is exactly ``range(n)``; under one it yields the one
  index 0 inside a region whose costs count ``n`` times.  The port's
  Python loops over time walk through it (the scan's plain version and
  its backward, xLSTM's cells, chunked attention's query blocks).
* ``steps_out(items, n)`` gives such a loop's per-step results as a loop
  over ``range(n)`` gives them: under a counter its one result stands in
  for all ``n``.
* ``charge(flops, nbytes)`` adds a hand kernel's work to the active
  counter (a no-op with none): a kernel wrapper called on meta tensors
  launches nothing the counter could see, so it charges its kernel's
  operations and the bytes it moves, each input read once and each
  output written once.
"""
from __future__ import annotations

from typing import List, Optional

_ACTIVE: List[object] = []


def enter(counter) -> None:
    _ACTIVE.append(counter)


def leave(counter) -> None:
    _ACTIVE.remove(counter)


def active():
    """The innermost active counter, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def steps(n: int):
    """``range(n)``, or under an active counter one step whose costs count
    ``n`` times."""
    counter = active()
    if counter is None:
        return range(n)
    return counter.region(n)


def steps_out(items: list, n: int) -> list:
    """The per-step results of a ``for t in steps(n)`` loop as a loop over
    ``range(n)`` gives them: under a counter the loop ran once, and its
    one result (of the shape every step's has) stands in for all ``n``."""
    if len(items) == n:
        return items
    if active() is None or len(items) != 1:
        raise ValueError(f"steps_out: {len(items)} results of {n} steps")
    return items * n


def charge(flops: float, nbytes: float) -> None:
    """Add a hand kernel's operations and bytes to the active counter
    (times its trip counts); nothing without one."""
    counter = active()
    if counter is not None:
        counter.charge(flops, nbytes)


def visible_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """The (query, key) pairs an attention mask leaves, for one batch row
    and head, from the shapes alone: query row i at position i over keys
    at positions 0..skv-1, a key visible at or before the query when
    ``causal`` and within ``window`` of it when ``window`` > 0.  Exact
    for a training step's and a cold prefill's positions; on other
    positions the data decides, which meta tensors do not hold."""
    total = 0
    for i in range(sq):
        hi = min(i + 1, skv) if causal else skv
        lo = max(0, i - window + 1) if window > 0 else 0
        total += max(0, hi - lo)
    return total
