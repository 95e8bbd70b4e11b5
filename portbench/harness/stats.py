"""Rates, percentiles and latencies from the host clock."""
from __future__ import annotations

from typing import List, Optional, Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between the
    closest ranks (numpy's default), of a non-empty sample."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def latencies_ms(dues: Sequence[float], dones: Sequence[Optional[float]],
                 gave_up: float) -> List[float]:
    """Each call's time from when it was due to its last token, in ms.  A
    call that never finished counts the time until ``gave_up``, when the
    harness stopped waiting: no less than its elapsed time."""
    return [1e3 * ((gave_up if d is None else d) - due)
            for due, d in zip(dues, dones)]


def rate(completed: int, seconds: float) -> float:
    return completed / seconds
