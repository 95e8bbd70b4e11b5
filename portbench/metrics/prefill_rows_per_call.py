"""Rows a prefill call carries: the window's ``EngineStats.prefill_rows``
(rows of the engine's chunk-prefill calls) over its prefill calls
(``engine.admit.model``).  None on a program that counts no rows."""
from portbench.harness.spans import count


def read(run):
    n = count(run.stats, "engine.admit.model")
    rows = run.stats.get("prefill_rows")
    if n is None or rows is None:
        return None
    return rows / n
