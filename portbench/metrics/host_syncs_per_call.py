"""Blocking host<->device copies the engine and its page pool made
(``EngineStats.host_syncs``) per prefilled call (``engine.admit.model``)."""
from portbench.harness.spans import count


def read(run):
    n = count(run.stats, "engine.admit.model")
    if n is None or "host_syncs" not in run.stats:
        return None
    return run.stats["host_syncs"] / n
