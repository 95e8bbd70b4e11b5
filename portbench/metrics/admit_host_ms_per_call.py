"""Host milliseconds of admission a prefilled call: the self time of the
engine's ``engine.admit`` span and of every span under it except the
model's prefill and the first token's read, over the prefills
(``engine.admit.model``; a deferred attempt adds host time, no call)."""
from portbench.harness.spans import count, host_self_s


def read(run):
    n = count(run.stats, "engine.admit.model")
    s = host_self_s(run.stats, "engine.admit")
    if n is None or s is None:
        return None
    return 1000.0 * s / n
