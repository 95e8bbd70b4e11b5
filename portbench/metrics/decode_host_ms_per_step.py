"""Host milliseconds of a decode step outside the model and the sampled
ids' read: the self time of ``engine.decode`` and every span under it
except ``.model`` and ``.sync``, over the steps."""
from portbench.harness.spans import count, host_self_s


def read(run):
    n = count(run.stats, "engine.decode")
    s = host_self_s(run.stats, "engine.decode")
    if n is None or s is None:
        return None
    return 1000.0 * s / n
