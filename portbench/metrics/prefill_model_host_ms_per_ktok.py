"""Host milliseconds in the model's prefill calls
(``engine.admit.model``) per 1000 prompt tokens computed
(``EngineStats.prefill_tokens``).  Beside ``prefill_ms_per_ktok``, the
device-event time of the same calls."""
from portbench.harness.spans import total_s


def read(run):
    s = total_s(run.stats, "engine.admit.model")
    toks = run.stats.get("prefill_tokens", 0)
    if s is None or not toks:
        return None
    return 1000.0 * s / (toks / 1000.0)
