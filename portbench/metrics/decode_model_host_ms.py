"""Host milliseconds a decode step spends in the model call
(``engine.decode.model``: its enqueue, and any wait inside it), over the
steps.  Beside ``decode_step_ms``, the device-event time of the same
call: equal values mean the step is launch-bound."""
from portbench.harness.spans import count, total_s


def read(run):
    n = count(run.stats, "engine.decode")
    s = total_s(run.stats, "engine.decode.model")
    if n is None or s is None:
        return None
    return 1000.0 * s / n
