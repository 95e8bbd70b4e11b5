"""Share of the traced window in which no operation runs on the device
(the union of the profiler's device intervals), in %."""


def read(run):
    t = run.trace
    if t is None:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
