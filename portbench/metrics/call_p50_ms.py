"""Median of the latencies that ``call_p90_ms`` takes its tail from."""
from portbench.harness.stats import percentile


def read(run):
    if not run.window.drained or not run.window.records:
        return None
    return percentile(run.latencies_ms(), 50)
