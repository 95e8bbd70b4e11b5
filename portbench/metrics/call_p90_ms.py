"""90th percentile, over every call due in the window, of the time from
its due time (its open-loop schedule) to its last token.  A call the
harness stopped waiting for counts until then."""
from portbench.harness.stats import percentile


def read(run):
    if not run.window.drained or not run.window.records:
        return None
    return percentile(run.latencies_ms(), 90)
