"""CUDA-event time of ``prefill_with_cache`` calls per 1000 prompt tokens
they computed (tokens served from shared pages and padding excluded)."""


def read(run):
    if run.trace is None or not run.trace.prefill:
        return None
    toks = sum(sum(c.n) for c in run.trace.prefill)
    return sum(c.ms for c in run.trace.prefill) / (toks / 1000.0)
