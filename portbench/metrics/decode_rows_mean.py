"""Rows a decode step carries: the window's ``EngineStats.decode_tokens``
over its calls of ``paged_decode_step``."""


def read(run):
    if run.trace is None or not run.trace.decode:
        return None
    return run.stats["decode_tokens"] / len(run.trace.decode)
