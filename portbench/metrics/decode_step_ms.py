"""Mean CUDA-event time of a ``paged_decode_step`` call in the traced
window: the window's decode time over its steps."""


def read(run):
    if run.trace is None or not run.trace.decode:
        return None
    return sum(c.ms for c in run.trace.decode) / len(run.trace.decode)
