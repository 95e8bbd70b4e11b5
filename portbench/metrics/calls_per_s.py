"""LLM calls completed inside the window over the window's seconds (a
call that failed is not completed)."""


def read(run):
    done = [r for r in run.in_window() if r.error is None]
    return len(done) / run.seconds
