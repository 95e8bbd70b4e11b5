"""Model FLOPs of the tokens the traced window computed, over the
window's seconds at the card's bf16 peak, in %.  A token's FLOPs are the
configuration's architecture's count (``archs/<arch>.py``,
``token_flops``; for ``gqa``: 2 x the weights it multiplies through, the
top-k and shared experts of an MoE layer, plus attention over its live
context); decode rows attend over their stored tokens and the new one,
prefill tokens over the positions before them and themselves."""
from portbench.yardstick.peaks import PEAK_FLOPS_BF16


def _contexts(t):
    for c in t.decode:
        for ln in c.lengths:
            if ln >= 0:
                yield ln + 1
    for c in t.prefill:
        for p0, n in zip(c.pos0, c.n):
            yield from range(p0 + 1, p0 + n + 1)


def read(run):
    t = run.trace
    if t is None or not (t.decode or t.prefill):
        return None
    flops = run.cell.arch.token_flops(run.model, _contexts(t))
    return 100.0 * flops / (t.window_s * PEAK_FLOPS_BF16)
