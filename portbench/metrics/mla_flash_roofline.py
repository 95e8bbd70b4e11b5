"""The flash kernel's share of its roofline in a latent-attention
model's prefill, in %: the least time of every launch of the traced
window (one a layer a prefill call; the architecture's
``prefill_flash_cost``: the kernel's work as it runs there, every head
zero-padded to ``flash_width``, over the real queries and their causal
keys) over the profiler's device time of the kernels named ``flash``.
None where the architecture has no such cost or the window ran no
prefill."""
from portbench.yardstick.costs import kernel_time_bound

KERNEL = "flash"


def read(run):
    t = run.trace
    cost = getattr(run.cell.arch, "prefill_flash_cost", None)
    if t is None or not t.prefill or cost is None:
        return None
    dev = t.kernel_seconds(KERNEL)
    if dev <= 0:
        return None
    m = run.model
    bound = 0.0
    for c in t.prefill:
        for p0, n in zip(c.pos0, c.n):
            bound += kernel_time_bound(*cost(m, p0, n))
    return 100.0 * bound * m["num_layers"] / dev
