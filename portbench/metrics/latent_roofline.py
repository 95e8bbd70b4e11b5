"""The latent decode kernel's share of its roofline, in %: the least
time of every launch of the traced window (one a layer a decode step;
the architecture's ``latent_decode_cost``: each valid key's float32
latent, the bf16 absorbed query and output; bf16 tensor-core FLOPs)
over the profiler's device time of the kernels named ``latent_decode``.
None where the architecture has no such kernel or the window ran none."""
from portbench.yardstick.costs import kernel_time_bound

KERNEL = "latent_decode"


def read(run):
    t = run.trace
    cost = getattr(run.cell.arch, "latent_decode_cost", None)
    if t is None or not t.decode or cost is None:
        return None
    dev = t.kernel_seconds(KERNEL)
    if dev <= 0:
        return None
    m = run.model
    bound = sum(kernel_time_bound(*cost(m, run.page_size, c.lengths))
                for c in t.decode)
    return 100.0 * bound * m["num_layers"] / dev
