"""The paged decode kernel's share of its roofline, in %: the
yardstick's least time for every launch of the traced window (one a
layer a decode step; the live pages of the f32 pool, q, the output and
the appended token) over the profiler's device time of the kernels
named ``paged``."""
from portbench.yardstick.costs import kernel_time_bound, paged_decode_cost

KERNEL = "paged"


def read(run):
    t = run.trace
    if t is None or not t.decode:
        return None
    dev = t.kernel_seconds(KERNEL)
    if dev <= 0:
        return None
    m = run.model
    h, hkv = m["num_heads"], m["num_kv_heads"]
    dh = m.get("head_dim") or m["d_model"] // h
    bound = sum(kernel_time_bound(*paged_decode_cost(
        h, hkv, dh, run.page_size, c.lengths)) for c in t.decode)
    return 100.0 * bound * m["num_layers"] / dev
