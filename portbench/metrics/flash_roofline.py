"""The flash prefill kernel's share of its roofline, in %: the
yardstick's least time for every launch of the traced window (one a
layer a prefill call; bytes or operations of the valid query-key pairs)
over the profiler's device time of the kernels named ``flash``."""
from portbench.yardstick.costs import flash_prefill_cost, kernel_time_bound

KERNEL = "flash"


def read(run):
    t = run.trace
    if t is None or not t.prefill:
        return None
    dev = t.kernel_seconds(KERNEL)
    if dev <= 0:
        return None
    m = run.model
    h, hkv = m["num_heads"], m["num_kv_heads"]
    dh = m.get("head_dim") or m["d_model"] // h
    bound = 0.0
    for c in t.prefill:
        for p0, n in zip(c.pos0, c.n):
            bound += kernel_time_bound(*flash_prefill_cost(h, hkv, dh, p0, n))
    return 100.0 * bound * m["num_layers"] / dev
