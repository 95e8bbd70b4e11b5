"""The kernels' launch counters lose no update under concurrent launches.

On the card several engines, each on its own loop thread, launch the same
kernels at once, and ``chip_smoke.py`` asserts on the counts they leave.
Each wrapper counts a launch through its module's ``_count``, which holds
one lock per module; here many threads race through that update path with
a short switch interval, and the totals must come out exact.
"""
import sys
import threading

import pytest

pytest.importorskip("torch")

from repro_torch.kernels.decode_attention import ops as da_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.paged_decode_attention import \
    ops as pd_ops  # noqa: E402
from repro_torch.kernels.rglru_scan import ops as lru_ops  # noqa: E402
from repro_torch.kernels.shared_prefix_attention import \
    ops as sp_ops  # noqa: E402

THREADS = 16
PER_THREAD = 4000

# module, the argument of _count for thread i, the counts and their totals
CASES = {
    "flash": (fa_ops, lambda i: (i % 2 == 0,),
              lambda n, tc: {"launches": n, "tensor_core_launches": tc,
                             "cuda_core_launches": n - tc}),
    "shared_prefix": (sp_ops, lambda i: (i % 2 == 0,),
                      lambda n, tc: {"launches": n,
                                     "tensor_core_launches": tc,
                                     "cuda_core_launches": n - tc}),
    "paged": (pd_ops, lambda i: (i % 2 == 0,
                                 "fused" if i % 2 == 0 else "single"),
              lambda n, s: {"launches": n, "split_launches": s,
                            "variant_launches": {"single": n - s,
                                                 "blocked": 0, "fused": s}}),
    "decode": (da_ops, lambda i: (i % 2 == 0,),
               lambda n, s: {"launches": n, "split_launches": s}),
    "scan": (lru_ops, lambda i: (),
             lambda n, _: {"launches": n}),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_concurrent_counts_are_exact(name):
    mod, args_of, expected = CASES[name]
    mod.reset_counts()
    start = threading.Barrier(THREADS)

    def work(i):
        args = args_of(i)
        start.wait(timeout=30)
        for _ in range(PER_THREAD):
            mod._count(*args)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    n = THREADS * PER_THREAD
    flagged = sum(PER_THREAD for i in range(THREADS) if args_of(i)[:1]
                  == (True,))
    for attr, want in expected(n, flagged).items():
        assert getattr(mod, attr) == want, (attr, getattr(mod, attr), want)
    mod.reset_counts()
    assert mod.launches == 0


def _lock(mod):
    """The lock a module's counts update under: its ``LaunchCounts``'
    where it keeps one."""
    counts = getattr(mod, "_counts", None)
    return mod._count_lock if counts is None else counts.lock


@pytest.mark.parametrize("name", sorted(CASES))
def test_count_updates_under_the_module_lock(name):
    """The update waits for the lock: CPython's interpreter lock alone
    makes ``+=`` on a global atomic only by accident of its bytecode, and
    not at all without it."""
    mod, args_of, _ = CASES[name]
    mod.reset_counts()
    done = threading.Event()

    def count():
        mod._count(*args_of(0))
        done.set()

    with _lock(mod):
        t = threading.Thread(target=count)
        t.start()
        assert not done.wait(timeout=0.2), "counted without the lock"
        assert mod.launches == 0
    assert done.wait(timeout=30)
    t.join(timeout=30)
    assert mod.launches == 1
    mod.reset_counts()
