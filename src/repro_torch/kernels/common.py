"""Shared online-softmax building blocks, in plain PyTorch.

The counterpart of ``repro/kernels/common.py``; ``csrc/common.cuh`` holds
the same recurrence as device functions for the CUDA kernels.  f32
accumulation, a running row max ``m`` and normalizer ``l``, and the
``alpha = exp(m_prev - m_new)`` rescale when a chunk raises the max.

Masked-row semantics: a row whose every KV position is masked ends with
``l == 0``; ``finalize_online_softmax`` pins it to ``m = NEG_INF, l = 0``
and a zero output row, so a log-sum-exp combine treats it as empty.

``sm_count`` is the card's SM count, which the split kernels' wrappers
plan their grids by, read once per device; ``launch_on`` hands a launch
the device's current stream; ``refuse_grad`` keeps a kernel without a
backward from dropping a gradient; ``LaunchCounts`` keeps a wrapper's
launch counts, and ``thread_launches`` and ``add_launches`` read and
credit the calling thread's over every kernel that keeps them.
"""
from __future__ import annotations

import functools
import threading
from typing import Dict, Iterable

import torch

# Finite stand-in for -inf: exp(NEG_INF - NEG_INF) stays defined (== 1)
# inside the rescale, unlike a true -inf which would produce NaN.
NEG_INF = -1e30


def qk_logits(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """Scaled q @ k^T in f32: q (R, Dh), k (C, Dh) -> logits (R, C)."""
    return (q.float() @ k.float().T) * scale


def online_softmax_update(logits, mask, v, acc, m_prev, l_prev):
    """One chunk update in f32.

    logits (R, C) raw scores; mask (1|R, C) bool, False = excluded;
    v (C, Dh); acc (R, Dh), m_prev/l_prev (R,) the running state.
    Returns the updated ``(acc, m, l)``.
    """
    logits = torch.where(mask, logits, NEG_INF)
    m_new = torch.maximum(m_prev, logits.amax(dim=-1))
    alpha = torch.exp(m_prev - m_new)
    p = torch.exp(logits - m_new[:, None])
    p = torch.where(mask, p, 0.0)
    l_new = alpha * l_prev + p.sum(dim=-1)
    acc_new = acc * alpha[:, None] + p @ v.float()
    return acc_new, m_new, l_new


def finalize_online_softmax(acc, m, l, *, normalize: bool = True):
    """End of the walk: divide by ``l`` and pin fully-masked rows.

    Returns ``(out_f32, m, l)``; rows with ``l == 0`` get ``out = 0`` and
    ``m = NEG_INF``.  With ``normalize=False`` the accumulator is returned
    unnormalized and the pin still applies.
    """
    empty = l == 0.0
    out = acc / torch.where(empty, 1.0, l)[:, None] if normalize else acc
    out = torch.where(empty[:, None], 0.0, out)
    m = torch.where(empty, NEG_INF, m)
    return out, m, l


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index`` (cached: the
    wrappers' host time bounds a call)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch_on(device: torch.device, launch):
    """Call ``launch(stream)`` with ``device``'s current CUDA stream as an
    int, making the device current only where it is not already.  The raw
    handle (read as PyTorch's generated code reads it) skips building a
    ``torch.cuda.Stream``, and both skips save host time on every call,
    which bounds a decode step."""
    index = device.index
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == torch.cuda.current_device():
        return launch(stream)
    with torch.cuda.device(device):
        return launch(stream)


def refuse_grad(what: str, *tensors) -> None:
    """Raise if grad is enabled and an input requires it.  A kernel
    without a backward writes into a fresh buffer through ``ctypes``, so
    its output has no ``grad_fn``: autograd would drop the gradient of
    every input silently.  The decode-side kernels serve only, under
    ``torch.no_grad()``."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{what}: the CUDA kernel has no backward, and an "
                           f"input requires grad; call it under "
                           f"torch.no_grad()")


class LaunchCounts:
    """One kernel's launch counts by key: over every thread since the last
    ``reset`` (``totals``), and each thread's own since it started.  The
    engines' loop threads launch concurrently, so every update of the
    totals holds the lock; a decode step captured into a CUDA graph reads
    its own thread's counts (``thread_launches``), whatever other threads
    launch meanwhile.  ``kernel`` names the counts in those flat dicts."""

    kept: Dict[str, "LaunchCounts"] = {}

    def __init__(self, kernel: str, keys: Iterable[str]):
        self.kernel = kernel
        self.totals = dict.fromkeys(keys, 0)
        self.lock = threading.Lock()
        self._mine = threading.local()
        LaunchCounts.kept[kernel] = self

    def add(self, **counts: int) -> None:
        with self.lock:
            for k, n in counts.items():
                self.totals[k] += n
        mine = self.mine()
        for k, n in counts.items():
            mine[k] += n

    def reset(self) -> None:
        with self.lock:
            self.totals.update(dict.fromkeys(self.totals, 0))

    def mine(self) -> Dict[str, int]:
        """The calling thread's counts since it started (live)."""
        if not hasattr(self._mine, "n"):
            self._mine.n = dict.fromkeys(self.totals, 0)
        return self._mine.n


def thread_launches() -> Dict[str, int]:
    """The calling thread's launches since it started, of every kernel
    that keeps ``LaunchCounts``: ``{"<kernel>.<key>": n}``."""
    return {f"{c.kernel}.{k}": n for c in LaunchCounts.kept.values()
            for k, n in c.mine().items()}


def add_launches(moved: Dict[str, int]) -> None:
    """Credit the calling thread, and the totals, with launches made
    without calling the wrappers (a CUDA graph's replay), keyed as
    ``thread_launches`` keys them."""
    by_kernel: Dict[str, Dict[str, int]] = {}
    for name, n in moved.items():
        kernel, key = name.split(".", 1)
        by_kernel.setdefault(kernel, {})[key] = n
    for kernel, counts in by_kernel.items():
        LaunchCounts.kept[kernel].add(**counts)
