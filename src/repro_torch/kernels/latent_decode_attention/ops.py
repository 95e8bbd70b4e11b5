"""Wrapper of the paged latent decode kernel (DeepSeek-V2's absorbed MLA).

One CUDA source, ``csrc/latent_decode_attention.cu``.  For CUDA tensors
the wrapper launches it on the current stream and counts each launch in
``launches``; for CPU tensors it runs the plain version in ``ref.py``.
There is no fallback: a CUDA call the kernel cannot take raises.

What the kernel takes, fixed (no tuning table): queries of ``LATENT_DIM``
(576 = ``kv_lora_rank`` 512 + ``qk_rope_head_dim`` 64) in bfloat16, a
float32 pool ``(P, page, 576)`` of one layer, the value being the first
``V_DIM`` (512) of each latent, heads a multiple of ``HEADS_PER_BLOCK``.
Its grid is ``(H / 32, B)``: a block takes 32 heads of one row and walks
the row's valid keys 32 at a time, so a row sums its keys in one order
in any batch.  The products run on the tensor cores in bfloat16 with
float32 sums; the pool's float32 values hold bfloat16 numbers (the
latents are computed in bfloat16), so their bfloat16 copy is exact, and
the probabilities are rounded to bfloat16 for the value product.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import LaunchCounts, launch_on, refuse_grad
from repro_torch.kernels.latent_decode_attention.ref import (
    latent_decode_attention_ref)

LATENT_DIM = 576
V_DIM = 512
HEADS_PER_BLOCK = 32

# launches since the last reset (CPU calls are not counted), and each
# thread's own (``common.thread_launches``)
_counts = LaunchCounts("latent", ("launches",))


def __getattr__(name: str):
    # ``launches``: read from the counts
    if name == "launches":
        return _counts.totals["launches"]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def reset_counts() -> None:
    _counts.reset()


def _count() -> None:
    _counts.add(launches=1)


def _check(q, pool, page_table, lengths, v_dim):
    if q.dim() != 3 or pool.dim() != 3 or q.shape[-1] != pool.shape[-1]:
        raise ValueError(f"latent_decode_attention: q must be (B, H, D) and "
                         f"the pool (P, page, D); got {tuple(q.shape)}, "
                         f"{tuple(pool.shape)}")
    B = q.shape[0]
    if page_table.dim() != 2 or page_table.shape[0] != B \
            or tuple(lengths.shape) != (B,):
        raise ValueError("latent_decode_attention: page_table must be "
                         "(B, n_pages) and lengths (B,)")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("latent_decode_attention: page_table and lengths "
                        "must be int32")
    if not 0 < v_dim <= q.shape[-1]:
        raise ValueError(f"latent_decode_attention: v_dim {v_dim} outside "
                         f"the latent's {q.shape[-1]}")
    if len({t.device for t in (q, pool, page_table, lengths)}) != 1:
        raise ValueError("latent_decode_attention: inputs on different "
                         "devices")


def latent_decode_attention(q, pool, page_table, lengths, *, scale: float,
                            v_dim: int):
    """q: (B, H, 576) bfloat16; pool: (P, page, 576) float32; page_table
    (B, n_pages) and lengths (B,) int32, ``lengths[b]`` the position of
    the row's newest key (already in the pool), -1 for padding.  Returns
    (B, H, 512) bfloat16: ``ref.latent_decode_attention_ref``'s function,
    a padding row 0."""
    _check(q, pool, page_table, lengths, v_dim)
    refuse_grad("latent_decode_attention", q, pool)
    if q.device.type == "cpu":
        return latent_decode_attention_ref(q, pool, page_table, lengths,
                                           scale=scale, v_dim=v_dim)
    if q.device.type != "cuda":
        raise ValueError(f"latent_decode_attention: unsupported device "
                         f"{q.device}")
    B, H, D = q.shape
    if D != LATENT_DIM or v_dim != V_DIM:
        raise ValueError(f"latent_decode_attention: the kernel takes a "
                         f"latent of {LATENT_DIM} and values of {V_DIM}; got "
                         f"{D} and {v_dim}")
    if H % HEADS_PER_BLOCK:
        raise ValueError(f"latent_decode_attention: {H} heads are not a "
                         f"multiple of {HEADS_PER_BLOCK}")
    if q.dtype != torch.bfloat16 or pool.dtype != torch.float32:
        raise TypeError(f"latent_decode_attention: the kernel takes bfloat16 "
                        f"queries and a float32 pool; got {q.dtype}, "
                        f"{pool.dtype}")
    tensors = (q, pool, page_table, lengths)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("latent_decode_attention: inputs must be contiguous")
    if q.data_ptr() % 16 or pool.data_ptr() % 16:
        raise ValueError("latent_decode_attention: q and the pool must be "
                         "16-byte aligned")
    lib = build.library()
    out = torch.empty((B, H, V_DIM), dtype=torch.bfloat16, device=q.device)
    err = launch_on(q.device, lambda stream: lib.latent_decode_attention_fwd(
        q.data_ptr(), pool.data_ptr(), page_table.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), float(scale), B, H,
        pool.shape[1], page_table.shape[1], stream))
    build.check(err, "latent_decode_attention_fwd")
    _count()
    return out


__all__ = ["latent_decode_attention", "latent_decode_attention_ref",
           "reset_counts"]
