"""Wrappers of the paged GQA flash-decode kernel.

One CUDA source (``csrc/paged_decode_attention.cu``) gives the three
variants of the JAX package: ``single`` (one page per iteration),
``blocked`` (``pages_per_block`` pages per iteration, bitwise equal to
single) and ``fused`` (blocked with the new token's K/V appended inside
the kernel, bitwise equal to scatter-then-attend).  For CUDA tensors the
wrappers launch it on the current stream and count each launch in
``launches``; for CPU tensors they run the plain versions in ``ref.py``.
There is no fallback: a CUDA call the kernel cannot take raises.

The variant is a built-in default (``fused``, 4 pages per block); no
autotune table is kept until the variants are timed on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_decode_attention.ref import (
    fused_paged_decode_attention_ref, paged_decode_attention_ref)

VARIANTS = ("single", "blocked", "fused")
PAGES_PER_BLOCK = (1, 2, 3, 4, 8)
DEFAULT_VARIANT = "fused"
DEFAULT_PAGES_PER_BLOCK = 4
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_ROW_ELEMS = 1024           # G * Dh: 4 (row, column) pairs x 256 threads
_MAX_SMEM = 227 * 1024

# kernel launches since the last reset, all variants (CPU calls are not
# counted)
launches = 0


def _check(q, k_pages, v_pages, page_table, lengths, k_new=None,
           v_new=None):
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"paged_decode_attention: q must be (B,H,Dh) and "
                         f"the pools (P,page,Hkv,Dh); got {tuple(q.shape)}, "
                         f"{tuple(k_pages.shape)}, {tuple(v_pages.shape)}")
    B, H, Dh = q.shape
    _, _, Hkv, Dhp = k_pages.shape
    if Dhp != Dh or H % Hkv:
        raise ValueError(f"paged_decode_attention: q {tuple(q.shape)} does "
                         f"not match pool {tuple(k_pages.shape)}")
    if page_table.dim() != 2 or page_table.shape[0] != B \
            or tuple(lengths.shape) != (B,):
        raise ValueError("paged_decode_attention: page_table must be "
                         "(B, n_pages) and lengths (B,)")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("paged_decode_attention: page_table and lengths "
                        "must be int32")
    if q.dtype not in DTYPES or k_pages.dtype not in DTYPES \
            or v_pages.dtype != k_pages.dtype:
        raise TypeError(f"paged_decode_attention: q and pools must be "
                        f"float32 or bfloat16, pools alike; got {q.dtype}, "
                        f"{k_pages.dtype}, {v_pages.dtype}")
    tensors = [q, k_pages, v_pages, page_table, lengths]
    if k_new is not None:
        if tuple(k_new.shape) != (B, Hkv, Dh) or k_new.shape != v_new.shape:
            raise ValueError("paged_decode_attention: k_new/v_new must be "
                             "(B, Hkv, Dh)")
        if k_new.dtype != k_pages.dtype or v_new.dtype != v_pages.dtype:
            raise TypeError("paged_decode_attention: k_new/v_new must be in "
                            "the pool's dtype")
        tensors += [k_new, v_new]
    if len({t.device for t in tensors}) != 1:
        raise ValueError("paged_decode_attention: inputs on different "
                         "devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_decode_attention: inputs must be contiguous")


def _launch(q, k_pages, v_pages, page_table, lengths, k_new, v_new, ppb):
    global launches
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device "
                         f"{q.device}")
    B, H, Dh = q.shape
    _, ps, Hkv, _ = k_pages.shape
    G = H // Hkv
    if ppb not in PAGES_PER_BLOCK:
        raise ValueError(f"pages_per_block {ppb} not in {PAGES_PER_BLOCK}")
    if G * Dh > _MAX_ROW_ELEMS:
        raise ValueError(f"paged_decode_attention: G*Dh = {G * Dh} exceeds "
                         f"{_MAX_ROW_ELEMS}")
    smem = 4 * (G * Dh + 2 * ppb * ps * Dh + G * ppb * ps)
    if smem > _MAX_SMEM:
        raise ValueError(f"paged_decode_attention: {smem} bytes of shared "
                         f"memory exceed {_MAX_SMEM}")
    lib = build.library()
    out = torch.empty_like(q)
    m = torch.empty((B, H), dtype=torch.float32, device=q.device)
    l = torch.empty((B, H), dtype=torch.float32, device=q.device)
    append = k_new is not None
    with torch.cuda.device(q.device):
        err = lib.paged_decode_attention_fwd(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), lengths.data_ptr(),
            k_new.data_ptr() if append else None,
            v_new.data_ptr() if append else None,
            out.data_ptr(), m.data_ptr(), l.data_ptr(),
            B, H, Hkv, Dh, ps, page_table.shape[1], ppb, int(append),
            DTYPES[q.dtype], DTYPES[k_pages.dtype],
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "paged_decode_attention_fwd")
    launches += 1
    return out, m, l


def _squeeze(q):
    if q.dim() == 4:
        if q.shape[1] != 1:
            raise ValueError("paged_decode_attention: q must hold one token")
        return q[:, 0], True
    return q, False


def paged_decode_attention(q, k_pages, v_pages, page_table, lengths, *,
                           return_lse: bool = False,
                           variant: Optional[str] = None,
                           pages_per_block: Optional[int] = None):
    """q: (B,1,H,Dh) or (B,H,Dh); k_pages/v_pages: (P, page, Hkv, Dh);
    page_table (B, n_pages) int32; lengths (B,) int32 (-1 = padded row).
    Returns the attention output at q's rank (plus ``m, l`` (B,H) f32
    with ``return_lse``).

    ``variant="single"`` walks one page per iteration; ``"blocked"`` (and
    ``"fused"``, which needs the new KV rows and so means blocked here)
    walks ``pages_per_block`` pages per iteration.
    """
    q3, squeeze = _squeeze(q)
    variant = variant or DEFAULT_VARIANT
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} not in {VARIANTS}")
    _check(q3, k_pages, v_pages, page_table, lengths)
    if q3.device.type == "cpu":
        res = paged_decode_attention_ref(q3, k_pages, v_pages, page_table,
                                         lengths, return_lse=True)
    else:
        ppb = 1 if variant == "single" else (
            pages_per_block or DEFAULT_PAGES_PER_BLOCK)
        res = _launch(q3, k_pages, v_pages, page_table, lengths, None, None,
                      ppb)
    out, m, l = res
    if squeeze:
        out = out[:, None]
    return (out, m, l) if return_lse else out


def fused_paged_decode_attention(q, k_pages, v_pages, page_table, lengths,
                                 k_new, v_new, *, return_lse: bool = False,
                                 pages_per_block: Optional[int] = None):
    """Append-then-attend in one kernel launch.

    k_new/v_new: (B, Hkv, Dh), the newest token's KV rows in the pool's
    dtype, written at ``page_table[b, lengths[b] // page] . (lengths[b] %
    page)`` for rows with ``lengths[b] >= 0``; that page must be private
    to the row (``PagedKVCache.prepare_appends``).  The pools are updated
    IN PLACE (the returned pools are the tensors passed in).

    Returns ``(out, k_pages, v_pages)``; with ``return_lse``,
    ``(out, m, l, k_pages, v_pages)``.
    """
    q3, squeeze = _squeeze(q)
    _check(q3, k_pages, v_pages, page_table, lengths, k_new, v_new)
    if q3.device.type == "cpu":
        out, m, l, _, _ = fused_paged_decode_attention_ref(
            q3, k_pages, v_pages, page_table, lengths, k_new, v_new,
            return_lse=True)
    else:
        out, m, l = _launch(q3, k_pages, v_pages, page_table, lengths,
                            k_new, v_new,
                            pages_per_block or DEFAULT_PAGES_PER_BLOCK)
    if squeeze:
        out = out[:, None]
    if return_lse:
        return out, m, l, k_pages, v_pages
    return out, k_pages, v_pages
