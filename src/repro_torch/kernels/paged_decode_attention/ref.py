"""Plain PyTorch paged GQA flash-decode: gather the pages dense, then run
the contiguous decode-attention math over them.

The counterpart of ``repro/kernels/paged_decode_attention/ref.py`` (with
the math of ``repro/kernels/decode_attention/ref.py`` it reuses) and the
plain version the CUDA kernel is held against.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention.ref import decode_attention_ref


def paged_decode_attention_ref(q, k_pages, v_pages, page_table, lengths,
                               return_lse: bool = False):
    """q: (B,H,Dh); k_pages/v_pages: (P, page, Hkv, Dh);
    page_table: (B, n_pages) int32; lengths: (B,) int32 (-1 = padding).

    Token position of page slot (i, j) in a row is ``i*page + j``; valid
    while ``<= lengths[b]``.  Returns out (B,H,Dh); with ``return_lse``
    also (m, l).
    """
    B, n_pages = page_table.shape
    _, page_size, Hkv, Dh = k_pages.shape
    T = n_pages * page_size
    idx = page_table.long()
    k = k_pages[idx].reshape(B, T, Hkv, Dh)
    v = v_pages[idx].reshape(B, T, Hkv, Dh)
    kv_positions = torch.arange(T, dtype=torch.int32,
                                device=q.device).expand(B, T)
    return decode_attention_ref(q, k, v, q_positions=lengths,
                                kv_positions=kv_positions,
                                return_lse=return_lse)


def scatter_append_ref(k_pages, v_pages, page_table, lengths, k_new, v_new):
    """The scatter the fused kernel absorbs, written IN PLACE.

    k_new/v_new: (B, Hkv, Dh), written to ``page_table[b, len // page]``
    at offset ``len % page`` for rows with ``0 <= lengths[b]`` whose slot
    lies inside the table.  Padding rows are masked out, never routed to
    an out-of-range page: torch has no drop mode for a scatter.  Returns
    the pools it was given.
    """
    ps, n_pages = k_pages.shape[1], page_table.shape[1]
    rows = torch.nonzero((lengths >= 0) & (lengths // ps < n_pages)
                         ).squeeze(1)
    pos = lengths[rows].long()
    wp = page_table[rows, pos // ps].long()
    wo = pos % ps
    k_pages[wp, wo] = k_new[rows].to(k_pages.dtype)
    v_pages[wp, wo] = v_new[rows].to(v_pages.dtype)
    return k_pages, v_pages


def fused_paged_decode_attention_ref(q, k_pages, v_pages, page_table,
                                     lengths, k_new, v_new,
                                     return_lse: bool = False):
    """Scatter-then-attend: the function the fused kernel computes.  The
    pools are updated in place.  Returns ``(out, k_pages, v_pages)`` (plus
    ``m, l`` between out and the pools with ``return_lse``)."""
    k_pages, v_pages = scatter_append_ref(
        k_pages, v_pages, page_table, lengths, k_new, v_new)
    res = paged_decode_attention_ref(
        q, k_pages, v_pages, page_table, lengths, return_lse=return_lse)
    if return_lse:
        out, m, l = res
        return out, m, l, k_pages, v_pages
    return res, k_pages, v_pages
