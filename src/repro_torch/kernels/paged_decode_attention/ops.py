"""Wrappers of the paged GQA flash-decode kernel.

One CUDA source (``csrc/paged_decode_attention.cu``) gives the three
variants of the JAX package: ``single`` (stages of one page), ``blocked``
(stages of up to ``pages_per_block`` pages, bitwise equal to single) and
``fused`` (blocked with the new token's K/V appended inside the kernel,
bitwise equal to scatter-then-attend).  For CUDA tensors the wrappers
launch it on the current stream and count each launch in ``launches``
and in ``variant_launches`` under the variant it ran; for CPU tensors
they run the plain versions in ``ref.py``; for meta tensors they give
the results' shapes and charge the kernel's work to the op-cost counter
(``cost_hooks``).  There is no fallback: a CUDA call the kernel cannot
take raises.

The kernel splits a row's pages across blocks (flash-decoding over
pages).  ``plan_chunk_pages`` fixes the chunk from the page size and Dh
alone, never from B, the table's width or the lengths, so a row sums its
keys in the same order in any batch; in a call whose table holds more
than one chunk, the last block of each (row, KV head) merges the chunks,
and the call counts in ``split_launches``.  The stage of the copy ring
holds at most ``pages_per_block`` pages and ``STAGE_BYTES`` of K and V;
the bits do not depend on it.

Which variant a model's decode step launches, and with what
``pages_per_block``, is read from the per-shape table ``autotune.json``
beside this module (``kernel_config``), which the sweep in ``tune.py``
writes from the card's timings; a key the table lacks takes its
``"default"`` entry, and a table without one ``DEFAULT_VARIANT`` at
``DEFAULT_PAGES_PER_BLOCK``.  The table never touches the chunk plan.
A caller forces a variant by passing it (``paged_decode_step(variant=)``,
``InferenceEngine(kernel_variant=)``); nothing in the environment does.
"""
from __future__ import annotations

import functools
import json
import os
import threading
from typing import Optional

import torch

from repro_torch import cost_hooks
from repro_torch.kernels import build
from repro_torch.kernels.common import launch_on, refuse_grad
from repro_torch.kernels.paged_decode_attention.ref import (
    fused_paged_decode_attention_ref, paged_decode_attention_ref)

VARIANTS = ("single", "blocked", "fused")
PAGES_PER_BLOCK = (1, 2, 3, 4, 8)
DEFAULT_VARIANT = "fused"
DEFAULT_PAGES_PER_BLOCK = 4
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (8, 16, 32, 64, 128, 256)
MAX_GROUP = 16                  # query heads per KV head
VECTOR_BYTES = 16               # pages are copied 16 bytes a thread
CHUNK_KEYS = 64                 # keys a block covers (32 at Dh=256)
STAGE_BYTES = 16 * 1024         # K and V bytes a stage of the ring holds
RING_STAGES = 2
MAX_SPLIT = 65535               # chunks a table may hold (the grid's z)
_MAX_SMEM = 227 * 1024
_DEFAULT_TABLE = os.path.join(os.path.dirname(__file__), "autotune.json")

# kernel launches since the last reset, all variants (CPU calls are not
# counted), those of each variant (an attend-only call with stages of
# more than one page counts as "blocked"), and those whose table held
# more than one chunk (partials, merged by each row's last block)
launches = 0
variant_launches = dict.fromkeys(VARIANTS, 0)
split_launches = 0
# the engines' loop threads launch concurrently: every update of the
# counts holds the lock, so none is lost
_count_lock = threading.Lock()


def reset_counts() -> None:
    global launches, split_launches
    with _count_lock:
        launches = split_launches = 0
        variant_launches.update(dict.fromkeys(VARIANTS, 0))


def _count(split: bool, variant: str) -> None:
    """Count one launch of ``variant``, and whether it was split."""
    global launches, split_launches
    with _count_lock:
        launches += 1
        variant_launches[variant] += 1
        if split:
            split_launches += 1


def shape_key(page_size: int, n_kv_heads: int, head_dim: int,
              group: int) -> str:
    """The table's key for a pool and query shape, in the JAX package's
    format, so that one key names one shape in both tables."""
    return f"ps{page_size}-hkv{n_kv_heads}-dh{head_dim}-g{group}"


@functools.lru_cache(maxsize=None)
def _load_table(path: str) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return {}


def table() -> dict:
    """The checked-in table (``autotune.json`` beside this module), the
    one ``kernel_config`` reads; ``{}`` where it is missing or
    unreadable."""
    return _load_table(_DEFAULT_TABLE)


def kernel_config(page_size: int, n_kv_heads: int, head_dim: int,
                  group: int) -> dict:
    """``{"variant", "pages_per_block"}`` for a shape: the table's entry
    for its exact key, else the table's ``"default"``, else ``fused`` at
    ``DEFAULT_PAGES_PER_BLOCK``.  An entry's other keys (a JAX table's
    ``grid_layout``) are ignored: the grid here is always ``(B, Hkv,
    chunks)``.  Raises ValueError on a
    variant outside ``VARIANTS`` or pages a block outside
    ``PAGES_PER_BLOCK``."""
    configs = table().get("configs", {})
    cfg = {"variant": DEFAULT_VARIANT,
           "pages_per_block": DEFAULT_PAGES_PER_BLOCK}
    for entry in (configs.get("default"),
                  configs.get(shape_key(page_size, n_kv_heads, head_dim,
                                        group))):
        cfg.update({k: v for k, v in (entry or {}).items() if k in cfg})
    if cfg["variant"] not in VARIANTS:
        raise ValueError(f"paged kernel variant {cfg['variant']!r} not in "
                         f"{VARIANTS}")
    if cfg["pages_per_block"] not in PAGES_PER_BLOCK \
            or isinstance(cfg["pages_per_block"], bool):
        raise ValueError(f"pages_per_block {cfg['pages_per_block']!r} not "
                         f"in {PAGES_PER_BLOCK}")
    return cfg


def plan_chunk_pages(page_size: int, head_dim: int) -> int:
    """Pages of a row each block covers: the whole pages that hold
    ``CHUNK_KEYS`` keys (half at Dh=256), at least one.  It depends on the
    page size and Dh alone: the grid is ``(B, Hkv, ceil(n_pages /
    chunk))`` and a row's order of summation is the same at every B and
    table width."""
    keys = CHUNK_KEYS // 2 if head_dim > 128 else CHUNK_KEYS
    return max(1, keys // page_size)


def row_chunks(length: int, page_size: int, n_pages: int,
               chunk_pages: int) -> int:
    """Chunks that hold a row's live pages (those with positions <=
    ``length``), as the kernel and its merge count them; 0 for padding."""
    live = 0 if length < 0 else min(length // page_size + 1, n_pages)
    return -(-live // chunk_pages)


def stage_pages(pages_per_block: int, page_size: int, head_dim: int,
                elem_bytes: int, chunk_pages: int) -> int:
    """Pages a stage of the copy ring holds: at most ``pages_per_block``,
    the chunk and ``STAGE_BYTES`` of K and V, at least one."""
    page_bytes = 2 * page_size * head_dim * elem_bytes
    return max(1, min(pages_per_block, chunk_pages,
                      STAGE_BYTES // page_bytes))


def smem_bytes(G: int, head_dim: int, page_size: int, elem_bytes: int,
               stage: int, chunk_pages: int) -> int:
    """The split kernel's shared memory (``smem_bytes`` in the source)."""
    sk = stage * page_size
    slots = (chunk_pages * page_size + 1) // 2 * 2
    return RING_STAGES * 2 * sk * head_dim * elem_bytes + 8 * slots \
        + 4 * (G * head_dim + G * sk + G * stage + 2 * G) + 4 * chunk_pages


def append_targets(page_table, lengths, page_size: int):
    """Where a decode step that appends outside the kernel writes each
    row's new K/V row, with no host sync (so it runs on meta tensors too):
    ``(slots, rows, live)`` over the pool's ``P * page`` slots.  A row
    with ``lengths[b] >= 0`` writes its own row at ``page_table[b, len //
    page] * page + len % page``; a padding row repeats the first live
    row's write (its slot and its row), and where no row is live
    ``live`` is false and every row writes that slot's own content back.
    So the pool changes at the live rows' slots and nowhere else, as
    ``scatter_append_ref`` writes it.  Computed once a step."""
    valid = lengths >= 0
    pos = lengths.clamp(min=0).long()
    page = page_table.gather(1, (pos // page_size)[:, None])[:, 0].long()
    slots = page * page_size + pos % page_size
    first = valid.int().argmax()            # 0 where no row is live
    rows = torch.where(valid, torch.arange(lengths.shape[0],
                                           device=lengths.device), first)
    return slots[rows], rows, valid.any()


def append_rows_(pool, targets, new) -> None:
    """Write ``new`` (B, Hkv, Dh), in the pool's dtype, into ``pool`` (P,
    page, Hkv, Dh) IN PLACE at ``append_targets``' slots: one layer's
    append of a step that attends with ``single`` or ``blocked``."""
    slots, rows, live = targets
    flat = pool.view(-1, *pool.shape[2:])
    flat.index_put_((slots,), torch.where(live, new[rows], flat[slots]))


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


def _launch(q, k_pages, v_pages, page_table, lengths, k_new, v_new, ppb,
            variant):
    """Launch ``variant`` on q (B,H,Dh) or (B,1,H,Dh), whose memory is
    the same.  Returns out at q's shape, the f32 buffer that holds m and
    l after ``n_part`` partial values, and ``n_part``."""
    refuse_grad("paged_decode_attention", q, k_pages, v_pages, k_new, v_new)
    if q.device.type == "meta":
        return _on_meta(q, k_pages, page_table, k_new)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device "
                         f"{q.device}")
    B, H, Dh = q.shape[0], q.shape[-2], q.shape[-1]
    _, ps, Hkv, _ = k_pages.shape
    G = H // Hkv
    n_pages = page_table.shape[1]
    if ppb not in PAGES_PER_BLOCK:
        raise ValueError(f"pages_per_block {ppb} not in {PAGES_PER_BLOCK}")
    if Dh not in HEAD_DIMS:
        raise ValueError(f"paged_decode_attention: head_dim {Dh} not in "
                         f"{HEAD_DIMS}")
    if G > MAX_GROUP:
        raise ValueError(f"paged_decode_attention: {G} query heads per KV "
                         f"head exceed {MAX_GROUP}")
    append = k_new is not None
    pooled = (k_pages, v_pages, k_new, v_new) if append else (k_pages,
                                                              v_pages)
    if any(t.data_ptr() % VECTOR_BYTES for t in pooled):
        raise ValueError("paged_decode_attention: pools and new K/V must be "
                         "16-byte aligned")
    chunk = plan_chunk_pages(ps, Dh)
    n_split = -(-n_pages // chunk)
    if n_split > MAX_SPLIT:
        raise ValueError(f"paged_decode_attention: {n_pages} pages make "
                         f"{n_split} chunks, over {MAX_SPLIT}")
    elem = k_pages.element_size()
    stage = stage_pages(ppb, ps, Dh, elem, chunk)
    smem = smem_bytes(G, Dh, ps, elem, stage, chunk)
    if smem > _MAX_SMEM:
        raise ValueError(f"paged_decode_attention: {smem} bytes of shared "
                         f"memory exceed {_MAX_SMEM}")
    lib = build.library()
    out = torch.empty_like(q)
    # one f32 allocation: the chunks' partials (acc, m, l) and the merge's
    # tickets (one int32 per row and KV head) when the table is split,
    # first so that acc stays 16-byte aligned, then m and l, viewed only
    # when the caller asks for them
    n_part = B * H * n_split * (Dh + 2) + B * Hkv if n_split > 1 else 0
    buf = torch.empty(n_part + 2 * B * H, dtype=torch.float32,
                      device=q.device)
    base = buf.data_ptr()
    err = launch_on(q.device, lambda stream: lib.paged_decode_attention_fwd(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), lengths.data_ptr(),
        k_new.data_ptr() if append else None,
        v_new.data_ptr() if append else None, out.data_ptr(),
        base + 4 * n_part, base + 4 * (n_part + B * H),
        base if n_part else None, B, H, Hkv, Dh, ps, n_pages, chunk, stage,
        int(append), DTYPES[q.dtype], DTYPES[k_pages.dtype], stream))
    build.check(err, "paged_decode_attention_fwd")
    _count(n_split > 1, variant)
    return out, buf, n_part


def _on_meta(q, k_pages, page_table, k_new):
    """``_launch``'s results on meta tensors, the kernel's work charged:
    the lengths are not known there, so every slot the table names is
    read (as a row as long as the table reads them), K and V; q read and
    the output written, m and l written, the table and the lengths read,
    and (fused) the new K/V read and written into the pool.  QK^T and PV
    over those slots."""
    B, H, Dh = q.shape[0], q.shape[-2], q.shape[-1]
    _, ps, Hkv, _ = k_pages.shape
    slots = page_table.numel() * ps
    elem = k_pages.element_size()
    nbytes = 2 * slots * Hkv * Dh * elem + 2 * q.numel() * q.element_size() \
        + 2 * B * H * 4 + 4 * (page_table.numel() + B)
    if k_new is not None:
        nbytes += 2 * 2 * k_new.numel() * elem
    cost_hooks.charge(4 * H * Dh * slots, nbytes)
    return (torch.empty_like(q),
            torch.empty(2 * B * H, dtype=torch.float32, device=q.device), 0)


def _lse(buf, n_part, B, H):
    m, l = buf[n_part:].view(2, B, H).unbind(0)
    return m, l


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

    ``variant="single"`` stages one page at a time; ``"blocked"`` (and
    ``"fused"``, which needs the new KV rows and so means blocked here)
    up to ``pages_per_block``.
    """
    q3, squeeze = _squeeze(q)
    variant = variant or DEFAULT_VARIANT
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} not in {VARIANTS}")
    _check(q3, k_pages, v_pages, page_table, lengths)
    if q3.device.type == "cpu":
        out, m, l = paged_decode_attention_ref(
            q3, k_pages, v_pages, page_table, lengths, return_lse=True)
        if squeeze:
            out = out[:, None]
        return (out, m, l) if return_lse else out
    ppb = 1 if variant == "single" else (
        pages_per_block or DEFAULT_PAGES_PER_BLOCK)
    out, buf, n_part = _launch(q, k_pages, v_pages, page_table, lengths,
                               None, None, ppb,
                               "single" if variant == "single" else "blocked")
    if not return_lse:
        return out
    return (out, *_lse(buf, n_part, *q3.shape[:2]))


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
        if squeeze:
            out = out[:, None]
        if return_lse:
            return out, m, l, k_pages, v_pages
        return out, k_pages, v_pages
    out, buf, n_part = _launch(q, k_pages, v_pages, page_table, lengths,
                               k_new, v_new,
                               pages_per_block or DEFAULT_PAGES_PER_BLOCK,
                               "fused")
    if return_lse:
        return (out, *_lse(buf, n_part, *q3.shape[:2]), k_pages, v_pages)
    return out, k_pages, v_pages
