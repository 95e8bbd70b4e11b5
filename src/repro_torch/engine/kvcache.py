"""Paged KV cache: refcounted pages on the device, metadata on the host.

The counterpart of ``repro/engine/kvcache.py``.  Layout: one device
tensor per K and V of shape ``(num_layers, num_pages, page_size,
kv_heads, head_dim)``, f32 by default, plus an integer page table per
sequence.  Prefill writes KV rows into freshly allocated pages, decode
writes one token per sequence per step at ``(page, offset)`` (inside the
fused decode kernel on the card), and the paged decode kernel reads the
pages in place.  Only metadata lives on the host: refcounts, the free
list, per-sequence page tables and lengths.

Every write updates the pool tensors IN PLACE (the JAX package returns a
fresh pool array from each update, which at full width is a 1.9 GB
copy); ``self.k``/``self.v`` are the same tensors for the cache's life.

Prefix sharing: pages are refcounted.  A new sequence whose prompt hits a
cached prefix aliases the donor's pages; full pages are immutable, and a
partial trailing page may be aliased too, in which case the first append
by either sequence into a page with refcount > 1 copies it first
(copy-on-write), so neither sequence can corrupt the other's tokens.

Host staging happens only at the migration boundary
(``export_sequence``/``import_sequence``): contiguous f32 numpy
``(L, T, Hkv, Dh)`` blocks, the same wire format as the JAX package, so
KV can move between a JAX engine and a torch engine.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


@dataclass
class SequenceEntry:
    seq_id: int
    page_ids: List[int]
    length: int                      # tokens written


class PagedKVCache:  # requires: InferenceEngine._cv | engine-loop
    """Device-resident paged KV store for one layer-stacked model.

    Thread contract: the cache has no lock of its own; every method runs
    on the owning engine's loop thread or under ``InferenceEngine._cv``
    in a step gap."""

    def __init__(self, num_layers: int, num_pages: int, page_size: int,
                 kv_heads: int, head_dim: int, dtype=torch.float32,
                 device="cuda"):
        self.num_layers = num_layers
        self.num_pages = num_pages
        self.page_size = page_size
        self.kv_heads = kv_heads
        self.head_dim = head_dim
        self.dtype = dtype
        self.device = torch.device(device)
        shape = (num_layers, num_pages, page_size, kv_heads, head_dim)
        self.k = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v = torch.zeros(shape, dtype=dtype, device=self.device)
        self.refcount = np.zeros((num_pages,), np.int64)
        self.free_pages: List[int] = list(range(num_pages - 1, -1, -1))
        self.sequences: Dict[int, SequenceEntry] = {}
        self._next_seq = 0
        self.pages_shared = 0
        self.tokens_reused = 0

    # ------------------------------------------------------------ alloc/free
    def _alloc_page(self) -> int:
        if not self.free_pages:
            raise MemoryError("KV cache out of pages")
        p = self.free_pages.pop()
        self.refcount[p] = 1
        return p

    def _ref_page(self, p: int) -> None:
        self.refcount[p] += 1

    def _unref_page(self, p: int) -> None:
        self.refcount[p] -= 1
        if self.refcount[p] == 0:
            self.free_pages.append(p)

    @property
    def pages_in_use(self) -> int:
        return int((self.refcount > 0).sum())

    # ----------------------------------------------------- device plumbing
    def _on_device(self, a) -> torch.Tensor:
        t = torch.from_numpy(np.array(a)) if isinstance(a, np.ndarray) else a
        return t.to(self.device, self.dtype)

    def _index(self, ids) -> torch.Tensor:
        return torch.as_tensor(list(ids), dtype=torch.long,
                               device=self.device)

    def _page_blocks(self, a) -> torch.Tensor:
        """(L, S, Hkv, Dh) -> (L, n_pages, page, Hkv, Dh), zero-padded to
        whole pages, in pool dtype on device."""
        a = self._on_device(a)
        S = a.shape[1]
        ps = self.page_size
        n = -(-S // ps)
        pad = n * ps - S
        if pad:
            a = F.pad(a, (0, 0, 0, 0, 0, pad))
        return a.reshape(self.num_layers, n, ps, self.kv_heads,
                         self.head_dim)

    def _write_pages(self, pages: List[int], k, v) -> None:
        """Write whole-page blocks into freshly allocated pages."""
        idx = self._index(pages)
        self.k[:, idx] = self._page_blocks(k)
        self.v[:, idx] = self._page_blocks(v)

    def _cow_last_page(self, e: SequenceEntry) -> int:
        """Make the trailing page of ``e`` private (device page copy when
        it is aliased); returns the (possibly new) page id."""
        p = e.page_ids[-1]
        if self.refcount[p] > 1:                 # copy-on-write partial page
            newp = self._alloc_page()
            self.k[:, newp] = self.k[:, p]
            self.v[:, newp] = self.v[:, p]
            self._unref_page(p)
            e.page_ids[-1] = newp
            p = newp
        return p

    # --------------------------------------------------------------- write
    def add_sequence(self, k=None, v=None,
                     shared_from: Optional[int] = None,
                     shared_len: int = 0) -> int:
        """Store a prefilled sequence's KV.  k/v: (L, S, Hkv, Dh) device
        tensors (or numpy at the import boundary) or None.

        If ``shared_from`` names an existing sequence, its first
        ``shared_len`` tokens are aliased.  A non-page-aligned
        ``shared_len`` also aliases the donor's partial page, which stays
        copy-on-write protected: the caller then passes no bulk suffix and
        extends through :meth:`extend_sequence` / :meth:`append_token`.
        """
        ps = self.page_size
        seq_id = self._next_seq
        self._next_seq += 1
        page_ids: List[int] = []
        length = 0

        if shared_from is not None and shared_len:
            donor = self.sequences[shared_from]
            if donor.length < shared_len:
                raise ValueError(f"donor {shared_from} holds {donor.length} "
                                 f"tokens, fewer than {shared_len}")
            n_full, tail = divmod(shared_len, ps)
            n_alias = n_full + (1 if tail else 0)
            for p in donor.page_ids[:n_alias]:
                self._ref_page(p)
                page_ids.append(p)
            length = shared_len
            self.pages_shared += n_alias
            self.tokens_reused += shared_len

        S = 0 if k is None else k.shape[1]
        if S:
            if length % ps:
                raise ValueError("a bulk suffix needs a page-aligned shared "
                                 "prefix; extend_sequence() handles the "
                                 "copy-on-write case")
            pages = [self._alloc_page() for _ in range(-(-S // ps))]
            self._write_pages(pages, k, v)
            page_ids.extend(pages)
            length += S
        self.sequences[seq_id] = SequenceEntry(seq_id, page_ids, length)
        return seq_id

    def extend_sequence(self, seq_id: int, k, v) -> None:
        """Append a bulk KV block (L, S, Hkv, Dh) at the sequence tail:
        fill the trailing partial page first (copy-on-write if aliased),
        then whole pages."""
        e = self.sequences[seq_id]
        k = self._on_device(k)
        v = self._on_device(v)
        S = k.shape[1]
        ps = self.page_size
        off = e.length % ps
        if off and S:
            p = self._cow_last_page(e)
            n = min(ps - off, S)
            self.k[:, p, off:off + n] = k[:, :n]
            self.v[:, p, off:off + n] = v[:, :n]
            e.length += n
            k, v = k[:, n:], v[:, n:]
            S -= n
        if S:
            pages = [self._alloc_page() for _ in range(-(-S // ps))]
            self._write_pages(pages, k, v)
            e.page_ids.extend(pages)
            e.length += S

    def append_token(self, seq_id: int, k_t, v_t) -> None:
        """k_t/v_t: (L, Hkv, Dh), one decode step's KV."""
        p, slot = self.prepare_append(seq_id)
        self.k[:, p, slot] = self._on_device(k_t)
        self.v[:, p, slot] = self._on_device(v_t)
        self.commit_append(seq_id)

    def append_tokens(self, seq_ids: List[int], k_t, v_t) -> None:
        """One decode step's KV for a whole batch: k_t/v_t (L, B, Hkv, Dh)
        device tensors, row b for ``seq_ids[b]``.  Allocates or
        copy-on-writes each trailing page, then lands every row in one
        scatter (the engine's dense-view arm; the paged arm appends inside
        the decode kernel)."""
        pages, slots = self.prepare_appends(seq_ids)
        pi, si = self._index(pages), self._index(slots)
        self.k[:, pi, si] = self._on_device(k_t)
        self.v[:, pi, si] = self._on_device(v_t)
        self.commit_appends(seq_ids)

    def prepare_append(self, seq_id: int) -> Tuple[int, int]:
        """Host-metadata half of a one-token append: allocate the next
        page at a boundary, copy-on-write an aliased trailing page, and
        return the ``(page, offset)`` the token's KV must land at.  The
        caller writes the KV, then bumps the length via
        :meth:`commit_append`."""
        e = self.sequences[seq_id]
        slot = e.length % self.page_size
        if slot == 0:
            e.page_ids.append(self._alloc_page())
            return e.page_ids[-1], 0
        return self._cow_last_page(e), slot

    def commit_append(self, seq_id: int, n: int = 1) -> None:
        self.sequences[seq_id].length += n

    def prepare_appends(self, seq_ids: List[int]
                        ) -> Tuple[List[int], List[int]]:
        """Batch :meth:`prepare_append` for one decode step.  After it,
        every returned page is private to its sequence (refcount 1), the
        contract the fused append+attend kernel relies on to write
        ``(page, offset)`` slots inside the attention launch."""
        pages, offsets = [], []
        for sid in seq_ids:
            p, o = self.prepare_append(sid)
            pages.append(p)
            offsets.append(o)
        return pages, offsets

    def commit_appends(self, seq_ids: List[int], n: int = 1) -> None:
        """Bump lengths once the step that wrote the prepared slots ran."""
        for sid in seq_ids:
            self.commit_append(sid, n)

    # --------------------------------------------------------------- read
    def gather(self, seq_id: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Contiguous (L, T, Hkv, Dh) device copies of a sequence."""
        e = self.sequences[seq_id]
        idx = self._index(e.page_ids)
        L, H, D = self.num_layers, self.kv_heads, self.head_dim
        k = self.k[:, idx].reshape(L, -1, H, D)
        v = self.v[:, idx].reshape(L, -1, H, D)
        return k[:, :e.length], v[:, :e.length]

    def page_table(self, seq_id: int) -> List[int]:
        return list(self.sequences[seq_id].page_ids)

    # --------------------------------------------------------- migration
    def export_sequence(self, seq_id: int,
                        length: Optional[int] = None
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """Contiguous (L, T, Hkv, Dh) f32 host copies of a sequence's first
        ``length`` tokens (default: all): the cross-worker wire format."""
        e = self.sequences[seq_id]
        n = e.length if length is None else min(length, e.length)
        L, H, D = self.num_layers, self.kv_heads, self.head_dim
        if n == 0:
            z = np.zeros((L, 0, H, D), np.float32)
            return z, z.copy()
        idx = self._index(e.page_ids[:-(-n // self.page_size)])
        out_k = self.k[:, idx].reshape(L, -1, H, D)[:, :n]
        out_v = self.v[:, idx].reshape(L, -1, H, D)[:, :n]
        return (out_k.float().cpu().numpy(), out_v.float().cpu().numpy())

    def import_sequence(self, k: np.ndarray, v: np.ndarray) -> int:
        """Adopt a migrated contiguous KV block as a new sequence (the
        inverse of :meth:`export_sequence`); raises MemoryError if the pool
        cannot hold it."""
        if k.shape != v.shape or k.shape[0] != self.num_layers \
                or tuple(k.shape[2:]) != (self.kv_heads, self.head_dim):
            raise ValueError(
                f"imported KV shape {k.shape} does not match cache layout "
                f"(L={self.num_layers}, Hkv={self.kv_heads}, "
                f"Dh={self.head_dim})")
        return self.add_sequence(k=k, v=v)

    def free_sequence(self, seq_id: int) -> None:
        e = self.sequences.pop(seq_id)
        for p in e.page_ids:
            self._unref_page(p)

    # --------------------------------------------------------------- sizing
    def hbm_bytes(self, dtype_bytes: Optional[int] = None) -> int:
        """The pools' bytes on the device, at the pool's own element width
        unless ``dtype_bytes`` is given."""
        if dtype_bytes is None:
            dtype_bytes = self.dtype.itemsize
        return 2 * self.num_layers * self.num_pages * self.page_size \
            * self.kv_heads * self.head_dim * dtype_bytes
