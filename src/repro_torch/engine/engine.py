"""InferenceEngine — continuous batching over a paged KV cache, in PyTorch.

The counterpart of ``repro/engine/engine.py``.  For full-attention
transformers (the paged path):

* a persistent engine loop owns a fixed-capacity decode batch; requests
  are submitted into it (``submit()`` returns a handle, ``generate()`` is
  submit-then-wait) and are admitted mid-decode, between decode steps;
* variable-length prompts share one batch through per-row lengths and
  attention masking;
* the only KV store is the refcounted device-resident ``PagedKVCache``:
  prefill writes KV rows into pages on the device, and each decode step
  runs ``paged_decode_step`` straight over the pool (on the card: the
  fused append+attend CUDA kernel).  Per step the host uploads O(batch)
  ints (tokens, page tables, lengths) and downloads O(batch) sampled ids
  in one sync;
* prompt prefixes found in the ``RadixPrefixTree`` are served by
  aliasing the donor's pages (copy-on-write guards partial pages) and
  chunk-prefilling only the unseen suffix;
* exact-duplicate (prompt, decode-params) requests are coalesced against
  the in-flight batch (per-request sampling streams are deterministic);
* greedy outputs do not depend on admission timing: rows are computed
  independently and padding is masked.

Two more decode paths, as in the JAX engine:

* dense rows, for models whose ``paged_kv_layout()`` is None (the hybrid
  recurrentgemma: ring-buffer local attention plus recurrent state): no
  pages and no prefix sharing (``kv`` stays None); each admitted request
  keeps its prefill state as one dense cache row, and the rows are
  stacked along ``cache_batch_axes`` into a decode view (batch padded to
  a power of two) whenever the batch composition changes;
* the dense view (``paged_decode=False`` on a paged model), the JAX
  engine's A/B reference: rows are gathered from their pages into a
  dense view, ``decode_step`` runs over it, and each step's new K/V
  (``decode_kv_taps``) is appended back to the pages.

Both decode one token over a dense cache in the ``decode_attention``
kernel.  The engine runs on ``device`` ("cuda" by default; it never moves
to the CPU on its own).
"""
from __future__ import annotations

import contextlib
import threading
import time
import zlib
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.debugsync import named_condition, named_lock
from repro_torch.engine.kvcache import PagedKVCache
from repro_torch.engine.models import build_model
from repro_torch.engine.prefix_tree import RadixPrefixTree
from repro_torch.engine.sampling import batched_sample, sample


@dataclass
class EngineStats:
    prefill_tokens: int = 0
    prefill_tokens_saved: int = 0        # tokens served from shared pages
    decode_tokens: int = 0
    batches: int = 0                     # generate() calls
    coalesced_requests: int = 0
    model_loads: int = 0
    load_seconds: float = 0.0
    prefix_hits: int = 0
    admission_waves: int = 0             # scheduler passes that admitted >=1
    priority_jumps: int = 0              # admissions that bypassed FIFO order
    peak_batch: int = 0                  # max concurrent decode slots
    pages_shared: int = 0                # mirrored from PagedKVCache
    tokens_reused: int = 0               # mirrored from PagedKVCache
    pages_migrated_in: int = 0           # pages imported from a peer engine
    pages_migrated_out: int = 0          # pages exported to a peer engine
    migrate_seconds: float = 0.0         # modeled link-transfer time (import side)
    h2d_bytes: int = 0                   # host->device traffic (KV + step inputs)
    d2h_bytes: int = 0                   # device->host traffic (KV + sampled ids)
    view_rebuilds: int = 0               # dense decode views built

    def as_dict(self) -> Dict[str, float]:
        return dict(self.__dict__)


class EngineError(RuntimeError):
    pass


class RequestHandle:
    """Completion handle for one submitted request.

    ``add_done_callback`` is the per-request pipelining hook: a caller
    can act on each request the moment it retires.
    """

    def __init__(self, rid: int):
        self.rid = rid
        self._event = threading.Event()
        self._result: Optional[List[int]] = None
        self._error: Optional[BaseException] = None
        self._cb_lock = named_lock("RequestHandle._cb_lock")
        self._callbacks: List[Any] = []       # guarded-by: self._cb_lock

    def add_done_callback(self, fn) -> None:
        """Call ``fn(handle)`` when the request completes (or failed).
        Runs on the engine loop thread (or inline if already done)."""
        with self._cb_lock:
            if not self._event.is_set():
                self._callbacks.append(fn)
                return
        fn(self)

    def _fire_callbacks(self) -> None:
        with self._cb_lock:
            cbs, self._callbacks = self._callbacks, []
        for fn in cbs:
            # one misbehaving observer must not fail every in-flight
            # request (or kill the loop thread during _fail_all)
            try:
                fn(self)
            except Exception:
                pass

    def _fulfill(self, tokens: List[int]) -> None:
        self._result = tokens
        self._event.set()
        self._fire_callbacks()

    def _fail(self, err: BaseException) -> None:
        self._error = err
        self._event.set()
        self._fire_callbacks()

    def done(self) -> bool:
        return self._event.is_set()

    def exception(self) -> Optional[BaseException]:
        """The failure, if the request failed (None while pending/ok)."""
        return self._error

    def result(self, timeout: float = 600.0) -> List[int]:
        if not self._event.wait(timeout):
            raise TimeoutError(f"request {self.rid} not finished "
                               f"after {timeout}s")
        if self._error is not None:
            raise self._error
        assert self._result is not None
        return self._result


@dataclass
class _Request:
    rid: int
    prompt: tuple
    extra: Dict[str, Any]
    max_new: int
    temperature: float
    handle: RequestHandle
    priority: int = 0                    # SLO lane (DESIGN.md §10.3)


@dataclass
class _Slot:
    req: _Request
    seq_id: Optional[int] = None         # paged models
    row: Any = None                      # dense rows: a B=1 cache dict
    length: int = 0                      # tokens whose KV is stored
    last_token: int = -1
    remaining: int = 0                   # samples still to produce
    generated: List[int] = field(default_factory=list)
    followers: List[RequestHandle] = field(default_factory=list)
    gen: Optional[torch.Generator] = None
    view_ix: int = -1                    # row index in the current view


class _Defer(Exception):
    """Admission must wait for pages freed by in-flight retirements."""


class InferenceEngine:
    """One engine instance == one worker's resident model."""

    MIN_SHARED_PREFIX = 4        # tokens; below this, page aliasing not worth it
    _T_QUANTUM = 32              # decode time bucket (page-table width)
    _PF_QUANTUM = 16             # chunk-prefill suffix bucket (share points
                                 # are timing-dependent under streaming)

    def __init__(self, cfg: ModelConfig, seed: int = 0, max_batch: int = 8,
                 enable_prefix_sharing: bool = True, page_size: int = 8,
                 num_pages: Optional[int] = None, max_seq_len: int = 512,
                 max_warm_sequences: int = 32, paged_decode: bool = True,
                 admission_window: float = 0.0,
                 kernel_variant: Optional[str] = None,
                 device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "InferenceEngine: device 'cuda' requested but no CUDA device "
                "is available; pass device='cpu' to run on the CPU")
        self.cfg = cfg
        # weights materialise on the device in load()
        self.model = build_model(cfg, device="meta")
        self.seed = seed
        self.max_batch = max_batch
        self.enable_prefix_sharing = enable_prefix_sharing
        self.page_size = page_size
        self.max_seq_len = max_seq_len
        self.max_warm_sequences = max_warm_sequences
        # paged-kernel variant override (None = the built-in default,
        # fused); the A/B arms pin single or blocked
        self.kernel_variant = kernel_variant
        # grace window (seconds): a fresh batch waits this long after the
        # LAST submission before admitting, so near-simultaneous arrivals
        # form one batch.  Applied only while the engine is idle.
        self.admission_window = admission_window
        self._loaded = False     # guarded-by: self._cv | engine-loop
        self.stats = EngineStats()
        self.warm_prefixes = RadixPrefixTree()  # guarded-by: self._cv | engine-loop
        self._paged_layout = self.model.paged_kv_layout()
        # decode straight over the pages, or (dense rows, and the
        # paged_decode=False reference arm) over a dense view
        self._use_paged = bool(self._paged_layout) and paged_decode
        self.num_pages = num_pages or max(
            64, 2 * max_batch * -(-max_seq_len // page_size))
        self.kv: Optional[PagedKVCache] = None   # guarded-by: self._cv | engine-loop
        self._cv = named_condition("InferenceEngine._cv")
        self._pending: "deque[_Request]" = deque()   # guarded-by: self._cv | engine-loop
        self._active: List[_Slot] = []               # guarded-by: self._cv | engine-loop
        self._warm: "OrderedDict[int, tuple]" = OrderedDict()  # guarded-by: self._cv | engine-loop
        self._view: Optional[Dict[str, torch.Tensor]] = None  # guarded-by: self._cv | engine-loop
        self._view_pad = 0               # guarded-by: self._cv | engine-loop
        self._dirty = True               # guarded-by: self._cv | engine-loop
        self._loop_thread: Optional[threading.Thread] = None
        self._stepping = False           # guarded-by: self._cv
        self._shutdown = False           # guarded-by: self._cv
        self._rid = 0                    # guarded-by: self._cv
        self._last_submit = 0.0          # guarded-by: self._cv

    # ---------------------------------------------------------------- weights
    def load(self, state_dict: Optional[Dict[str, torch.Tensor]] = None
             ) -> float:
        """Materialize the weights on the device: random from ``seed``, or
        ``state_dict`` (e.g. ``repro_torch.bridge.params_from_jax``).
        Returns seconds."""
        if self._loaded and state_dict is None:
            return 0.0
        t0 = time.perf_counter()
        with torch.no_grad():
            if self.model.device.type == "meta":
                self.model.to_empty(device=self.device)
            if state_dict is None:
                gen = torch.Generator(device=self.device)
                self.model.init(gen.manual_seed(self.seed))
            else:
                self.model.load_state_dict(state_dict)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        self._loaded = True
        self.stats.model_loads += 1
        self.stats.load_seconds += dt
        return dt

    def unload(self) -> None:
        """Drain in-flight work, then drop weights, pages and warm prefixes."""
        with self._cv:
            self._wait_idle_locked(time.monotonic() + 600.0)
            self.model.to_empty(device="meta")
            self._loaded = False
            self.kv = None
            self._warm.clear()
            self.warm_prefixes = RadixPrefixTree()
            self._view = None
            self._dirty = True

    @property
    def loaded(self) -> bool:
        return self._loaded

    # ----------------------------------------------------------- submission
    def submit(self, prompt: Sequence[int], *, max_new_tokens: int = 16,
               temperature: float = 0.0,
               extra: Optional[Dict[str, Any]] = None,
               priority: int = 0) -> RequestHandle:
        """Enqueue one request into the persistent engine loop.

        Returns immediately; the request joins the running decode batch at
        the next admission pass.  ``priority`` is the SLO lane: each
        admission pass picks the highest-priority waiting request (FIFO
        within a lane).
        """
        if not self._paged_layout \
                and len(prompt) + max_new_tokens > self.max_seq_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds engine max_seq_len ({self.max_seq_len}); dense-row "
                f"caches would wrap and corrupt state")
        with self._cv:
            if self._shutdown:
                raise EngineError("engine is shut down")
            self._rid += 1
            req = _Request(self._rid, tuple(int(t) for t in prompt),
                           dict(extra or {}), max_new_tokens, temperature,
                           RequestHandle(self._rid), priority=int(priority))
            self._pending.append(req)
            self._last_submit = time.monotonic()
            self._ensure_loop()
            self._cv.notify_all()
        return req.handle

    def generate(self, prompts: Sequence[Sequence[int]], *,
                 max_new_tokens: int = 16, temperature: float = 0.0,
                 extras: Optional[List[Dict[str, Any]]] = None,
                 ) -> List[List[int]]:
        """Submit-then-wait over the continuous-batching loop.  Returns one
        generated-token list per prompt (same order)."""
        extras = extras or [{} for _ in prompts]
        handles = [self.submit(p, max_new_tokens=max_new_tokens,
                               temperature=temperature, extra=e)
                   for p, e in zip(prompts, extras)]
        self.stats.batches += 1
        return [h.result() for h in handles]

    # requires: self._cv
    def _wait_idle_locked(self, deadline: float) -> None:
        """Wait (holding _cv) until nothing is queued, nothing is in
        flight, and the loop thread is not inside _step()."""
        while self._pending or self._active or self._stepping:
            if not self._cv.wait(timeout=min(1.0,
                                             deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise TimeoutError("engine drain timed out")

    def drain(self, timeout: float = 600.0) -> None:
        """Block until no request is pending or in flight."""
        with self._cv:
            self._wait_idle_locked(time.monotonic() + timeout)

    def reset_peak_batch(self) -> None:
        """Reset the peak-concurrency watermark to the current batch size."""
        with self._cv:
            self.stats.peak_batch = len(self._active)

    # ------------------------------------------------------- kv migration
    # requires: self._cv
    def _wait_step_gap_locked(self, deadline: float) -> None:
        """Wait (holding _cv) until the loop thread is between steps."""
        while self._stepping:
            if not self._cv.wait(timeout=min(1.0,
                                             deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise TimeoutError("engine never paused between steps")

    # requires: self._cv | engine-loop
    def _find_warm_donor(self, tokens: Sequence[int],
                         cap: Optional[int] = None):
        """Deepest valid warm donor covering a prefix of ``tokens``:
        ``(seq_id, depth)``, or ``(None, 0)``.  ``cap`` bounds the usable
        depth (admission caps at S-1 so one fresh token remains)."""
        kv = self.kv
        if kv is None or not self.enable_prefix_sharing:
            return None, 0
        _, cands = self.warm_prefixes.match_all(tokens)
        for depth, payload in cands:                     # deepest first
            d = depth if cap is None else min(depth, cap)
            if (d >= self.MIN_SHARED_PREFIX and isinstance(payload, int)
                    and payload in kv.sequences
                    and kv.sequences[payload].length >= d):
                return payload, d
        return None, 0

    def probe_prefix(self, prompt: Sequence[int], timeout: float = 60.0
                     ) -> int:
        """Longest warm-donor prefix of ``prompt`` resident here (tokens);
        0 when nothing useful is cached.  Runs in a step gap."""
        if not self._paged_layout:
            return 0                                 # dense rows share nothing
        prompt = tuple(int(t) for t in prompt)
        deadline = time.monotonic() + timeout
        with self._cv:
            self._wait_step_gap_locked(deadline)
            return self._find_warm_donor(prompt)[1]

    def export_prefix(self, prompt: Sequence[int], timeout: float = 60.0):
        """Export the warm KV prefix matching ``prompt`` as ``(tokens, k,
        v)`` (f32 numpy (L, T, Hkv, Dh)), or None when no warm donor covers
        MIN_SHARED_PREFIX tokens.  Runs in a step gap."""
        if not self._paged_layout:
            return None
        prompt = tuple(int(t) for t in prompt)
        deadline = time.monotonic() + timeout
        with self._cv:
            self._wait_step_gap_locked(deadline)
            donor, depth = self._find_warm_donor(prompt)
            if donor is None:
                return None
            k, v = self.kv.export_sequence(donor, depth)
            self.stats.d2h_bytes += k.nbytes + v.nbytes
            return prompt[:depth], k, v

    def import_prefix(self, tokens: Sequence[int], k, v,
                      migrate_seconds: float = 0.0,
                      timeout: float = 60.0) -> int:
        """Adopt a migrated KV prefix as a warm donor.  Best-effort:
        returns the number of pages imported, or 0 when the prefix is
        already resident or the pool has no headroom beyond the active
        batch's decode reservation."""
        tokens = tuple(int(t) for t in tokens)
        if not self._paged_layout or not self.enable_prefix_sharing \
                or len(tokens) < self.MIN_SHARED_PREFIX:
            return 0                                 # donor would be unusable
        deadline = time.monotonic() + timeout
        with self._cv:
            self._wait_step_gap_locked(deadline)
            kv = self._ensure_kv()
            if self._find_warm_donor(tokens)[1] >= len(tokens):
                return 0                             # already resident
            need = -(-len(tokens) // self.page_size)
            # feasibility BEFORE evicting anything: a page is reclaimable
            # only if every reference to it comes from warm sequences
            warm_refs: Dict[int, int] = {}
            for seq_id in self._warm:
                for p in kv.sequences[seq_id].page_ids:
                    warm_refs[p] = warm_refs.get(p, 0) + 1
            reclaimable = sum(1 for p, n in warm_refs.items()
                              if n == kv.refcount[p])
            headroom = len(kv.free_pages) - self._reserved_pages()
            if headroom + reclaimable < need:
                return 0
            while headroom < need and self._warm:    # evict LRU warm only
                victim = next(
                    (s for s in self._warm
                     if any(kv.refcount[p] == 1
                            for p in kv.sequences[s].page_ids)),
                    None) or next(iter(self._warm))
                self._warm.pop(victim)
                kv.free_sequence(victim)
                headroom = len(kv.free_pages) - self._reserved_pages()
            if headroom < need:
                return 0
            seq = kv.import_sequence(k, v)
            self.stats.h2d_bytes += k.nbytes + v.nbytes
            self._warm[seq] = tokens
            self._warm.move_to_end(seq)
            while len(self._warm) > self.max_warm_sequences:
                victim, _ = self._warm.popitem(last=False)
                kv.free_sequence(victim)
            self.warm_prefixes.insert(tokens, payload=seq, stamp_path=True)
            self._maybe_prune_tree()
            pages = len(kv.sequences[seq].page_ids)
            self.stats.pages_migrated_in += pages
            self.stats.migrate_seconds += migrate_seconds
            return pages

    def release_warm(self, timeout: float = 600.0) -> None:
        """Free every warm (retained-for-prefix-reuse) sequence's pages,
        once the engine is idle."""
        with self._cv:
            self._wait_idle_locked(time.monotonic() + timeout)
            for seq_id in list(self._warm):
                self.kv.free_sequence(seq_id)
            self._warm.clear()

    def shutdown(self) -> None:
        with self._cv:
            self._shutdown = True
            self._cv.notify_all()
        if self._loop_thread is not None:
            self._loop_thread.join(timeout=10)

    # ------------------------------------------------------------- the loop
    def _ensure_loop(self) -> None:
        if self._loop_thread is None or not self._loop_thread.is_alive():
            self._loop_thread = threading.Thread(
                target=self._run_loop, daemon=True,
                name=f"engine-{self.cfg.name}")
            self._loop_thread.start()

    def _device_scope(self):
        """The loop thread works on the engine's device explicitly: the
        kernels launch on that device's current stream."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    # runs-on: engine-loop
    def _run_loop(self) -> None:
        with torch.no_grad(), self._device_scope():
            while True:
                with self._cv:
                    while not self._shutdown and not self._pending \
                            and not self._active:
                        self._cv.wait()
                    if self._shutdown:
                        return
                    self._stepping = True
                try:
                    self._step()
                except BaseException as e:              # engine-fatal
                    self._fail_all(e)
                finally:
                    with self._cv:
                        self._stepping = False
                        self._cv.notify_all()

    def _fail_all(self, err: BaseException) -> None:
        with self._cv:
            victims = list(self._pending)
            self._pending.clear()
            slots, self._active = self._active, []
        for req in victims:
            req.handle._fail(err)
        for s in slots:
            s.req.handle._fail(err)
            for f in s.followers:
                f._fail(err)
            # return the slot's pages: a failed batch must not leak them
            if self.kv is not None and s.seq_id in self.kv.sequences:
                try:
                    self.kv.free_sequence(s.seq_id)
                except Exception:
                    pass                        # pool corrupt > pool leaked
        self._dirty = True
        self._view = None

    def _step(self) -> None:
        """One scheduler iteration: admit, then one decode step."""
        self._grace_window()
        self._admit()
        if self._active:
            self._decode_once()

    def _grace_window(self) -> None:
        """Hold a FRESH batch's admission until ``admission_window``
        seconds have passed since the last submission (capped at 10
        windows).  Running batches are never delayed."""
        w = self.admission_window
        if w <= 0 or self._active:
            return
        cap = time.monotonic() + 10 * w
        with self._cv:
            while not self._shutdown and self._pending:
                now = time.monotonic()
                wait = self._last_submit + w - now
                if wait <= 0 or now >= cap:
                    break
                self._cv.wait(timeout=min(wait, cap - now))

    # ------------------------------------------------------------- admission
    def _admit(self) -> None:
        admitted = 0
        while len(self._active) < self.max_batch:
            with self._cv:
                if not self._pending:
                    break
                # highest priority first; max() keeps the FIRST maximum,
                # so equal priorities are exact FIFO
                req = max(self._pending, key=lambda r: r.priority)
                jumped = req is not self._pending[0]
            if self._coalesce(req):
                self._remove_pending(req)
                continue
            try:
                slot = self._admit_one(req)
            except _Defer:
                # left in the queue: a deferred request blocks the pass,
                # so lower-priority work never slips past it
                break
            except BaseException as e:                  # per-request failure
                self._remove_pending(req)
                req.handle._fail(e)
                continue
            # attach still-queued exact duplicates now: a leader that
            # retires within this pass would otherwise leave _active
            # before its duplicates reach _coalesce
            slot.followers.extend(self._claim_pending_duplicates(req))
            if slot.remaining > 0:
                self._active.append(slot)
                admitted += 1
            else:
                self._retire(slot)
            self._remove_pending(req)
            if jumped:
                self.stats.priority_jumps += 1
        if admitted:
            self.stats.admission_waves += 1
            self.stats.peak_batch = max(self.stats.peak_batch,
                                        len(self._active))
            self._dirty = True

    @staticmethod
    def _duplicates(a: _Request, b: _Request) -> bool:
        return (not a.extra and not b.extra and a.prompt == b.prompt
                and a.max_new == b.max_new
                and a.temperature == b.temperature)

    def _coalesce(self, req: _Request) -> bool:
        """Attach an exact duplicate of an in-flight request as follower.
        Per-request sampling streams are a pure function of (engine seed,
        prompt, max_new), so duplicates decode the same tokens at any
        temperature."""
        if req.extra:
            return False
        for s in self._active:
            if self._duplicates(s.req, req):
                s.followers.append(req.handle)
                self.stats.coalesced_requests += 1
                return True
        return False

    def _claim_pending_duplicates(self, req: _Request) -> List[RequestHandle]:
        """Pop every exact duplicate of ``req`` still waiting in _pending
        and return their handles."""
        if req.extra:
            return []
        out: List[RequestHandle] = []
        with self._cv:
            kept: "deque[_Request]" = deque()
            for r in self._pending:
                if r is not req and self._duplicates(r, req):
                    out.append(r.handle)
                else:
                    kept.append(r)
            self._pending = kept
        self.stats.coalesced_requests += len(out)
        return out

    def _request_gen(self, req: _Request) -> torch.Generator:
        """Per-request sampling stream, stable under reordering: seeded
        from (engine seed, crc32 of the prompt, max_new)."""
        h = zlib.crc32(np.asarray(req.prompt, np.int64).tobytes())
        h = zlib.crc32(np.asarray([req.max_new], np.int64).tobytes(), h)
        h = zlib.crc32(np.asarray([self.seed], np.int64).tobytes(), h)
        return torch.Generator(device=self.device).manual_seed(h)

    # requires: self._cv | engine-loop
    def _ensure_kv(self) -> PagedKVCache:
        if self.kv is None:
            layers, kv_heads, head_dim = self._paged_layout
            self.kv = PagedKVCache(layers, self.num_pages, self.page_size,
                                   kv_heads, head_dim, device=self.device)
        return self.kv

    def _remove_pending(self, req: _Request) -> None:
        with self._cv:
            try:
                self._pending.remove(req)
            except ValueError:       # already claimed as a duplicate
                pass

    # requires: self._cv | engine-loop
    def _reserved_pages(self) -> int:
        """Pages the in-flight batch may still allocate (one token per
        remaining step, +1 page of boundary slack per slot)."""
        ps = self.page_size
        return sum(-(-s.remaining // ps) + 1 for s in self._active)

    # requires: self._cv | engine-loop
    def _ensure_pages(self, needed: int, protect: Optional[int] = None) -> None:
        """Evict warm sequences (LRU, never ``protect``) until ``needed``
        pages are free beyond the active batch's decode reservation;
        defer admission if in-flight work will free more."""
        kv = self.kv
        if needed > kv.num_pages:
            raise MemoryError(
                f"request needs {needed} KV pages but the pool holds only "
                f"{kv.num_pages} ({kv.page_size} tokens/page); raise "
                f"num_pages/max_seq_len or shrink the prompt / "
                f"max_new_tokens")
        needed += self._reserved_pages()
        while len(kv.free_pages) < needed:
            victim = next((s for s in self._warm if s != protect), None)
            if victim is None:
                if self._active:
                    raise _Defer()
                raise MemoryError(
                    f"KV cache out of pages ({needed} needed, "
                    f"{len(kv.free_pages)} free, no warm sequences left)")
            self._warm.pop(victim)
            kv.free_sequence(victim)

    def _tokens(self, rows) -> torch.Tensor:
        return torch.as_tensor(rows, dtype=torch.int32).to(self.device)

    def _admit_one(self, req: _Request) -> _Slot:
        if not self._loaded:
            self.load()
        if {"patch_embeds", "frames"} & set(req.extra):
            raise NotImplementedError(
                "multimodal requests are not ported yet (ROADMAP Queue 1)")
        S = len(req.prompt)
        slot = _Slot(req=req, remaining=req.max_new,
                     gen=self._request_gen(req))
        if not self._paged_layout:
            # dense row: the prefill state, grown to the engine's horizon
            logits, cache = self.model.prefill(self._tokens([req.prompt]))
            slot.row = self.model.extend_cache(cache, self.max_seq_len - S)
            slot.length = S
            self.stats.prefill_tokens += S
            if req.max_new > 0:
                self._emit_token(slot, logits[0:1])
            return slot
        shareable = self.enable_prefix_sharing and not req.extra and S > 1
        kv = self._ensure_kv()
        donor, shared = None, 0
        if shareable:
            # deepest-first; cap at S-1 so one fresh token remains
            donor, shared = self._find_warm_donor(req.prompt, cap=S - 1)
        self._ensure_pages(-(-(S - shared + req.max_new) // self.page_size)
                           + 1, protect=donor)
        if donor is not None:
            logits = self._prefill_shared(slot, donor, shared)
            self.stats.prefix_hits += 1
            self.stats.prefill_tokens += S - shared
            self.stats.prefill_tokens_saved += shared
        elif not req.extra:
            # cold prompts run the SAME bucketed chunk-prefill step as
            # shared ones, so padding shapes do not depend on timing
            logits = self._prefill_cold(slot)
            self.stats.prefill_tokens += S
        else:
            logits, cache = self.model.prefill(self._tokens([req.prompt]))
            slot.seq_id = kv.add_sequence(
                *self.model.cache_kv_rows_dev(cache, 0, S))
            self.stats.prefill_tokens += S
        slot.length = kv.sequences[slot.seq_id].length
        if shareable:
            self.warm_prefixes.insert(req.prompt, payload=slot.seq_id,
                                      stamp_path=True)
        self.stats.pages_shared = kv.pages_shared
        self.stats.tokens_reused = kv.tokens_reused
        if req.max_new > 0:
            self._emit_token(slot, logits[0:1])
        return slot

    def _chunk_view(self, T1: int, prefix=None):
        """An empty (or prefix-filled) dense (1, L, T1, Hkv, Dh) view for
        the chunk prefill, in the model dtype, on the device."""
        layers, heads, dh = self._paged_layout
        k_rows = torch.zeros((1, layers, T1, heads, dh),
                             dtype=self.model.dtype, device=self.device)
        v_rows = torch.zeros_like(k_rows)
        n = 0
        if prefix is not None:
            kp, vp = prefix
            n = kp.shape[1]
            k_rows[0, :, :n] = kp
            v_rows[0, :, :n] = vp
        return self.model.paged_cache_view(k_rows, v_rows, [n])

    def _prefill_cold(self, slot: _Slot):
        """Prefill a donor-less prompt via the bucketed chunk step over an
        empty cache view (one shape per (suffix bucket, time bucket))."""
        req = slot.req
        S = len(req.prompt)
        pad = -(-S // self._PF_QUANTUM) * self._PF_QUANTUM
        cache = self._chunk_view(self._round_t(pad + req.max_new))
        toks = self._tokens([list(req.prompt) + [0] * (pad - S)])
        logits, cache = self.model.prefill_with_cache(
            toks, cache, valid_len=self._tokens([S]))
        slot.seq_id = self.kv.add_sequence(
            *self.model.cache_kv_rows_dev(cache, 0, S))
        return logits

    def _prefill_shared(self, slot: _Slot, donor: int, shared: int):
        """Admit via page aliasing: reuse the donor's first ``shared``
        tokens, chunk-prefill only the unseen suffix, append its KV."""
        kv = self.kv
        req = slot.req
        seq = kv.add_sequence(shared_from=donor, shared_len=shared)
        slot.seq_id = seq
        S = len(req.prompt)
        # pad the suffix to a quantum: the share point depends on which
        # prefixes happen to be warm at admission time
        n_suf = S - shared
        pad = -(-n_suf // self._PF_QUANTUM) * self._PF_QUANTUM
        cache = self._chunk_view(self._round_t(shared + pad + req.max_new),
                                 prefix=kv.gather(seq))
        suffix = self._tokens(
            [list(req.prompt[shared:]) + [0] * (pad - n_suf)])
        logits, cache = self.model.prefill_with_cache(
            suffix, cache, valid_len=self._tokens([n_suf]))
        k_row, v_row = self.model.cache_kv_rows_dev(cache, 0, S)
        kv.extend_sequence(seq, k_row[:, shared:], v_row[:, shared:])
        return logits

    # ---------------------------------------------------------------- decode
    def _round_t(self, n: int) -> int:
        q = self._T_QUANTUM
        return -(-n // q) * q

    @staticmethod
    def _round_b(n: int) -> int:
        b = 1
        while b < n:
            b *= 2
        return b

    def _rebuild_view(self) -> None:
        """Re-materialize the dense decode batch after a composition change.

        Paged models gather every active row from its pages on the device
        (the pages stay authoritative); dense-row models restack their
        per-request rows along ``cache_batch_axes``.  The batch is padded
        to a power of two and, for paged models, time to ``_T_QUANTUM``;
        padded rows compute garbage that is never sampled or written back.
        """
        slots = self._active
        b_pad = self._round_b(len(slots))
        self.stats.view_rebuilds += 1
        if self._paged_layout:
            t_view = self._round_t(max(s.length + s.remaining for s in slots))
            layers, heads, dh = self._paged_layout
            k_rows = torch.zeros((b_pad, layers, t_view, heads, dh),
                                 dtype=self.model.dtype, device=self.device)
            v_rows = torch.zeros_like(k_rows)
            lengths = [0] * b_pad
            for i, s in enumerate(slots):
                kr, vr = self.kv.gather(s.seq_id)
                k_rows[i, :, :s.length] = kr
                v_rows[i, :, :s.length] = vr
                lengths[i] = s.length
            self._view = self.model.paged_cache_view(k_rows, v_rows, lengths)
        else:
            rows = self._dense_rows() + [None] * (b_pad - len(slots))
            axes = self.model.cache_batch_axes(rows[0])
            dummy = {k: torch.zeros_like(v) for k, v in rows[0].items()}
            rows = [dummy if r is None else r for r in rows]
            self._view = {key: torch.cat([r[key] for r in rows], dim=ax)
                          for key, ax in axes.items()}
        self._view_pad = b_pad
        self._dirty = False

    def _dense_rows(self) -> List[Dict[str, torch.Tensor]]:
        """Per-slot cache rows; slots already in the current view are
        sliced back out of it (they carry the decoded state)."""
        out = []
        for s in self._active:
            if s.row is None:
                s.row = self._slice_row(self._view, s.view_ix)
            out.append(s.row)
            s.row = None                    # ownership moves into the view
        return out

    def _slice_row(self, view, ix: int) -> Dict[str, torch.Tensor]:
        axes = self.model.cache_batch_axes(view)
        return {k: v.narrow(axes[k], ix, 1) for k, v in view.items()}

    def _decode_once(self) -> None:
        if self._use_paged:
            self._decode_paged()
            return
        if self._dirty:
            self._rebuild_view()
            for i, s in enumerate(self._active):
                s.view_ix = i
        slots = self._active
        b_real = len(slots)
        tokens = np.zeros((self._view_pad,), np.int32)
        tokens[:b_real] = [s.last_token for s in slots]
        prev_lengths = [s.length for s in slots]
        self.stats.h2d_bytes += tokens.nbytes
        logits, self._view = self.model.decode_step(self._tokens(tokens),
                                                    self._view)
        if self._paged_layout:
            # the step's new K/V back into the pages (identity slots: a
            # full-attention view does not wrap)
            k_taps, v_taps = self.model.decode_kv_taps(self._view,
                                                       prev_lengths)
            self.kv.append_tokens([s.seq_id for s in slots], k_taps, v_taps)
        for s in slots:
            s.length += 1
        self.stats.decode_tokens += b_real
        self._advance(logits)

    def _decode_paged(self) -> None:
        """One decode step straight over the device-resident page pool:
        upload O(batch) metadata (tokens, page tables, lengths), run the
        paged step (the pool is written in place), download O(batch)
        sampled ids."""
        kv = self.kv
        slots = self._active
        b_real = len(slots)
        # page alloc + COW (host metadata): after this every write-target
        # page is private to its row, the fused kernel's safety contract
        kv.prepare_appends([s.seq_id for s in slots])
        b_pad = self._round_b(b_real)
        t_cap = self._round_t(max(s.length + s.remaining for s in slots))
        n_pages = -(-t_cap // self.page_size)
        pt = np.zeros((b_pad, n_pages), np.int32)
        lens = np.full((b_pad,), -1, np.int32)
        tokens = np.zeros((b_pad,), np.int32)
        for i, s in enumerate(slots):
            ids = kv.sequences[s.seq_id].page_ids
            pt[i, :len(ids)] = ids
            lens[i] = s.length
            tokens[i] = s.last_token
        self.stats.h2d_bytes += pt.nbytes + lens.nbytes + tokens.nbytes
        logits, _, _ = self.model.paged_decode_step(
            self._tokens(tokens), kv.k, kv.v, self._tokens(pt),
            self._tokens(lens), variant=self.kernel_variant)
        kv.commit_appends([s.seq_id for s in slots])
        for s in slots:
            s.length += 1
        self.stats.decode_tokens += b_real
        self._advance(logits)

    def _emit_token(self, slot: _Slot, logits) -> None:
        """Sample one token for ``slot`` from (1, Vpad) logits."""
        nxt = sample(logits, slot.gen, temperature=slot.req.temperature,
                     vocab_size=self.cfg.vocab_size)
        tok = int(nxt[0])
        slot.generated.append(tok)
        slot.last_token = tok
        slot.remaining -= 1

    def _advance(self, logits) -> None:
        """Advance every active slot from one decode step's logits: the
        whole (B, Vpad) batch is sampled on the device and synced once."""
        slots = list(self._active)
        temps = [s.req.temperature for s in slots]
        toks = batched_sample(logits[:len(slots)], temps,
                              [s.gen for s in slots],
                              vocab_size=self.cfg.vocab_size).cpu().numpy()
        self.stats.d2h_bytes += toks.nbytes
        finished = []
        for i, s in enumerate(slots):
            tok = int(toks[i])
            s.generated.append(tok)
            s.last_token = tok
            s.remaining -= 1
            if s.remaining == 0:
                finished.append(s)
        for s in finished:
            self._active.remove(s)
            self._retire(s)
        if finished:
            self._dirty = True

    def _retire(self, slot: _Slot) -> None:
        req = slot.req
        if slot.seq_id is not None:
            if self.enable_prefix_sharing and not req.extra:
                self._warm[slot.seq_id] = req.prompt
                self._warm.move_to_end(slot.seq_id)
                while len(self._warm) > self.max_warm_sequences:
                    victim, _ = self._warm.popitem(last=False)
                    self.kv.free_sequence(victim)
                self._maybe_prune_tree()
            else:
                self.kv.free_sequence(slot.seq_id)
        out = list(slot.generated)
        req.handle._fulfill(out)
        for f in slot.followers:
            f._fulfill(list(out))

    # requires: self._cv | engine-loop
    def _maybe_prune_tree(self) -> None:
        """Rebuild the radix tree from live donors once stale entries
        dominate, so a long-lived engine does not grow it forever."""
        if self.warm_prefixes.num_sequences <= 8 * self.max_warm_sequences:
            return
        tree = RadixPrefixTree()
        for seq_id, prompt in self._warm.items():
            tree.insert(prompt, payload=seq_id, stamp_path=True)
        for s in self._active:
            if s.seq_id is not None and not s.req.extra:
                tree.insert(s.req.prompt, payload=s.seq_id, stamp_path=True)
        self.warm_prefixes = tree
