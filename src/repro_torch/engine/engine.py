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
  paged kernel the model picks).  Per step the host uploads O(batch)
  ints (tokens, page tables, lengths) and downloads O(batch) sampled ids
  in one sync.  The engine does not know what a pool's planes hold: it
  passes the model the pool's (K, V) pair and builds its dense views one
  zero tensor a plane (``PagedKVCache.plane_rows``);
* prompt prefixes found in the ``RadixPrefixTree`` are served by
  aliasing the donor's pages (copy-on-write guards partial pages) and
  chunk-prefilling only the unseen suffix;
* the cold prompts one admission pass takes (no warm donor, no extras)
  are chunk-prefilled together, as the rows of as few calls as fit
  ``_PF_BUDGET`` padded tokens, where the model states that a row's
  result does not depend on the rows beside it
  (``prefill_rows_independent``); otherwise one row a call;
* exact-duplicate (prompt, decode-params) requests are coalesced against
  the in-flight batch (per-request sampling streams are deterministic);
* in exact arithmetic (float32, as the tests run) greedy outputs do not
  depend on admission timing: rows are computed independently and
  padding is masked.  In bf16 a GEMM's rounding follows its row count
  and padded width, so a cold request's first token can depend on the
  prompts prefilled in the same call, as its later tokens depend on the
  rows decoded beside it.

Multimodal requests carry their stub frontend's output in ``extra``, as
in the JAX engine: a VLM request ``patch_embeds`` (1, P, d_model),
prefilled in full with the patches ahead of its tokens (its pages hold
P + S rows and decode starts at position P + S); an audio request
``frames`` (1, T, d_model), encoded at its admission.  Numpy arrays or
tensors, moved to the engine's device in the model dtype.  A request with
extras neither shares a prefix nor coalesces.

Two more decode paths, as in the JAX engine:

* dense rows, for models whose ``paged_kv_layout()`` is None (the hybrid
  recurrentgemma: ring-buffer local attention plus recurrent state; the
  xLSTM's recurrent state; whisper's decoder KV and the cross-attention
  KV over its frames): no pages and no prefix sharing (``kv`` stays
  None); each admitted request keeps its prefill state as one dense
  cache row, and the rows are stacked along ``cache_batch_axes`` into a
  decode view (batch padded to a power of two) whenever the batch
  composition changes;
* the dense view (``paged_decode=False`` on a paged model), the JAX
  engine's A/B reference: rows are gathered from their pages into a
  dense view, ``decode_step`` runs over it, and each step's new K/V
  (``decode_kv_taps``) is appended back to the pages.  It needs a pool
  of a K and a V plane.

Both decode one token over a dense cache, attention in the
``decode_attention`` kernel.  The engine runs on ``device`` ("cuda" by
default; it never moves to the CPU on its own).
"""
from __future__ import annotations

import contextlib
import threading
import time
import zlib
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.debugsync import named_condition, named_lock
from repro_torch.engine.kvcache import PagedKVCache, kv_pair
from repro_torch.engine.models import build_model
from repro_torch.engine.prefix_tree import RadixPrefixTree
from repro_torch.engine.sampling import batched_sample
from repro_torch.engine.spans import SpanRecorder


@dataclass
class EngineStats:
    prefill_tokens: int = 0
    prefill_tokens_saved: int = 0        # tokens served from shared pages
    prefill_rows: int = 0                # rows of chunk-prefill calls
    decode_tokens: int = 0
    batches: int = 0                     # generate() calls
    coalesced_requests: int = 0
    model_loads: int = 0
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
    widest_decode_table: int = 0         # most pages a paged decode table held
    host_syncs: int = 0                  # blocking host<->device transfers
    admit_deferrals: int = 0             # admissions deferred for pages
    warm_evictions: int = 0              # warm sequences freed
    tree_rebuilds: int = 0               # radix-tree prunes
    spans: SpanRecorder = field(default_factory=SpanRecorder, repr=False)
    # the model's own counters, where it keeps some (``counters()``)
    probes: Optional[Callable[[], Dict[str, float]]] = field(
        default=None, repr=False)

    def as_dict(self) -> Dict[str, float]:
        """The counters, the engine loop's span totals flattened
        (``SpanRecorder.as_dict``) and the model's ``probes`` (a device
        counter among them is read here, the only place it is).  The key
        set is fixed at construction: another thread may call this while
        the loop runs."""
        out = {k: v for k, v in self.__dict__.items()
               if k not in ("spans", "probes")}
        out.update(self.spans.as_dict())
        if self.probes is not None:
            out.update(self.probes())
        return out


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
    _PF_BUDGET = 4096            # padded tokens (rows x widest bucket) of a
                                 # batched cold prefill call: its chunk view
                                 # and activations stay within a few GB at
                                 # deepseek-67b's widths

    def __init__(self, cfg: ModelConfig, seed: int = 0, max_batch: int = 8,
                 enable_prefix_sharing: bool = True, page_size: int = 8,
                 num_pages: Optional[int] = None, max_seq_len: int = 512,
                 max_warm_sequences: int = 32, paged_decode: bool = True,
                 admission_window: float = 0.0,
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
        # grace window (seconds): a fresh batch waits this long after the
        # LAST submission before admitting, so near-simultaneous arrivals
        # form one batch.  Applied only while the engine is idle.
        self.admission_window = admission_window
        self._loaded = False     # guarded-by: self._cv | engine-loop
        self.stats = EngineStats()
        # a model's own counters (its decode graphs', an expert layer's),
        # read with the engine's
        self.stats.probes = getattr(self.model, "counters", None)
        # the loop thread's spans (runs-on: engine-loop only)
        self._span = self.stats.spans.span
        self.warm_prefixes = RadixPrefixTree()  # guarded-by: self._cv | engine-loop
        self._paged_layout = self.model.paged_kv_layout()
        # decode straight over the pages, or (dense rows, and the
        # paged_decode=False reference arm) over a dense view
        self._use_paged = bool(self._paged_layout) and paged_decode
        if self._paged_layout:
            # a token's row in each of the pool's planes, as the chunk
            # and dense views hold it
            self._plane_rows = PagedKVCache.plane_rows(
                *self._paged_layout[1:])
            if not paged_decode and len(self._plane_rows) != 2:
                raise NotImplementedError(
                    f"{cfg.name}: the dense view (paged_decode=False) "
                    f"needs a K and a V plane; this model's pool holds "
                    f"{len(self._plane_rows)}")
        # cold prompts of one pass share a chunk-prefill call only where a
        # row's result does not depend on the rows beside it
        self._batch_prefill = bool(self._paged_layout) \
            and self.model.prefill_rows_independent
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
            # the stream the weights were made on, not the whole device:
            # another engine's loop may be capturing a decode graph, and a
            # device-wide sync is refused while a stream captures
            torch.cuda.current_stream(self.device).synchronize()
        dt = time.perf_counter() - t0
        self._loaded = True
        self.stats.model_loads += 1
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

    def param_bytes(self) -> int:
        """Bytes of the model's weights on the device when loaded, each
        leaf at its own dtype (an MoE router stays float32); read from the
        shapes, so it holds before ``load`` and after ``unload``."""
        return sum(w.numel() * w.element_size()
                   for w in self.model.parameters())

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
                self.stats.warm_evictions += 1
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
                self.stats.warm_evictions += 1
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
                    if not self._work_or_shutdown():
                        with self._span("engine.idle"):
                            while not self._work_or_shutdown():
                                self._cv.wait()
                    if self._shutdown:
                        return
                    self._stepping = True
                try:
                    with self._span("engine.step"):
                        self._step()
                except BaseException as e:              # engine-fatal
                    self._fail_all(e)
                finally:
                    with self._cv:
                        self._stepping = False
                        self._cv.notify_all()

    # requires: self._cv
    def _work_or_shutdown(self) -> bool:
        return bool(self._shutdown or self._pending or self._active)

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
        with self._span("engine.admit"):
            self._admit()
        if self._active:
            with self._span("engine.decode"):
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
    # runs-on: engine-loop
    def _admit(self) -> None:
        """One admission pass.  Requests are taken in priority order,
        duplicates coalesced and pages reserved one request at a time
        (``_claim``).  A cold prompt is collected, and the collected
        prompts are prefilled together (``_prefill_collected``) at the
        pass's end, or before a request that is prefilled alone or that
        may share a collected prompt's prefix: slots join the batch in
        the order they were taken, and a prompt finds the donors it would
        find admitted one at a time.  A request prefilled alone uses its
        donor before the rows prefilled ahead of it join, since a row
        that retires on its first token may evict that donor."""
        admitted = 0
        cold: List[_Slot] = []
        heads: set = set()              # the collected prompts' _head()s
        while len(self._active) + len(cold) < self.max_batch:
            with self._span("engine.admit.pick"):
                with self._cv:
                    if not self._pending:
                        break
                    # highest priority first; max() keeps the FIRST
                    # maximum, so equal priorities are exact FIFO
                    req = max(self._pending, key=lambda r: r.priority)
                    jumped = req is not self._pending[0]
                coalesced = self._coalesce(req, cold)
                if coalesced:
                    self._remove_pending(req)
            if coalesced:
                continue
            head = self._head(req)
            if head is not None and head in heads:
                admitted += self._join(self._prefill_collected(cold, heads))
            held = sum(self._pages_for(s.req) for s in cold)
            try:
                with self._span("engine.admit.request", req.rid):
                    slot, donor, shared = self._claim(req, held)
            except _Defer:
                # left in the queue: a deferred request blocks the pass,
                # so lower-priority work never slips past it
                self.stats.admit_deferrals += 1
                break
            except BaseException as e:                  # per-request failure
                self._remove_pending(req)
                req.handle._fail(e)
                continue
            # attach still-queued exact duplicates now: a leader that
            # retires within this pass would otherwise leave _active
            # before its duplicates reach _coalesce
            with self._span("engine.admit.pick"):
                slot.followers.extend(self._claim_pending_duplicates(req))
                self._remove_pending(req)
            if jumped:
                self.stats.priority_jumps += 1
            if self._paged_layout and donor is None and not req.extra:
                cold.append(slot)
                if head is not None:
                    heads.add(head)
                if not self._batch_prefill:             # one row a call
                    admitted += self._join(
                        self._prefill_collected(cold, heads))
                continue
            ready = self._prefill_collected(cold, heads)
            try:
                self._admit_one(slot, donor, shared)
                ready.append(slot)
            except BaseException as e:                  # per-request failure
                self._fail_admission(slot, e)
            admitted += self._join(ready)
        admitted += self._join(self._prefill_collected(cold, heads))
        if admitted:
            self.stats.admission_waves += 1
            self.stats.peak_batch = max(self.stats.peak_batch,
                                        len(self._active))
            self._dirty = True

    def _join(self, slots: Sequence[_Slot]) -> int:
        """Put prefilled slots into the decode batch in order, then retire
        those whose first token was their last (a retirement may rebuild
        the radix tree from the batch); returns the slots that joined."""
        done = []
        for s in slots:
            (self._active if s.remaining > 0 else done).append(s)
        for s in done:
            self._retire(s)
        return len(slots) - len(done)

    def _unwind(self, slot: _Slot) -> None:
        """Return the pages a failed prefill wrote for ``slot`` and give it
        a fresh sampling stream, as before its prefill."""
        if self.kv is not None and slot.seq_id in self.kv.sequences:
            self.kv.free_sequence(slot.seq_id)
        slot.seq_id = None
        slot.gen = self._request_gen(slot.req)

    def _fail_admission(self, slot: _Slot, err: BaseException) -> None:
        """Fail a request whose prefill raised, with its followers, and
        return whatever pages it had taken."""
        if self.kv is not None and slot.seq_id in self.kv.sequences:
            self.kv.free_sequence(slot.seq_id)
        slot.req.handle._fail(err)
        for f in slot.followers:
            f._fail(err)

    @staticmethod
    def _duplicates(a: _Request, b: _Request) -> bool:
        return (not a.extra and not b.extra and a.prompt == b.prompt
                and a.max_new == b.max_new
                and a.temperature == b.temperature)

    def _coalesce(self, req: _Request, collected: Sequence[_Slot]) -> bool:
        """Attach an exact duplicate of an in-flight request, or of one
        this pass has ``collected``, as follower.  Per-request sampling
        streams are a pure function of (engine seed, prompt, max_new), so
        duplicates decode the same tokens at any temperature."""
        if req.extra:
            return False
        for s in (*self._active, *collected):
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
                                   kv_heads, head_dim, device=self.device,
                                   on_sync=self._count_syncs)
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

    def _pages_for(self, req: _Request, shared: int = 0) -> int:
        """Pages an admission of ``req`` reserves: its prompt past the
        ``shared`` tokens a donor holds, its patches' rows, its decode
        budget, and one page of boundary slack."""
        n = len(req.prompt) - shared + self._n_patch(req) + req.max_new
        return -(-n // self.page_size) + 1

    @staticmethod
    def _n_patch(req: _Request) -> int:
        patches = req.extra.get("patch_embeds")
        return 0 if patches is None else patches.shape[-2]

    # requires: self._cv | engine-loop
    def _ensure_pages(self, needed: int, protect: Optional[int] = None,
                      held: int = 0) -> None:
        """Evict warm sequences (LRU, never ``protect``) until ``needed``
        pages are free beyond the active batch's decode reservation and
        the ``held`` pages of the rows this pass has collected and not yet
        written; defer admission if in-flight work will free more."""
        kv = self.kv
        if needed > kv.num_pages:
            raise MemoryError(
                f"request needs {needed} KV pages but the pool holds only "
                f"{kv.num_pages} ({kv.page_size} tokens/page) — it cannot "
                f"be admitted even after evicting all warm sequences; "
                f"raise num_pages/max_seq_len or shrink the prompt / "
                f"max_new_tokens")
        needed += self._reserved_pages() + held
        while len(kv.free_pages) < needed:
            victim = next((s for s in self._warm if s != protect), None)
            if victim is None:
                if self._active or held:
                    raise _Defer()
                raise MemoryError(
                    f"KV cache out of pages ({needed} needed, "
                    f"{len(kv.free_pages)} free, no warm sequences left)")
            self._warm.pop(victim)
            kv.free_sequence(victim)
            self.stats.warm_evictions += 1

    # ------------------------------------------------- host<->device copies
    # Each of these copies waits for the device (a blocking copy from or
    # to pageable host memory synchronises the stream); ``host_syncs``
    # counts them by site, so an engine on the CPU counts the same ones.
    def _count_syncs(self, n: int = 1) -> None:
        self.stats.host_syncs += n

    def _tokens(self, rows) -> torch.Tensor:
        self._count_syncs()
        return torch.as_tensor(rows, dtype=torch.int32).to(self.device)

    def _extra(self, value) -> torch.Tensor:
        """A request's ``patch_embeds`` or ``frames`` (numpy, any float
        dtype, or a tensor) on the engine's device in the model dtype."""
        if not isinstance(value, torch.Tensor):
            value = torch.from_numpy(np.asarray(value, np.float32))
        if value.device.type == "cpu":
            self._count_syncs()
        return value.to(self.device, self.model.dtype)

    def _to_host(self, t: torch.Tensor) -> np.ndarray:
        """A device result read on the host: sampled token ids."""
        self._count_syncs()
        return t.cpu().numpy()

    def _cache_view(self, k_rows, v_rows, lengths):
        """``model.paged_cache_view``, which uploads ``lengths``."""
        self._count_syncs()
        return self.model.paged_cache_view(k_rows, v_rows, lengths)

    def _prefill(self, req: _Request):
        """The full prefill of one prompt with its request's extras: an
        audio request's ``frames`` go through the encoder, a VLM request's
        ``patch_embeds`` are prepended to its tokens."""
        tokens = self._tokens([req.prompt])
        if self.cfg.family == "audio":
            if "frames" not in req.extra:
                raise ValueError("an audio request carries its frames")
            return self.model.prefill(tokens, self._extra(req.extra["frames"]))
        if self.cfg.family == "vlm" \
                and req.extra.get("patch_embeds") is not None:
            return self.model.prefill(
                tokens, prefix_embeds=self._extra(req.extra["patch_embeds"]))
        return self.model.prefill(tokens)

    def _shareable(self, req: _Request) -> bool:
        """Whether ``req``'s prompt may take a donor's pages or be one."""
        return self.enable_prefix_sharing and not req.extra \
            and len(req.prompt) > 1

    def _head(self, req: _Request) -> Optional[tuple]:
        """The first MIN_SHARED_PREFIX tokens of a prompt that could share
        them: two prompts share a usable prefix only if these are equal."""
        if self._shareable(req) and len(req.prompt) >= self.MIN_SHARED_PREFIX:
            return req.prompt[:self.MIN_SHARED_PREFIX]
        return None

    # runs-on: engine-loop
    def _claim(self, req: _Request, held: int):
        """The part of an admission that is the request's own: its
        sampling stream, its warm donor and its pages (``held``: see
        ``_ensure_pages``).  Returns (slot, donor, shared tokens)."""
        if not self._loaded:
            self.load()
        with self._span("engine.admit.seed"):
            gen = self._request_gen(req)
        slot = _Slot(req=req, remaining=req.max_new, gen=gen)
        if not self._paged_layout:
            return slot, None, 0
        self._ensure_kv()
        donor, shared = None, 0
        if self._shareable(req):
            # deepest-first; cap at S-1 so one fresh token remains
            with self._span("engine.admit.match"):
                donor, shared = self._find_warm_donor(
                    req.prompt, cap=len(req.prompt) - 1)
        with self._span("engine.admit.pages"):
            self._ensure_pages(self._pages_for(req, shared), protect=donor,
                               held=held)
        return slot, donor, shared

    # runs-on: engine-loop
    def _admit_one(self, slot: _Slot, donor: Optional[int],
                   shared: int) -> None:
        """Prefill one claimed request on its own: a dense row, a prompt
        whose first ``shared`` tokens ``donor`` holds, or a request with
        extras; then sample its first token."""
        req = slot.req
        S = len(req.prompt)
        if not self._paged_layout:
            # dense row: the prefill state, grown to the engine's horizon
            with self._span("engine.admit.model"):
                logits, cache = self._prefill(req)
                slot.row = self.model.extend_cache(cache,
                                                   self.max_seq_len - S)
            slot.length = S
            self.stats.prefill_tokens += S
            self._first_tokens([slot], logits)
            return
        kv = self.kv
        if donor is not None:
            logits = self._prefill_shared(slot, donor, shared)
            self.stats.prefix_hits += 1
            self.stats.prefill_tokens += S - shared
            self.stats.prefill_tokens_saved += shared
        else:
            # one full prefill; the patches' rows lead the sequence's pages
            with self._span("engine.admit.model"):
                logits, cache = self._prefill(req)
            s_kv = S + self._n_patch(req)
            with self._span("engine.admit.pool"):
                slot.seq_id = kv.add_sequence(
                    *self.model.cache_kv_rows_dev(cache, 0, s_kv))
            self.stats.prefill_tokens += s_kv
        slot.length = kv.sequences[slot.seq_id].length
        if self._shareable(req):
            with self._span("engine.admit.tree"):
                self.warm_prefixes.insert(req.prompt, payload=slot.seq_id,
                                          stamp_path=True)
        self.stats.pages_shared = kv.pages_shared
        self.stats.tokens_reused = kv.tokens_reused
        self._first_tokens([slot], logits)

    def _chunk_view(self, T1: int, prefix=None, rows: int = 1):
        """An empty (or, for one row, filled with the (K, V) pair
        ``prefix``) dense (rows, L, T1, *row) view a plane for the chunk
        prefill, in the model dtype, on the device.  Made in the cache's
        (L, rows, ...) layout, so that ``paged_cache_view``'s transpose
        copies nothing."""
        planes = [torch.zeros((self._paged_layout[0], rows, T1) + row,
                              dtype=self.model.dtype,
                              device=self.device).transpose(0, 1)
                  for row in self._plane_rows]
        n = 0
        if prefix is not None:
            n = prefix[0].shape[1]
            for plane, p in zip(planes, prefix):
                plane[0, :, :n] = p
        return self._cache_view(*kv_pair(planes), [n] * rows)

    def _pf_pad(self, n: int) -> int:
        q = self._PF_QUANTUM
        return -(-n // q) * q

    def _cold_groups(self, slots: Sequence[_Slot]) -> List[List[_Slot]]:
        """``slots`` sorted by padded prompt length and cut into groups
        whose rows times widest padded length stay within ``_PF_BUDGET``
        (a row wider than that alone)."""
        groups: List[List[_Slot]] = []
        for s in sorted(slots, key=lambda s: len(s.req.prompt)):
            width = self._pf_pad(len(s.req.prompt))
            if groups and (len(groups[-1]) + 1) * width <= self._PF_BUDGET:
                groups[-1].append(s)
            else:
                groups.append([s])
        return groups

    # runs-on: engine-loop
    def _prefill_collected(self, cold: List[_Slot],
                           heads: set) -> List[_Slot]:
        """Prefill the cold prompts a pass has collected, one
        ``_prefill_cold`` call a group of ``_cold_groups``.  A group whose
        call raises is unwound and its rows prefilled one a call, so only
        a row that raises alone fails.  Empties ``cold`` and ``heads``;
        returns the prefilled slots in the order they were collected, for
        ``_join``."""
        failed = set()
        todo = self._cold_groups(cold)
        while todo:
            group = todo.pop(0)
            try:
                self._prefill_cold(group)
            except BaseException as e:                  # per-call failure
                if len(group) > 1:
                    for s in group:
                        self._unwind(s)
                    todo[:0] = [[s] for s in group]
                else:
                    self._fail_admission(group[0], e)
                    failed.add(id(group[0]))
        ready = [s for s in cold if id(s) not in failed]
        cold.clear()
        heads.clear()
        return ready

    # runs-on: engine-loop
    def _prefill_cold(self, slots: Sequence[_Slot]) -> None:
        """Prefill donor-less prompts as the rows of one bucketed chunk
        step over an empty cache view, each right-padded to the widest
        row's ``_PF_QUANTUM`` bucket (its valid length masks the rest);
        then each row's KV into the pool and its prompt into the radix
        tree, and every row's first token."""
        reqs = [s.req for s in slots]
        pad = self._pf_pad(max(len(r.prompt) for r in reqs))
        with self._span("engine.admit.view"):
            cache = self._chunk_view(
                self._round_t(pad + max(r.max_new for r in reqs)),
                rows=len(reqs))
            toks = self._tokens([list(r.prompt) + [0] * (pad - len(r.prompt))
                                 for r in reqs])
            valid = self._tokens([len(r.prompt) for r in reqs])
        with self._span("engine.admit.model"):
            logits, cache = self.model.prefill_with_cache(
                toks, cache, valid_len=valid)
        kv = self.kv
        with self._span("engine.admit.pool"):
            for i, s in enumerate(slots):
                s.seq_id = kv.add_sequence(*self.model.cache_kv_rows_dev(
                    cache, i, len(s.req.prompt)))
                s.length = len(s.req.prompt)
        with self._span("engine.admit.tree"):
            for s in slots:
                if self._shareable(s.req):
                    self.warm_prefixes.insert(s.req.prompt, payload=s.seq_id,
                                              stamp_path=True)
        self._first_tokens(slots, logits)
        self.stats.prefill_tokens += sum(len(r.prompt) for r in reqs)
        self.stats.prefill_rows += len(reqs)
        self.stats.pages_shared = kv.pages_shared
        self.stats.tokens_reused = kv.tokens_reused

    # runs-on: engine-loop
    def _prefill_shared(self, slot: _Slot, donor: int, shared: int):
        """Admit via page aliasing: reuse the donor's first ``shared``
        tokens, chunk-prefill only the unseen suffix, append its KV."""
        kv = self.kv
        req = slot.req
        with self._span("engine.admit.pool"):
            seq = kv.add_sequence(shared_from=donor, shared_len=shared)
        slot.seq_id = seq
        S = len(req.prompt)
        # pad the suffix to a quantum: the share point depends on which
        # prefixes happen to be warm at admission time
        n_suf = S - shared
        pad = self._pf_pad(n_suf)
        with self._span("engine.admit.view"):
            cache = self._chunk_view(
                self._round_t(shared + pad + req.max_new),
                prefix=kv.gather(seq))
            suffix = self._tokens(
                [list(req.prompt[shared:]) + [0] * (pad - n_suf)])
            valid = self._tokens([n_suf])
        with self._span("engine.admit.model"):
            logits, cache = self.model.prefill_with_cache(
                suffix, cache, valid_len=valid)
        self.stats.prefill_rows += 1
        with self._span("engine.admit.pool"):
            rows = self.model.cache_kv_rows_dev(cache, 0, S)
            kv.extend_sequence(seq, *kv_pair(
                [r[:, shared:] for r in rows[:len(self._plane_rows)]]))
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
            planes = [torch.zeros((b_pad, self._paged_layout[0], t_view)
                                  + row, dtype=self.model.dtype,
                                  device=self.device)
                      for row in self._plane_rows]
            lengths = [0] * b_pad
            for i, s in enumerate(slots):
                for plane, r in zip(planes, self.kv.gather(s.seq_id)):
                    plane[i, :, :s.length] = r
                lengths[i] = s.length
            self._view = self._cache_view(*kv_pair(planes), lengths)
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

    # runs-on: engine-loop
    def _decode_once(self) -> None:
        if self._use_paged:
            self._decode_paged()
            return
        with self._span("engine.decode.tables"):
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
            t_tokens = self._tokens(tokens)
        with self._span("engine.decode.model"):
            logits, self._view = self.model.decode_step(t_tokens, self._view)
            if self._paged_layout:
                # the step's new K/V back into the pages (identity slots:
                # a full-attention view does not wrap); the taps upload
                # their slots
                self._count_syncs()
                k_taps, v_taps = self.model.decode_kv_taps(self._view,
                                                           prev_lengths)
                self.kv.append_tokens([s.seq_id for s in slots],
                                      k_taps, v_taps)
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
        with self._span("engine.decode.tables"):
            # page alloc + COW (host metadata): after this every
            # write-target page is private to its row, the fused kernel's
            # safety contract
            kv.prepare_appends([s.seq_id for s in slots])
            b_pad = self._round_b(b_real)
            t_cap = self._round_t(max(s.length + s.remaining for s in slots))
            n_pages = -(-t_cap // self.page_size)
            self.stats.widest_decode_table = max(
                self.stats.widest_decode_table, n_pages)
            pt = np.zeros((b_pad, n_pages), np.int32)
            lens = np.full((b_pad,), -1, np.int32)
            tokens = np.zeros((b_pad,), np.int32)
            for i, s in enumerate(slots):
                ids = kv.sequences[s.seq_id].page_ids
                pt[i, :len(ids)] = ids
                lens[i] = s.length
                tokens[i] = s.last_token
            self.stats.h2d_bytes += pt.nbytes + lens.nbytes + tokens.nbytes
            t_tokens = self._tokens(tokens)
            t_pt = self._tokens(pt)
            t_lens = self._tokens(lens)
        with self._span("engine.decode.model"):
            logits, _, _ = self.model.paged_decode_step(
                t_tokens, kv.k, kv.v, t_pt, t_lens)
        kv.commit_appends([s.seq_id for s in slots])
        for s in slots:
            s.length += 1
        self.stats.decode_tokens += b_real
        self._advance(logits)

    # runs-on: engine-loop
    def _first_tokens(self, slots: Sequence[_Slot], logits) -> None:
        """Sample each prefilled slot's first token from its row of the
        (B, Vpad) logits, each from its own stream, and read them in one
        sync; a slot with no decode budget samples none."""
        if not any(s.req.max_new > 0 for s in slots):
            return
        ids = batched_sample(logits[:len(slots)],
                             [s.req.temperature for s in slots],
                             [s.gen for s in slots],
                             vocab_size=self.cfg.vocab_size)
        with self._span("engine.admit.sync"):
            toks = self._to_host(ids)
        for s, tok in zip(slots, toks):
            if s.req.max_new > 0:
                s.generated.append(int(tok))
                s.last_token = int(tok)
                s.remaining -= 1

    def _advance(self, logits) -> None:
        """Advance every active slot from one decode step's logits: the
        whole (B, Vpad) batch is sampled on the device and synced once."""
        slots = list(self._active)
        temps = [s.req.temperature for s in slots]
        with self._span("engine.decode.sample"):
            ids = batched_sample(logits[:len(slots)], temps,
                                 [s.gen for s in slots],
                                 vocab_size=self.cfg.vocab_size)
        with self._span("engine.decode.sync"):
            toks = self._to_host(ids)
        with self._span("engine.decode.retire"):
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
                    self.stats.warm_evictions += 1
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
        dominate, so a long-lived engine does not grow it forever.  The
        bar is at least twice the live donors (warm and active), so that
        a batch wider than the warm set does not rebuild on every
        retirement."""
        live = len(self._warm) + len(self._active)
        if self.warm_prefixes.num_sequences <= max(
                8 * self.max_warm_sequences, 2 * live):
            return
        tree = RadixPrefixTree()
        for seq_id, prompt in self._warm.items():
            tree.insert(prompt, payload=seq_id, stamp_path=True)
        for s in self._active:
            if s.seq_id is not None and not s.req.extra:
                tree.insert(s.req.prompt, payload=s.seq_id, stamp_path=True)
        self.warm_prefixes = tree
        self.stats.tree_rebuilds += 1
