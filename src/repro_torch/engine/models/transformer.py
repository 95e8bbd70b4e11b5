"""Decoder-only transformer LM, dense, MoE and VLM families, as a PyTorch
module.

The counterpart of ``repro/engine/models/transformer.py`` for the dense
family (qwen3-1.7b and qwen3-8b: GQA, qk-norm; llama3.2-3b: three query
heads per KV head, no qk-norm), the MoE family (deepseek-moe-16b: its
first ``first_dense_layers`` layers keep a dense FFN of ``d_ff_dense``,
the rest route through ``moe.py``) and the VLM (internvl2-2b: the dense
backbone; ``forward`` and ``prefill`` take ``prefix_embeds`` (B, P,
d_model), the stub frontend's patch embeddings, prepended before the
first block at positions 0..P-1, so the cache holds P + S rows).
Sliding-window attention (mixtral-8x22b, ``swa_window``) keeps its KV in
a ring of ``cache_capacity = min(max_len, swa_window)`` slots, position p
in slot ``p % T``; a ring wraps in place, which immutable pages cannot
hold, so ``paged_kv_layout()`` is None and the engine serves such a model
on dense rows (``cache_batch_axes``, ``extend_cache``).  Unlike the JAX
``prefill``, which keeps the last T positions in slots 0..T-1, the
port's rolls them into their ring slots, so a prompt past the window
decodes as the teacher-forced forward does.

Weights are ``(in, out)`` as in the JAX package; the blocks are a
``ModuleList`` where the JAX package stacks them on a leading layer axis
(``repro_torch.bridge`` splits that axis); the JAX package's unscanned
``lead_blocks`` are the list's first layers, as they are the first layers
of its KV cache and page pool.  Serving runs under ``torch.no_grad()``
(its parameters do not require grad unless a trainer turns it on);
``loss_fn`` is the training loss over ``forward_train``, a forward that
keeps the graph and holds no KV.  Unlike the JAX functions,
``prefill_with_cache``, ``paged_decode_step`` and ``decode_step`` write
KV into the cache or pool they are given IN PLACE, which saves the
whole-pool copy an immutable update would cost (about 1.9 GB at full
width).

On the card ``paged_decode_step`` replays CUDA graphs: the step's
launches, captured once per batch, table width and pool
(``_StepGraph``), go to the card in one graph launch instead of one
Python call each, which bounded a step's time at full width.  The first
call of such a key runs eagerly (``_paged_decode_step_eager``), the
second captures it, every later one copies its inputs into the graph's
and replays it; a model keeps the graphs of its ``_GRAPH_KEYS`` keys
used last.  Elsewhere (the CPU, meta tensors, ``impl="torch"``, grad
on, a stream already capturing) the eager step runs as it is.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.engine.models import layers as L
from repro_torch.engine.models import moe as M
from repro_torch.kernels import common as KC
from repro_torch.kernels.paged_decode_attention import ops as pd_ops

Cache = Dict[str, torch.Tensor]


class Block(nn.Module):
    """One pre-norm attention block with a SwiGLU FFN (``ffn``) or, in an
    MoE layer, the experts (``moe``); the other is None."""

    def __init__(self, cfg: ModelConfig, head_dim: int, dtype, device,
                 layer: int = 0):
        super().__init__()
        d, dh = cfg.d_model, head_dim
        h, hkv = cfg.num_heads, cfg.num_kv_heads
        self.ln1 = L.param(d, dtype=dtype, device=device)
        self.ln2 = L.param(d, dtype=dtype, device=device)
        attn = {"wq": (d, h * dh), "wk": (d, hkv * dh), "wv": (d, hkv * dh),
                "wo": (h * dh, d)}
        if cfg.qk_norm:
            attn.update(q_norm=(dh,), k_norm=(dh,))
        self.attn = L.param_dict(attn, dtype, device)
        m = cfg.moe
        self.ffn = self.moe = None
        if m is not None and layer >= m.first_dense_layers:
            self.moe = M.MoE(d, m, dtype, device)
            return
        d_ff = m.d_ff_dense if m is not None else cfg.d_ff
        self.ffn = L.param_dict({"w_gate": (d, d_ff), "w_up": (d, d_ff),
                                 "w_down": (d_ff, d)}, dtype, device)


@dataclass
class _StepGraph:
    """One captured paged decode step: its static inputs, which a replay
    overwrites with the caller's, the logits buffer it writes (shared by
    every graph of its batch size), its replay, and how far the host
    counts moved while the step's Python ran at capture
    (``_host_counts``), added at each replay."""
    token: torch.Tensor
    page_table: torch.Tensor
    lengths: torch.Tensor
    logits: torch.Tensor
    replay: Optional[Callable[[], None]] = None
    moved: Optional[Dict[str, int]] = None


# one capture at a time in the process (each engine's loop thread
# captures its own model's steps)
_CAPTURE_LOCK = threading.Lock()


def _moved(before: Dict[str, int], after: Dict[str, int]
           ) -> Dict[str, int]:
    return {k: n - before.get(k, 0) for k, n in after.items()}


def _keep(cache: OrderedDict, key, value, limit: int) -> None:
    """Put ``key`` last in ``cache`` and drop the least recent keys past
    ``limit``."""
    cache[key] = value
    cache.move_to_end(key)
    while len(cache) > limit:
        cache.popitem(last=False)


class TransformerLM(nn.Module):
    """The dense or MoE decoder; its weights live on ``device`` (the card
    unless the caller asks for the CPU, or "meta" until the engine
    loads).

    ``counters()`` gives what the decode step's CUDA graphs did since
    construction: ``decode_graph_replays``, ``decode_graph_captures`` and
    ``decode_graph_capture_s`` (host seconds of the captures: the step's
    Python under capture and the graph's instantiation)."""

    # the call of a decode key that captures its graph: the first runs
    # eagerly, so a shape seen once pays no capture
    _GRAPH_CALL = 2
    # decode keys a model remembers, graphs and calls each, least recent
    # dropped first: traffic of ever new table widths keeps a few graphs,
    # and a key not seen again within that many others is never captured
    _GRAPH_KEYS = 8

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        if cfg.family not in ("dense", "moe", "vlm"):
            raise NotImplementedError(
                f"family {cfg.family!r} is not a transformer LM")
        self.cfg = cfg
        self.head_dim = cfg.resolved_head_dim
        self.dtype = getattr(torch, cfg.dtype)
        self.embed = L.param(cfg.padded_vocab, cfg.d_model, dtype=self.dtype,
                             device=device)
        self.final_norm = L.param(cfg.d_model, dtype=self.dtype, device=device)
        if not cfg.tie_embeddings:
            self.lm_head = L.param(cfg.d_model, cfg.padded_vocab,
                                   dtype=self.dtype, device=device)
        self.blocks = nn.ModuleList(self._new_block(i, device)
                                    for i in range(cfg.num_layers))
        self._drop_graphs()
        self.decode_graph_replays = 0
        self.decode_graph_captures = 0
        self.decode_graph_capture_s = 0.0

    def _new_block(self, layer: int, device) -> nn.Module:
        return Block(self.cfg, self.head_dim, self.dtype, device, layer=layer)

    # ------------------------------------------------------------------ init
    @torch.no_grad()
    def init(self, gen: torch.Generator) -> "TransformerLM":
        """Random weights from ``gen`` with the JAX package's scales
        (normal/sqrt(fan_in), embedding 0.02, norms 0).  The draws differ
        from JAX's; tests bridge JAX's own weights instead."""
        cfg = self.cfg
        self.embed.copy_(L.embed_init(gen, cfg.padded_vocab, cfg.d_model,
                                      self.dtype))
        self.final_norm.zero_()
        if not cfg.tie_embeddings:
            self.lm_head.copy_(L.dense_init(gen, cfg.d_model,
                                            cfg.padded_vocab, self.dtype))
        for blk in self.blocks:
            blk.ln1.zero_()
            blk.ln2.zero_()
            for name, w in L.attn_init(gen, cfg.d_model, cfg.num_heads,
                                       cfg.num_kv_heads, self.head_dim,
                                       self.dtype, cfg.qk_norm).items():
                blk.attn[name].copy_(w)
            if blk.moe is None:
                d_ff = blk.ffn["w_up"].shape[1]
                for name, w in L.ffn_init(gen, cfg.d_model, d_ff,
                                          self.dtype).items():
                    blk.ffn[name].copy_(w)
                continue
            experts = M.moe_init(gen, cfg.d_model, cfg.moe, self.dtype)
            for name, w in experts.pop("shared", {}).items():
                blk.moe.shared[name].copy_(w)
            for name, w in experts.items():
                blk.moe[name].copy_(w)
        return self

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _head(self) -> torch.Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head

    def _qkv(self, blk: Block, x, positions):
        cfg = self.cfg
        h = L.rms_norm(x, blk.ln1, cfg.norm_eps)
        return L.attn_qkv(blk.attn, h, num_heads=cfg.num_heads,
                          num_kv_heads=cfg.num_kv_heads,
                          head_dim=self.head_dim, positions=positions,
                          rope_theta=cfg.rope_theta, qk_norm=cfg.qk_norm,
                          norm_eps=cfg.norm_eps)

    def _finish_block(self, blk: Block, x, o):
        """The attention output, then the FFN or the experts.  Returns (x,
        the MoE layer's aux loss, or None for a dense FFN)."""
        x = x + L.attn_out(blk.attn, o)
        h = L.rms_norm(x, blk.ln2, self.cfg.norm_eps)
        if blk.moe is None:
            return x + L.ffn_apply(blk.ffn, h), None
        y, a = M.moe_ffn(h, blk.moe, self.cfg.moe)
        return x + y, a

    def _hidden(self, x):
        """The residual stream at a block's start, sequence-sharded under
        the sequence-parallel hints (``layers.constrain_hidden``, an
        identity with none set).  Dense family only, as in JAX: MoE
        dispatch and the VLM's prefix concatenation work against the
        sequence-sharded layout."""
        return L.constrain_hidden(x) if self.cfg.family == "dense" else x

    def _block(self, blk: Block, x, positions, impl):
        """One block of the teacher-forced forward: (x, its aux loss, f32,
        0 for a dense FFN).  It returns the aux loss rather than collecting
        it, so a rematerialized block adds it once."""
        x = self._hidden(x)
        q, k, v = self._qkv(blk, x, positions)
        o = L.attention(q, k, v, q_positions=positions,
                        kv_positions=positions, causal=True,
                        window=self.cfg.swa_window, impl=impl)
        x, a = self._finish_block(blk, x, o)
        if a is None:
            a = torch.zeros((), dtype=torch.float32, device=x.device)
        return x, a

    # -------------------------------------------------------------- training
    def forward_train(self, tokens: torch.Tensor,
                      prefix_embeds: Optional[torch.Tensor] = None,
                      remat: bool = False, impl: Optional[str] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The teacher-forced forward with its graph, for training: (logits
        (B,P+S,Vpad), the aux losses summed in layer order, f32).  With
        ``remat`` each block past the MoE lead layers is rematerialized in
        the backward (``checkpoint``, as the JAX package's
        ``jax.checkpoint`` over its scanned blocks); the lead blocks are
        not, as in JAX."""
        cfg = self.cfg
        impl = impl or cfg.attention_impl
        x = L.embed_lookup(self.embed, tokens)
        if prefix_embeds is not None:
            x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
        B, S, _ = x.shape
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S).contiguous()
        n_lead = cfg.moe.first_dense_layers if cfg.moe else 0
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, blk in enumerate(self.blocks):
            if remat and i >= n_lead:
                x, a = checkpoint(self._block, blk, x, positions, impl,
                                  use_reentrant=False)
            else:
                x, a = self._block(blk, x, positions, impl)
            aux = aux + a
        x = L.rms_norm(x, self.final_norm, cfg.norm_eps)
        return x @ self._head(), aux

    def loss_fn(self, batch: Dict[str, torch.Tensor], remat: bool = False,
                impl: Optional[str] = None) -> torch.Tensor:
        """Next-token cross-entropy over ``batch["tokens"]`` against
        ``batch["labels"]`` shifted by one, past the patch positions of a
        VLM batch (``patch_embeds``), under ``loss_mask`` when given, plus
        ``router_aux_weight`` times the MoE aux loss."""
        cfg = self.cfg
        patches = batch.get("patch_embeds")
        logits, aux = self.forward_train(batch["tokens"],
                                         prefix_embeds=patches, remat=remat,
                                         impl=impl)
        if patches is not None:
            logits = logits[:, patches.shape[1]:]
        ce = L.next_token_loss(logits, batch, cfg.vocab_size)
        weight = cfg.moe.router_aux_weight if cfg.moe else 0.0
        return ce + weight * aux

    # --------------------------------------------------------------- forward
    @torch.no_grad()
    def forward(self, tokens: torch.Tensor, impl: Optional[str] = None,
                prefix_embeds: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Teacher-forced forward.  Returns (logits (B,P+S,Vpad), aux): the
        MoE layers' aux losses summed in layer order, float32 (0 for a
        dense model)."""
        return self.forward_train(tokens, prefix_embeds=prefix_embeds,
                                  impl=impl)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, impl: Optional[str] = None,
                prefix_embeds: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Cache]:
        """Run the full prompt, after ``prefix_embeds`` when given; return
        (last-position logits, filled cache ``{"k", "v": (L,B,T,Hkv,Dh),
        "length": (B,) int32}``) with ``T = cache_capacity(P+S)``: past a
        sliding window the ring keeps the last T positions, position p in
        slot ``p % T``."""
        cfg = self.cfg
        impl = impl or cfg.attention_impl
        x = L.embed_lookup(self.embed, tokens)
        if prefix_embeds is not None:
            x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
        B, S, _ = x.shape
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S).contiguous()
        T = self.cache_capacity(S)
        ks, vs = [], []
        for blk in self.blocks:
            x = self._hidden(x)
            q, k, v = self._qkv(blk, x, positions)
            o = L.attention(q, k, v, q_positions=positions,
                            kv_positions=positions, causal=True,
                            window=cfg.swa_window, impl=impl)
            x, _ = self._finish_block(blk, x, o)
            if T < S:
                k = L.roll_time(k[:, S - T:], S % T)
                v = L.roll_time(v[:, S - T:], S % T)
            ks.append(k)
            vs.append(v)
        x = L.rms_norm(x, self.final_norm, cfg.norm_eps)
        cache = {"k": torch.stack(ks), "v": torch.stack(vs),
                 "length": torch.full((B,), S, dtype=torch.int32,
                                      device=x.device)}
        return x[:, -1] @ self._head(), cache

    # ----------------------------------------------------- chunked prefill
    @torch.no_grad()
    def prefill_with_cache(self, tokens: torch.Tensor, cache: Cache,
                           impl: Optional[str] = None,
                           valid_len: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, Cache]:
        """Prefill ``tokens`` (B, S_suf) as a continuation of ``cache``.

        The chunk's queries attend to the cached KV plus the chunk
        itself; the chunk's KV is written into ``cache["k"/"v"]`` IN PLACE
        at its absolute slots.  ``valid_len`` (B,) marks the real chunk
        length when ``tokens`` is right-padded to a bucketed shape: causal
        attention keeps pad rows out of every real row, logits are read at
        ``valid_len - 1`` and the length advances by ``valid_len``, so the
        padding is invisible.  Returns (logits (B,Vpad), cache with the
        new length).  Full-attention caches only (slot s holds position s):
        a sliding-window model raises.
        """
        cfg = self.cfg
        if cfg.swa_window:
            raise ValueError("chunked prefill needs full attention; a "
                             "sliding-window model keeps a ring cache")
        impl = impl or cfg.attention_impl
        B, Ssuf = tokens.shape
        dev = tokens.device
        pos0 = cache["length"]                               # (B,)
        x = L.embed_lookup(self.embed, tokens)
        positions = (pos0[:, None] + torch.arange(
            Ssuf, dtype=torch.int32, device=dev)[None, :]).contiguous()
        T = cache["k"].shape[2]
        arange_t = torch.arange(T, dtype=torch.int32, device=dev)[None, :]
        kv_pos = torch.where(arange_t < (pos0 + Ssuf)[:, None], arange_t,
                             -1).to(torch.int32).contiguous()
        batch_ix = torch.arange(B, device=dev)[:, None]
        slots = positions.long()
        for i, blk in enumerate(self.blocks):
            x = self._hidden(x)
            q, k, v = self._qkv(blk, x, positions)
            k_cache, v_cache = cache["k"][i], cache["v"][i]
            k_cache[batch_ix, slots] = k
            v_cache[batch_ix, slots] = v
            o = L.attention(q, k_cache, v_cache, q_positions=positions,
                            kv_positions=kv_pos, causal=True, window=0,
                            impl=impl)
            x, _ = self._finish_block(blk, x, o)
        new_cache = dict(cache)
        new_cache["length"] = pos0 + (Ssuf if valid_len is None
                                      else valid_len.to(torch.int32))
        x = L.rms_norm(x, self.final_norm, cfg.norm_eps)
        if valid_len is None:
            last = x[:, -1]
        else:
            last = x[torch.arange(B, device=dev), valid_len.long() - 1]
        return last @ self._head(), new_cache

    # ------------------------------------------------ dense-cache decode step
    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, cache: Cache,
                    impl: Optional[str] = None) -> Tuple[torch.Tensor, Cache]:
        """One autoregressive step over a dense cache ``{"k", "v": (L,B,T,
        Hkv,Dh), "length": (B,)}``: the engine's dense-view arm
        (``paged_decode=False``) and a sliding-window model's dense rows.

        Each layer writes the new token's K/V at slot ``length % T`` IN
        PLACE and attends over the slots holding positions ``<= length``
        (under ``impl="cuda"`` in the decode_attention kernel): slot s
        holds the newest position congruent to s (``_kv_slot_positions``),
        which is s itself while ``length < T``, as in every full-attention
        cache.  Returns (logits (B,Vpad), a dict of the same tensors with
        ``length + 1``).
        """
        cfg = self.cfg
        impl = impl or cfg.attention_impl
        B = token.shape[0]
        T = cache["k"].shape[2]
        pos = cache["length"].to(torch.int32)
        slot = torch.remainder(pos, T).long()
        kv_pos = self._kv_slot_positions(pos, T).contiguous()
        batch_ix = torch.arange(B, device=token.device)
        x = L.embed_lookup(self.embed, token)[:, None, :]      # (B,1,D)
        for i, blk in enumerate(self.blocks):
            q, k, v = self._qkv(blk, x, pos[:, None])
            k_cache, v_cache = cache["k"][i], cache["v"][i]
            L.write_slots_(k_cache, batch_ix, slot, k[:, 0])
            L.write_slots_(v_cache, batch_ix, slot, v[:, 0])
            o = L.attention(q, k_cache, v_cache, q_positions=pos[:, None],
                            kv_positions=kv_pos, causal=True,
                            window=cfg.swa_window, impl=impl)
            x, _ = self._finish_block(blk, x, o)
        new_cache = dict(cache)
        new_cache["length"] = pos + 1
        x = L.rms_norm(x, self.final_norm, cfg.norm_eps)
        return x[:, -1] @ self._head(), new_cache

    def decode_kv_taps(self, cache: Cache, slots) -> Tuple[torch.Tensor,
                                                          torch.Tensor]:
        """The K/V at per-row ``slots`` (the last decode step's token) as
        device tensors ``(L, B, Hkv, Dh)``: the page-append payload that
        mirrors one :meth:`decode_step`."""
        ix = torch.as_tensor(slots, dtype=torch.long,
                             device=cache["k"].device)
        rows = torch.arange(ix.shape[0], device=ix.device)
        return cache["k"][:, rows, ix], cache["v"][:, rows, ix]

    # ----------------------------------------------------- paged decode step
    def paged_decode_step(self, token: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: Optional[torch.Tensor],
                          page_table: torch.Tensor, lengths: torch.Tensor,
                          impl: Optional[str] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     Optional[torch.Tensor]]:
        """One autoregressive step over the page pool: the eager step
        (``_paged_decode_step_eager``, which states the arguments), or on
        the card its CUDA graph.

        A graph is keyed by ``(B, n_pages)`` and the pools' addresses.  A
        key's first call runs eagerly, its second (``_GRAPH_CALL``)
        captures it, and each later call copies ``token``, ``page_table``
        and ``lengths`` into the graph's own buffers and replays it, with
        the host counts a step advances (the kernels' launches) moved as
        the captured step moved them.
        The graphs and the calls of the ``_GRAPH_KEYS`` keys used last
        are kept, each least recent first out.  Graphs are used only
        where ``_graphs_apply`` holds, and a key whose capture finds no
        memory stays eager (``_capture_step``).  A replayed step returns
        the logits buffer that every graph of its batch size writes:
        valid until the next decode step.  The pools returned are the
        tensors passed in.

        The paged kernel's table is read by the eager step only, so a
        key's graph replays the variant its capture launched: a step under
        another table (``pd_ops._DEFAULT_TABLE``) wants a fresh model.  A
        malformed table raises ``ValueError`` from the first step."""
        if not self._graphs_apply(token, impl):
            return self._paged_decode_step_eager(
                token, k_pages, v_pages, page_table, lengths, impl=impl)
        key = (token.shape[0], page_table.shape[1], k_pages.data_ptr(),
               tuple(k_pages.shape),
               None if v_pages is None else v_pages.data_ptr())
        g = self._graphs.get(key)
        if g is None:
            n = self._graph_calls.get(key, 0) + 1
            _keep(self._graph_calls, key, n, self._GRAPH_KEYS)
            if n == self._GRAPH_CALL:
                g = self._capture_step(token, k_pages, v_pages, page_table,
                                       lengths, impl)
            if g is None:
                return self._paged_decode_step_eager(
                    token, k_pages, v_pages, page_table, lengths, impl=impl)
            del self._graph_calls[key]
            _keep(self._graphs, key, g, self._GRAPH_KEYS)
        else:
            self._graphs.move_to_end(key)
            g.token.copy_(token)
            g.page_table.copy_(page_table)
            g.lengths.copy_(lengths)
            self._add_host_counts(g.moved)
            self.decode_graph_replays += 1
        g.replay()
        return g.logits, k_pages, v_pages

    def _graphs_apply(self, token: torch.Tensor, impl: Optional[str]
                      ) -> bool:
        """Whether a decode step may run as a CUDA graph: its tensors on
        the card under the ``"cuda"`` kernels, grad off and the stream
        not capturing already.  Every family's step qualifies: none reads
        the device back on the host, and each one's shapes follow its
        inputs' alone (the MoE capacity is computed from the shapes)."""
        return (token.device.type == "cuda"
                and (impl or self.cfg.attention_impl) == "cuda"
                and not torch.is_grad_enabled()
                and not torch.cuda.is_current_stream_capturing())

    def _capture_step(self, token, k_pages, v_pages, page_table, lengths,
                      impl) -> Optional[_StepGraph]:
        """Capture the eager step over static copies of the inputs
        (``_record``), with its logits copied into the batch size's
        buffer, and note how far the host counts moved meanwhile.  The
        graphs' pool cannot take the blocks the eager steps and prefills
        left cached: where the capture runs out of memory, they are given
        back to the device (``empty_cache``) and it runs once more, and
        where that runs out too the key stays eager (None).  One capture
        at a time in the process, so no other thread captures while the
        cache is emptied."""
        t0 = time.perf_counter()
        head = self._head()
        B = token.shape[0]
        logits = self._graph_logits.get(B)
        if logits is None:
            logits = self._graph_logits[B] = torch.empty(
                (B, head.shape[-1]), dtype=head.dtype, device=token.device)
        g = _StepGraph(
            *(t.clone(memory_format=torch.contiguous_format)
              for t in (token, page_table, lengths)), logits)

        def step():
            out = self._paged_decode_step_eager(
                g.token, k_pages, v_pages, g.page_table, g.lengths,
                impl=impl)
            g.logits.copy_(out[0])

        before = self._host_counts()
        for attempt in range(2):
            try:
                with _CAPTURE_LOCK:
                    if attempt:
                        torch.cuda.empty_cache()
                    g.replay = self._record(step)
                break
            except torch.OutOfMemoryError:
                # the aborted capture counted part of a step: take it back
                self._add_host_counts(
                    {k: -n for k, n in
                     _moved(before, self._host_counts()).items()})
                if not self._graphs:
                    # no graph holds the pool any more, and the allocator
                    # shares only a pool in use: the next capture takes a
                    # new one
                    self._graph_pool = None
        else:
            return None
        g.moved = _moved(before, self._host_counts())
        self.decode_graph_captures += 1
        self.decode_graph_capture_s += time.perf_counter() - t0
        return g

    def _record(self, step: Callable[[], None]) -> Callable[[], None]:
        """Capture ``step()`` into a CUDA graph on the model's side stream,
        into the memory pool its graphs share (steps never overlap, and
        each step's logits are read before the next step), and return the
        graph's replay.  ``capture_begin`` directly: the
        ``torch.cuda.graph`` context synchronizes and empties the cache
        before each capture; ``thread_local``: the engine captures on its
        loop thread while others run."""
        dev = self.device
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
            self._graph_stream = torch.cuda.Stream(dev)
        side = self._graph_stream
        side.wait_stream(torch.cuda.current_stream(dev))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            graph.capture_begin(pool=self._graph_pool,
                                capture_error_mode="thread_local")
            try:
                step()
            finally:
                graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(side)
        return graph.replay

    def _drop_graphs(self) -> None:
        self._graphs: OrderedDict[tuple, _StepGraph] = OrderedDict()
        self._graph_calls: OrderedDict[tuple, int] = OrderedDict()
        self._graph_logits: Dict[int, torch.Tensor] = {}
        self._graph_pool = None
        self._graph_stream = None

    def _apply(self, fn, recurse=True):
        # the graphs hold the weights' addresses: moving or re-making the
        # weights (``to``, ``to_empty``) drops them
        self._drop_graphs()
        return super()._apply(fn, recurse)

    def _host_counts(self) -> Dict[str, int]:
        """The host counts the step's Python advances: this thread's
        kernel launches (``common.thread_launches``)."""
        return KC.thread_launches()

    def _add_host_counts(self, moved: Dict[str, int]) -> None:
        KC.add_launches(moved)

    def counters(self) -> Dict[str, float]:
        return {"decode_graph_replays": self.decode_graph_replays,
                "decode_graph_captures": self.decode_graph_captures,
                "decode_graph_capture_s": self.decode_graph_capture_s}

    @torch.no_grad()
    def _paged_decode_step_eager(self, token: torch.Tensor,
                                 k_pages: torch.Tensor,
                                 v_pages: torch.Tensor,
                                 page_table: torch.Tensor,
                                 lengths: torch.Tensor,
                                 impl: Optional[str] = None
                                 ) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
        """One autoregressive step straight over the page pool.

        token: (B,) int; k_pages/v_pages: the pool, (L, P, page, Hkv, Dh);
        page_table: (B, n_pages) int32 (each row's pages in sequence
        order, zero-padded); lengths: (B,) int32 with -1 for padded rows.
        Each layer lands the new token's KV at ``(page_table[b, len //
        page], len % page)`` IN PLACE and attends over the row's pages.
        Under ``impl="cuda"`` the paged kernel's table
        (``pd_ops.kernel_config`` at this pool's page size, KV heads, Dh
        and grouping) names the variant and its ``pages_per_block``:
        ``fused`` appends inside the attention kernel; ``single`` and
        ``blocked`` scatter first, then attend.  Under ``impl="torch"``
        the step scatters and gathers densely.  The scatter makes no host
        sync (``pd_ops.append_targets``), so the step runs on meta
        tensors under every variant.  Padded rows write nothing and are fully
        masked.  Returns ``(logits (B, Vpad), k_pages, v_pages)``, the
        pools being the tensors passed in.
        """
        cfg = self.cfg
        impl = impl or cfg.attention_impl
        if impl not in ("cuda", "torch"):
            raise ValueError(f"unknown attention impl {impl!r}")
        B = token.shape[0]
        ps = k_pages.shape[2]
        T = page_table.shape[1] * ps
        dev = token.device
        pos = lengths.to(torch.int32).contiguous()
        page_table = page_table.to(torch.int32).contiguous()
        posc = pos.clamp(min=0)
        x = L.embed_lookup(self.embed, token)[:, None, :]      # (B,1,D)
        if impl == "cuda":
            kc = pd_ops.kernel_config(ps, cfg.num_kv_heads, self.head_dim,
                                      cfg.num_heads // cfg.num_kv_heads)
            variant, ppb = kc["variant"], kc["pages_per_block"]
        else:
            variant = None
        fused = variant == "fused"
        if not fused:
            targets = pd_ops.append_targets(page_table, pos, ps)
        if impl == "torch":
            t_idx = torch.arange(T, dtype=torch.int32, device=dev)[None, :]
            kv_pos = torch.where(t_idx <= pos[:, None], t_idx, -1)
            pt_long = page_table.long()
        for i, blk in enumerate(self.blocks):
            kp_l, vp_l = k_pages[i], v_pages[i]
            q, k, v = self._qkv(blk, x, posc[:, None])
            k_t = k[:, 0].to(kp_l.dtype).contiguous()
            v_t = v[:, 0].to(vp_l.dtype).contiguous()
            if fused:
                o, _, _ = pd_ops.fused_paged_decode_attention(
                    q, kp_l, vp_l, page_table, pos, k_t, v_t,
                    pages_per_block=ppb)
            else:
                pd_ops.append_rows_(kp_l, targets, k_t)
                pd_ops.append_rows_(vp_l, targets, v_t)
                if impl == "cuda":
                    o = pd_ops.paged_decode_attention(
                        q, kp_l, vp_l, page_table, pos, variant=variant,
                        pages_per_block=ppb)
                else:
                    Hkv, Dh = cfg.num_kv_heads, self.head_dim
                    kd = kp_l[pt_long].reshape(B, T, Hkv, Dh).to(self.dtype)
                    vd = vp_l[pt_long].reshape(B, T, Hkv, Dh).to(self.dtype)
                    o = L.attention(q, kd, vd, q_positions=posc[:, None],
                                    kv_positions=kv_pos, causal=True,
                                    window=cfg.swa_window, impl="torch")
            x, _ = self._finish_block(blk, x, o)
        x = L.rms_norm(x, self.final_norm, cfg.norm_eps)
        return x[:, -1] @ self._head(), k_pages, v_pages

    # ------------------------------------------------- paged-KV engine hooks
    @property
    def prefill_rows_independent(self) -> bool:
        """Whether a row's ``prefill_with_cache`` result, in exact
        arithmetic (float32), depends on nothing but the row: not on the
        rows beside it, nor on padding past its own bucket.  True with no
        MoE layer.  (In bf16 the GEMMs' rounding still follows the call's
        row count and width.)  An MoE layer's expert capacity follows the
        chunk's padded length and its row grouping (``moe_ffn``), and so
        does which tokens an expert drops, in any precision."""
        return all(blk.moe is None for blk in self.blocks)

    def paged_kv_layout(self) -> Optional[Tuple[int, int, int]]:
        """(layers, kv_heads, head_dim) of the PagedKVCache backing this
        model's KV, or None for sliding-window attention: its ring wraps
        in place, which immutable pages cannot hold, so the engine keeps
        dense rows."""
        if self.cfg.swa_window:
            return None
        return (self.cfg.num_layers, self.cfg.num_kv_heads, self.head_dim)

    # ------------------------------------------------ dense-row engine hooks
    def cache_capacity(self, max_len: int) -> int:
        w = self.cfg.swa_window
        return min(max_len, w) if w else max_len

    def init_cache(self, batch: int, max_len: int) -> Cache:
        """A zero dense cache in the layout ``prefill`` fills, ``{"k", "v":
        (L,B,T,Hkv,Dh), "length": (B,)}`` with ``T = cache_capacity(
        max_len)``, on the model's device (meta tensors on a meta model).
        The JAX ``init_cache`` keeps an MoE model's unscanned lead layers
        in ``lead_k``/``lead_v``; here every layer is in ``k``/``v``."""
        cfg, dev = self.cfg, self.device
        shape = (cfg.num_layers, batch, self.cache_capacity(max_len),
                 cfg.num_kv_heads, self.head_dim)
        return {"k": torch.zeros(shape, dtype=self.dtype, device=dev),
                "v": torch.zeros(shape, dtype=self.dtype, device=dev),
                "length": torch.zeros(batch, dtype=torch.int32, device=dev)}

    def cache_batch_axes(self, cache: Cache) -> Dict[str, int]:
        return {k: (0 if k == "length" else 1) for k in cache}

    def extend_cache(self, cache: Cache, extra: int) -> Cache:
        """Grow the time axis by ``extra`` zero slots, up to
        ``cache_capacity``; a ring already at the window is returned
        unchanged."""
        T = cache["k"].shape[2]
        target = self.cache_capacity(T + extra)
        if target <= T:
            return cache
        out = dict(cache)
        for key in ("k", "v"):
            out[key] = F.pad(cache[key], (0, 0, 0, 0, 0, target - T))
        return out

    _kv_slot_positions = staticmethod(L.ring_slot_positions)

    def cache_kv_rows_dev(self, cache: Cache, row: int, length: int):
        """One sequence's KV from a dense cache as device tensors
        ``(L, length, Hkv, Dh)``, the page-store write format."""
        return cache["k"][:, row, :length], cache["v"][:, row, :length]

    def cache_kv_rows(self, cache: Cache, row: int):
        """Host float32 numpy variant of :meth:`cache_kv_rows_dev`, the
        migration wire format (exact for bf16)."""
        ln = int(cache["length"][row])
        k, v = self.cache_kv_rows_dev(cache, row, ln)
        return (k.float().cpu().numpy(), v.float().cpu().numpy())

    def paged_cache_view(self, k_rows, v_rows, lengths) -> Cache:
        """The dense chunk-prefill cache from gathered page rows.

        k_rows/v_rows: ``(B, L, T, Hkv, Dh)`` tensors or float32 numpy
        (zero past each row's length); lengths: per-row token counts.  The
        float32 -> model-dtype cast is exact for bf16 page contents.
        """
        dev = self.device

        def view(rows):
            t = torch.from_numpy(np.array(rows)) if isinstance(
                rows, np.ndarray) else rows
            return t.to(dev, self.dtype).transpose(0, 1).contiguous()

        return {"k": view(k_rows), "v": view(v_rows),
                "length": torch.as_tensor(list(lengths), dtype=torch.int32,
                                          device=dev)}
