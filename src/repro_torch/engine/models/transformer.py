"""Decoder-only transformer LM, dense family, as a PyTorch module.

The counterpart of ``repro/engine/models/transformer.py`` for the dense
family (qwen3-1.7b: GQA, qk-norm, tied embeddings).  MoE, sliding-window
attention and the VLM prefix are not ported yet and raise
``NotImplementedError`` (ROADMAP Queue 1 items 8 and 9).

Weights are ``(in, out)`` as in the JAX package; the blocks are a
``ModuleList`` where the JAX package stacks them on a leading layer axis
(``repro_torch.bridge`` splits that axis).  The module serves inference
only: its parameters do not require grad.  Unlike the JAX functions,
``prefill_with_cache``, ``paged_decode_step`` and ``decode_step`` write
KV into the cache or pool they are given IN PLACE, which saves the
whole-pool copy an immutable update would cost (about 1.9 GB at full
width).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.engine.models import layers as L
from repro_torch.kernels.paged_decode_attention import ops as pd_ops

Cache = Dict[str, torch.Tensor]


def _param(*shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(*shape, dtype=dtype, device=device),
                        requires_grad=False)


class Block(nn.Module):
    """One pre-norm attention + SwiGLU block."""

    def __init__(self, cfg: ModelConfig, head_dim: int, dtype, device):
        super().__init__()
        d, dh = cfg.d_model, head_dim
        h, hkv = cfg.num_heads, cfg.num_kv_heads
        self.ln1 = _param(d, dtype=dtype, device=device)
        self.ln2 = _param(d, dtype=dtype, device=device)
        attn = {"wq": (d, h * dh), "wk": (d, hkv * dh), "wv": (d, hkv * dh),
                "wo": (h * dh, d)}
        if cfg.qk_norm:
            attn.update(q_norm=(dh,), k_norm=(dh,))
        self.attn = nn.ParameterDict(
            {n: _param(*s, dtype=dtype, device=device)
             for n, s in attn.items()})
        self.ffn = nn.ParameterDict(
            {n: _param(*s, dtype=dtype, device=device)
             for n, s in (("w_gate", (d, cfg.d_ff)), ("w_up", (d, cfg.d_ff)),
                          ("w_down", (cfg.d_ff, d)))})


class TransformerLM(nn.Module):
    """The dense decoder; its weights live on ``device`` (the card unless
    the caller asks for the CPU, or "meta" until the engine loads)."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        if cfg.family != "dense" or cfg.moe is not None:
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet (ROADMAP Queue 1 "
                f"item 8: MoE)")
        if cfg.swa_window or cfg.num_patches:
            raise NotImplementedError(
                "sliding-window attention and the VLM prefix are not "
                "ported yet (ROADMAP Queue 1 item 9)")
        self.cfg = cfg
        self.head_dim = cfg.resolved_head_dim
        self.dtype = getattr(torch, cfg.dtype)
        self.embed = _param(cfg.padded_vocab, cfg.d_model, dtype=self.dtype,
                            device=device)
        self.final_norm = _param(cfg.d_model, dtype=self.dtype, device=device)
        if not cfg.tie_embeddings:
            self.lm_head = _param(cfg.d_model, cfg.padded_vocab,
                                  dtype=self.dtype, device=device)
        self.blocks = nn.ModuleList(
            Block(cfg, self.head_dim, self.dtype, device)
            for _ in range(cfg.num_layers))

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
            for name, w in L.ffn_init(gen, cfg.d_model, cfg.d_ff,
                                      self.dtype).items():
                blk.ffn[name].copy_(w)
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
        x = x + L.attn_out(blk.attn, o)
        h = L.rms_norm(x, blk.ln2, self.cfg.norm_eps)
        return x + L.ffn_apply(blk.ffn, h)

    # --------------------------------------------------------------- forward
    @torch.no_grad()
    def forward(self, tokens: torch.Tensor, impl: Optional[str] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Teacher-forced forward.  Returns (logits (B,S,Vpad), aux)."""
        logits, _ = self._run_prompt(tokens, impl, all_logits=True)
        return logits, torch.zeros((), device=tokens.device)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, impl: Optional[str] = None
                ) -> Tuple[torch.Tensor, Cache]:
        """Run the full prompt; return (last-position logits, filled cache
        ``{"k", "v": (L,B,S,Hkv,Dh), "length": (B,) int32}``)."""
        return self._run_prompt(tokens, impl, all_logits=False)

    def _run_prompt(self, tokens, impl, all_logits):
        cfg = self.cfg
        impl = impl or cfg.attention_impl
        x = self.embed[tokens]
        B, S, _ = x.shape
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S).contiguous()
        ks, vs = [], []
        for blk in self.blocks:
            q, k, v = self._qkv(blk, x, positions)
            o = L.attention(q, k, v, q_positions=positions,
                            kv_positions=positions, causal=True,
                            window=cfg.swa_window, impl=impl)
            x = self._finish_block(blk, x, o)
            ks.append(k)
            vs.append(v)
        x = L.rms_norm(x, self.final_norm, cfg.norm_eps)
        if all_logits:
            return x @ self._head(), None
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
        new length).
        """
        cfg = self.cfg
        impl = impl or cfg.attention_impl
        B, Ssuf = tokens.shape
        dev = tokens.device
        pos0 = cache["length"]                               # (B,)
        x = self.embed[tokens]
        positions = (pos0[:, None] + torch.arange(
            Ssuf, dtype=torch.int32, device=dev)[None, :]).contiguous()
        T = cache["k"].shape[2]
        arange_t = torch.arange(T, dtype=torch.int32, device=dev)[None, :]
        kv_pos = torch.where(arange_t < (pos0 + Ssuf)[:, None], arange_t,
                             -1).to(torch.int32).contiguous()
        batch_ix = torch.arange(B, device=dev)[:, None]
        slots = positions.long()
        for i, blk in enumerate(self.blocks):
            q, k, v = self._qkv(blk, x, positions)
            k_cache, v_cache = cache["k"][i], cache["v"][i]
            k_cache[batch_ix, slots] = k
            v_cache[batch_ix, slots] = v
            o = L.attention(q, k_cache, v_cache, q_positions=positions,
                            kv_positions=kv_pos, causal=True, window=0,
                            impl=impl)
            x = self._finish_block(blk, x, o)
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
        Hkv,Dh), "length": (B,)}``, the engine's dense-view arm
        (``paged_decode=False``).

        Each layer writes the new token's K/V at slot ``length`` IN PLACE
        and attends over the slots holding positions ``<= length`` (under
        ``impl="cuda"`` in the decode_attention kernel).  Returns (logits
        (B,Vpad), a dict of the same tensors with ``length + 1``).
        """
        cfg = self.cfg
        impl = impl or cfg.attention_impl
        B = token.shape[0]
        T = cache["k"].shape[2]
        pos = cache["length"].to(torch.int32)
        slot = torch.remainder(pos, T).long()
        t_idx = torch.arange(T, dtype=torch.int32, device=token.device)[None]
        kv_pos = torch.where(t_idx <= pos[:, None], t_idx, -1).to(
            torch.int32).contiguous()
        batch_ix = torch.arange(B, device=token.device)
        x = self.embed[token][:, None, :]                    # (B,1,D)
        for i, blk in enumerate(self.blocks):
            q, k, v = self._qkv(blk, x, pos[:, None])
            k_cache, v_cache = cache["k"][i], cache["v"][i]
            k_cache[batch_ix, slot] = k[:, 0]
            v_cache[batch_ix, slot] = v[:, 0]
            o = L.attention(q, k_cache, v_cache, q_positions=pos[:, None],
                            kv_positions=kv_pos, causal=True,
                            window=cfg.swa_window, impl=impl)
            x = self._finish_block(blk, x, o)
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
    @torch.no_grad()
    def paged_decode_step(self, token: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, page_table: torch.Tensor,
                          lengths: torch.Tensor, impl: Optional[str] = None,
                          variant: Optional[str] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
        """One autoregressive step straight over the page pool.

        token: (B,) int; k_pages/v_pages: the pool, (L, P, page, Hkv, Dh);
        page_table: (B, n_pages) int32 (each row's pages in sequence
        order, zero-padded); lengths: (B,) int32 with -1 for padded rows.
        Each layer lands the new token's KV at ``(page_table[b, len //
        page], len % page)`` IN PLACE and attends over the row's pages.
        Under ``impl="cuda"`` the kernel ``variant`` (None = ``fused``)
        picks how: ``fused`` appends inside the attention kernel;
        ``single``/``blocked`` scatter first, then attend.  Under
        ``impl="torch"`` the step scatters and gathers densely.  Padded
        rows write nothing (they are masked out of the scatter) and are
        fully masked.  Returns ``(logits (B, Vpad), k_pages, v_pages)``,
        the pools being the tensors passed in.
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
        x = self.embed[token][:, None, :]                    # (B,1,D)
        variant = (variant or pd_ops.DEFAULT_VARIANT) if impl == "cuda" \
            else None
        fused = variant == "fused"
        if not fused:
            # padding rows are masked out of the scatter (torch has no
            # out-of-bounds drop mode); one host sync per step, not per
            # layer
            rows = torch.nonzero(pos >= 0).squeeze(1)
            w_page = page_table[rows, (posc[rows] // ps).long()].long()
            w_off = (posc[rows] % ps).long()
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
                    q, kp_l, vp_l, page_table, pos, k_t, v_t)
            else:
                kp_l[w_page, w_off] = k_t[rows]
                vp_l[w_page, w_off] = v_t[rows]
                if impl == "cuda":
                    o = pd_ops.paged_decode_attention(
                        q, kp_l, vp_l, page_table, pos, variant=variant)
                else:
                    Hkv, Dh = cfg.num_kv_heads, self.head_dim
                    kd = kp_l[pt_long].reshape(B, T, Hkv, Dh).to(self.dtype)
                    vd = vp_l[pt_long].reshape(B, T, Hkv, Dh).to(self.dtype)
                    o = L.attention(q, kd, vd, q_positions=posc[:, None],
                                    kv_positions=kv_pos, causal=True,
                                    window=cfg.swa_window, impl="torch")
            x = self._finish_block(blk, x, o)
        x = L.rms_norm(x, self.final_norm, cfg.norm_eps)
        return x[:, -1] @ self._head(), k_pages, v_pages

    # ------------------------------------------------- paged-KV engine hooks
    def paged_kv_layout(self) -> Optional[Tuple[int, int, int]]:
        """(layers, kv_heads, head_dim) of the PagedKVCache backing this
        model's KV."""
        return (self.cfg.num_layers, self.cfg.num_kv_heads, self.head_dim)

    def cache_capacity(self, max_len: int) -> int:
        return max_len

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
