"""DeepSeek-V2 on the paged path: multi-head latent attention over a
latent page pool, YaRN rotary positions, a dense lead layer and the
expert share (``moe_share.py``).

The equations (arXiv:2405.04434, the published ``config.json``): per
layer, from the normed hidden state h,

* ``c_q = RMSNorm(h W_DQ)``, ``q = c_q W_UQ`` split per head into
  ``q_nope`` (``qk_nope_head_dim``) and ``q_rope`` (``qk_rope_head_dim``),
  RoPE on ``q_rope``;
* ``c_kv = RMSNorm(h W_DKV)`` (``kv_lora_rank`` wide) and ``k_rope =
  RoPE(h W_KR)``, one for all heads: ``attn.wkv_a`` holds W_DKV and W_KR
  side by side, as the published ``kv_a_proj_with_mqa``;
* ``k_nope = c_kv W_UK`` and ``v = c_kv W_UV`` per head: ``attn.wkv_b``
  holds them per head side by side, as ``kv_b_proj``;
* ``softmax((q_nope . k_nope + q_rope . k_rope) s)``, then ``W_O`` over the
  heads, where ``s = mscale_yarn^2 / sqrt(qk_nope + qk_rope)``.

The page pool holds one latent a token a layer, ``[c_kv; k_rope]``
(``kv_lora_rank + qk_rope_head_dim`` float32 values): ``paged_kv_layout``
gives ``(layers, None, that width)``, and the pool keeps one tensor in
place of K and V (``kvcache.PagedKVCache``).

* Prefill (``prefill_with_cache``) writes the chunk's latents into the
  chunk view, decompresses every position's keys and values through
  ``W_UK``/``W_UV`` (an aliased prefix's too) and attends with the
  port's flash kernel at Dh 256 on zero-padded heads: q and k from 192,
  v from 128, q scaled by ``s sqrt(256)`` so that the kernel's own
  ``1/sqrt(256)`` leaves ``s``.  The padding costs 256/192 = 1.33 times
  the score work and 2 times the value work of a kernel at the true
  widths.
* Decode (``paged_decode_step``, which replays CUDA graphs of
  ``_paged_decode_step_eager`` as ``TransformerLM``'s does) takes the
  absorbed form: ``q~ = W_UK^T q_nope`` per head, joined with
  ``q_rope`` into one query of the latent's width, attends over the
  latent pages in the hand-written kernel
  (``kernels/latent_decode_attention``; the token's latent is scattered
  into its page first, with no host sync), whose output is the
  probability-weighted ``c_kv``; ``o = W_UV`` of that per head, then
  ``W_O``.

Departures from the published model: norms scale by ``1 + w`` (the
port's convention: weights drawn around 0); the rotary dimensions pair
as split halves where the published checkpoint interleaves them (a
permutation of the rope weights' columns, which random weights do not
see); the expert layer holds a share of the experts (``moe_share``).
Out of scope, each raising: training (``loss_fn``), the engine's dense
view (``decode_step``, ``paged_decode=False``) and KV migration.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import MLAConfig, ModelConfig
from repro_torch.engine.models import layers as L
from repro_torch.engine.models import moe_share as MS
from repro_torch.engine.models.transformer import Cache, TransformerLM
from repro_torch.kernels.latent_decode_attention import ops as ld_ops
from repro_torch.kernels.paged_decode_attention import ops as pd_ops


def yarn_mscale(scale: float, mscale: float) -> float:
    return 0.1 * mscale * math.log(scale) + 1.0 if scale > 1 else 1.0


def yarn_inv_freq(mla: MLAConfig, theta: float, device=None) -> torch.Tensor:
    """(qk_rope_head_dim / 2,) inverse frequencies: the interpolated
    (``/ rope_factor``) and the original ones blended by a linear ramp
    between the correction dimensions of ``beta_fast`` and
    ``beta_slow``."""
    dim = mla.qk_rope_head_dim
    base = theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                  device=device) / dim)
    extra, inter = 1.0 / base, 1.0 / (mla.rope_factor * base)

    def corr(rot):
        return dim * math.log(mla.original_max_position
                              / (rot * 2 * math.pi)) / (2 * math.log(theta))

    lo = max(math.floor(corr(mla.beta_fast)), 0)
    hi = min(math.ceil(corr(mla.beta_slow)), dim - 1)
    if lo == hi:
        hi += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device) - lo)
            / (hi - lo)).clamp(0, 1)
    keep = 1.0 - ramp
    return inter * (1 - keep) + extra * keep


def softmax_scale(mla: MLAConfig) -> float:
    s = (mla.qk_nope_head_dim + mla.qk_rope_head_dim) ** -0.5
    if mla.rope_factor > 1:
        m = yarn_mscale(mla.rope_factor, mla.mscale_all_dim)
        s *= m * m
    return s


def rope_cos_scale(mla: MLAConfig) -> float:
    return yarn_mscale(mla.rope_factor, mla.mscale) \
        / yarn_mscale(mla.rope_factor, mla.mscale_all_dim)


def apply_yarn_rope(x: torch.Tensor, positions: torch.Tensor,
                    inv_freq: torch.Tensor, cos_scale: float) -> torch.Tensor:
    """x (B, S, H, dr) at positions (B, S): split halves rotated, in f32."""
    ang = positions[..., None].float() * inv_freq
    cos = (torch.cos(ang) * cos_scale)[:, :, None, :]
    sin = (torch.sin(ang) * cos_scale)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class MLABlock(nn.Module):
    """One pre-norm block: latent attention, then a dense SwiGLU FFN
    (``ffn``, the lead layers) or the expert share (``moe``)."""

    def __init__(self, cfg: ModelConfig, dtype, device, layer: int):
        super().__init__()
        d, h, a = cfg.d_model, cfg.num_heads, cfg.mla
        dn, dr, dv = a.qk_nope_head_dim, a.qk_rope_head_dim, a.v_head_dim
        self.ln1 = L.param(d, dtype=dtype, device=device)
        self.ln2 = L.param(d, dtype=dtype, device=device)
        self.attn = L.param_dict({
            "wq_a": (d, a.q_lora_rank), "q_norm": (a.q_lora_rank,),
            "wq_b": (a.q_lora_rank, h * (dn + dr)),
            "wkv_a": (d, a.kv_lora_rank + dr), "kv_norm": (a.kv_lora_rank,),
            "wkv_b": (a.kv_lora_rank, h * (dn + dv)),
            "wo": (h * dv, d)}, dtype, device)
        m = cfg.moe
        self.ffn = self.moe = None
        if layer >= m.first_dense_layers:
            self.moe = MS.ExpertShare(d, m, cfg.routing, dtype, device)
            return
        f = m.d_ff_dense
        self.ffn = L.param_dict({"w_gate": (d, f), "w_up": (d, f),
                                 "w_down": (f, d)}, dtype, device)


class MLATransformerLM(TransformerLM):
    """The decoder of DeepSeek-V2 (``cfg.mla`` and ``cfg.routing`` set):
    ``TransformerLM``'s embedding, final norm and head, ``MLABlock``s, and
    the paged engine's hooks over a latent pool.

    ``counters()`` gives, besides the decode graphs' counts
    (``TransformerLM``), what the expert layer did since construction:
    ``expert_slots_held`` (token-expert slots the held experts computed,
    summed on the device and read only when asked), ``moe_layer_calls``
    (expert-layer calls, counted on the host, and at each replay of a
    captured decode step as many as its capture counted) and the latent
    kernel's launches (``latent_decode_launches``, ``ld_ops.launches``)."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        if cfg.mla is None or cfg.moe is None or cfg.routing is None:
            raise ValueError("MLATransformerLM needs cfg.mla, cfg.moe and "
                             "cfg.routing")
        if cfg.moe.num_experts % cfg.routing.n_group:
            raise ValueError("the experts must split evenly into n_group")
        super().__init__(cfg, device=device)
        a = cfg.mla
        self.latent_dim = a.kv_lora_rank + a.qk_rope_head_dim
        self.scale = softmax_scale(a)
        self.cos_scale = rope_cos_scale(a)
        self._inv_freq: Dict[torch.device, torch.Tensor] = {}
        self._slots: Optional[torch.Tensor] = None
        self.moe_layer_calls = 0

    def _new_block(self, layer: int, device) -> nn.Module:
        return MLABlock(self.cfg, self.dtype, device, layer)

    @torch.no_grad()
    def init(self, gen: torch.Generator) -> "MLATransformerLM":
        """Random weights from ``gen``: matrices normal / sqrt(fan_in), the
        embedding 0.02, norms 0."""
        for name, p in self.named_parameters():
            if p.dim() == 1:
                p.zero_()
                continue
            w = torch.randn(p.shape, generator=gen, device=gen.device)
            std = 0.02 if name == "embed" else 1.0 / math.sqrt(p.shape[-2])
            p.copy_(w * std)
        return self

    # ------------------------------------------------------------- pieces
    def _rope(self, x, positions):
        dev = positions.device
        if dev not in self._inv_freq:
            self._inv_freq[dev] = yarn_inv_freq(self.cfg.mla,
                                                self.cfg.rope_theta, dev)
        return apply_yarn_rope(x, positions, self._inv_freq[dev],
                               self.cos_scale)

    def _mla_inputs(self, blk: MLABlock, x, positions):
        """(h normed, q_nope (B,S,H,dn), q_rope (B,S,H,dr) rotated, the
        tokens' latents (B,S,kv_lora + dr): ``[c_kv; k_rope]``)."""
        cfg, a, p = self.cfg, self.cfg.mla, blk.attn
        B, S, _ = x.shape
        eps = cfg.norm_eps
        h = L.rms_norm(x, blk.ln1, eps)
        cq = L.rms_norm(h @ p["wq_a"], p["q_norm"], eps)
        q = (cq @ p["wq_b"]).view(B, S, cfg.num_heads, -1)
        q_nope, q_rope = q.split([a.qk_nope_head_dim, a.qk_rope_head_dim],
                                 dim=-1)
        kv = h @ p["wkv_a"]
        c_kv = L.rms_norm(kv[..., :a.kv_lora_rank], p["kv_norm"], eps)
        k_rope = self._rope(kv[..., None, a.kv_lora_rank:], positions)
        latent = torch.cat([c_kv, k_rope[:, :, 0]], dim=-1)
        return q_nope, self._rope(q_rope, positions), latent

    def _w_uk_uv(self, blk: MLABlock):
        """W_UK and W_UV as (kv_lora, H, dn) and (kv_lora, H, dv) views of
        ``wkv_b``."""
        a = self.cfg.mla
        w = blk.attn["wkv_b"].view(a.kv_lora_rank, self.cfg.num_heads, -1)
        return w[..., :a.qk_nope_head_dim], w[..., a.qk_nope_head_dim:]

    def _finish(self, blk: MLABlock, x, o, valid):
        """x + o W_O, then the FFN or the expert share on the normed sum."""
        x = x + o @ blk.attn["wo"]
        h = L.rms_norm(x, blk.ln2, self.cfg.norm_eps)
        if blk.moe is None:
            return x + L.ffn_apply(blk.ffn, h)
        if self._slots is None or self._slots.device != x.device:
            self._slots = torch.zeros((), dtype=torch.int64, device=x.device)
        self.moe_layer_calls += 1
        return x + MS.share_ffn(h, blk.moe, self.cfg.moe, self.cfg.routing,
                                valid=valid, slots_held=self._slots)

    def counters(self) -> Dict[str, float]:
        slots = 0 if self._slots is None else int(self._slots.item())
        return {**super().counters(), "expert_slots_held": slots,
                "moe_layer_calls": self.moe_layer_calls,
                "latent_decode_launches": ld_ops.launches}

    def _host_counts(self) -> Dict[str, int]:
        """Besides the kernels' launches: the expert-layer calls.
        ``expert_slots_held`` is summed on the device, inside the
        graph."""
        return {**super()._host_counts(),
                "moe_layer_calls": self.moe_layer_calls}

    def _add_host_counts(self, moved: Dict[str, int]) -> None:
        moved = dict(moved)
        self.moe_layer_calls += moved.pop("moe_layer_calls")
        super()._add_host_counts(moved)

    # ------------------------------------------------------ not served here
    def _unsupported(self, what: str):
        raise NotImplementedError(
            f"{self.cfg.name}: {what} is not implemented for latent "
            f"attention (paged serving only)")

    def forward_train(self, *args, **kw):
        self._unsupported("training or the teacher-forced forward")

    def decode_step(self, *args, **kw):
        self._unsupported("the dense-view decode step (paged_decode=False)")

    def cache_kv_rows(self, *args, **kw):
        self._unsupported("KV migration")

    # -------------------------------------------------------------- prefill
    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, impl: Optional[str] = None,
                prefix_embeds: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Cache]:
        """The whole prompt through ``prefill_with_cache`` over an empty
        latent view."""
        if prefix_embeds is not None:
            self._unsupported("prefix embeddings")
        B, S = tokens.shape
        lat = torch.zeros((self.cfg.num_layers, B, S, self.latent_dim),
                          dtype=self.dtype, device=tokens.device)
        cache = {"latent": lat, "length": torch.zeros(
            B, dtype=torch.int32, device=tokens.device)}
        return self.prefill_with_cache(tokens, cache, impl=impl)

    @torch.no_grad()
    def prefill_with_cache(self, tokens: torch.Tensor, cache: Cache,
                           impl: Optional[str] = None,
                           valid_len: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, Cache]:
        """Prefill ``tokens`` (B, S_suf) as a continuation of ``cache``
        (``{"latent": (L, B, T, kv_lora + dr), "length": (B,)}``), writing
        the chunk's latents IN PLACE at their slots, as
        ``TransformerLM.prefill_with_cache`` writes K and V; ``valid_len``
        as there.  Returns (logits (B, Vpad), cache with the new
        length)."""
        cfg, a = self.cfg, self.cfg.mla
        impl = impl or cfg.attention_impl
        B, Ssuf = tokens.shape
        dev = tokens.device
        H = cfg.num_heads
        dn, dr, dv = a.qk_nope_head_dim, a.qk_rope_head_dim, a.v_head_dim
        width = _pow2(max(dn + dr, dv))
        pos0 = cache["length"]
        x = L.embed_lookup(self.embed, tokens)
        ar = torch.arange(Ssuf, dtype=torch.int32, device=dev)
        positions = (pos0[:, None] + ar[None, :]).contiguous()
        # the keys attended: the view's slots up to the longest row's
        # cached positions plus the chunk (``paged_cache_view`` keeps that
        # many on the host), not the view's room for decoding
        T = cache["latent"].shape[2]
        T = min(T, cache.get("longest", T) + Ssuf)
        arange_t = torch.arange(T, dtype=torch.int32, device=dev)[None, :]
        kv_pos = torch.where(arange_t < (pos0 + Ssuf)[:, None], arange_t,
                             -1).to(torch.int32).contiguous()
        n_new = Ssuf if valid_len is None else valid_len.to(torch.int32)
        valid = (ar[None, :] < torch.as_tensor(n_new, device=dev)
                 .reshape(-1, 1)).expand(B, Ssuf)
        batch_ix = torch.arange(B, device=dev)[:, None]
        slots = positions.long()
        q_mul = self.scale * math.sqrt(width)
        # zero-padded heads, written in place each layer: the padding
        # stays 0 across the layers
        qp = x.new_zeros((B, Ssuf, H, width))
        kp = x.new_zeros((B, T, H, width))
        vp = x.new_zeros((B, T, H, width))
        r = a.kv_lora_rank
        for i, blk in enumerate(self.blocks):
            q_nope, q_rope, latent = self._mla_inputs(blk, x, positions)
            lat = cache["latent"][i]                           # (B, T', D)
            lat[batch_ix, slots] = latent
            lat = lat[:, :T]
            kv = (lat[..., :r] @ blk.attn["wkv_b"]).view(B, T, H, dn + dv)
            kp[..., :dn] = kv[..., :dn]
            kp[..., dn:dn + dr] = lat[:, :, None, r:]
            vp[..., :dv] = kv[..., dn:]
            torch.mul(q_nope, q_mul, out=qp[..., :dn])
            torch.mul(q_rope, q_mul, out=qp[..., dn:dn + dr])
            o = L.attention(qp, kp, vp, q_positions=positions,
                            kv_positions=kv_pos, causal=True, window=0,
                            impl=impl)[..., :dv]
            x = self._finish(blk, x, o.reshape(B, Ssuf, H * dv), valid)
        new_cache = dict(cache)
        new_cache["length"] = pos0 + n_new
        x = L.rms_norm(x, self.final_norm, cfg.norm_eps)
        if valid_len is None:
            last = x[:, -1]
        else:
            last = x[torch.arange(B, device=dev), valid_len.long() - 1]
        return last @ self._head(), new_cache

    # --------------------------------------------------------------- decode
    @torch.no_grad()
    def _paged_decode_step_eager(self, token: torch.Tensor,
                                 k_pages: torch.Tensor,
                                 v_pages: Optional[torch.Tensor],
                                 page_table: torch.Tensor,
                                 lengths: torch.Tensor,
                                 impl: Optional[str] = None
                                 ) -> Tuple[torch.Tensor, torch.Tensor, None]:
        """One autoregressive step over the latent pool ``k_pages`` (L, P,
        page, kv_lora + dr); ``v_pages`` is None (a latent pool has no
        V).  Each layer lands the token's latent at ``(page_table[b,
        len // page], len % page)`` IN PLACE (no host sync), then attends
        in the absorbed form: under ``impl="cuda"`` in the latent kernel
        (``ld_ops``), under ``"torch"`` in its plain version.  Padded rows
        (``lengths`` -1) write nothing and give 0.  Returns ``(logits (B,
        Vpad), k_pages, None)``."""
        cfg, a = self.cfg, self.cfg.mla
        impl = impl or cfg.attention_impl
        if impl not in ("cuda", "torch"):
            raise ValueError(f"unknown attention impl {impl!r}")
        if v_pages is not None:
            raise ValueError("a latent pool has no V pages")
        B = token.shape[0]
        H, dv = cfg.num_heads, a.v_head_dim
        pos = lengths.to(torch.int32).contiguous()
        page_table = page_table.to(torch.int32).contiguous()
        posc = pos.clamp(min=0)[:, None]
        targets = pd_ops.append_targets(page_table, pos, k_pages.shape[2])
        attend = ld_ops.latent_decode_attention if impl == "cuda" \
            else ld_ops.latent_decode_attention_ref
        valid = (pos >= 0)[:, None]
        x = L.embed_lookup(self.embed, token)[:, None, :]      # (B,1,D)
        for i, blk in enumerate(self.blocks):
            q_nope, q_rope, latent = self._mla_inputs(blk, x, posc)
            pool = k_pages[i]
            pd_ops.append_rows_(pool, targets,
                                latent[:, 0].to(pool.dtype).contiguous())
            w_uk, w_uv = self._w_uk_uv(blk)
            q_abs = torch.bmm(q_nope[:, 0].transpose(0, 1),
                              w_uk.permute(1, 2, 0))           # (H,B,r)
            q_lat = torch.cat([q_abs.transpose(0, 1), q_rope[:, 0]],
                              dim=-1).contiguous()            # (B,H,r+dr)
            o_lat = attend(q_lat, pool, page_table, pos, scale=self.scale,
                           v_dim=a.kv_lora_rank)
            o = torch.bmm(o_lat.transpose(0, 1), w_uv.permute(1, 0, 2))
            x = self._finish(blk, x, o.transpose(0, 1).reshape(B, 1, H * dv),
                             valid)
        x = L.rms_norm(x, self.final_norm, cfg.norm_eps)
        return x[:, -1] @ self._head(), k_pages, None

    # ------------------------------------------------- paged-KV engine hooks
    @property
    def prefill_rows_independent(self) -> bool:
        """True: the routing is dropless, so a row's experts and its
        result depend on the row alone (in exact arithmetic)."""
        return True

    def paged_kv_layout(self) -> Tuple[int, None, int]:
        """(layers, None, latent width): one latent a token a layer, no
        KV heads."""
        return (self.cfg.num_layers, None, self.latent_dim)

    def cache_kv_rows_dev(self, cache: Cache, row: int, length: int):
        """One sequence's latents ``(L, length, D)`` and None (no V)."""
        return cache["latent"][:, row, :length], None

    def paged_cache_view(self, k_rows, v_rows, lengths) -> Cache:
        """The chunk-prefill cache from gathered latent rows ``(B, L, T,
        D)`` (a tensor or float32 numpy); ``v_rows`` is None.  Besides the
        latents and the lengths it keeps the longest length as a host int
        (``"longest"``): a prefill attends over no slot past it and the
        chunk."""
        if v_rows is not None:
            raise ValueError("a latent cache has no V rows")
        dev = self.device
        t = torch.from_numpy(np.array(k_rows)) if isinstance(
            k_rows, np.ndarray) else k_rows
        lengths = list(lengths)
        return {"latent": t.to(dev, self.dtype).transpose(0, 1).contiguous(),
                "length": torch.as_tensor(lengths, dtype=torch.int32,
                                          device=dev),
                "longest": max(lengths, default=0)}


__all__ = ["MLATransformerLM", "apply_yarn_rope", "softmax_scale",
           "yarn_inv_freq"]
