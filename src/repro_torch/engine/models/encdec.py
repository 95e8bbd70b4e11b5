"""Encoder-decoder transformer (whisper-tiny) as a PyTorch module.

The counterpart of ``repro/engine/models/encdec.py``.  The conv/mel
frontend is a stub: the model takes precomputed frame embeddings
``frames`` (B, T_enc, d_model).  The encoder attends bidirectionally over
the frames (non-causal flash under ``impl="cuda"``); the decoder has
causal self-attention and cross-attention over the encoder states.
LayerNorm with a bias, non-gated FFNs with tanh GELU, sinusoidal
positions, no RoPE, a tied head.

The decode cache holds the decoder's self-attention KV ``k``/``v``
(L,B,T,Hkv,Dh), the cross-attention KV over the encoder states
``xk``/``xv`` (L,B,T_enc,Hkv,Dh), made once at prefill, ``enc_len`` and
``length`` (B,).  ``extend_cache`` pads ``xk``/``xv`` to ``enc_max_len``
so that rows with different frame counts stack into one decode batch:
``enc_len`` masks the padded slots.  A decode step's cross-attention is a
one-token non-causal query, which ``layers.attention`` hands the decode
kernel with each row's last frame as its position.  ``decode_step``
writes the new token's K/V into ``k``/``v`` IN PLACE.  Serving runs
under ``torch.no_grad()``; ``loss_fn`` trains through ``forward_train``
(the batch carries ``frames``), which holds no KV and, with ``remat``,
rematerializes each encoder and decoder block in the backward (the JAX
function takes ``remat`` and ignores it: the same values either way).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.engine.models import layers as L

Cache = Dict[str, torch.Tensor]


class Block(nn.Module):
    """An encoder block (``ln1``, ``attn``, ``ln2``, ``ffn``) or, with
    ``cross``, a decoder block (adds ``ln_x`` and ``xattn``)."""

    def __init__(self, cfg: ModelConfig, head_dim: int, dtype, device,
                 cross: bool):
        super().__init__()
        d, dh = cfg.d_model, head_dim
        h, hkv = cfg.num_heads, cfg.num_kv_heads
        ln = {"w": (d,), "b": (d,)}
        attn = {"wq": (d, h * dh), "wk": (d, hkv * dh), "wv": (d, hkv * dh),
                "wo": (h * dh, d)}
        self.ln1 = L.param_dict(ln, dtype, device)
        self.attn = L.param_dict(attn, dtype, device)
        if cross:
            self.ln_x = L.param_dict(ln, dtype, device)
            self.xattn = L.param_dict(attn, dtype, device)
        self.ln2 = L.param_dict(ln, dtype, device)
        self.ffn = L.param_dict(
            {"w_up": (d, cfg.d_ff), "w_down": (cfg.d_ff, d)}, dtype, device)


class EncDecLM(nn.Module):
    """Whisper-style encoder-decoder; its weights live on ``device`` (the
    card unless the caller asks for the CPU, or "meta" until the engine
    loads)."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.head_dim = cfg.resolved_head_dim
        self.dtype = getattr(torch, cfg.dtype)
        d = cfg.d_model
        self.embed = L.param(cfg.padded_vocab, d, dtype=self.dtype,
                             device=device)
        self.enc_blocks = nn.ModuleList(
            Block(cfg, self.head_dim, self.dtype, device, cross=False)
            for _ in range(cfg.enc_layers))
        self.dec_blocks = nn.ModuleList(
            Block(cfg, self.head_dim, self.dtype, device, cross=True)
            for _ in range(cfg.num_layers))
        self.enc_ln = L.param_dict({"w": (d,), "b": (d,)}, self.dtype, device)
        self.dec_ln = L.param_dict({"w": (d,), "b": (d,)}, self.dtype, device)
        self._pe: Optional[torch.Tensor] = None

    # ------------------------------------------------------------------ init
    @torch.no_grad()
    def init(self, gen: torch.Generator) -> "EncDecLM":
        """Random weights from ``gen`` with the JAX package's scales (norm
        weights 1, biases 0).  The draws differ from JAX's; tests bridge
        JAX's own weights instead."""
        cfg = self.cfg
        d = cfg.d_model
        self.embed.copy_(L.embed_init(gen, cfg.padded_vocab, d, self.dtype))
        for blk in [*self.enc_blocks, *self.dec_blocks]:
            for name, mod in blk.named_children():
                if name.startswith("ln"):
                    mod["w"].fill_(1.0)
                    mod["b"].zero_()
                elif name == "ffn":
                    mod["w_up"].copy_(L.dense_init(gen, d, cfg.d_ff,
                                                   self.dtype))
                    mod["w_down"].copy_(L.dense_init(gen, cfg.d_ff, d,
                                                     self.dtype))
                else:
                    for n, w in L.attn_init(gen, d, cfg.num_heads,
                                            cfg.num_kv_heads, self.head_dim,
                                            self.dtype).items():
                        mod[n].copy_(w)
        for ln in (self.enc_ln, self.dec_ln):
            ln["w"].fill_(1.0)
            ln["b"].zero_()
        return self

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _positions_table(self, length: int) -> torch.Tensor:
        """The first ``length`` rows of the sinusoidal table in the model
        dtype (a row does not depend on the table's length).  One table,
        made at the first call and again only when a longer one or
        another device is asked for."""
        pe = self._pe
        if pe is None or pe.shape[0] < length or pe.device != self.device:
            rows = max(length, self.cfg.enc_max_len)
            pe = self._pe = L.sinusoidal_positions(
                rows, self.cfg.d_model, self.device).to(self.dtype)
        return pe[:length]

    @staticmethod
    def _ln(p, x):
        return L.layer_norm(x, p["w"], p["b"])

    def _qkv(self, p, h, positions):
        cfg = self.cfg
        return L.attn_qkv(p, h, num_heads=cfg.num_heads,
                          num_kv_heads=cfg.num_kv_heads,
                          head_dim=self.head_dim, positions=positions,
                          rope_theta=1.0, use_rope=False)

    def _cross_kv(self, p, enc_out):
        B, T = enc_out.shape[:2]
        shape = (B, T, self.cfg.num_kv_heads, self.head_dim)
        return ((enc_out @ p["wk"]).reshape(shape),
                (enc_out @ p["wv"]).reshape(shape))

    @staticmethod
    def _run(fn, remat, *args):
        """``fn(*args)``, rematerialized in the backward with ``remat``."""
        if remat:
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    # --------------------------------------------------------------- encoder
    def _enc_block(self, blk: Block, x, positions, impl):
        q, k, v = self._qkv(blk.attn, self._ln(blk.ln1, x), positions)
        o = L.attention(q, k, v, q_positions=positions,
                        kv_positions=positions, causal=False, impl=impl)
        x = x + L.attn_out(blk.attn, o)
        return x + L.ffn_apply_nogate(blk.ffn, self._ln(blk.ln2, x))

    def _encode(self, frames, impl, remat=False):
        B, T, _ = frames.shape
        x = frames.to(self.dtype) + self._positions_table(T)[None]
        positions = torch.arange(T, dtype=torch.int32,
                                 device=x.device).expand(B, T).contiguous()
        for blk in self.enc_blocks:
            x = self._run(self._enc_block, remat, blk, x, positions, impl)
        return self._ln(self.enc_ln, x)

    @torch.no_grad()
    def encode(self, frames: torch.Tensor,
               impl: Optional[str] = None) -> torch.Tensor:
        """frames: (B, T, D) stub frontend output -> encoder states."""
        return self._encode(frames, impl or self.cfg.attention_impl)

    # --------------------------------------------------------------- decoder
    def _dec_block(self, blk: Block, x, positions, enc_out, enc_positions,
                   impl):
        """One decoder block over the whole sequence: (x, (k, v, xk, xv))."""
        B, S, _ = x.shape
        q, k, v = self._qkv(blk.attn, self._ln(blk.ln1, x), positions)
        o = L.attention(q, k, v, q_positions=positions,
                        kv_positions=positions, causal=True, impl=impl)
        x = x + L.attn_out(blk.attn, o)
        h = self._ln(blk.ln_x, x)
        qx = (h @ blk.xattn["wq"]).reshape(B, S, self.cfg.num_heads,
                                           self.head_dim)
        kx, vx = self._cross_kv(blk.xattn, enc_out)
        ox = L.attention(qx, kx, vx, q_positions=positions,
                         kv_positions=enc_positions, causal=False,
                         impl=impl)
        x = x + L.attn_out(blk.xattn, ox)
        x = x + L.ffn_apply_nogate(blk.ffn, self._ln(blk.ln2, x))
        return x, (k, v, kx, vx)

    def _dec_block_x(self, *args):
        return self._dec_block(*args)[0]

    def _decoder_inputs(self, tokens, enc_out):
        """(x, positions, enc_positions) of a whole-sequence decoder pass."""
        B, T_enc, _ = enc_out.shape
        S = tokens.shape[1]
        dev = tokens.device
        enc_positions = torch.arange(T_enc, dtype=torch.int32,
                                     device=dev).expand(B, T_enc).contiguous()
        positions = torch.arange(S, dtype=torch.int32,
                                 device=dev).expand(B, S).contiguous()
        x = L.embed_lookup(self.embed, tokens) + self._positions_table(S)[None]
        return x, positions, enc_positions

    def _dec_prompt(self, tokens, frames, impl):
        """Encode, then run the decoder over the whole prompt.  Returns
        (last-position logits, per-layer (k, v, xk, xv), T_enc)."""
        impl = impl or self.cfg.attention_impl
        enc_out = self._encode(frames, impl)
        x, positions, enc_positions = self._decoder_inputs(tokens, enc_out)
        kvs = []
        for blk in self.dec_blocks:
            x, kv = self._dec_block(blk, x, positions, enc_out,
                                    enc_positions, impl)
            kvs.append(kv)
        x = self._ln(self.dec_ln, x)
        return x[:, -1] @ self.embed.T, kvs, enc_out.shape[1]

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor, frames: torch.Tensor,
                impl: Optional[str] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Teacher-forced decoder over the full sequence -> (logits
        (B,S,Vpad), aux 0)."""
        return self.forward_train(tokens, frames, impl=impl)

    def forward_train(self, tokens: torch.Tensor, frames: torch.Tensor,
                      remat: bool = False, impl: Optional[str] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The teacher-forced forward with its graph: (logits, aux 0)."""
        impl = impl or self.cfg.attention_impl
        enc_out = self._encode(frames, impl, remat)
        x, positions, enc_positions = self._decoder_inputs(tokens, enc_out)
        for blk in self.dec_blocks:
            x = self._run(self._dec_block_x, remat, blk, x, positions,
                          enc_out, enc_positions, impl)
        x = self._ln(self.dec_ln, x)
        return x @ self.embed.T, torch.zeros((), device=tokens.device)

    def loss_fn(self, batch: Dict[str, torch.Tensor], remat: bool = False,
                impl: Optional[str] = None) -> torch.Tensor:
        """Next-token cross-entropy of ``batch["tokens"]`` (decoded over
        ``batch["frames"]``) against ``batch["labels"]`` shifted by one
        (``loss_mask`` shifted alike: the JAX function passes it
        unshifted, which fails on its own shapes)."""
        logits, _ = self.forward_train(batch["tokens"], batch["frames"],
                                       remat=remat, impl=impl)
        return L.next_token_loss(logits, batch, self.cfg.vocab_size)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, frames: torch.Tensor,
                impl: Optional[str] = None) -> Tuple[torch.Tensor, Cache]:
        """Encode the frames, run the decoder prompt, build the caches.
        Returns (last logits (B,Vpad), cache)."""
        logits, kvs, T_enc = self._dec_prompt(tokens, frames, impl)
        B, S = tokens.shape
        cache = {key: torch.stack([kv[i] for kv in kvs])
                 for i, key in enumerate(("k", "v", "xk", "xv"))}
        cache["enc_len"] = torch.full((B,), T_enc, dtype=torch.int32,
                                      device=tokens.device)
        cache["length"] = torch.full((B,), S, dtype=torch.int32,
                                     device=tokens.device)
        return logits, cache

    # ------------------------------------------------------------- KV cache
    def cache_batch_axes(self, cache: Cache) -> Dict[str, int]:
        return {k: (0 if k in ("length", "enc_len") else 1) for k in cache}

    def paged_kv_layout(self):
        """Cross-attention KV is indexed by frame, not by token: the
        engine keeps the encoder and decoder state as dense rows."""
        return None

    def extend_cache(self, cache: Cache, extra: int) -> Cache:
        """Grow the self-attention KV's time axis by ``extra`` zero slots,
        and pad the cross-attention KV to ``enc_max_len``."""
        out = dict(cache)
        for key in ("k", "v"):
            out[key] = F.pad(cache[key], (0, 0, 0, 0, 0, extra))
        t_enc = cache["xk"].shape[2]
        if t_enc < self.cfg.enc_max_len:
            for key in ("xk", "xv"):
                out[key] = F.pad(cache[key], (0, 0, 0, 0, 0,
                                              self.cfg.enc_max_len - t_enc))
        return out

    def init_cache(self, batch: int, max_len: int) -> Cache:
        cfg, dev = self.cfg, self.device
        shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads,
                 self.head_dim)
        xshape = shape[:2] + (cfg.enc_max_len,) + shape[3:]
        return {"k": torch.zeros(shape, dtype=self.dtype, device=dev),
                "v": torch.zeros(shape, dtype=self.dtype, device=dev),
                "xk": torch.zeros(xshape, dtype=self.dtype, device=dev),
                "xv": torch.zeros(xshape, dtype=self.dtype, device=dev),
                "enc_len": torch.zeros(batch, dtype=torch.int32, device=dev),
                "length": torch.zeros(batch, dtype=torch.int32, device=dev)}

    # ------------------------------------------------------------ decode step
    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, cache: Cache,
                    impl: Optional[str] = None) -> Tuple[torch.Tensor, Cache]:
        """token: (B,) int.  One decoder step at ``cache["length"]``: each
        layer writes the token's K/V at that slot IN PLACE, attends over
        the slots up to it, then over the row's ``enc_len`` frames.
        Returns (logits (B,Vpad), a dict of the same tensors with
        ``length + 1``)."""
        cfg = self.cfg
        impl = impl or cfg.attention_impl
        B = token.shape[0]
        dev = token.device
        pos = cache["length"].to(torch.int32)
        T, T_enc = cache["k"].shape[2], cache["xk"].shape[2]
        x = (L.embed_lookup(self.embed, token)
             + self._positions_table(T)[pos.long()])[:, None]
        slots = torch.arange(T, dtype=torch.int32, device=dev)[None]
        kv_pos = torch.where(slots <= pos[:, None], slots, -1).to(
            torch.int32).contiguous()
        frames = torch.arange(T_enc, dtype=torch.int32, device=dev)[None]
        enc_positions = torch.where(frames < cache["enc_len"][:, None],
                                    frames, -1).to(torch.int32).contiguous()
        q_pos = pos[:, None]
        batch_ix = torch.arange(B, device=dev)
        slot = pos.long()
        for i, blk in enumerate(self.dec_blocks):
            q, k, v = self._qkv(blk.attn, self._ln(blk.ln1, x), q_pos)
            k_c, v_c = cache["k"][i], cache["v"][i]
            L.write_slots_(k_c, batch_ix, slot, k[:, 0])
            L.write_slots_(v_c, batch_ix, slot, v[:, 0])
            o = L.attention(q, k_c, v_c, q_positions=q_pos,
                            kv_positions=kv_pos, causal=True, impl=impl)
            x = x + L.attn_out(blk.attn, o)
            h = self._ln(blk.ln_x, x)
            qx = (h @ blk.xattn["wq"]).reshape(B, 1, cfg.num_heads,
                                               self.head_dim)
            ox = L.attention(qx, cache["xk"][i], cache["xv"][i],
                             q_positions=q_pos, kv_positions=enc_positions,
                             causal=False, impl=impl)
            x = x + L.attn_out(blk.xattn, ox)
            x = x + L.ffn_apply_nogate(blk.ffn, self._ln(blk.ln2, x))
        new_cache = dict(cache)
        new_cache["length"] = pos + 1
        x = self._ln(self.dec_ln, x)
        return x[:, -1] @ self.embed.T, new_cache
