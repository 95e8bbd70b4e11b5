"""Griffin-style hybrid LM (recurrentgemma-2b) as a PyTorch module.

The counterpart of ``repro/engine/models/rglru.py``.  Block pattern
``(rglru, rglru, attn)`` tiled over ``num_layers`` (26 = 8 full groups +
2 leftover recurrent blocks); every temporal-mix block is followed by a
gated MLP, with residuals around both.

* RG-LRU: r, i = sigmoid gates (f32 matmuls); log a = -c*softplus(lam)*r
  (c = 8); h_t = a_t*h_{t-1} + sqrt(1 - a_t^2)*(i_t*x_t), an elementwise
  linear recurrence.  Its sequence form runs the hand-written scan kernel
  under ``impl="cuda"`` and a Python loop over time under ``"torch"``;
  decode is the single-step form.  (The JAX ``prefill`` always inlines an
  associative scan; here the prefill's recurrence goes through the same
  ``impl`` switch, so the serving path runs the kernel.)
* Local attention: MQA, RoPE, a sliding window; the KV cache is a ring
  buffer of ``cache_capacity`` slots in which position p sits in slot
  ``p % T``.  ``prefill`` places the last T prompt positions so (a roll
  by ``S % T`` when the prompt is longer than the window); the JAX
  reference keeps them in slots 0..T-1, which disagrees with its own
  ``decode_step`` unless ``S % T == 0`` (ROADMAP Queue 3).

The 26 blocks are one ``ModuleList`` in layer order (group g, position i
is layer ``3g + i``, then the leftovers); ``repro_torch.bridge`` splits
the JAX group axis.  The cache keeps the JAX layout: ``g{i}_*`` leaves
stacked ``(G, B, ...)`` over groups, ``l{j}_*`` leaves ``(B, ...)``, and
``length`` (B,).  ``decode_step`` updates the cache's tensors IN PLACE.
Inference only: the parameters do not require grad.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.engine.models import layers as L
from repro_torch.engine.models.xlstm import causal_conv1d, causal_conv1d_step
from repro_torch.kernels.rglru_scan import ops as lru_ops
from repro_torch.kernels.rglru_scan.ref import linear_scan_ref

Cache = Dict[str, torch.Tensor]
RG_C = 8.0


# ---------------------------------------------------------------------------
# RG-LRU core
# ---------------------------------------------------------------------------

def rglru_gates(p, u: torch.Tensor):
    """u: (..., D_rnn) -> (a, b) of the recurrence h = a*h_prev + b, f32."""
    u32 = u.float()
    r = torch.sigmoid(u32 @ p["w_a"].float() + p["b_a"])
    i = torch.sigmoid(u32 @ p["w_x"].float() + p["b_x"])
    log_a = -RG_C * F.softplus(p["lam"]) * r
    a = torch.exp(log_a)
    scale = torch.sqrt(torch.clamp(-torch.expm1(2.0 * log_a), min=1e-12))
    return a, scale * (i * u32)


def rglru_sequence(p, u: torch.Tensor, impl: str = "torch") -> torch.Tensor:
    """u: (B,S,D) -> h: (B,S,D) from a zero state, in f32 (the JAX
    function returns u's dtype; the prefill keeps the last h in f32, so
    callers cast)."""
    a, b = rglru_gates(p, u)
    if impl == "cuda":
        return lru_ops.linear_scan(a.contiguous(), b.contiguous())
    if impl == "torch":
        return linear_scan_ref(a, b)
    raise ValueError(f"unknown recurrence impl {impl!r}")


def rglru_step(p, u_t: torch.Tensor, h_prev: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """u_t: (B,D); h_prev: (B,D) f32.  Returns (h in u_t's dtype, h f32)."""
    a, b = rglru_gates(p, u_t)
    h = a * h_prev + b
    return h.to(u_t.dtype), h


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _param(*shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(*shape, dtype=dtype, device=device),
                        requires_grad=False)


def _mlp(cfg: ModelConfig, dtype, device) -> nn.ParameterDict:
    d = cfg.d_model
    return nn.ParameterDict(
        {n: _param(*s, dtype=dtype, device=device)
         for n, s in (("ln", (d,)), ("w_gate", (d, cfg.d_ff)),
                      ("w_up", (d, cfg.d_ff)), ("w_down", (cfg.d_ff, d)))})


class RecurrentBlock(nn.Module):
    """RG-LRU temporal mix + MLP.  ``rg``'s biases and lam stay f32, as
    the JAX init makes them."""

    def __init__(self, cfg: ModelConfig, d_rnn: int, dtype, device):
        super().__init__()
        d = cfg.d_model
        self.ln = _param(d, dtype=dtype, device=device)
        self.w_gate = _param(d, d_rnn, dtype=dtype, device=device)
        self.w_in = _param(d, d_rnn, dtype=dtype, device=device)
        self.conv_w = _param(cfg.conv1d_width, d_rnn, dtype=dtype,
                             device=device)
        f32 = torch.float32
        self.rg = nn.ParameterDict({
            "w_a": _param(d_rnn, d_rnn, dtype=dtype, device=device),
            "b_a": _param(d_rnn, dtype=f32, device=device),
            "w_x": _param(d_rnn, d_rnn, dtype=dtype, device=device),
            "b_x": _param(d_rnn, dtype=f32, device=device),
            "lam": _param(d_rnn, dtype=f32, device=device)})
        self.w_out = _param(d_rnn, d, dtype=dtype, device=device)
        self.mlp = _mlp(cfg, dtype, device)


class AttentionBlock(nn.Module):
    """Local MQA attention + MLP."""

    def __init__(self, cfg: ModelConfig, head_dim: int, dtype, device):
        super().__init__()
        d, dh = cfg.d_model, head_dim
        h, hkv = cfg.num_heads, cfg.num_kv_heads
        self.ln = _param(d, dtype=dtype, device=device)
        self.attn = nn.ParameterDict(
            {n: _param(*s, dtype=dtype, device=device)
             for n, s in (("wq", (d, h * dh)), ("wk", (d, hkv * dh)),
                          ("wv", (d, hkv * dh)), ("wo", (h * dh, d)))})
        self.mlp = _mlp(cfg, dtype, device)


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

class GriffinLM(nn.Module):
    """The hybrid; its weights live on ``device`` (the card unless the
    caller asks for the CPU, or "meta" until the engine loads)."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.dtype)
        self.head_dim = cfg.resolved_head_dim
        self.d_rnn = cfg.lru_width or cfg.d_model
        self.pattern = cfg.block_pattern or ("rglru", "rglru", "attn")
        self.glen = len(self.pattern)
        self.n_groups = cfg.num_layers // self.glen
        self.n_leftover = cfg.num_layers % self.glen
        if any(k != "rglru" for k in self.pattern[:self.n_leftover]):
            raise NotImplementedError("leftover blocks must be recurrent, "
                                      "as in the JAX model")
        self.embed = _param(cfg.padded_vocab, cfg.d_model, dtype=self.dtype,
                            device=device)
        self.final_norm = _param(cfg.d_model, dtype=self.dtype, device=device)
        self.blocks = nn.ModuleList(
            RecurrentBlock(cfg, self.d_rnn, self.dtype, device)
            if self._kind(l) == "rglru"
            else AttentionBlock(cfg, self.head_dim, self.dtype, device)
            for l in range(cfg.num_layers))

    def _kind(self, layer: int) -> str:
        return self.pattern[layer % self.glen]

    def _state(self, layer: int) -> Tuple[str, Optional[int]]:
        """Cache-key prefix and group index of a layer's state."""
        if layer < self.n_groups * self.glen:
            return f"g{layer % self.glen}", layer // self.glen
        return f"l{layer - self.n_groups * self.glen}", None

    # ------------------------------------------------------------------ init
    @torch.no_grad()
    def init(self, gen: torch.Generator) -> "GriffinLM":
        """Random weights from ``gen`` with the JAX package's scales.  The
        draws differ from JAX's; tests bridge JAX's own weights instead."""
        cfg = self.cfg
        d, dr = cfg.d_model, self.d_rnn
        self.embed.copy_(L.embed_init(gen, cfg.padded_vocab, d, self.dtype))
        self.final_norm.zero_()
        for blk in self.blocks:
            blk.ln.zero_()
            blk.mlp["ln"].zero_()
            for name, w in L.ffn_init(gen, d, cfg.d_ff, self.dtype).items():
                blk.mlp[name].copy_(w)
            if isinstance(blk, AttentionBlock):
                for name, w in L.attn_init(gen, d, cfg.num_heads,
                                           cfg.num_kv_heads, self.head_dim,
                                           self.dtype).items():
                    blk.attn[name].copy_(w)
                continue
            blk.w_gate.copy_(L.dense_init(gen, d, dr, self.dtype))
            blk.w_in.copy_(L.dense_init(gen, d, dr, self.dtype))
            blk.conv_w.copy_(torch.randn(
                cfg.conv1d_width, dr, generator=gen, device=gen.device) * 0.1)
            blk.rg["w_a"].copy_(L.dense_init(gen, dr, dr, self.dtype))
            blk.rg["w_x"].copy_(L.dense_init(gen, dr, dr, self.dtype))
            blk.rg["b_a"].zero_()
            blk.rg["b_x"].zero_()
            # decay a in (0.9, 0.999) at r = 0.5, as in the paper
            blk.rg["lam"].copy_(torch.linspace(-2.0, 1.0, dr))
            blk.w_out.copy_(L.dense_init(gen, dr, d, self.dtype))
        return self

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ----------------------------------------------------------- block bodies
    def _mlp_apply(self, p, x):
        h = L.rms_norm(x, p["ln"], self.cfg.norm_eps)
        return x + L.ffn_apply(p, h)

    def _rblock_seq(self, blk: RecurrentBlock, x, impl):
        """(B,S,D) -> (x, (h_last (B,D_rnn) f32, conv buffer (B,W-1,D_rnn)))."""
        W = self.cfg.conv1d_width
        h = L.rms_norm(x, blk.ln, self.cfg.norm_eps)
        gate = F.gelu(h @ blk.w_gate, approximate="tanh")
        u_in = h @ blk.w_in
        hr = rglru_sequence(blk.rg, causal_conv1d(u_in, blk.conv_w), impl)
        x = x + (gate * hr.to(x.dtype)) @ blk.w_out
        # the last W-1 conv inputs, zero-padded on the left for short prompts
        conv = F.pad(u_in, (0, 0, max(0, W - 1 - u_in.shape[1]), 0))
        return self._mlp_apply(blk.mlp, x), (hr[:, -1], conv[:, -(W - 1):])

    def _ablock_seq(self, blk: AttentionBlock, x, positions, impl):
        cfg = self.cfg
        h = L.rms_norm(x, blk.ln, cfg.norm_eps)
        q, k, v = L.attn_qkv(blk.attn, h, num_heads=cfg.num_heads,
                             num_kv_heads=cfg.num_kv_heads,
                             head_dim=self.head_dim, positions=positions,
                             rope_theta=cfg.rope_theta)
        o = L.attention(q, k, v, q_positions=positions,
                        kv_positions=positions, causal=True,
                        window=cfg.local_attn_window, impl=impl)
        x = x + L.attn_out(blk.attn, o)
        return self._mlp_apply(blk.mlp, x), (k, v)

    def _run_prompt(self, tokens, impl):
        """Every block over the prompt: (final-normed x, per-layer state)."""
        x = self.embed[tokens]
        B, S, _ = x.shape
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S).contiguous()
        states = []
        for blk in self.blocks:
            if isinstance(blk, RecurrentBlock):
                x, st = self._rblock_seq(blk, x, impl)
            else:
                x, st = self._ablock_seq(blk, x, positions, impl)
            states.append(st)
        return L.rms_norm(x, self.final_norm, self.cfg.norm_eps), states

    # --------------------------------------------------------------- forward
    @torch.no_grad()
    def forward(self, tokens: torch.Tensor, impl: Optional[str] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Teacher-forced forward.  Returns (logits (B,S,Vpad), aux)."""
        x, _ = self._run_prompt(tokens, impl or self.cfg.attention_impl)
        return x @ self.embed.T, torch.zeros((), device=tokens.device)

    # ------------------------------------------------------------- KV / state
    def cache_capacity(self, max_len: int) -> int:
        return min(max_len, self.cfg.local_attn_window)

    def cache_batch_axes(self, cache: Cache) -> Dict[str, int]:
        return {k: (0 if (k == "length" or k.startswith("l")) else 1)
                for k in cache}

    def paged_kv_layout(self):
        """Ring-buffer local attention and recurrent state fit no
        immutable pages: the engine keeps dense rows instead."""
        return None

    def extend_cache(self, cache: Cache, extra: int) -> Cache:
        """Grow the ring's time axis by ``extra`` zero slots, up to the
        window; a ring already at the window is returned unchanged."""
        keys = [k for k in cache if k.startswith("g")
                and (k.endswith("_k") or k.endswith("_v"))]
        if not keys:
            return cache
        T = cache[keys[0]].shape[2]
        target = self.cache_capacity(T + extra)
        if target <= T:
            return cache
        out = dict(cache)
        for key in keys:
            out[key] = F.pad(cache[key], (0, 0, 0, 0, 0, target - T))
        return out

    def _kv_slot_positions(self, pos: torch.Tensor, T: int) -> torch.Tensor:
        """(B, T) int32: the newest position q <= pos with q = slot (mod T)
        held in each ring slot, -1 where none is.  ``torch.remainder`` is
        a floor modulo, as JAX's ``%``."""
        slots = torch.arange(T, dtype=torch.int32, device=pos.device)[None]
        p = pos[:, None].to(torch.int32)
        q = p - torch.remainder(p - slots, T)
        return torch.where((q >= 0) & (q <= p), q, -1).to(torch.int32)

    # --------------------------------------------------------------- prefill
    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, impl: Optional[str] = None
                ) -> Tuple[torch.Tensor, Cache]:
        """Full prompt pass; returns (last logits (B,Vpad), state cache).

        The ring keeps the last ``T = cache_capacity(S)`` positions with
        position p in slot ``p % T``."""
        x, states = self._run_prompt(tokens, impl or self.cfg.attention_impl)
        B, S = tokens.shape
        T = self.cache_capacity(S)
        groups: Dict[str, list] = {}
        cache: Cache = {}
        for layer, st in enumerate(states):
            prefix, g = self._state(layer)
            if self._kind(layer) == "rglru":
                vals = {"lru": st[0], "conv": st[1]}
            else:
                vals = {kv: torch.roll(t[:, S - T:], shifts=S % T, dims=1)
                        for kv, t in zip(("k", "v"), st)}
            for name, t in vals.items():
                if g is None:
                    cache[f"{prefix}_{name}"] = t.contiguous()
                else:
                    groups.setdefault(f"{prefix}_{name}", []).append(t)
        cache.update({k: torch.stack(v) for k, v in groups.items()})
        cache["length"] = torch.full((B,), S, dtype=torch.int32,
                                     device=tokens.device)
        return x[:, -1] @ self.embed.T, cache

    # ------------------------------------------------------------ decode step
    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, cache: Cache,
                    impl: Optional[str] = None) -> Tuple[torch.Tensor, Cache]:
        """token: (B,) int.  One autoregressive step at ``cache["length"]``.

        Writes the new token's K/V into its ring slot and the new
        recurrent and conv state into the cache IN PLACE; returns (logits
        (B,Vpad), a dict of the same tensors with ``length + 1``)."""
        cfg = self.cfg
        impl = impl or cfg.attention_impl
        B = token.shape[0]
        pos = cache["length"].to(torch.int32)
        x = self.embed[token]                                  # (B,D)
        batch_ix = torch.arange(B, device=x.device)
        kv_pos = slot = None
        for layer, blk in enumerate(self.blocks):
            prefix, g = self._state(layer)

            def state(name):
                t = cache[f"{prefix}_{name}"]
                return t if g is None else t[g]

            if isinstance(blk, RecurrentBlock):
                h = L.rms_norm(x, blk.ln, cfg.norm_eps)
                gate = F.gelu(h @ blk.w_gate, approximate="tanh")
                conv = state("conv")
                u_t, new_conv = causal_conv1d_step(h @ blk.w_in, conv,
                                                   blk.conv_w)
                hr, lru = rglru_step(blk.rg, u_t, state("lru"))
                conv.copy_(new_conv)
                state("lru").copy_(lru)
                x = x + (gate * hr) @ blk.w_out
            else:
                k_c, v_c = state("k"), state("v")
                if kv_pos is None:
                    T = k_c.shape[1]
                    slot = torch.remainder(pos, T).long()
                    kv_pos = self._kv_slot_positions(pos, T).contiguous()
                h = L.rms_norm(x[:, None], blk.ln, cfg.norm_eps)
                q, k, v = L.attn_qkv(blk.attn, h, num_heads=cfg.num_heads,
                                     num_kv_heads=cfg.num_kv_heads,
                                     head_dim=self.head_dim,
                                     positions=pos[:, None],
                                     rope_theta=cfg.rope_theta)
                k_c[batch_ix, slot] = k[:, 0]
                v_c[batch_ix, slot] = v[:, 0]
                o = L.attention(q, k_c, v_c, q_positions=pos[:, None],
                                kv_positions=kv_pos, causal=True,
                                window=cfg.local_attn_window, impl=impl)
                x = x + L.attn_out(blk.attn, o)[:, 0]
            x = self._mlp_apply(blk.mlp, x)
        new_cache = dict(cache)
        new_cache["length"] = pos + 1
        x = L.rms_norm(x, self.final_norm, cfg.norm_eps)
        return x @ self.embed.T, new_cache
