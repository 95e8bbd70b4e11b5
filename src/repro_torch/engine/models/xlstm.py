"""xLSTM LM (xlstm-350m) as a PyTorch module, and the causal depthwise
convolution the hybrid shares.

The counterpart of ``repro/engine/models/xlstm.py``: alternating mLSTM /
sLSTM blocks, one pair per two layers.

* mLSTM block: RMS norm -> up-proj (2x, split u/z) -> causal conv(4) on u
  -> q, k from silu(conv(u)), v from u -> multi-head mLSTM -> RMS norm
  (the group-norm proxy) -> * silu(z) -> down-proj -> residual.
* sLSTM block: RMS norm -> headwise sLSTM with block-diagonal recurrent
  weights -> RMS norm -> GeGLU up/down (factor 4/3, tanh GELU) ->
  residual.

Both recurrences run in f32 with the stabiliser ``m`` (exponential
gating), step by step: the JAX package scans them with ``lax.scan``, the
port loops over time in Python, a few dozen small ops a token per pair.
There is no Pallas kernel here and so no CUDA kernel either; the loop
is host-bound on the card (PERF.md).

The state keeps the JAX layout: each leaf is stacked over the pairs,
``m_C`` (P,B,H,Dh,Dh), ``m_n`` (P,B,H,Dh), ``m_m`` (P,B,H), ``m_conv``
(P,B,W-1,d_inner), ``s_c``/``s_n``/``s_h``/``s_m`` (P,B,D), and
``length`` (B,).  ``decode_step`` writes the new state into the cache's
tensors IN PLACE and returns a new dict (the caller's dict is not
changed).  The sequence form of the conv sums shifted elementwise
products in the input's dtype, in the JAX package's order, rather than
calling ``F.conv1d``: cuDNN would run an f32 convolution in TF32 and sum
in another order.  The sequence loops collect each step's output and stack
them (no slice writes into a preallocated buffer), so autograd runs
through them unchanged; they walk time through ``cost_hooks.steps`` (a
``range`` outside the op-cost counter, one step counted S times under
it).  ``loss_fn`` trains through ``forward_train``,
rematerializing each pair with ``remat`` as the JAX package checkpoints
its scanned pairs.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.cost_hooks import steps, steps_out
from repro_torch.engine.models import layers as L

Cache = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# causal depthwise conv (shared with rglru.py)
# ---------------------------------------------------------------------------

def causal_conv1d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (B,S,D); w: (W,D) depthwise taps.  Output (B,S,D)."""
    W = w.shape[0]
    S = x.shape[1]
    pad = L.pad_time(x, W - 1)
    out = torch.zeros_like(x)
    for t in range(W):                         # W is tiny (4): unrolled
        out = out + pad[:, t:t + S] * w[t][None, None, :]
    return out


def causal_conv1d_step(x_t: torch.Tensor, buf: torch.Tensor,
                       w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x_t: (B,D); buf: (B,W-1,D) previous inputs.  Returns (y_t,
    new_buf)."""
    window = torch.cat([buf, x_t[:, None, :]], dim=1)      # (B,W,D)
    y = torch.einsum("bwd,wd->bd", window, w)
    return y, window[:, 1:]


# ---------------------------------------------------------------------------
# mLSTM cell (stabilised, recurrent form)
# ---------------------------------------------------------------------------

def _mlstm_update(state, q32, k32, v32, i_t, log_f):
    """One mLSTM step from f32 inputs: q, k, v (B,H,Dh); i_t, log_f (B,H)
    (log_f = log_sigmoid of the forget pre-activation)."""
    C, n, m = state
    a = log_f + m
    m_new = torch.maximum(a, i_t)
    f_sc = torch.exp(a - m_new)[..., None]                 # (B,H,1)
    i_sc = torch.exp(i_t - m_new)[..., None]
    C = f_sc[..., None] * C + i_sc[..., None] * (v32[..., :, None]
                                                 * k32[..., None, :])
    n = f_sc * n + i_sc * k32
    num = torch.matmul(C, q32[..., None])[..., 0]           # (B,H,Dh)
    den = torch.maximum((n * q32).sum(dim=-1).abs(),
                        torch.exp(-m_new))[..., None]
    return (C, n, m_new), num / den


def mlstm_step(state, q, k, v, i_pre, f_pre):
    """One mLSTM step for all heads.

    state: (C (B,H,Dh,Dh), n (B,H,Dh), m (B,H)), f32.
    q, k, v: (B,H,Dh); i_pre, f_pre: (B,H) pre-activations.
    Returns (new state, h (B,H,Dh) f32)."""
    return _mlstm_update(state, q.float(), k.float(), v.float(),
                         i_pre.float(), L.log_sigmoid(f_pre.float()))


def mlstm_sequence(q, k, v, i_pre, f_pre, state):
    """q, k, v: (B,S,H,Dh); gates (B,S,H).  Steps over time; returns
    (final state, hs (B,S,H,Dh) f32)."""
    q, k, v, i_pre, f_pre = map(L.constrain_rows, (q, k, v, i_pre, f_pre))
    q32, k32, v32 = q.float(), k.float(), v.float()
    i32 = i_pre.float()
    log_f = L.log_sigmoid(f_pre.float())                    # all steps at once
    hs = []
    S = q.shape[1]
    for t in steps(S):
        state, h = _mlstm_update(state, q32[:, t], k32[:, t], v32[:, t],
                                 i32[:, t], log_f[:, t])
        hs.append(h)
    return state, torch.stack(steps_out(hs, S), dim=1)


# ---------------------------------------------------------------------------
# sLSTM cell (stabilised, headwise recurrent weights)
# ---------------------------------------------------------------------------

def _slstm_update(state, pre, r_cat):
    """One sLSTM step: pre (4,B,D) f32, the [z,i,f,o] pre-activations from
    x; r_cat (H, Dh, 4*Dh) f32, the block-diagonal recurrent weights with
    the four gates side by side (``_recurrent_matrix``)."""
    c, n, h, m = state
    B, D = c.shape
    H, Dh = r_cat.shape[0], r_cat.shape[1]
    rec = torch.bmm(h.view(B, H, Dh).transpose(0, 1), r_cat)   # (H,B,4Dh)
    rec = rec.view(H, B, 4, Dh).permute(2, 1, 0, 3).reshape(4, B, D)
    g = pre + rec
    z_t = torch.tanh(g[0])
    i_t = g[1]
    o_t = torch.sigmoid(g[3])
    a = L.log_sigmoid(g[2]) + m
    m_new = torch.maximum(a, i_t)
    f_sc = torch.exp(a - m_new)
    i_sc = torch.exp(i_t - m_new)
    c_new = f_sc * c + i_sc * z_t
    n_new = f_sc * n + i_sc
    h_new = o_t * (c_new / torch.clamp(n_new, min=1e-6))
    return (c_new, n_new, h_new, m_new), h_new


def _recurrent_matrix(r_w: torch.Tensor) -> torch.Tensor:
    """(4, H, Dh, Dh) -> (H, Dh, 4*Dh) f32: gate g's block of head h at
    columns g*Dh..(g+1)*Dh of row block h."""
    G, H, Dh, _ = r_w.shape
    return r_w.float().permute(1, 2, 0, 3).reshape(H, Dh, G * Dh)


def _gate_major(x_gates: torch.Tensor) -> torch.Tensor:
    """(..., 4D) [z,i,f,o] -> (4, ..., D) f32."""
    D = x_gates.shape[-1] // 4
    x = x_gates.float().reshape(*x_gates.shape[:-1], 4, D)
    return x.movedim(-2, 0)


def slstm_step(state, x_gates, r_w):
    """state: (c, n, h, m), each (B,D) f32; x_gates: (B,4D) [z,i,f,o]
    pre-activations from x; r_w: (4,H,Dh,Dh) block-diagonal recurrent
    weights.  Returns (new state, h (B,D) f32)."""
    return _slstm_update(state, _gate_major(x_gates), _recurrent_matrix(r_w))


def slstm_sequence(x_gates, r_w, state):
    """x_gates: (B,S,4D).  Steps over time; returns (final state, hs
    (B,S,D) f32)."""
    pre = _gate_major(L.constrain_rows(x_gates)).permute(
        2, 0, 1, 3).contiguous()                                 # (S,4,B,D)
    r_cat = _recurrent_matrix(r_w)
    hs = []
    S = x_gates.shape[1]
    for t in steps(S):
        state, h = _slstm_update(state, pre[t], r_cat)
        hs.append(h)
    return state, torch.stack(steps_out(hs, S), dim=1)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _dff(d: int) -> int:
    return max((4 * d) // 3, 8)


class Pair(nn.Module):
    """One mLSTM block and one sLSTM block, ``mlstm`` and ``slstm``."""

    def __init__(self, cfg: ModelConfig, H: int, Dh: int, dtype, device):
        super().__init__()
        d, di, dff = cfg.d_model, H * Dh, _dff(cfg.d_model)
        shapes = {
            "mlstm": {"ln": (d,), "w_up": (d, 2 * di),
                      "conv_w": (cfg.conv1d_width, di), "wq": (di, di),
                      "wk": (di, di), "wv": (di, di), "w_if": (di, 2 * H),
                      "gn": (di,), "w_down": (di, d)},
            "slstm": {"ln": (d,), "w_gates": (d, 4 * d),
                      "r_w": (4, H, d // H, d // H), "gn": (d,),
                      "w_up": (d, 2 * dff), "w_down": (dff, d)}}
        for name, leaves in shapes.items():
            setattr(self, name, L.param_dict(leaves, dtype, device))


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

class XLSTMLM(nn.Module):
    """The ssm family; its weights live on ``device`` (the card unless the
    caller asks for the CPU, or "meta" until the engine loads)."""

    STATE = ("m_C", "m_n", "m_m", "m_conv", "s_c", "s_n", "s_h", "s_m")

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        pattern = cfg.block_pattern or ("mlstm", "slstm")
        if pattern != ("mlstm", "slstm") or cfg.num_layers % 2:
            raise ValueError("xLSTM uses (mlstm, slstm) pairs")
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.dtype)
        self.H = cfg.num_heads
        self.Dh = cfg.resolved_head_dim
        self.d_inner = self.H * self.Dh
        self.n_pairs = cfg.num_layers // 2
        # q is divided by sqrt(Dh) rounded to the model dtype, as in JAX
        self.q_scale = float(torch.tensor(math.sqrt(self.Dh),
                                          dtype=self.dtype))
        self.embed = L.param(cfg.padded_vocab, cfg.d_model, dtype=self.dtype,
                             device=device)
        self.final_norm = L.param(cfg.d_model, dtype=self.dtype, device=device)
        self.pairs = nn.ModuleList(
            Pair(cfg, self.H, self.Dh, self.dtype, device)
            for _ in range(self.n_pairs))

    # ------------------------------------------------------------------ init
    @torch.no_grad()
    def init(self, gen: torch.Generator) -> "XLSTMLM":
        """Random weights from ``gen`` with the JAX package's scales.  The
        draws differ from JAX's; tests bridge JAX's own weights instead."""
        cfg = self.cfg
        d, di, H = cfg.d_model, self.d_inner, self.H
        dff = _dff(d)
        dt = self.dtype
        self.embed.copy_(L.embed_init(gen, cfg.padded_vocab, d, dt))
        self.final_norm.zero_()
        for pair in self.pairs:
            mp, sp = pair.mlstm, pair.slstm
            for name, (i, o) in (("w_up", (d, 2 * di)), ("wq", (di, di)),
                                 ("wk", (di, di)), ("wv", (di, di)),
                                 ("w_if", (di, 2 * H)),
                                 ("w_down", (di, d))):
                mp[name].copy_(L.dense_init(gen, i, o, dt))
            mp["conv_w"].copy_(torch.randn(
                cfg.conv1d_width, di, generator=gen, device=gen.device) * 0.1)
            for name, (i, o) in (("w_gates", (d, 4 * d)),
                                 ("w_up", (d, 2 * dff)),
                                 ("w_down", (dff, d))):
                sp[name].copy_(L.dense_init(gen, i, o, dt))
            sp["r_w"].copy_(torch.randn(
                4, H, d // H, d // H, generator=gen, device=gen.device)
                / math.sqrt(d / H))
            for p in (mp["ln"], mp["gn"], sp["ln"], sp["gn"]):
                p.zero_()
        return self

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ------------------------------------------------------------- state
    def _zero_state(self, batch: int) -> Cache:
        """One pair's zero state, (B, ...) leaves."""
        cfg, dev, f32 = self.cfg, self.device, torch.float32
        H, Dh, d = self.H, self.Dh, cfg.d_model
        return {
            "m_C": torch.zeros(batch, H, Dh, Dh, dtype=f32, device=dev),
            "m_n": torch.zeros(batch, H, Dh, dtype=f32, device=dev),
            "m_m": torch.zeros(batch, H, dtype=f32, device=dev),
            "m_conv": torch.zeros(batch, cfg.conv1d_width - 1, self.d_inner,
                                  dtype=self.dtype, device=dev),
            **{k: torch.zeros(batch, d, dtype=f32, device=dev)
               for k in ("s_c", "s_n", "s_h", "s_m")}}

    def init_cache(self, batch: int, max_len: int = 0) -> Cache:
        one = self._zero_state(batch)
        cache = {k: torch.stack([one[k]] * self.n_pairs) for k in self.STATE}
        cache["length"] = torch.zeros(batch, dtype=torch.int32,
                                      device=self.device)
        return cache

    def cache_batch_axes(self, cache: Cache) -> Dict[str, int]:
        return {k: (0 if k == "length" else 1) for k in cache}

    def paged_kv_layout(self):
        """O(1) recurrent state has no KV to page: the engine keeps one
        dense state row per request."""
        return None

    def extend_cache(self, cache: Cache, extra: int) -> Cache:
        return cache                    # O(1) state: nothing to grow

    # ----------------------------------------------------------- block bodies
    def _mlstm_qkv(self, p, u, cu):
        """q, k, v (..., H, Dh) and the gate pre-activations (..., H) from
        the conv output ``cu`` (after silu) and the up-projection ``u``."""
        shape = u.shape[:-1] + (self.H, self.Dh)
        q = (cu @ p["wq"]).reshape(shape) / self.q_scale
        k = (cu @ p["wk"]).reshape(shape)
        v = (u @ p["wv"]).reshape(shape)
        i_pre, f_pre = (cu @ p["w_if"]).chunk(2, dim=-1)
        return q, k, v, i_pre, f_pre

    def _mlstm_out(self, p, x, hs, z):
        hs = L.rms_norm(hs.reshape(*x.shape[:-1], self.d_inner).to(
            self.dtype), p["gn"], self.cfg.norm_eps)       # group-norm proxy
        return x + (hs * F.silu(z)) @ p["w_down"]

    def _slstm_out(self, p, x, hs):
        hs = L.rms_norm(hs.to(self.dtype), p["gn"], self.cfg.norm_eps)
        g, up = (hs @ p["w_up"]).chunk(2, dim=-1)
        return x + (L.gelu(g) * up) @ p["w_down"]

    def _pair_seq(self, pair: Pair, x, st):
        """(B,S,D) through one pair from state ``st`` (one pair's (B, ...)
        leaves); returns (x, new state)."""
        cfg = self.cfg
        W = cfg.conv1d_width
        mp, sp = pair.mlstm, pair.slstm
        h = L.rms_norm(x, mp["ln"], cfg.norm_eps)
        u, z = (h @ mp["w_up"]).chunk(2, dim=-1)            # (B,S,di)
        cu = F.silu(causal_conv1d(u, mp["conv_w"]))
        q, k, v, i_pre, f_pre = self._mlstm_qkv(mp, u, cu)
        (C, n, m), hs = mlstm_sequence(q, k, v, i_pre, f_pre,
                                       (st["m_C"], st["m_n"], st["m_m"]))
        x = self._mlstm_out(mp, x, hs, z)
        conv = torch.cat([st["m_conv"], u], dim=1)[:, -(W - 1):]
        h = L.rms_norm(x, sp["ln"], cfg.norm_eps)
        (c, sn, sh, sm), hs = slstm_sequence(
            h @ sp["w_gates"], sp["r_w"],
            (st["s_c"], st["s_n"], st["s_h"], st["s_m"]))
        x = self._slstm_out(sp, x, hs)
        return x, {"m_C": C, "m_n": n, "m_m": m, "m_conv": conv, "s_c": c,
                   "s_n": sn, "s_h": sh, "s_m": sm}

    def _run_prompt(self, tokens):
        """Every pair over the prompt from the zero state: (final-normed
        x, per-pair states)."""
        x = L.embed_lookup(self.embed, tokens)
        zero = self._zero_state(x.shape[0])
        states = []
        for pair in self.pairs:
            x, st = self._pair_seq(pair, x, zero)
            states.append(st)
        return L.rms_norm(x, self.final_norm, self.cfg.norm_eps), states

    def _pair_x(self, pair: Pair, x, st):
        return self._pair_seq(pair, x, st)[0]

    # --------------------------------------------------------------- forward
    @torch.no_grad()
    def forward(self, tokens: torch.Tensor, impl: Optional[str] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Teacher-forced forward.  Returns (logits (B,S,Vpad), aux 0).
        ``impl`` is accepted for the engine's interface: no attention."""
        return self.forward_train(tokens)

    def forward_train(self, tokens: torch.Tensor, remat: bool = False,
                      impl: Optional[str] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The teacher-forced forward with its graph, every pair from the
        zero state: (logits, aux 0); ``remat`` rematerializes each pair in
        the backward."""
        x = L.embed_lookup(self.embed, tokens)
        zero = self._zero_state(x.shape[0])
        for pair in self.pairs:
            if remat:
                x = checkpoint(self._pair_x, pair, x, zero,
                               use_reentrant=False)
            else:
                x = self._pair_x(pair, x, zero)
        x = L.rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return x @ self.embed.T, torch.zeros((), device=tokens.device)

    def loss_fn(self, batch: Dict[str, torch.Tensor], remat: bool = False,
                impl: Optional[str] = None) -> torch.Tensor:
        """Next-token cross-entropy of ``batch["tokens"]`` against
        ``batch["labels"]`` shifted by one (``loss_mask`` shifted alike:
        the JAX function passes it unshifted, which fails on its own
        shapes)."""
        logits, _ = self.forward_train(batch["tokens"], remat=remat)
        return L.next_token_loss(logits, batch, self.cfg.vocab_size)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, impl: Optional[str] = None
                ) -> Tuple[torch.Tensor, Cache]:
        """Full prompt pass; returns (last logits (B,Vpad), state cache)."""
        x, states = self._run_prompt(tokens)
        cache = {k: torch.stack([st[k] for st in states]) for k in self.STATE}
        cache["length"] = torch.full((tokens.shape[0],), tokens.shape[1],
                                     dtype=torch.int32, device=tokens.device)
        return x[:, -1] @ self.embed.T, cache

    # ------------------------------------------------------------ decode step
    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, cache: Cache,
                    impl: Optional[str] = None) -> Tuple[torch.Tensor, Cache]:
        """token: (B,) int.  One step of every pair from ``cache``; the new
        state goes into the cache's tensors IN PLACE.  Returns (logits
        (B,Vpad), a new dict of the same tensors with ``length + 1``)."""
        cfg = self.cfg
        x = L.embed_lookup(self.embed, token)                  # (B,D)
        for i, pair in enumerate(self.pairs):
            mp, sp = pair.mlstm, pair.slstm
            st = {k: cache[k][i] for k in self.STATE}
            h = L.rms_norm(x, mp["ln"], cfg.norm_eps)
            u, z = (h @ mp["w_up"]).chunk(2, dim=-1)
            cu, conv = causal_conv1d_step(u, st["m_conv"], mp["conv_w"])
            q, k, v, i_pre, f_pre = self._mlstm_qkv(mp, u, F.silu(cu))
            mstate, hm = mlstm_step((st["m_C"], st["m_n"], st["m_m"]),
                                    q, k, v, i_pre, f_pre)
            x = self._mlstm_out(mp, x, hm, z)
            h = L.rms_norm(x, sp["ln"], cfg.norm_eps)
            sstate, hs = slstm_step(
                (st["s_c"], st["s_n"], st["s_h"], st["s_m"]),
                h @ sp["w_gates"], sp["r_w"])
            x = self._slstm_out(sp, x, hs)
            for key, val in zip(self.STATE,
                                (*mstate, conv, *sstate)):
                st[key].copy_(val)
        new_cache = dict(cache)
        new_cache["length"] = cache["length"] + 1
        x = L.rms_norm(x, self.final_norm, cfg.norm_eps)
        return x @ self.embed.T, new_cache
