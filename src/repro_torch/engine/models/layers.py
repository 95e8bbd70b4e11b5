"""Core layers of the port's transformer, in plain PyTorch.

The counterpart of ``repro/engine/models/layers.py`` (without its
sharding hints and its chunked XLA attention).  Conventions kept from
there:

* weights are laid out ``(in, out)`` and applied as ``x @ W``, as in the
  JAX package, so its weights bridge over without a transpose;
* activations flow in ``cfg.dtype`` (bf16 by default); norms, RoPE and
  softmax run in f32;
* GELU is the tanh approximation, ``jax.nn.gelu``'s default (PyTorch's
  default is the erf form);
* attention has two implementations, selected by ``cfg.attention_impl``:
  ``"torch"`` (plain math, the counterpart of ``attention_xla``) and
  ``"cuda"`` (the hand-written kernels under ``repro_torch.kernels``:
  flash prefill for a query block, flash-decode for one token).  A
  one-token query with ``causal=False`` (whisper's decode cross-attention)
  sees every valid key, as under ``attention_xla``: the JAX ``"pallas"``
  path drops ``causal`` there (ROADMAP Queue 3).  The flash kernel and the
  scan carry a backward (an autograd ``Function``); the decode kernels
  serve only and raise if asked for a gradient;
* ``cross_entropy`` over a padded vocabulary and ``next_token_loss``, the
  training loss.

Parameters are made with ``requires_grad=False``: the engines serve under
``torch.no_grad()``, and the trainer turns grad on for the model it
trains (``repro_torch.training``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.common import NEG_INF
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

# ---------------------------------------------------------------------------
# initializers (explicit generator; its device is where the weights land)
# ---------------------------------------------------------------------------


def param(*shape, dtype, device) -> nn.Parameter:
    """A zero parameter the model's init or a ``load_state_dict`` fills."""
    return nn.Parameter(torch.zeros(*shape, dtype=dtype, device=device),
                        requires_grad=False)


def param_dict(shapes, dtype, device) -> nn.ParameterDict:
    """``param`` for each ``{name: shape}``."""
    return nn.ParameterDict({n: param(*s, dtype=dtype, device=device)
                             for n, s in shapes.items()})


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
               dtype: torch.dtype) -> torch.Tensor:
    w = torch.randn(in_dim, out_dim, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * (1.0 / math.sqrt(in_dim))).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int,
               dtype: torch.dtype) -> torch.Tensor:
    w = torch.randn(vocab, dim, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms, rotary and sinusoidal positions
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in f32, scaled by ``1 + weight`` (weights start at 0)."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * (1.0 + weight.float())).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in f32 over the last axis, population variance (as
    ``jnp.var``), scaled by ``weight`` and shifted by ``bias``."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, unbiased=False, keepdim=True)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    return (out * weight.float() + bias.float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float,
               device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)                       # (head_dim/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, Dh); positions: (B, S) int.  Rotates split halves
    (not interleaved pairs), in f32."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs          # (B, S, dh/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(length: int, dim: int,
                         device=None) -> torch.Tensor:
    """(length, dim) f32 table: sin at even columns, cos at odd ones."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32,
                                 device=device) * (-math.log(10000.0) / dim))
    pe = torch.zeros(length, dim, dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def ring_slot_positions(pos: torch.Tensor, T: int) -> torch.Tensor:
    """(B, T) int32: the position each slot of a ring of T slots holds
    once position ``pos`` (B,) is written, the newest q <= pos with q =
    slot (mod T), -1 where none is.  ``torch.remainder`` is a floor
    modulo, as JAX's ``%``."""
    slots = torch.arange(T, dtype=torch.int32, device=pos.device)[None]
    p = pos[:, None].to(torch.int32)
    q = p - torch.remainder(p - slots, T)
    return torch.where((q >= 0) & (q <= p), q, -1).to(torch.int32)


def attention_torch(q, k, v, *, q_positions, kv_positions, causal=True,
                    window=0):
    """Plain attention, the counterpart of ``attention_xla``: q (B,Sq,H,Dh)
    over k, v (B,Skv,Hkv,Dh) with explicit positions (-1 = invalid),
    logits and softmax in f32, probs cast to V's dtype before PV.  It is
    the same function as the flash kernel's plain version, so it is that
    function."""
    return flash_attention_ref(q, k, v, q_positions=q_positions,
                               kv_positions=kv_positions, causal=causal,
                               window=window)


def attention(q, k, v, *, q_positions, kv_positions, causal=True, window=0,
              impl: str = "cuda"):
    """Dispatch between the plain math and the CUDA kernels: under
    ``"cuda"`` a one-token query goes to the decode kernel, longer ones to
    the flash kernel.

    The decode kernel masks keys past the query position.  A non-causal
    one-token query (window 0 on every such call) therefore takes each
    row's largest key position as its own, so it sees every valid key;
    a row with none (-1) gives 0."""
    if impl == "torch":
        return attention_torch(q, k, v, q_positions=q_positions,
                               kv_positions=kv_positions, causal=causal,
                               window=window)
    if impl == "cuda":
        if q.shape[1] == 1:
            # one new token over a contiguous or ring cache (decode_step)
            if not causal:
                assert window == 0, "a non-causal call has no window"
                q_positions = kv_positions.amax(dim=1, keepdim=True)
            return da_ops.decode_attention(
                q.contiguous(), k.contiguous(), v.contiguous(),
                q_positions=q_positions.to(torch.int32).contiguous(),
                kv_positions=kv_positions.to(torch.int32).contiguous(),
                window=window)
        return fa_ops.flash_attention(
            q.contiguous(), k.contiguous(), v.contiguous(),
            q_positions=q_positions.to(torch.int32).contiguous(),
            kv_positions=kv_positions.to(torch.int32).contiguous(),
            causal=causal, window=window)
    raise ValueError(f"unknown attention impl {impl!r}")


# ---------------------------------------------------------------------------
# attention block (projections + qk-norm + rope)
# ---------------------------------------------------------------------------

def attn_init(gen, d_model, num_heads, num_kv_heads, head_dim, dtype,
              qk_norm: bool = False):
    p = {
        "wq": dense_init(gen, d_model, num_heads * head_dim, dtype),
        "wk": dense_init(gen, d_model, num_kv_heads * head_dim, dtype),
        "wv": dense_init(gen, d_model, num_kv_heads * head_dim, dtype),
        "wo": dense_init(gen, num_heads * head_dim, d_model, dtype),
    }
    if qk_norm:
        p["q_norm"] = torch.zeros(head_dim, dtype=dtype, device=gen.device)
        p["k_norm"] = torch.zeros(head_dim, dtype=dtype, device=gen.device)
    return p


def attn_qkv(p, x, *, num_heads, num_kv_heads, head_dim, positions,
             rope_theta, qk_norm=False, use_rope=True, norm_eps=1e-6):
    """Projections, then qk-norm, then RoPE (in that order)."""
    B, S, _ = x.shape
    q = (x @ p["wq"]).reshape(B, S, num_heads, head_dim)
    k = (x @ p["wk"]).reshape(B, S, num_kv_heads, head_dim)
    v = (x @ p["wv"]).reshape(B, S, num_kv_heads, head_dim)
    if qk_norm:
        q = rms_norm(q, p["q_norm"], norm_eps)
        k = rms_norm(k, p["k_norm"], norm_eps)
    if use_rope:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    return q, k, v


def attn_out(p, o):
    B, S, H, Dh = o.shape
    return o.reshape(B, S, H * Dh) @ p["wo"]


# ---------------------------------------------------------------------------
# feed-forward (SwiGLU; non-gated GELU)
# ---------------------------------------------------------------------------

def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def ffn_init(gen, d_model, d_ff, dtype):
    return {
        "w_gate": dense_init(gen, d_model, d_ff, dtype),
        "w_up": dense_init(gen, d_model, d_ff, dtype),
        "w_down": dense_init(gen, d_ff, d_model, dtype),
    }


def ffn_apply(p, x):
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


def ffn_apply_nogate(p, x):
    """Whisper's FFN: ``gelu(x @ w_up) @ w_down``."""
    return gelu(x @ p["w_up"]) @ p["w_down"]


# ---------------------------------------------------------------------------
# cross-entropy with padded vocab
# ---------------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab_size: int, mask=None) -> torch.Tensor:
    """logits: (..., V_pad); labels int (...); mask optional (...).  The
    mean token NLL in f32; the pad columns past ``vocab_size`` are masked
    to NEG_INF by a ``where``, so they get no gradient."""
    vpad = logits.shape[-1]
    logits32 = logits.float()
    if vpad > vocab_size:
        real = torch.arange(vpad, device=logits.device) < vocab_size
        logits32 = torch.where(real, logits32, NEG_INF)
    logz = torch.logsumexp(logits32, dim=-1)
    gold = torch.gather(logits32, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        denom = torch.clamp(mask.sum(), min=1)
        return (nll * mask).sum() / denom
    return nll.mean()


def next_token_loss(logits: torch.Tensor, batch, vocab_size: int
                    ) -> torch.Tensor:
    """``cross_entropy`` of ``logits[:, :-1]`` against ``batch["labels"]``
    shifted by one, under ``batch["loss_mask"]`` shifted alike when the
    batch has one."""
    mask = batch.get("loss_mask")
    return cross_entropy(logits[:, :-1], batch["labels"][:, 1:], vocab_size,
                         mask=None if mask is None else mask[:, 1:])
