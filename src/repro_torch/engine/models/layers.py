"""Core layers of the port's transformer, in plain PyTorch.

The counterpart of ``repro/engine/models/layers.py``, its
sequence-parallel hints and its chunked plain attention included.
Conventions kept from there:

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
  training loss;
* under ``"torch"``, a query longer than one token whose score tensor
  would pass ``_CHUNK_TARGET_ELEMS`` goes to ``attention_torch_chunked``
  (query blocks; a causal self-attention's blocks read only the keys
  they can see), as ``attention_xla_chunked`` in JAX;
* the sequence-parallel hints (``set_activation_sharding``): with a mesh
  set, DTensor activations are placed as the JAX package constrains
  them, the residual stream and attention's queries sequence-sharded on
  the model axis and its keys and values replicated there; with no mesh
  (the default) every hint is an identity.  The dry run
  (``repro_torch.launch.dryrun``) sets them.

Parameters are made with ``requires_grad=False``: the engines serve under
``torch.no_grad()``, and the trainer turns grad on for the model it
trains (``repro_torch.training``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.cost_hooks import steps, steps_out
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
    function, under the sequence-parallel hints: these are re-applied per
    call, so that they hold for each block of the chunked path; only the
    query side is placed here, the keys and values once in ``attention``
    (outside any block loop)."""
    sp = _sp_attention_specs(q, k) if q.shape[1] > 1 else None
    if sp is not None:
        q = _constrain(q, sp[0])
        q_positions = _constrain(q_positions, sp[0][:2])
    elif q.shape[1] > 1:
        # no sequence split: the queries (and the output's gradient,
        # below) sharded on the batch alone, as ``attention`` places keys
        # and values
        q = constrain_rows(q)
    out = flash_attention_ref(q, k, v, q_positions=q_positions,
                              kv_positions=kv_positions, causal=causal,
                              window=window)
    if sp is not None:
        out = _constrain(out, sp[0])
    elif q.shape[1] > 1:
        out = rows_grad(out)
    return out


# Above ~4M logits elements per (query block x keys), materializing the
# whole (B,H,Sq,Skv) score tensor dominates the memory (train_4k: 17 GiB
# a device a layer; prefill_32k: TBs).  The chunked path walks query
# blocks, so one block's scores are live at a time.
_CHUNK_TARGET_ELEMS = 4 * 1024 * 1024

# ---------------------------------------------------------------------------
# activation placement (sequence-parallel attention), as in the JAX package
#
# GQA head counts (8 KV heads) do not divide a 16-way model axis, so
# attention cannot shard by heads there.  The hints shard the query time
# axis on the model axis around attention (sequence parallelism: seq_len
# divides the axis for every arch) and replicate KV across it (small under
# GQA), and keep the residual stream sequence-sharded between blocks.  A
# DTensor is placed with ``redistribute``; with no mesh set (the default)
# or on a plain tensor every hint is an identity.
# ---------------------------------------------------------------------------

_ACT_CTX: dict = {"mesh": None, "batch": ("data",), "seq": "model"}


def set_activation_sharding(mesh, batch_axes=("data",), seq_axis="model"):
    """Install (or clear, with mesh=None) the activation-sharding hints."""
    _ACT_CTX["mesh"] = mesh
    _ACT_CTX["batch"] = tuple(batch_axes)
    _ACT_CTX["seq"] = seq_axis


def _sizes() -> dict:
    from repro_torch.distribution.sharding import axis_sizes
    return axis_sizes(_ACT_CTX["mesh"])


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _constrain(x, spec_entries):
    """``x`` redistributed to the placements of ``spec_entries`` (a spec of
    the distribution layer: one entry per dim, None, an axis or a tuple
    of axes), the counterpart of ``with_sharding_constraint``."""
    mesh = _ACT_CTX["mesh"]
    if mesh is None or not _is_dtensor(x):
        return x
    from repro_torch.distribution.sharding import to_placements
    return x.redistribute(mesh, to_placements(tuple(spec_entries), mesh))


def _batch_entry(b: int):
    """The batch axes when they divide ``b``, else None (replicated)."""
    sizes = _sizes()
    bn = 1
    for a in _ACT_CTX["batch"]:
        bn *= sizes[a]
    return _ACT_CTX["batch"] if b % bn == 0 else None


def constrain_hidden(x):
    """Keep the residual stream (B,S,D) sequence-sharded between blocks
    (Megatron-SP): without this, every sequence-sharded attention output
    is gathered back to a replicated hidden state.  An identity with no
    mesh, or where the sequence does not divide the axis."""
    mesh = _ACT_CTX["mesh"]
    if mesh is None or x.ndim != 3 or x.shape[1] <= 1:
        return x
    seq_n = _sizes()[_ACT_CTX["seq"]]
    if x.shape[1] % seq_n or x.shape[1] < seq_n:
        return x
    return _constrain(x, (_batch_entry(x.shape[0]), _ACT_CTX["seq"], None))


def _sp_attention_specs(q, k):
    """(q_spec, kv_spec) for sequence-parallel attention, or None."""
    mesh = _ACT_CTX["mesh"]
    if mesh is None:
        return None
    seq_n = _sizes()[_ACT_CTX["seq"]]
    b_ent = _batch_entry(q.shape[0])
    if q.shape[1] % seq_n or q.shape[1] < seq_n:
        return None
    return (b_ent, _ACT_CTX["seq"], None, None), (b_ent, None, None, None)


def write_slots_(cache, rows, slot, values) -> None:
    """``cache[rows, slot] = values``, IN PLACE: cache (B, T, ...), rows
    ``arange(B)``, slot (B,) int, values (B, ...).

    Under the hints, a DTensor cache whose batch or time axis is sharded
    cannot be written in place by DTensor (it would place the cache whole
    first); each rank then writes the rows its shard holds at the slots
    its shard holds, a slot outside the shard leaving the shard as it
    was: the write XLA's partitioner makes of the JAX package's scatter.
    An ordinary indexed write otherwise."""
    if _ACT_CTX["mesh"] is None or not _is_dtensor(cache):
        cache[rows, slot] = values
        return
    from torch.distributed.tensor import DTensor, Replicate
    mesh = cache.device_mesh
    by_row = [p if p.is_shard(0) else Replicate() for p in cache.placements]

    def local_rows(t):
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim)
        return t.redistribute(mesh, by_row).to_local()

    slot, values, local = local_rows(slot), local_rows(values), \
        cache.to_local()
    T = local.shape[1]
    offset, span = 0, T
    for i in reversed(range(mesh.ndim)):
        if cache.placements[i].is_shard(1):
            offset += mesh.get_local_rank(i) * span
            span *= mesh.size(i)
    s = slot.long() - offset
    inside = ((s >= 0) & (s < T)).view(-1, *[1] * (values.ndim - 1))
    s = s.clamp(0, T - 1)
    rows = torch.arange(local.shape[0], device=local.device)
    local[rows, s] = torch.where(inside, values.to(local.dtype),
                                 local[rows, s])


def sharded(x) -> bool:
    """Whether the hints are on and ``x`` is a DTensor: where a model
    takes another, equal formulation that DTensor places."""
    return _ACT_CTX["mesh"] is not None and _is_dtensor(x)


def embed_lookup(table, tokens):
    """``table[tokens]``, as ``F.embedding`` over the table placed whole on
    its vocabulary dim (an identity with no mesh set or on a plain
    tensor): DTensor's vocab-parallel lookup keeps a mask of the tokens'
    values, which meta tensors do not hold."""
    if sharded(table):
        from torch.distributed.tensor import Replicate
        table = table.redistribute(table.device_mesh, [
            Replicate() if p.is_shard(0) else p for p in table.placements])
    return F.embedding(tokens, table)


def pad_time(x, n: int):
    """``x`` (B, S, ...) with ``n`` zero rows before its time axis, as a
    concatenation with zeros (``F.pad``'s values; not every DTensor
    places a pad)."""
    zeros = torch.zeros((x.shape[0], n) + tuple(x.shape[2:]), dtype=x.dtype,
                        device=x.device)
    return torch.cat([zeros, x], dim=1)


def roll_time(x, shift: int):
    """``torch.roll(x, shift, dims=1)``, as the same rows concatenated
    (not every DTensor places a roll)."""
    shift %= x.shape[1]
    return torch.cat([x[:, x.shape[1] - shift:], x[:, :x.shape[1] - shift]],
                     dim=1)


def rows_grad(x, groups: int = 0):
    """``x``, whose gradient is placed by ``constrain_rows`` under the
    hints (``x`` itself with no mesh set)."""
    if _ACT_CTX["mesh"] is None:
        return x
    return _RowsGrad.apply(x, groups)


class _RowsGrad(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return constrain_rows(g, ctx.groups), None


def log_sigmoid(x):
    """``F.logsigmoid``; under the hints on a DTensor ``-softplus(-x)``,
    the same function, since DTensor has no sharding rule for
    logsigmoid's backward."""
    if sharded(x):
        return -F.softplus(-x)
    return F.logsigmoid(x)


def constrain_rows(x, groups: int = 0):
    """Under the hints, ``x`` sharded on its batch dim alone (partial sums
    reduced, every other dim whole), over the batch axes where their size
    divides that dim (and ``groups``, the groups its rows are regrouped
    into, where given), else whole: the placement of a loop over time's
    inputs, whose per-step slices would otherwise each be gathered or
    reduced, and of rows about to be regrouped.  An identity with no mesh
    set or on a plain tensor."""
    if not sharded(x):
        return x
    b_ent = _batch_entry(x.shape[0])
    if b_ent is not None and groups:
        b_ent = _batch_entry(groups)
    return _constrain(x, (b_ent,) + (None,) * (x.ndim - 1))


def _pick_q_block(sq: int, skv: int) -> int:
    """Query-block size for chunked attention.

    The budget is per device: under sequence-parallel placement a block of
    bq rows puts bq/seq_n of them on each device, so the block can be
    seq_n times larger for the same footprint, and larger blocks re-read
    the keys fewer times (nq = Sq/bq)."""
    mesh = _ACT_CTX["mesh"]
    seq_n = _sizes()[_ACT_CTX["seq"]] if mesh is not None else 1
    bq = max(_CHUNK_TARGET_ELEMS * seq_n // max(skv, 1), 128)
    while sq % bq:
        bq //= 2
        if bq < 2:
            return sq
    return min(bq, sq)


def attention_torch_chunked(q, k, v, *, q_positions, kv_positions,
                            causal=True, window=0, block_q: int = 0,
                            static_causal: bool = False):
    """Query-block-chunked plain attention: each row's math is
    ``attention_torch``'s.

    ``static_causal`` (self-attention at the standard arange positions:
    prefill, the teacher-forced forward) unrolls the blocks and slices
    each one's keys to the range it can see, ``[max(0, hi - window -
    bq), hi)``, skipping the masked upper triangle (about half the work
    when causal, Skv/window of it under a window).  Otherwise a loop over
    query blocks (``steps``) attends each to every key, which holds any
    positions (rings, padding); under autograd each block is
    rematerialized in the backward, as ``jax.checkpoint`` does there."""
    B, Sq, H, Dh = q.shape
    Skv = k.shape[1]
    bq = block_q or _pick_q_block(Sq, Skv)
    if bq >= Sq:
        return attention_torch(q, k, v, q_positions=q_positions,
                               kv_positions=kv_positions, causal=causal,
                               window=window)
    nq = Sq // bq

    if static_causal and causal and Sq == Skv and nq <= 64:
        outs = []
        for i in range(nq):
            hi = (i + 1) * bq
            lo = max(0, hi - window - bq) if window > 0 else 0
            outs.append(attention_torch(
                q[:, i * bq:hi], k[:, lo:hi], v[:, lo:hi],
                q_positions=q_positions[:, i * bq:hi],
                kv_positions=kv_positions[:, lo:hi], causal=True,
                window=window))
        return torch.cat(outs, dim=1)

    def block(qb, qpb):
        return attention_torch(qb, k, v, q_positions=qpb,
                               kv_positions=kv_positions, causal=causal,
                               window=window)

    outs = []
    for i in steps(nq):
        rows = slice(i * bq, (i + 1) * bq)
        qb, qpb = q[:, rows], q_positions[:, rows]
        if torch.is_grad_enabled():
            outs.append(checkpoint(block, qb, qpb, use_reentrant=False))
        else:
            outs.append(block(qb, qpb))
    return torch.cat(steps_out(outs, nq), dim=1)


def attention(q, k, v, *, q_positions, kv_positions, causal=True, window=0,
              impl: str = "cuda"):
    """Dispatch between the plain math and the CUDA kernels: under
    ``"cuda"`` a one-token query goes to the decode kernel, longer ones to
    the flash kernel; under ``"torch"`` a query longer than one token whose
    scores pass ``_CHUNK_TARGET_ELEMS`` goes to the chunked path, as in
    JAX.

    The decode kernel masks keys past the query position.  A non-causal
    one-token query (window 0 on every such call) therefore takes each
    row's largest key position as its own, so it sees every valid key;
    a row with none (-1) gives 0."""
    if impl == "torch":
        sp = _sp_attention_specs(q, k) if q.shape[1] > 1 else None
        if sp is not None:
            # replicate KV across the sequence-parallel axis once, outside
            # any block loop
            k = _constrain(k, sp[1])
            v = _constrain(v, sp[1])
            kv_positions = _constrain(kv_positions, sp[1][:2])
        elif q.shape[1] > 1:
            k, v = constrain_rows(k), constrain_rows(v)
        if q.shape[1] > 1 and q.shape[1] * k.shape[1] > _CHUNK_TARGET_ELEMS:
            # every Sq == Skv causal call in the port is at the standard
            # arange positions (rings and padded caches have Sq != Skv),
            # so the static triangle slicing applies
            return attention_torch_chunked(
                q, k, v, q_positions=q_positions, kv_positions=kv_positions,
                causal=causal, window=window,
                static_causal=(causal and window == 0
                               and q.shape[1] == k.shape[1]))
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
    if _ACT_CTX["mesh"] is not None and _is_dtensor(logits32):
        # under the hints, vocab-sharded logits: the gold logit as a masked
        # sum over the vocabulary (exact: one term is not 0), which every
        # vocab shard computes on its own; DTensor's vocab-parallel gather
        # reads its mask's values, which meta tensors do not hold
        hit = torch.arange(vpad, device=logits32.device) == labels[..., None]
        gold = torch.where(hit, logits32, 0.0).sum(dim=-1)
    else:
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
