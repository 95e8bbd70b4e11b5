"""Random weights from a seed, in the checkpoint layout the port loads.

Each tensor is drawn from a generator of its own, seeded from the run's
seed and the tensor's key, so any one tensor can be made again alone, in
any order: the harness fills the port's parameters with them before the
window, and the reference makes each layer's again once the port's state
is freed.  On one device and dtype the two draws give the same bits.

Layout (the port's ``load`` format, weights ``(in, out)``): ``embed``
(Vpad, d), ``final_norm`` (d,), ``lm_head`` (d, Vpad); per layer ``i``
``blocks.i.ln1``/``ln2`` (d,), ``blocks.i.attn.{wq,wk,wv,wo}``, then
either ``blocks.i.ffn.{w_gate,w_up,w_down}`` or
``blocks.i.moe.{router,w_gate,w_up,w_down}`` with the experts stacked on
a leading axis and ``blocks.i.moe.shared.{w_gate,w_up,w_down}``.  Norms
scale by ``1 + w``.  The router is float32, every other tensor is in the
configuration's dtype.  Vpad is the vocabulary rounded up to 256.
"""
from __future__ import annotations

import math
import zlib
from typing import Dict, List, Tuple

import torch

_MIX = 0x9E3779B97F4A7C15
EMBED_STD = 0.02
NORM_STD = 0.1


def padded_vocab(vocab: int) -> int:
    return -(-vocab // 256) * 256


def layout(m: dict) -> Dict[str, Tuple[Tuple[int, ...], str, float]]:
    """``{key: (shape, dtype name, std)}`` of every tensor of the model
    described by a configuration file's ``model`` section."""
    d, h, hkv = m["d_model"], m["num_heads"], m["num_kv_heads"]
    dh = m.get("head_dim") or d // h
    vpad = padded_vocab(m["vocab_size"])
    dt = m.get("dtype", "bfloat16")
    moe = m.get("moe")

    def mat(i, o):
        return ((i, o), dt, 1.0 / math.sqrt(i))

    out = {"embed": ((vpad, d), dt, EMBED_STD),
           "final_norm": ((d,), dt, NORM_STD),
           "lm_head": mat(d, vpad)}
    for i in range(m["num_layers"]):
        b = f"blocks.{i}."
        out[b + "ln1"] = ((d,), dt, NORM_STD)
        out[b + "ln2"] = ((d,), dt, NORM_STD)
        out[b + "attn.wq"] = mat(d, h * dh)
        out[b + "attn.wk"] = mat(d, hkv * dh)
        out[b + "attn.wv"] = mat(d, hkv * dh)
        out[b + "attn.wo"] = mat(h * dh, d)
        if moe is None or i < moe.get("first_dense_layers", 0):
            f = m["d_ff"] if moe is None else moe["d_ff_dense"]
            out[b + "ffn.w_gate"] = mat(d, f)
            out[b + "ffn.w_up"] = mat(d, f)
            out[b + "ffn.w_down"] = mat(f, d)
            continue
        e, fe = moe["num_experts"], moe["d_ff_expert"]
        out[b + "moe.router"] = ((d, e), "float32", 1.0 / math.sqrt(d))
        out[b + "moe.w_gate"] = ((e, d, fe), dt, 1.0 / math.sqrt(d))
        out[b + "moe.w_up"] = ((e, d, fe), dt, 1.0 / math.sqrt(d))
        out[b + "moe.w_down"] = ((e, fe, d), dt, 1.0 / math.sqrt(fe))
        fs = moe.get("num_shared_experts", 0) * fe
        if fs:
            out[b + "moe.shared.w_gate"] = mat(d, fs)
            out[b + "moe.shared.w_up"] = mat(d, fs)
            out[b + "moe.shared.w_down"] = mat(fs, d)
    return out


def layer_keys(m: dict, i: int) -> List[str]:
    return [k for k in layout(m) if k.startswith(f"blocks.{i}.")]


def key_seed(seed: int, key: str) -> int:
    """A generator seed for one tensor: any whole-number run seed (more
    than 32 bits, or negative) and the key's CRC, folded into 63 bits."""
    return (int(seed) * _MIX + zlib.crc32(key.encode())) % (1 << 63)


def fill_(t: torch.Tensor, seed: int, key: str, std: float) -> torch.Tensor:
    """Draw ``t`` in place: normal with standard deviation ``std``."""
    gen = torch.Generator(device=t.device).manual_seed(key_seed(seed, key))
    return t.normal_(0.0, std, generator=gen)


def make(m: dict, seed: int, key: str, device) -> torch.Tensor:
    """One tensor of the layout, drawn anew."""
    shape, dt, std = layout(m)[key]
    t = torch.empty(shape, dtype=getattr(torch, dt), device=device)
    return fill_(t, seed, key, std)


def fill_params(named_params, m: dict, seed: int) -> int:
    """Fill every ``(name, tensor)`` in place from the layout, checking
    that the names, shapes and dtypes are the layout's exactly.  Returns
    the bytes written."""
    lay = layout(m)
    seen, nbytes = set(), 0
    for name, p in named_params:
        if name not in lay:
            raise KeyError(f"parameter {name!r} is not in the checkpoint "
                           f"layout")
        shape, dt, std = lay[name]
        if tuple(p.shape) != shape or p.dtype != getattr(torch, dt):
            raise ValueError(f"{name}: the port holds {tuple(p.shape)} "
                             f"{p.dtype}, the layout {shape} {dt}")
        with torch.no_grad():
            fill_(p.data, seed, name, std)
        seen.add(name)
        nbytes += p.numel() * p.element_size()
    missing = sorted(set(lay) - seen)
    if missing:
        raise KeyError(f"the port lacks layout tensors {missing[:4]}")
    return nbytes
