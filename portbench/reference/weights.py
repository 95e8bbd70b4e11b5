"""Random weights from a seed, in the checkpoint layout the port loads.

Each tensor is drawn from a generator of its own, seeded from the run's
seed and the tensor's key, so any one tensor can be made again alone, in
any order: the harness fills the port's parameters with them before the
window, and the reference makes each layer's again once the port's state
is freed.  On one device and dtype the two draws give the same bits.

The layout (``{key: (shape, dtype name, std)}``) is the configuration's
architecture's (``archs/<arch>.py``): the harness hands it to
``fill_layout`` and ``draw``.  ``layout``, ``make`` and ``fill_params``
take a ``model`` section and serve ``gqa`` (``archs.default``).  Vpad,
the vocabulary rounded up to 256, and the stds of the embedding and the
norms are shared here.
"""
from __future__ import annotations

import zlib
from typing import Dict, Tuple

import torch

from portbench.archs import default

_MIX = 0x9E3779B97F4A7C15
EMBED_STD = 0.02
NORM_STD = 0.1


def padded_vocab(vocab: int) -> int:
    return -(-vocab // 256) * 256


def layout(m: dict) -> Dict[str, Tuple[Tuple[int, ...], str, float]]:
    """``{key: (shape, dtype name, std)}`` of every tensor of the ``gqa``
    model described by a configuration file's ``model`` section."""
    return default(m).layout(m)


def key_seed(seed: int, key: str) -> int:
    """A generator seed for one tensor: any whole-number run seed (more
    than 32 bits, or negative) and the key's CRC, folded into 63 bits."""
    return (int(seed) * _MIX + zlib.crc32(key.encode())) % (1 << 63)


def fill_(t: torch.Tensor, seed: int, key: str, std: float) -> torch.Tensor:
    """Draw ``t`` in place: normal with standard deviation ``std``."""
    gen = torch.Generator(device=t.device).manual_seed(key_seed(seed, key))
    return t.normal_(0.0, std, generator=gen)


def draw(entry: Tuple[Tuple[int, ...], str, float], seed: int, key: str,
         device) -> torch.Tensor:
    """The tensor ``key`` of a layout, whose entry is ``(shape, dtype
    name, std)``, drawn anew."""
    shape, dt, std = entry
    t = torch.empty(shape, dtype=getattr(torch, dt), device=device)
    return fill_(t, seed, key, std)


def make(m: dict, seed: int, key: str, device) -> torch.Tensor:
    """One tensor of the ``gqa`` layout, drawn anew."""
    return draw(layout(m)[key], seed, key, device)


def fill_params(named_params, m: dict, seed: int) -> int:
    """``fill_layout`` from the ``gqa`` layout of ``m``."""
    return fill_layout(named_params, layout(m), seed)


def fill_layout(named_params, lay: dict, seed: int) -> int:
    """Fill every ``(name, tensor)`` in place from the layout ``lay``,
    checking that the names, shapes and dtypes are the layout's exactly.
    Returns the bytes written."""
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
