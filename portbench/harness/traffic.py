"""The one traffic generator: it turns a traffic file's parameters and a
seed into a list of calls.

A traffic file (``traffic/<name>.json``) holds::

    source          where its lengths come from
    loop            the loop that drives the window, ``loops/<loop>.py``:
                    "closed" (``outstanding`` calls in flight, each
                    finished call replaced at once) or "open"
                    (``rate_per_s``, Poisson arrivals)
    segments        the prompt, in order: ``{"shared": n, "tokens": L}``
                    is one of n fixed L-token sequences (a template or a
                    system prompt); ``{"tokens": L}``, ``{"tokens":
                    {"log_uniform": [lo, hi]}}`` or ``{"tokens": "node"}``
                    is unique to the call
    max_new_tokens  the output lengths, drawn in equal shares, or "node"
    nodes           optional: workflow nodes, each ``{"node": name,
                    "prompt_tokens": L, "max_new_tokens": n}``, drawn in
                    equal shares; a call's "node" lengths are its node's
    block           calls per stratification block (default 64)
    warm_shared     prefill the shared sequences in set-up

Lengths, nodes, shared variants, output lengths and inter-arrival gaps
are stratified: every block of ``block`` consecutive calls holds the same set
of quantiles, in an order drawn from the seed.  So every seed offers the
same work in another order, and seeds differ in arrangement, not in load.
Token ids are drawn from the seed, uniformly over ``[lo, hi)``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

_SEED_BITS = 63


@dataclass(frozen=True)
class Call:
    index: int
    prompt: Tuple[int, ...]
    max_new: int
    due: float            # seconds after the window opens (open loop)
    variant: int          # the shared segment's variant, or -1


def _fold(seed: int) -> int:
    return int(seed) % (1 << _SEED_BITS)


class Traffic:
    def __init__(self, spec: dict, seed: int, token_range: Sequence[int]):
        self.spec = spec
        self.seed = _fold(seed)
        self.lo, self.hi = int(token_range[0]), int(token_range[1])
        self.loop = spec["loop"]
        self.block = int(spec.get("block", 64))
        self.segments = spec["segments"]
        self.nodes = spec.get("nodes", [])
        outs = spec["max_new_tokens"]
        self.outs = outs if outs == "node" else [int(x) for x in outs]
        self._shared = {}
        self._dues: List[float] = [0.0]

    def _rng(self, *key: int) -> np.random.Generator:
        return np.random.default_rng([self.seed, *key])

    def _quantile_rank(self, what: int, i: int) -> int:
        """Call i's rank within its block for attribute ``what``."""
        b, r = divmod(i, self.block)
        return int(self._rng(1, what, b).permutation(self.block)[r])

    def _u(self, what: int, i: int) -> float:
        return (self._quantile_rank(what, i) + 0.5) / self.block

    def shared_tokens(self, seg: int, variant: int) -> Tuple[int, ...]:
        key = (seg, variant)
        if key not in self._shared:
            n = int(self.segments[seg]["tokens"])
            self._shared[key] = tuple(int(t) for t in self._rng(
                2, seg, variant).integers(self.lo, self.hi, n))
        return self._shared[key]

    def shared_prompts(self) -> List[Tuple[int, ...]]:
        """Every variant of every shared segment, as a prompt of its own."""
        out = []
        for s, seg in enumerate(self.segments):
            for v in range(int(seg.get("shared", 0))):
                out.append(self.shared_tokens(s, v))
        return out

    def node(self, i: int) -> dict:
        """Call i's workflow node."""
        return self.nodes[self._quantile_rank(5, i) % len(self.nodes)]

    def _length(self, seg: int, i: int) -> int:
        t = self.segments[seg]["tokens"]
        if isinstance(t, int):
            return t
        if t == "node":
            return int(self.node(i)["prompt_tokens"])
        lo, hi = t["log_uniform"]
        return int(round(lo * (hi / lo) ** self._u(10 + seg, i)))

    def _due(self, i: int) -> float:
        rate = float(self.spec["rate_per_s"])
        while len(self._dues) <= i:
            j = len(self._dues) - 1
            gap = -math.log(1.0 - self._u(3, j)) / rate
            self._dues.append(self._dues[-1] + gap)
        return self._dues[i]

    def call(self, i: int) -> Call:
        toks: List[int] = []
        variant = -1
        unique = self._rng(3, i)
        for s, seg in enumerate(self.segments):
            n_var = int(seg.get("shared", 0))
            if n_var:
                variant = self._quantile_rank(20 + s, i) % n_var
                toks.extend(self.shared_tokens(s, variant))
            else:
                toks.extend(int(t) for t in unique.integers(
                    self.lo, self.hi, self._length(s, i)))
        if self.outs == "node":
            out = int(self.node(i)["max_new_tokens"])
        else:
            out = self.outs[self._quantile_rank(4, i) % len(self.outs)]
        due = self._due(i) if "rate_per_s" in self.spec else 0.0
        return Call(i, tuple(toks), out, due, variant)

    def longest_prompt(self) -> int:
        n = 0
        for seg in self.segments:
            t = seg["tokens"]
            if t == "node":
                n += max(int(x["prompt_tokens"]) for x in self.nodes)
            else:
                n += t if isinstance(t, int) else int(t["log_uniform"][1])
        return n
