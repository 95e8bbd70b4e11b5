"""Radix tree over token ids — shared-prefix detection for KV reuse.

Used by (i) the engine to find how much of a new prompt's KV is already
resident (prefix-caching discount), and (ii) Halo's consolidator to pick
the template prefix shared by a batch of workflow-bound prompts.

A copy of the JAX package's module of the same name; the port imports
nothing of it.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


@dataclass
class _Node:
    children: Dict[int, "_Node"] = field(default_factory=dict)
    # number of inserted sequences passing through this node
    count: int = 0
    # opaque payload attached at the deepest node of an inserted sequence
    # (the engine stores the paged-KV sequence id here)
    payload: Optional[object] = None
    # recent path-stamped payloads, newest first (bounded): fallback
    # donors for when the newest one's KV pages get evicted
    payloads: List[object] = field(default_factory=list)

    MAX_STAMPS = 4

    def stamp(self, payload: object) -> None:
        self.payloads = [p for p in self.payloads
                         if p is not payload and p != payload]
        self.payloads.insert(0, payload)
        del self.payloads[self.MAX_STAMPS:]
        self.payload = payload


class RadixPrefixTree:
    """Token-level radix tree (one token per edge — simple and exact)."""

    def __init__(self):
        self.root = _Node()
        self.num_sequences = 0

    # ------------------------------------------------------------------
    def insert(self, tokens: Sequence[int], payload: object = None,
               stamp_path: bool = False) -> None:
        """Insert ``tokens``; attach ``payload`` at the deepest node.

        With ``stamp_path`` the payload is also stamped on every interior
        node of the path, making this sequence the *representative donor*
        for each of its prefixes — a later ``match()`` that diverges
        mid-sequence then still yields a payload covering the matched
        prefix (the engine uses this for partial-prompt KV-page reuse).
        """
        node = self.root
        node.count += 1
        for t in tokens:
            # not-a-sync: tokens is the host-side prompt tuple
            node = node.children.setdefault(int(t), _Node())
            node.count += 1
            if stamp_path:
                node.stamp(payload)
        node.payload = payload
        self.num_sequences += 1

    def match(self, tokens: Sequence[int]) -> Tuple[int, Optional[object]]:
        """Longest cached prefix of ``tokens``.

        Returns (match_len, payload of the deepest payload-bearing node on
        the matched path).
        """
        n, cands = self.match_all(tokens)
        return n, cands[0][1] if cands else None

    def match_all(self, tokens: Sequence[int]
                  ) -> Tuple[int, List[Tuple[int, object]]]:
        """Longest cached prefix plus every (depth, payload) pair on the
        matched path, deepest-first and payload-deduplicated.

        A payload stamped at depth d certifies only that its sequence
        shares the first d tokens, so each candidate carries its own
        depth.  Callers whose payloads can go stale (the engine's
        evicted KV sequences) walk the candidates instead of giving up
        when the most recent donor stamped over an older, still-valid
        one.
        """
        def node_payloads(node) -> List[object]:
            ps = list(node.payloads)
            if node.payload is not None and all(
                    q is not node.payload and q != node.payload for q in ps):
                ps.insert(0, node.payload)
            return ps

        node = self.root
        found: List[Tuple[int, List[object]]] = [(0, node_payloads(node))]
        n = 0
        for t in tokens:
            # not-a-sync: tokens is the host-side prompt tuple
            child = node.children.get(int(t))
            if child is None:
                break
            node = child
            n += 1
            found.append((n, node_payloads(node)))
        out: List[Tuple[int, object]] = []
        for depth, ps in reversed(found):              # deepest first
            for p in ps:                               # newest first
                if all(q is not p and q != p for _, q in out):
                    out.append((depth, p))
        return n, out

    # ------------------------------------------------------------------
    def longest_common_prefix(self) -> List[int]:
        """LCP over ALL inserted sequences (the batch's template prefix)."""
        out: List[int] = []
        node = self.root
        total = node.count
        while len(node.children) == 1:
            (tok, child), = node.children.items()
            if child.count != total:
                break
            out.append(tok)
            node = child
        return out


def common_prefix_length(a: Sequence[int], b: Sequence[int]) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


def batch_shared_prefix(prompts: Sequence[Sequence[int]]) -> List[int]:
    """Longest prefix shared by every prompt in the batch."""
    if not prompts:
        return []
    out = list(prompts[0])
    for p in prompts[1:]:
        n = common_prefix_length(out, p)
        del out[n:]
        if not out:
            break
    return out
