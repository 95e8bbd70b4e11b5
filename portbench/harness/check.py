"""How ``correct`` is decided for a served model.

Once the window has closed and the port's state is freed, a sample of
the calls it finished, drawn from the seed with the longest call always
in it, goes through the plain float32 reference: one teacher-forced pass
over each prompt and its served tokens.  The number compared is the
widest gap by which a served token's reference logit lies below the
reference's best at that position (0 where the port picked the
reference's argmax), or, where a cell's limits say so, the mean gap
over every served token.  The control is the same reference computed with
float8 products (``precision="fp8"``): its gap is that of the token it
puts first, read under the float32 logits.

The reference is the one of the configuration's architecture: the
``served_logits`` of ``archs/<arch>.py``, named by the ``model``
section's ``arch`` (``gqa`` where it names none; ``archs/__init__.py``
states what such a module gives).  A model the harness does not know yet
brings its reference in a module of its own, and nothing here changes.
"""
from __future__ import annotations

import random
from typing import Sequence

import torch

from portbench.reference.model import NoTF32

OUTSIDE = 1e9              # the gap of a token id outside the vocabulary


def sample(records, seed: int, k: int) -> list:
    """The longest finished call (prompt plus served tokens) and ``k - 1``
    others drawn from the seed."""
    ok = sorted((r for r in records if r.tokens is not None),
                key=lambda r: r.call.index)
    if not ok:
        return []
    longest = max(ok, key=lambda r: len(r.call.prompt) + len(r.tokens))
    rest = [r for r in ok if r is not longest]
    return [longest] + random.Random(seed).sample(rest, min(k - 1, len(rest)))


def gap_rows(ref: torch.Tensor, picked: Sequence[int]) -> torch.Tensor:
    """Per row, the reference's best logit less that of ``picked``;
    ``OUTSIDE`` where a pick lies outside the vocabulary."""
    idx = torch.as_tensor(list(picked), device=ref.device, dtype=torch.long)
    bad = (idx < 0) | (idx >= ref.shape[1])
    got = ref.gather(1, idx.clamp(0, ref.shape[1] - 1)[:, None])[:, 0]
    g = ref.max(dim=1).values - got
    return torch.where(bad, torch.full_like(g, OUTSIDE), g)


def served_gaps(m: dict, seed: int, seqs, *, device, quantum: int, arch,
                control: bool = False):
    """Per sequence ``(prompt, served)``, the gap of each served token
    (a 1-D tensor on the CPU) under the reference of ``arch``, the
    configuration's ``archs/<arch>.py``; with ``control``, also those of
    the fp8 control's picks at the same positions: ``port`` or ``(port,
    control)``."""
    served_logits = arch.served_logits
    with NoTF32(), torch.no_grad():
        ref = served_logits(m, seed, seqs, device=device,
                            prefill_quantum=quantum)
        port = [gap_rows(r, s).cpu() for r, (_, s) in zip(ref, seqs)]
        if not control:
            return port
        low = served_logits(m, seed, seqs, device=device,
                            prefill_quantum=quantum, precision="fp8")
        ctrl = [gap_rows(r, lw.argmax(dim=1).tolist()).cpu()
                for r, lw in zip(ref, low)]
        return port, ctrl


def numbers(gaps) -> dict:
    """The numbers a cell may compare, from per-sequence token gaps: the
    widest gap (``logit_gap``) and the mean over every served token
    (``logit_gap_mean``)."""
    if not gaps:
        return {"logit_gap": OUTSIDE, "logit_gap_mean": OUTSIDE}
    flat = torch.cat(gaps)
    return {"logit_gap": float(flat.max()),
            "logit_gap_mean": float(flat.mean())}
