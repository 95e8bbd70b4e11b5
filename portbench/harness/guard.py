"""The import guard: no module of JAX or of the JAX package in the
process.  Names are compared by their top-level part whole, so
``repro_torch`` (the port) passes and ``repro`` does not."""
from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden(names: Iterable[str] = None) -> List[str]:
    names = sys.modules if names is None else names
    return sorted({n.split(".", 1)[0] for n in names} & set(FORBIDDEN))
