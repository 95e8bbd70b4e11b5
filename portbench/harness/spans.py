"""The engine loop's spans, as the window's ``EngineStats`` deltas carry
them: ``span_s.<name>`` and ``span_self_s.<name>`` (seconds) and
``span_n.<name>`` for each name of ``repro_torch.engine.spans``.  A
program without these spans has none of the keys, and each reader of
them then returns None."""
from __future__ import annotations

from typing import Dict, Optional

# the children whose time the host spends waiting on or enqueueing the
# model: the model call and the read of its result
OFF_HOST = ("model", "sync")


def count(stats: Dict[str, float], name: str) -> Optional[float]:
    """How often span ``name`` closed in the window; None where the
    program has no such span or it never closed."""
    n = stats.get("span_n." + name)
    return n if n else None


def total_s(stats: Dict[str, float], name: str) -> Optional[float]:
    return stats.get("span_s." + name)


def host_self_s(stats: Dict[str, float], root: str) -> Optional[float]:
    """Self seconds of span ``root`` and every span under it, less its
    children named in ``OFF_HOST``: the host's own work in that layer."""
    key = "span_self_s." + root
    if key not in stats:
        return None
    skip = {f"{key}.{c}" for c in OFF_HOST}
    return sum(v for k, v in stats.items()
               if (k == key or k.startswith(key + ".")) and k not in skip)
