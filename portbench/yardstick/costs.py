"""Operations and bytes of the kernels and of the model, from shapes.

``kernel_time_bound`` and ``paged_decode_cost`` copy the arithmetic of
``repro_torch/launch/roofline.py``; ``flash_prefill_cost`` is the
benchmark's own, and ``matmul_params`` and ``token_flops`` are those of
``archs/gqa.py`` (an architecture's own are its module's).  Every count is
what the inputs need (valid query-key pairs, live keys), never what a
kernel happens to read, so a share of the bound cannot pass 100% unless
the time leaves out work or a count is too high.
"""
from __future__ import annotations

from typing import Iterable, Sequence, Tuple

from portbench.archs import default
from portbench.yardstick.peaks import HBM_BW, PEAK_FLOPS_BF16


def kernel_time_bound(bytes_hbm: float, flops: float, *,
                      hbm_bw: float = HBM_BW,
                      peak_flops: float = PEAK_FLOPS_BF16) -> float:
    """Least seconds one launch can take: the slower of every byte once at
    peak bandwidth and every operation at peak rate."""
    return max(bytes_hbm / hbm_bw, flops / peak_flops)


def paged_decode_cost(H: int, Hkv: int, Dh: int, page_size: int,
                      lengths: Sequence[int], *, kv_bytes: int = 4,
                      qo_bytes: int = 2, fused: bool = True
                      ) -> Tuple[float, float]:
    """(HBM bytes, FLOPs) of one paged-decode launch over rows whose
    stored lengths are ``lengths`` (-1: a padded row, which costs
    nothing).  Each row streams its live pages once (the appended token's
    page included), q is read and the output written once, and the fused
    variant writes the new token's K and V."""
    live = [ln for ln in lengths if ln >= 0]
    pages = sum(ln // page_size + 1 for ln in live)
    kv = 2 * pages * page_size * Hkv * Dh * kv_bytes
    qo = 2 * len(live) * H * Dh * qo_bytes
    append = 2 * len(live) * Hkv * Dh * kv_bytes if fused else 0
    tokens = sum(ln + 1 for ln in live)
    flops = 4.0 * H * Dh * tokens                  # QK^T and PV
    return kv + qo + append, flops


def causal_pairs(pos0: int, n: int) -> int:
    """Query-key pairs of ``n`` queries at positions pos0..pos0+n-1, each
    over keys 0..its position."""
    return n * pos0 + n * (n + 1) // 2


def flash_prefill_cost(H: int, Hkv: int, Dh: int, pos0: int, n: int, *,
                       elem_bytes: int = 2) -> Tuple[float, float]:
    """(HBM bytes, FLOPs) of one causal flash launch of ``n`` real
    queries after ``pos0`` cached positions: q read and o written once,
    the ``pos0 + n`` valid keys and values read once; 4 H Dh operations
    per valid pair (QK^T and PV)."""
    q_o = 2 * n * H * Dh * elem_bytes
    kv = 2 * (pos0 + n) * Hkv * Dh * elem_bytes
    return q_o + kv, 4.0 * H * Dh * causal_pairs(pos0, n)


def matmul_params(m: dict) -> int:
    """Weights a token of a ``gqa`` configuration's ``model`` section
    multiplies through."""
    return default(m).matmul_params(m)


def token_flops(m: dict, contexts: Iterable[int]) -> float:
    """Model FLOPs of ``gqa`` tokens that attend over ``contexts`` keys
    each."""
    return default(m).token_flops(m, contexts)
