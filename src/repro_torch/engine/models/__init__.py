"""Model registry of the port: ``build_model(cfg)`` dispatches on
``cfg.family``.

* ``dense`` -> ``TransformerLM``.  It implements the paged-KV hooks the
  continuous-batching engine drives:
    paged_kv_layout() -> (layers, kv_heads, head_dim)
    prefill_with_cache(tokens, cache, valid_len=...) -> (logits, cache)
    paged_decode_step(token, k_pages, v_pages, page_table, lengths)
        -> (logits, k_pages, v_pages)          # pools updated in place
    cache_kv_rows_dev / cache_kv_rows / paged_cache_view / cache_capacity
  and the dense-view hooks of the engine's ``paged_decode=False`` arm:
    decode_step(token, cache) -> (logits, cache)
    decode_kv_taps(cache, slots) -> (k, v) (L, B, Hkv, Dh)
* ``hybrid`` -> ``GriffinLM`` (recurrentgemma).  ``paged_kv_layout()`` is
  None, so the engine keeps one dense cache row per request:
    prefill(tokens) -> (logits, cache); extend_cache(cache, extra)
    decode_step(token, cache) -> (logits, cache)
    cache_batch_axes(cache) -> {leaf: batch axis}
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig


def build_model(cfg: ModelConfig, device="cuda"):
    if cfg.family == "dense":
        from repro_torch.engine.models.transformer import TransformerLM
        return TransformerLM(cfg, device=device)
    if cfg.family == "hybrid":
        from repro_torch.engine.models.rglru import GriffinLM
        return GriffinLM(cfg, device=device)
    raise NotImplementedError(
        f"family {cfg.family!r} is not ported yet (ROADMAP Queue 1)")


__all__ = ["build_model"]
