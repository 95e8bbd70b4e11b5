"""Model registry of the port: ``build_model(cfg)`` dispatches on
``cfg.family``.

Only the dense family is ported (``TransformerLM``).  It implements the
paged-KV hooks the continuous-batching engine drives:
  paged_kv_layout() -> (layers, kv_heads, head_dim)
  prefill_with_cache(tokens, cache, valid_len=...) -> (logits, cache)
  paged_decode_step(token, k_pages, v_pages, page_table, lengths)
      -> (logits, k_pages, v_pages)          # pools updated in place
  cache_kv_rows_dev / cache_kv_rows / paged_cache_view / cache_capacity
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig


def build_model(cfg: ModelConfig, device="cuda"):
    if cfg.family == "dense":
        from repro_torch.engine.models.transformer import TransformerLM
        return TransformerLM(cfg, device=device)
    raise NotImplementedError(
        f"family {cfg.family!r} is not ported yet (ROADMAP Queue 1)")


__all__ = ["build_model"]
