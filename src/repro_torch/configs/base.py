"""Model configuration for the PyTorch port.

A copy of the JAX package's ``ModelConfig``/``MoEConfig`` dataclasses
without its TPU hardware constants.  ``attention_impl`` selects the
attention path: ``"cuda"`` (the hand-written kernels, the default) or
``"torch"`` (plain PyTorch math, the counterpart of the JAX ``"xla"``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    first_dense_layers: int = 0          # leading layers that use a dense FFN
    d_ff_dense: int = 0                  # width of those dense FFNs
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                          # dense|moe|audio|vlm|ssm|hybrid
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                    # 0 -> d_model // num_heads
    max_seq_len: int = 532480
    rope_theta: float = 500000.0
    qk_norm: bool = False
    swa_window: int = 0                  # 0 -> full attention
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    moe: Optional[MoEConfig] = None
    enc_layers: int = 0
    enc_max_len: int = 0
    block_pattern: Tuple[str, ...] = ()
    local_attn_window: int = 2048
    lru_width: int = 0
    conv1d_width: int = 4
    num_patches: int = 0
    # --- numerics ---
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    # --- attention implementation: "cuda" (hand kernels) or "torch" ---
    attention_impl: str = "cuda"
    supports_partial_prefix: bool = True

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256, as in the JAX package (its
        weights bridge over unchanged)."""
        return round_up(self.vocab_size, 256)

    def param_count(self) -> int:
        """Analytic parameter count of the ported families (embedding +
        blocks + head), counted as the JAX package counts it."""
        d, dh = self.d_model, self.resolved_head_dim
        h, hkv = self.num_heads, self.num_kv_heads
        embed = self.padded_vocab * d
        head = 0 if self.tie_embeddings else self.padded_vocab * d
        attn = d * h * dh + 2 * d * hkv * dh + h * dh * d
        w = self.lru_width or d
        rglru = 2 * d * w + 2 * w + self.conv1d_width * w + w * d
        pattern = self.block_pattern or ("attn",)
        total = embed + head + d
        for i in range(self.num_layers):
            mix = attn if pattern[i % len(pattern)] == "attn" else rglru
            total += 2 * d + mix + 3 * d * self.d_ff
        return int(total)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
