"""Model configuration for the PyTorch port.

A copy of the JAX package's ``ModelConfig``/``MoEConfig`` dataclasses,
``ShapeSpec``/``SHAPES`` and ``shape_applicable``, with the NVIDIA H100
SXM's hardware constants in place of the JAX package's TPU ones (the
roofline, ``launch/roofline.py``, and the dry run's memory fit read
them).  ``attention_impl`` selects the attention path: ``"cuda"`` (the
hand-written kernels, the default) or ``"torch"`` (plain PyTorch math,
the counterpart of the JAX ``"xla"``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Hardware constants: one NVIDIA H100 SXM5 80 GB (NVIDIA H100 Tensor Core
# GPU data sheet; dense rates, no structured sparsity)
# ---------------------------------------------------------------------------
PEAK_FLOPS_BF16 = 989e12      # per GPU, FLOP/s: BF16 tensor cores, dense
PEAK_FLOPS_F32 = 67e12        # per GPU, FLOP/s: FP32 on the CUDA cores
HBM_BW = 3.35e12              # per GPU, bytes/s: HBM3
HBM_BYTES = 80e9              # per GPU, bytes (80 GB)
# the collective terms (the JAX package's ICI_BW and DCN_BW counterparts)
NVLINK_BW = 450e9             # per GPU, bytes/s, one direction: NVLink 4,
#                               18 links, 900 GB/s both directions together
IB_BW = 50e9                  # per GPU, bytes/s, one direction: one NDR
#                               InfiniBand port (400 Gb/s) a GPU, as in a
#                               DGX H100 (cross-node)


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
class MLAConfig:
    """Multi-head latent attention (DeepSeek-V2, arXiv:2405.04434): the
    query through a ``q_lora_rank`` bottleneck, keys and values from one
    ``kv_lora_rank`` latent a token, a ``qk_rope_head_dim`` rotary key
    shared by all heads, and YaRN rotary positions (``rope_factor`` over
    ``original_max_position`` with the ``beta_fast``/``beta_slow``
    correction range; ``mscale``/``mscale_all_dim`` scale the scores)."""
    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int
    rope_factor: float = 1.0
    original_max_position: int = 4096
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 1.0


@dataclass(frozen=True)
class RoutingConfig:
    """DeepSeek-V2's expert layer: ``group_limited_greedy`` routing over
    all ``MoEConfig.num_experts`` (the softmax's experts in ``n_group``
    groups, each scored by its best expert, the top ``topk_group`` groups
    kept, then the top-k among them), weights times
    ``routed_scaling_factor`` (renormalized first with
    ``norm_topk_prob``), dispatched dropless; the layer holds experts
    ``held_start .. held_start + held_count - 1`` and computes their part
    of the result alone (``held_count`` 0: all of them)."""
    n_group: int = 1
    topk_group: int = 1
    routed_scaling_factor: float = 1.0
    norm_topk_prob: bool = False
    held_start: int = 0
    held_count: int = 0


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
    # --- DeepSeek-V2's latent attention and expert layer (models/mla.py)
    mla: Optional[MLAConfig] = None
    routing: Optional[RoutingConfig] = None

    def __post_init__(self):
        # a configuration file's nested groups may arrive as dicts
        for name, kind in (("mla", MLAConfig), ("routing", RoutingConfig)):
            value = getattr(self, name)
            if isinstance(value, dict):
                object.__setattr__(self, name, kind(**value))

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    @property
    def is_recurrent(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def full_attention(self) -> bool:
        """True if the arch relies on unbounded dense self-attention (the
        ssm holds no attention, the hybrid's local windows are bounded)."""
        if self.is_recurrent:
            return False
        return self.swa_window == 0

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256, as in the JAX package (its
        weights bridge over unchanged)."""
        return round_up(self.vocab_size, 256)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head), counted
        as the JAX package counts it, its approximations included: an MoE
        layer holds its routed and shared experts and its router, a lead
        layer (``i < first_dense_layers``) a dense FFN of ``d_ff_dense``;
        an mLSTM or sLSTM layer ``10 d^2``; every FFN three matrices; an
        encoder-decoder adds its encoder blocks and one attention and norm
        a decoder layer for the cross-attention; the head counts unless
        ``tie_embeddings`` (whisper ties in the model, not in the
        config)."""
        d, dh = self.d_model, self.resolved_head_dim
        h, hkv = self.num_heads, self.num_kv_heads
        embed = self.padded_vocab * d
        head = 0 if self.tie_embeddings else self.padded_vocab * d
        attn = d * h * dh + 2 * d * hkv * dh + h * dh * d
        w = self.lru_width or d
        rglru = 2 * d * w + 2 * w + self.conv1d_width * w + w * d
        m = self.moe
        pattern = self.block_pattern or ("attn",)
        total = embed + head + d
        for i in range(self.num_layers):
            total += 2 * d
            kind = pattern[i % len(pattern)]
            if kind in ("mlstm", "slstm"):
                total += 10 * d * d
            elif kind != "attn":
                total += rglru + 3 * d * self.d_ff
            elif m is None:
                total += attn + 3 * d * self.d_ff
            elif i < m.first_dense_layers:
                total += attn + 3 * d * (m.d_ff_dense or self.d_ff)
            else:
                total += attn + (m.num_experts + m.num_shared_experts) \
                    * 3 * d * m.d_ff_expert + d * m.num_experts
        if self.is_encdec:
            total += self.enc_layers * (2 * d + attn + 3 * d * self.d_ff)
            total += self.num_layers * (d + attn)
        return int(total)

    def active_param_count(self) -> int:
        """Parameters a token touches: an MoE layer's top_k routed
        experts and its shared ones, not the other routed experts."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        inactive = (self.num_layers - m.first_dense_layers) \
            * (m.num_experts - m.top_k) * 3 * self.d_model * m.d_ff_expert
        return int(self.param_count() - inactive)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Input shapes assigned to the LM family (all 10 archs share this set), as
# in the JAX package; the distribution layer shards a cell's inputs by them
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Whether an (arch, shape) cell is runnable; the reason if not.

    long_500k requires sub-quadratic attention (a bounded window or a
    recurrent state); the full-attention archs skip it, as in the JAX
    package."""
    if shape.name == "long_500k" and cfg.full_attention:
        return False, "full dense attention cannot hold a 512k KV (O(S^2))"
    return True, ""
