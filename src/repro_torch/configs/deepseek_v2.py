"""deepseek-v2 — latent attention (MLA) in every layer, DeepSeekMoE with
160 routed experts (top-6 under group-limited routing) and 2 shared.

60L d_model=5120 128H, q_lora 1536, kv_lora 512, qk_nope 128, qk_rope 64,
v 128, dense lead layer of 12288, experts of 1536, vocab=102400, YaRN
rotary positions (factor 40 over 4096).  [arXiv:2405.04434; the
published config.json of deepseek-ai/DeepSeek-V2]

Not in the registry (``ARCH_IDS`` holds the JAX package's ten, which has
no latent attention).  ``CONFIG`` is the cut one card serves: 30 of the
60 layers (one stage of two) holding experts 0-19, routing group 0 of
the 8 that share each layer over 8 cards.  The engine serves it through
``models/mla.py`` (``build_model`` picks that model where ``cfg.mla`` is
set).
"""
from repro_torch.configs.base import (MLAConfig, ModelConfig, MoEConfig,
                                      RoutingConfig)

CONFIG = ModelConfig(
    name="deepseek-v2",
    family="moe",
    num_layers=30,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,
    d_ff=12288,
    vocab_size=102400,
    head_dim=192,
    rope_theta=10000.0,
    moe=MoEConfig(
        num_experts=160,
        top_k=6,
        d_ff_expert=1536,
        num_shared_experts=2,
        first_dense_layers=1,
        d_ff_dense=12288,
    ),
    mla=MLAConfig(
        q_lora_rank=1536, kv_lora_rank=512, qk_nope_head_dim=128,
        qk_rope_head_dim=64, v_head_dim=128, rope_factor=40.0,
        original_max_position=4096, beta_fast=32.0, beta_slow=1.0,
        mscale=0.707, mscale_all_dim=0.707),
    routing=RoutingConfig(n_group=8, topk_group=3,
                          routed_scaling_factor=16.0, norm_topk_prob=False,
                          held_start=0, held_count=20),
)


def smoke_config() -> ModelConfig:
    """Reduced same-family config for the CPU tests: every kind of layer,
    16 experts in 4 groups of which 2 are kept, 4 held."""
    return CONFIG.replace(
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=4, head_dim=24,
        d_ff=96, vocab_size=256,
        moe=MoEConfig(num_experts=16, top_k=3, d_ff_expert=32,
                      num_shared_experts=2, first_dense_layers=1,
                      d_ff_dense=96),
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
                      qk_rope_head_dim=8, v_head_dim=16, rope_factor=40.0,
                      original_max_position=64, beta_fast=32.0,
                      beta_slow=1.0, mscale=0.707, mscale_all_dim=0.707),
        routing=RoutingConfig(n_group=4, topk_group=2,
                              routed_scaling_factor=16.0, held_start=0,
                              held_count=4),
    )
