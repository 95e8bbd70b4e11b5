"""deepseek-moe-16b — fine-grained MoE: 2 shared + 64 routed top-6.

28L d_model=2048 16H (kv=16, i.e. MHA) d_ff=1408 (expert width) vocab=102400.
First layer uses a dense FFN (DeepSeekMoE keeps layer 0 dense).
[arXiv:2401.06066; hf]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    head_dim=128,
    rope_theta=10000.0,
    moe=MoEConfig(
        num_experts=64,
        top_k=6,
        d_ff_expert=1408,
        num_shared_experts=2,
        first_dense_layers=1,
        d_ff_dense=10944,
    ),
)


def smoke_config() -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return CONFIG.replace(
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=96, vocab_size=256,
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=96,
                      num_shared_experts=1, first_dense_layers=1,
                      d_ff_dense=128),
    )
