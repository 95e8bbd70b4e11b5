"""mixtral-8x22b — 8 experts top-2 + sliding-window attention.

56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768.
SWA window 4096 bounds the KV cache, so long_500k decode is runnable.
[arXiv:2401.04088; hf]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    head_dim=128,
    rope_theta=1000000.0,
    swa_window=4096,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=16384),
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, swa_window=16,
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128),
    )
