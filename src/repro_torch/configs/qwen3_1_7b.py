"""qwen3-1.7b — dense decoder with qk-norm + GQA.

28L d_model=2048 16H (GQA kv=8) d_ff=6144 vocab=151936.
[hf:Qwen/Qwen3-1.7B]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    family="dense",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=6144,
    vocab_size=151936,
    head_dim=128,
    rope_theta=1000000.0,
    qk_norm=True,
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256,
    )
