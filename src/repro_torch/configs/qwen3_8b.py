"""qwen3-8b — dense decoder with qk-norm + GQA.

36L d_model=4096 32H (GQA kv=8) d_ff=12288 vocab=151936.
[hf:Qwen/Qwen3-8B]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=12288,
    vocab_size=151936,
    head_dim=128,
    rope_theta=1000000.0,
    qk_norm=True,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256,
    )
