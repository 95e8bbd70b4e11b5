"""deepseek-67b — llama-architecture dense decoder.

95L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=102400.
[arXiv:2401.02954; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    family="dense",
    num_layers=95,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22016,
    vocab_size=102400,
    head_dim=128,
    rope_theta=10000.0,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256,
    )
