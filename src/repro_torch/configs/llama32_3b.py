"""llama3.2-3b — small llama3 dense decoder.

28L d_model=3072 24H (GQA kv=8, three query heads per KV head)
d_ff=8192 vocab=128256, tied embeddings.
[hf:meta-llama/Llama-3.2-3B]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b",
    family="dense",
    num_layers=28,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=128256,
    head_dim=128,
    rope_theta=500000.0,
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=3, d_model=48, num_heads=6, num_kv_heads=2, head_dim=8,
        d_ff=128, vocab_size=256,
    )
