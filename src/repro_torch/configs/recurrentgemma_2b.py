"""recurrentgemma-2b — Griffin: RG-LRU blocks + local attention, 2:1.

26L d_model=2560 10H (MQA kv=1) d_ff=7680 vocab=256000.
Block pattern (rglru, rglru, attn) repeating; local window 2048 bounds KV.
[arXiv:2402.19427; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,              # 26 blocks: pattern tiled (rglru,rglru,attn)
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    d_ff=7680,
    vocab_size=256000,
    head_dim=256,
    rope_theta=10000.0,
    block_pattern=("rglru", "rglru", "attn"),
    local_attn_window=2048,
    lru_width=2560,
    conv1d_width=4,
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=3, d_model=64, num_heads=2, num_kv_heads=1, head_dim=32,
        d_ff=128, vocab_size=256, local_attn_window=16, lru_width=64,
    )
