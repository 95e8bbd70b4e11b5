"""internvl2-2b — VLM: InternLM2 backbone; the ViT frontend is a stub.

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553, untied head.  A
request carries precomputed patch embeddings ``patch_embeds`` (1, 256,
d_model), prepended to its tokens.  [arXiv:2404.16821; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    head_dim=128,
    rope_theta=1000000.0,
    num_patches=256,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, num_patches=8,
    )
