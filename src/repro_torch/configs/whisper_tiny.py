"""whisper-tiny — encoder-decoder ASR backbone; the conv frontend is a stub.

4L (enc) + 4L (dec) d_model=384 6H d_ff=1536 vocab=51865.  A request
carries precomputed frame embeddings ``frames`` (1, frames, d_model).  The
encoder attends bidirectionally over the frames; the decoder has causal
self-attention and cross-attention.  [arXiv:2212.04356]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    num_layers=4,            # decoder layers
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    head_dim=64,
    enc_layers=4,
    enc_max_len=1500,        # 30 s of audio at 50 frames/s
    rope_theta=0.0,          # sinusoidal positions, no rope
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=256, enc_layers=2, enc_max_len=64,
    )
