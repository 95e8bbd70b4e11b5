"""xlstm-350m — alternating mLSTM / sLSTM recurrent blocks (no attention).

24L d_model=1024 4H d_ff=0 vocab=50304, tied.  d_ff=0: the xLSTM blocks
carry their own up/down projections.  Pure recurrent: O(1) decode state,
and prefix reuse is whole-prefix only (supports_partial_prefix=False).
[arXiv:2405.04517]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    head_dim=256,
    block_pattern=("mlstm", "slstm"),
    tie_embeddings=True,
    supports_partial_prefix=False,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=64, num_heads=2, num_kv_heads=2, head_dim=32,
        vocab_size=256,
    )
