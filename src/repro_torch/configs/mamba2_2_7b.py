"""mamba2-2.7b [ssm] — arXiv:2405.21060 (unverified); SSD, attention-free.

64L, d_model=2560, ssm_state=128, headdim=64 (=> 80 SSD heads), expand=2.
d_ff=0 / heads are attention-free placeholders.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
)
