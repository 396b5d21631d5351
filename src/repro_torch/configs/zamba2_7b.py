"""zamba2-7b [hybrid] — arXiv:2411.15242 (unverified).

81L Mamba2 backbone, d_model=3584, ssm_state=64; a SHARED attention block
(32H, kv=32, d_ff=14336) applied after every 6th mamba layer (13
applications; 3 trailing mamba layers).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    head_dim=112,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    attn_period=6,
)
