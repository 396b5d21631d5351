"""phi3-mini-3.8b [dense] — arXiv:2404.14219 (unverified).

32L, d_model=3072, 32H (GQA kv=32 = MHA-degenerate), d_ff=8192,
vocab=32064; RoPE + SwiGLU.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
)
