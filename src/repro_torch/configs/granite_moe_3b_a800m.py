"""granite-moe-3b-a800m [moe] — hf:ibm-granite/granite-3.0 MoE family (hf).

32L, d_model=1536, 24H (GQA kv=8), d_ff=512, vocab=49155; MoE 40 experts
top-8.  (The source's structured field says 40 experts and its prose
note 32; the structured field is followed, as in the JAX package.)
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    head_dim=64,
    num_experts=40,
    experts_per_token=8,
)
