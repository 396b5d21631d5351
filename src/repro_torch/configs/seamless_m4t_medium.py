"""seamless-m4t-medium [audio, enc-dec] — arXiv:2308.11596 (hf).

12L encoder + 12L decoder, d_model=1024, 16H (GQA kv=16), d_ff=4096,
vocab=256206.  The audio frontend is a STUB: the encoder takes
precomputed frame embeddings (``batch["enc_embeds"]``) directly.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    num_layers=12,          # decoder layers
    encoder_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    norm="layernorm",
)
