"""llava-next-34b [vlm] — hf:llava-hf/llava-v1.6 family (unverified).

60L backbone, d_model=7168, 56H (GQA kv=8), d_ff=20480, vocab=64000.
The anyres-tiling vision frontend is a STUB: ``input_specs`` provides
precomputed patch embeddings for 1152 positions (2 tiles x 576 patches).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    frontend_positions=1152,
)
