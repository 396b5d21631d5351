"""Model / shape configuration schema for the architecture zoo."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int = 0  # 0 -> d_model // num_heads
    qkv_bias: bool = False
    sliding_window: int = 0  # 0 = full attention
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    norm: str = "rmsnorm"  # rmsnorm | layernorm

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25

    # Mamba2 / SSD
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    ssm_conv_width: int = 4
    ssm_chunk: int = 128

    # Hybrid (zamba2): apply the shared attention block after every
    # `attn_period` SSM layers.
    attn_period: int = 0

    # Encoder-decoder
    encoder_layers: int = 0  # >0 => encdec; num_layers = decoder layers

    # Modality frontend stub: number of positions fed as precomputed
    # embeddings ("anyres tiles" for VLM; audio frames handled by encdec).
    frontend_positions: int = 0

    norm_eps: float = 1e-5
    dtype: str = "bfloat16"  # compute dtype (params kept f32)

    # ---- derived -------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_inner // self.ssm_head_dim

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch serve a 500k-token context with bounded state?"""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    def scaled(self, **overrides) -> "ModelConfig":
        return dataclasses.replace(self, **overrides)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


# The four assigned input shapes (identical across all 10 archs).
SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return cfg.scaled(
        name=cfg.name + "-smoke",
        num_layers=min(cfg.num_layers, 2),
        d_model=128,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads else 0,
        d_ff=256,
        vocab_size=512,
        head_dim=32,
        num_experts=min(cfg.num_experts, 4),
        experts_per_token=min(cfg.experts_per_token, 2),
        # dropless in smoke runs: capacity >= T*k makes the batched and
        # single-token MoE paths bit-consistent (teacher-forcing test)
        moe_capacity_factor=float(min(cfg.num_experts, 4) or 1),
        ssm_state=min(cfg.ssm_state, 16),
        ssm_head_dim=32 if cfg.ssm_state else cfg.ssm_head_dim,
        sliding_window=min(cfg.sliding_window, 16),
        encoder_layers=min(cfg.encoder_layers, 2),
        attn_period=min(cfg.attn_period, 2),
        frontend_positions=min(cfg.frontend_positions, 8),
        dtype="float32",
    )
