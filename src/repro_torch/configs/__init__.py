"""Architecture registry of the PyTorch package.

Ported so far: ``qwen2-0.5b`` (dense) and ``mamba2-2.7b`` (ssm); the
other families of the JAX package's registry are later slices of the
port.
"""

from .base import SHAPES, ModelConfig, ShapeConfig, smoke_config
from .mamba2_2_7b import CONFIG as mamba2_2_7b
from .qwen2_0_5b import CONFIG as qwen2_0_5b

ARCHS = {c.name: c for c in [qwen2_0_5b, mamba2_2_7b]}

__all__ = ["ARCHS", "SHAPES", "ModelConfig", "ShapeConfig", "smoke_config"]
