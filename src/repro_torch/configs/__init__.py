"""Architecture registry of the PyTorch package.

Only ``qwen2-0.5b`` is ported so far; the other families of the JAX
package's registry are later slices of the port.
"""

from .base import SHAPES, ModelConfig, ShapeConfig, smoke_config
from .qwen2_0_5b import CONFIG as qwen2_0_5b

ARCHS = {c.name: c for c in [qwen2_0_5b]}

__all__ = ["ARCHS", "SHAPES", "ModelConfig", "ShapeConfig", "smoke_config"]
