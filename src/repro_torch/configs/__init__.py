"""Architecture registry of the PyTorch package.

Ported so far: ``qwen2-0.5b`` (dense), ``mamba2-2.7b`` (ssm) and
``seamless-m4t-medium`` (encdec); the other families of the JAX
package's registry are later slices of the port.
"""

from .base import SHAPES, ModelConfig, ShapeConfig, smoke_config
from .mamba2_2_7b import CONFIG as mamba2_2_7b
from .qwen2_0_5b import CONFIG as qwen2_0_5b
from .seamless_m4t_medium import CONFIG as seamless_m4t_medium

ARCHS = {c.name: c for c in [qwen2_0_5b, mamba2_2_7b, seamless_m4t_medium]}

__all__ = ["ARCHS", "SHAPES", "ModelConfig", "ShapeConfig", "smoke_config"]
