"""Architecture registry of the PyTorch package.

Ported so far: ``qwen2-0.5b`` (dense), ``mamba2-2.7b`` (ssm),
``seamless-m4t-medium`` (encdec), ``zamba2-7b`` (hybrid) and
``mixtral-8x7b`` (moe, sliding window); the other entries of the JAX
package's registry are later slices of the port.
"""

from .base import SHAPES, ModelConfig, ShapeConfig, smoke_config
from .mamba2_2_7b import CONFIG as mamba2_2_7b
from .mixtral_8x7b import CONFIG as mixtral_8x7b
from .qwen2_0_5b import CONFIG as qwen2_0_5b
from .seamless_m4t_medium import CONFIG as seamless_m4t_medium
from .zamba2_7b import CONFIG as zamba2_7b

ARCHS = {c.name: c for c in [qwen2_0_5b, mamba2_2_7b, seamless_m4t_medium,
                             zamba2_7b, mixtral_8x7b]}

__all__ = ["ARCHS", "SHAPES", "ModelConfig", "ShapeConfig", "smoke_config"]
