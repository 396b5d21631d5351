"""Architecture registry of the PyTorch package.

Ported: ``qwen2-0.5b``, ``granite-3-8b``, ``minitron-4b`` and
``phi3-mini-3.8b`` (dense), ``mamba2-2.7b`` (ssm),
``seamless-m4t-medium`` (encdec), ``zamba2-7b`` (hybrid),
``llava-next-34b`` (vlm), ``mixtral-8x7b`` (moe, sliding window) and
``granite-moe-3b-a800m`` (moe, paged) — every entry of the JAX package's
registry, in its order.
"""

from .base import SHAPES, ModelConfig, ShapeConfig, smoke_config
from .granite_3_8b import CONFIG as granite_3_8b
from .granite_moe_3b_a800m import CONFIG as granite_moe_3b_a800m
from .llava_next_34b import CONFIG as llava_next_34b
from .mamba2_2_7b import CONFIG as mamba2_2_7b
from .minitron_4b import CONFIG as minitron_4b
from .mixtral_8x7b import CONFIG as mixtral_8x7b
from .phi3_mini_3_8b import CONFIG as phi3_mini_3_8b
from .qwen2_0_5b import CONFIG as qwen2_0_5b
from .seamless_m4t_medium import CONFIG as seamless_m4t_medium
from .zamba2_7b import CONFIG as zamba2_7b

# the JAX registry's order
ARCHS = {
    c.name: c
    for c in [
        seamless_m4t_medium,
        qwen2_0_5b,
        minitron_4b,
        phi3_mini_3_8b,
        granite_3_8b,
        mamba2_2_7b,
        llava_next_34b,
        mixtral_8x7b,
        granite_moe_3b_a800m,
        zamba2_7b,
    ]
}


def get_arch(name: str) -> ModelConfig:
    try:
        return ARCHS[name]
    except KeyError:
        raise ValueError(
            f"unknown arch {name!r}; available: {sorted(ARCHS)}"
        ) from None


def cells():
    """All runnable (arch, shape) dry-run cells + documented skips."""
    runnable, skipped = [], []
    for cfg in ARCHS.values():
        for shape in SHAPES.values():
            if shape.name == "long_500k" and not cfg.sub_quadratic:
                skipped.append((cfg.name, shape.name,
                                "full attention: unbounded 500k KV state"))
            else:
                runnable.append((cfg.name, shape.name))
    return runnable, skipped


__all__ = [
    "ARCHS", "SHAPES", "ModelConfig", "ShapeConfig", "get_arch",
    "smoke_config", "cells",
]
