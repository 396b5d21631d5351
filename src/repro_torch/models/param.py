"""Parameter declaration machinery and the weight bridge.

Models declare their parameters once as a nested-dict tree of
:class:`ParamSpec` (shape + dtype + logical axis names + initializer), as
in the JAX package, so the two packages share one tree layout leaf for
leaf (``wq (L, M, H, D)``, ``wo (L, H, D, M)``, stacked layer axis).

  * ``init_params``       — materialized tensors from a seeded
                            ``torch.Generator`` per leaf, with the JAX
                            package's distributions (the bits differ:
                            ``jax.random`` and torch draw differently)
  * ``params_from_numpy`` — the weight bridge: a JAX param tree as numpy
                            arrays -> the same tree as tensors
  * ``cache_from_numpy``  — the same bridge for a decode cache
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    dtype: torch.dtype = torch.float32
    init: str = "normal"  # normal | zeros | ones | scaled
    scale: float = 0.02

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def tree_map_specs(fn: Callable[[str, ParamSpec], Any], tree, prefix=""):
    """Map over a nested-dict tree of ParamSpec with path strings."""
    if is_spec(tree):
        return fn(prefix, tree)
    if not isinstance(tree, dict):
        raise TypeError(f"unexpected leaf at {prefix}: {tree!r}")
    return {
        k: tree_map_specs(fn, v, f"{prefix}/{k}" if prefix else k)
        for k, v in tree.items()
    }


def tree_map(fn: Callable[[Any], Any], tree):
    """Map over the leaves of a nested-dict tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _path_seed(path: str, base: int) -> int:
    h = hashlib.md5(path.encode()).digest()
    return (base + int.from_bytes(h[:4], "little")) % (2**31)


def init_params(spec_tree, seed: int = 0, device: DeviceLike = "cuda"):
    """Materialize parameters on ``device``: one ``torch.Generator`` per
    leaf, seeded from the leaf's path and ``seed`` as the JAX package
    seeds its keys."""
    dev = resolve_device(device)

    def make(path: str, s: ParamSpec):
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=s.dtype, device=dev)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=s.dtype, device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(_path_seed(path, seed))
        x = torch.randn(s.shape, generator=gen, dtype=torch.float32,
                        device=dev)
        if s.init == "scaled":  # fan-in scaled
            fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
            return (x * float(1.0 / np.sqrt(max(fan_in, 1)))).to(s.dtype)
        return (x * s.scale).to(s.dtype)

    return tree_map_specs(make, spec_tree)


def count_params(spec_tree) -> int:
    total = 0

    def add(path, s):
        nonlocal total
        total += int(np.prod(s.shape))

    tree_map_specs(add, spec_tree)
    return total


def _tensor(a, dev: torch.device) -> torch.Tensor:
    # a private, writable copy: caches are updated in place, and the
    # source may be a read-only view of another framework's buffer
    a = np.array(a, copy=True, order="C")
    if a.dtype.name == "bfloat16":  # ml_dtypes' bf16: move the raw bits
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(dev)
    return torch.from_numpy(a).to(dev)


def params_from_numpy(tree, device: DeviceLike = "cuda"):
    """The weight bridge: a param tree of numpy arrays (for example
    ``jax.tree.map(np.asarray, params)``) -> the same tree of tensors on
    ``device``, leaf for leaf, layouts and dtypes unchanged."""
    dev = resolve_device(device)
    return tree_map(lambda a: _tensor(a, dev), tree)


def cache_from_numpy(tree, device: DeviceLike = "cuda"):
    """The bridge for a decode cache tree (paged pools), as
    :func:`params_from_numpy`."""
    return params_from_numpy(tree, device)
