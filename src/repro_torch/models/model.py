"""Model facade: one object per architecture config, bound to a device.

Mirrors the JAX package's ``repro/models/model.py`` for the serving
path: params, the paged decode cache, one prefill chunk and one decode
step.  The model lives on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..device import DeviceLike, resolve_device
from . import transformer as T
from .param import count_params, init_params


class Model:
    def __init__(self, cfg: ModelConfig, device: DeviceLike = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.param_specs = T.build_specs(cfg)

    # ------------------------------------------------------------------
    # Params
    # ------------------------------------------------------------------
    def init_params(self, seed: int = 0):
        """f32 params on the model's device, from seeded generators."""
        return init_params(self.param_specs, seed, self.device)

    def compute_params(self, params):
        """The tree the serving steps read: every weight cast ONCE to the
        compute dtype (the layers would cast at each call otherwise —
        at full width a re-read of ~2 GB of f32 weights per step).  Norm
        scales stay f32, as the norms read them.  The numbers equal the
        per-call casts of the JAX package."""
        dt = getattr(torch, self.cfg.dtype)

        def cast(tree, path=()):
            if isinstance(tree, dict):
                return {k: cast(v, path + (k,)) for k, v in tree.items()}
            return tree if "scale" in path else tree.to(dt)

        return cast(params)

    def n_params(self) -> int:
        return count_params(self.param_specs)

    # ------------------------------------------------------------------
    # Cache
    # ------------------------------------------------------------------
    def cache_specs(self, shape: ShapeConfig, pool_slack: int = 0):
        return T.cache_specs(self.cfg, shape.global_batch, shape.seq_len,
                             pool_slack=pool_slack)

    def init_cache(self, shape: ShapeConfig, pool_slack: int = 0):
        """Zeroed paged cache on the model's device."""
        return init_params(self.cache_specs(shape, pool_slack), 0,
                           self.device)

    # ------------------------------------------------------------------
    # Forward entry points
    # ------------------------------------------------------------------
    def prefill_chunk(self, params, cache, batch, *,
                      n_kv: Optional[int] = None, global_pages: bool = True,
                      impl: Optional[str] = None):
        """One chunk of an incremental prefill against the paged cache
        (see :func:`repro_torch.models.transformer.prefill_chunk`).
        ``impl="plain"`` runs the plain attention in place of the
        kernels (comparison only)."""
        return T.prefill_chunk(params, cache, batch, self.cfg, n_kv=n_kv,
                               global_pages=global_pages, impl=impl)

    def decode_step(self, params, cache, batch, *,
                    n_kv: Optional[int] = None, global_pages: bool = True,
                    impl: Optional[str] = None):
        """One token for every slot; ``n_kv`` bounds the paged sweep."""
        return T.decode_step(params, cache, batch, self.cfg, n_kv=n_kv,
                             global_pages=global_pages, impl=impl)

