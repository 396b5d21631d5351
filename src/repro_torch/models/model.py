"""Model facade: one object per architecture config, bound to a device.

Mirrors the JAX package's ``repro/models/model.py``: params, the step
inputs of each shape kind (``input_specs``) and synthetic batches of
them, the training loss (``loss_fn``), the decode cache (paged for the
dense family, the vlm and granite-moe's MoE, a rolling sliding-window
ring for mixtral's MoE, state and conv tails for the SSM family, both
for the hybrid — every Mamba2 layer's state and one paged pool per
application of its shared attention block — and paged self-attention
pools and a fixed cross-attention cache for the encoder-decoder), the
whole-prompt prefill, one prefill chunk (the paged layout: dense and
MoE) and one decode step.  The model lives on the card unless the
caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, Optional

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..device import DeviceLike, resolve_device
from . import transformer as T
from .param import ParamSpec, count_params, init_params, tree_map_specs

#: leaves (by the last two keys of their path) that the JAX package reads
#: in f32 whatever the compute dtype (``repro/models/ssm.py``)
_F32_LEAVES = {("mamba", "dt_bias"), ("mamba", "a_log"),
               ("mamba", "d_skip"), ("mamba", "norm")}

#: encoder length of the encoder-decoder's decode cache (audio frames),
#: as the JAX package fixes it: the cross cache holds this many rows per
#: sequence and ``cache["enc_len"]`` says how many are valid
ENCDEC_DECODE_ENC_LEN = 4096


class Model:
    def __init__(self, cfg: ModelConfig, device: DeviceLike = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.param_specs = T.build_specs(cfg)

    def with_layers(self, num_layers: int) -> "Model":
        """The same architecture cut to its first ``num_layers`` layers,
        on the same device (the speculative lane's draft model)."""
        return Model(dataclasses.replace(self.cfg, num_layers=num_layers),
                     device=self.device)

    # ------------------------------------------------------------------
    # Params
    # ------------------------------------------------------------------
    def init_params(self, seed: int = 0):
        """f32 params on the model's device, from seeded generators."""
        return init_params(self.param_specs, seed, self.device)

    def compute_params(self, params):
        """The tree the serving steps read: every weight cast ONCE to the
        compute dtype (the layers would cast at each call otherwise —
        at full width a re-read of ~2 GB of f32 weights per step).  The
        leaves the JAX package reads in f32 stay f32: norm scales, and
        the Mamba2 ``dt_bias``, ``a_log``, ``d_skip`` and gated-norm
        weight ``norm``.  The numbers equal the per-call casts of the JAX
        package."""
        dt = getattr(torch, self.cfg.dtype)

        def cast(tree, path=()):
            if isinstance(tree, dict):
                return {k: cast(v, path + (k,)) for k, v in tree.items()}
            if "scale" in path or path[-2:] in _F32_LEAVES:
                return tree
            return tree.to(dt)

        return cast(params)

    def n_params(self) -> int:
        return count_params(self.param_specs)

    # ------------------------------------------------------------------
    # Cache
    # ------------------------------------------------------------------
    def cache_specs(self, shape: ShapeConfig, pool_slack: int = 0):
        enc_len = ENCDEC_DECODE_ENC_LEN if self.cfg.is_encdec else 0
        return T.cache_specs(self.cfg, shape.global_batch, shape.seq_len,
                             enc_len=enc_len, pool_slack=pool_slack)

    def init_cache(self, shape: ShapeConfig, pool_slack: int = 0):
        """Zeroed decode cache on the model's device.  The hybrid's is
        {"layers": the SSM state and conv tails of every Mamba2 layer
        (f32), "attn": {"k_pool", "v_pool"} of shape (n_shared_attn,
        batch, n_pool, BLOCK_SIZE, Hkv, D)}; a prefill cache loads into
        it as the JAX package's ``tests/test_arch_smoke.py`` loads one
        (the Mamba2 caches cast to f32, each application's K/V paged into
        the slot's pages).  The rolling layout's is {"layers": {"k", "v"}}
        of shape (L, batch, min(window, seq_len), Hkv, D); a prefill's
        last W positions load into it with position p in row p % W."""
        return init_params(self.cache_specs(shape, pool_slack), 0,
                           self.device)

    # ------------------------------------------------------------------
    # Inputs
    # ------------------------------------------------------------------
    def input_specs(self, shape: ShapeConfig) -> Dict[str, ParamSpec]:
        """ParamSpec tree of the step inputs of this (arch, shape) cell,
        as the JAX package declares them: train {"tokens", "labels"}
        (the encoder-decoder also "enc_embeds", the vlm
        "frontend_embeds" of ``frontend_positions`` rows, its tokens and
        labels the other ``seq_len - P``); prefill {"tokens"} with the
        same frontend inputs; decode {"tokens" (B, 1), "lengths"} and a
        "block_table" for the paged layouts."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        ii = torch.int32
        dt = getattr(torch, cfg.dtype)

        def ints(*shp):
            return ParamSpec(shp, ("batch",) + (None,) * (len(shp) - 1),
                             dtype=ii, init="zeros")

        def embeds(n):
            return ParamSpec((B, n, cfg.d_model), ("batch", None, None),
                             dtype=dt)

        if shape.kind in ("train", "prefill"):
            P = cfg.frontend_positions if cfg.family == "vlm" else 0
            specs = {"tokens": ints(B, S - P)}
            if shape.kind == "train":
                specs["labels"] = ints(B, S - P)
            if cfg.is_encdec:
                specs["enc_embeds"] = embeds(S)
            elif cfg.family == "vlm":
                specs["frontend_embeds"] = embeds(P)
            return specs

        specs = {"tokens": ints(B, 1), "lengths": ints(B)}
        if self.uses_block_table():
            specs["block_table"] = ints(B, -(-S // T.BLOCK_SIZE) + 1)
        return specs

    def synthetic_batch(self, shape: ShapeConfig, seed: int = 0):
        """A batch of :meth:`input_specs` on the model's device, by the
        JAX package's formula: token ids uniform over the vocabulary,
        embeddings ``N(0, 1)`` cast to their dtype times 0.02, decode
        lengths at mid-cache and block tables ``arange`` in every row.
        Each input's generator is seeded from ``seed`` and a CRC-32 of
        its path, the same in every process (the JAX package's
        ``hash(path)`` is salted per process, so two of its processes
        given one seed make different batches).  The numbers are
        torch's, not ``jax.random``'s."""
        cfg = self.cfg

        def make(path: str, s: ParamSpec):
            if s.dtype == torch.int32 and path == "lengths":
                # mid-cache decode position
                t = torch.full(s.shape, shape.seq_len // 2,
                               dtype=torch.int32)
            elif s.dtype == torch.int32 and path == "block_table":
                B, mb = s.shape
                t = torch.arange(mb, dtype=torch.int32).repeat(B, 1)
            else:
                gen = torch.Generator()
                gen.manual_seed((seed * 9973 + zlib.crc32(path.encode()))
                                % (2**31))
                if s.dtype == torch.int32:
                    t = torch.randint(0, cfg.vocab_size, s.shape,
                                      generator=gen, dtype=torch.int32)
                else:
                    t = torch.randn(s.shape, generator=gen).to(
                        s.dtype) * 0.02
            return t.to(self.device)

        return tree_map_specs(make, self.input_specs(shape))

    def uses_block_table(self) -> bool:
        """Whether ``decode_step`` reads a block table: paged layouts,
        not the rolling one."""
        layout = T.cache_layout(self.cfg)
        return layout in ("paged", "hybrid") or self.cfg.is_encdec

    # ------------------------------------------------------------------
    # Forward entry points
    # ------------------------------------------------------------------
    def loss_fn(self, params, batch, *, remat: Optional[str] = "full",
                impl: Optional[str] = None):
        """The training loss and its metrics {"loss", "ntokens"} (see
        :func:`repro_torch.models.transformer.forward_train`); ``remat``
        is None, "none", "full" or "dots", as in the JAX package."""
        return T.forward_train(params, batch, self.cfg, remat=remat,
                               impl=impl)

    def prefill(self, params, batch, *, impl: Optional[str] = None):
        """Whole-prompt prefill (every ported family): last-position
        logits and the per-layer cache (see
        :func:`repro_torch.models.transformer.forward_prefill`).
        ``impl="plain"`` runs the plain versions in place of the kernels
        (comparison only)."""
        return T.forward_prefill(params, batch, self.cfg, impl=impl)

    def prefill_chunk(self, params, cache, batch, *,
                      n_kv: Optional[int] = None, global_pages: bool = False,
                      impl: Optional[str] = None):
        """One chunk of an incremental prefill against the paged cache
        (see :func:`repro_torch.models.transformer.prefill_chunk`).
        ``global_pages`` switches ``row`` / ``pages`` to slot-flattened
        global page ids, as the serving engine passes them; the default
        is the JAX package's (page ids inside the slot's own pool).
        ``impl="plain"`` runs the plain attention in place of the
        kernels (comparison only)."""
        return T.prefill_chunk(params, cache, batch, self.cfg, n_kv=n_kv,
                               global_pages=global_pages, impl=impl)

    def decode_step(self, params, cache, batch, *,
                    n_kv: Optional[int] = None, global_pages: bool = False,
                    impl: Optional[str] = None):
        """One token for every slot; ``n_kv`` bounds the paged sweep.
        ``global_pages`` switches block-table entries to slot-flattened
        global page ids (the serving engine's mode); the default is the
        JAX package's, page ids inside each row's own pool.  The SSM
        family needs only ``batch["tokens"]``; the hybrid also its
        lengths and block table, for the shared block's pools; the
        rolling layout its tokens and lengths (no table)."""
        return T.decode_step(params, cache, batch, self.cfg, n_kv=n_kv,
                             global_pages=global_pages, impl=impl)

