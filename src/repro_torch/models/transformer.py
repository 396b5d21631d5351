"""Model stacks of every family: the decoder-only stack (dense and
granite-moe's MoE on the paged KV cache of the serving path; mixtral's
MoE on a rolling sliding-window cache; the vlm, whose frontend
embeddings go before the token embeddings), the Mamba2 SSM stack, the
Zamba2-style hybrid (groups of Mamba2 layers, each followed by one
shared attention block), and the encoder-decoder (an encoder over frame
embeddings, a decoder with self- and cross-attention).

Mirrors the JAX package's ``repro/models/transformer.py``: the param and
cache spec trees, the training loss of every family
(:func:`forward_train`, with the JAX package's remat policies), the
whole-prompt prefill, one chunk of a chunked prefill (the paged layout:
dense, and MoE without a window), and the decode step.  Layer params and
caches are stacked over a leading ``layers`` axis, as there; JAX's
``lax.scan`` over that axis is a Python loop here.  The decode and chunk
steps update the cache in place and return the same cache dict.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import torch
from torch.utils import checkpoint as ckpt

from ..configs.base import ModelConfig
from . import layers as L
from . import ssm as S
from .param import ParamSpec

#: KV page size (tokens per page)
BLOCK_SIZE = 128
#: tensor-parallel width of the JAX package's meshes; the pool's page
#: count is rounded to a multiple of it exactly as there, so page ids
#: and pool statistics agree between the two packages
TP_WIDTH = 16


# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------
def _decoder_layer_specs(cfg: ModelConfig, n: int) -> Dict[str, Any]:
    specs = {
        "norm1": {"scale": ParamSpec((n, cfg.d_model), ("layers", "embed"),
                                     init="ones")},
        "attn": L.attention_specs(cfg, n),
        "norm2": {"scale": ParamSpec((n, cfg.d_model), ("layers", "embed"),
                                     init="ones")},
    }
    if cfg.family == "moe":
        specs["moe"] = L.moe_specs(cfg, n)
    else:
        specs["mlp"] = L.mlp_specs(cfg, n)
    return specs


def build_specs(cfg: ModelConfig) -> Dict[str, Any]:
    specs: Dict[str, Any] = {"embed": L.embed_specs(cfg)}
    if cfg.family in ("dense", "moe", "vlm"):
        specs["layers"] = _decoder_layer_specs(cfg, cfg.num_layers)
    elif cfg.family == "ssm":
        specs["layers"] = {
            "norm": {"scale": ParamSpec((cfg.num_layers, cfg.d_model),
                                        ("layers", "embed"), init="ones")},
            "mamba": S.mamba_specs(cfg, cfg.num_layers),
        }
    elif cfg.family == "hybrid":
        specs["layers"] = {
            "norm": {"scale": ParamSpec((cfg.num_layers, cfg.d_model),
                                        ("layers", "embed"), init="ones")},
            "mamba": S.mamba_specs(cfg, cfg.num_layers),
        }
        # one shared attention block, applied every attn_period layers
        specs["shared_attn"] = {
            "norm1": {"scale": ParamSpec((cfg.d_model,), ("embed",),
                                         init="ones")},
            "attn": L.attention_specs(cfg, 0),
            "norm2": {"scale": ParamSpec((cfg.d_model,), ("embed",),
                                         init="ones")},
            "mlp": L.mlp_specs(cfg, 0),
        }
    elif cfg.family == "encdec":
        ne, nd = cfg.encoder_layers, cfg.num_layers

        def norm(n):
            return {"scale": ParamSpec((n, cfg.d_model),
                                       ("layers", "embed"), init="ones")}

        specs["enc_layers"] = {
            "norm1": norm(ne), "attn": L.attention_specs(cfg, ne),
            "norm2": norm(ne), "mlp": L.mlp_specs(cfg, ne),
        }
        specs["enc_norm"] = {
            "scale": ParamSpec((cfg.d_model,), ("embed",), init="ones")
        }
        specs["dec_layers"] = {
            "norm1": norm(nd), "self_attn": L.attention_specs(cfg, nd),
            "norm_x": norm(nd), "cross_attn": L.attention_specs(cfg, nd),
            "norm2": norm(nd), "mlp": L.mlp_specs(cfg, nd),
        }
    else:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP.md, Queue A)")
    specs["final_norm"] = {
        "scale": ParamSpec((cfg.d_model,), ("embed",), init="ones")
    }
    return specs


# ---------------------------------------------------------------------------
# Cache specs
# ---------------------------------------------------------------------------
def cache_layout(cfg: ModelConfig) -> str:
    if cfg.family == "ssm":
        return "ssm"
    if cfg.family == "hybrid":
        return "hybrid"
    if cfg.sliding_window > 0:
        return "rolling"
    return "paged"


def paged_blocks_sharded_cfg(cfg: ModelConfig) -> bool:
    """True when kv heads do not divide the TP width (the JAX package
    then stripes pool PAGES over its `model` axis)."""
    hkv = cfg.num_kv_heads or cfg.num_heads
    return hkv % TP_WIDTH != 0


def n_shared_attn(cfg: ModelConfig) -> int:
    """Applications of the hybrid's shared attention block."""
    return cfg.num_layers // cfg.attn_period if cfg.attn_period else 0


def _ssm_cache_specs(cfg: ModelConfig, n_layers: int, batch: int):
    H, P = cfg.ssm_heads, cfg.ssm_head_dim
    G, N = cfg.ssm_groups, cfg.ssm_state
    W = cfg.ssm_conv_width
    DI = cfg.ssm_inner
    f32 = torch.float32
    return {
        "state": ParamSpec((n_layers, batch, H, P, N),
                           ("layers", "batch", "ssm_heads", None, None),
                           dtype=f32, init="zeros"),
        "conv_x": ParamSpec((n_layers, batch, W - 1, DI),
                            ("layers", "batch", None, "ssm_inner"),
                            dtype=f32, init="zeros"),
        "conv_b": ParamSpec((n_layers, batch, W - 1, G * N),
                            ("layers", "batch", None, None),
                            dtype=f32, init="zeros"),
        "conv_c": ParamSpec((n_layers, batch, W - 1, G * N),
                            ("layers", "batch", None, None),
                            dtype=f32, init="zeros"),
    }


def _paged_cache_specs(cfg: ModelConfig, n_layers: int, batch: int,
                       max_seq: int, pool_slack: int):
    Hkv = cfg.num_kv_heads or cfg.num_heads
    D = cfg.resolved_head_dim
    dtype = getattr(torch, cfg.dtype)
    mb = -(-max_seq // BLOCK_SIZE) + 1 + pool_slack
    if pool_slack == 0 and paged_blocks_sharded_cfg(cfg):
        mb = -(-mb // TP_WIDTH) * TP_WIDTH
    blocks_ax = "blocks" if paged_blocks_sharded_cfg(cfg) else None
    shape = (n_layers, batch, mb, BLOCK_SIZE, Hkv, D)
    axes = ("layers", "batch", blocks_ax, None, "kv_heads", None)
    return {
        "k_pool": ParamSpec(shape, axes, dtype=dtype, init="zeros"),
        "v_pool": ParamSpec(shape, axes, dtype=dtype, init="zeros"),
    }


def _kv_cache_specs(cfg: ModelConfig, n_layers: int, batch: int,
                    rows: int):
    Hkv = cfg.num_kv_heads or cfg.num_heads
    shape = (n_layers, batch, rows, Hkv, cfg.resolved_head_dim)
    axes = ("layers", "batch", "window", "kv_heads", None)
    dtype = getattr(torch, cfg.dtype)
    return {"k": ParamSpec(shape, axes, dtype=dtype, init="zeros"),
            "v": ParamSpec(shape, axes, dtype=dtype, init="zeros")}


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int,
                enc_len: int = 0, pool_slack: int = 0) -> Dict[str, Any]:
    """ParamSpec tree of the decode cache of this architecture.

    SSM: the f32 state ``(L, batch, H, P, N)`` and the conv tails
    ``(L, batch, W - 1, C)`` of x, B and C (``max_seq`` plays no part).

    Rolling (a config with ``sliding_window > 0``): ``{"k", "v"}`` of
    shape ``(L, batch, W, Hkv, D)`` with ``W = min(sliding_window,
    max_seq)``, in the compute dtype.  With ``W`` the window it is a ring
    (position p in row ``p % W``); with ``max_seq`` under the window it is
    a contiguous cache, which the window never cuts
    (:func:`layers.attention_decode` tells the two apart by ``W``).

    Paged (dense, MoE without a window): per-slot pools ``(L, batch,
    n_pool, BLOCK_SIZE, Hkv, D)`` in the compute dtype.  ``n_pool`` is
    ceil(max_seq / block) + 1 + ``pool_slack`` pages, rounded up to a
    multiple of ``TP_WIDTH`` when the JAX package would stripe pages (and
    no slack was asked for) — the same rule, so the host pool sized from
    this dimension matches the JAX engine's page for page.

    Hybrid: the SSM layout of every Mamba2 layer under ``"layers"``, and
    per-slot paged pools ``(n_shared_attn, batch, n_pool, BLOCK_SIZE,
    Hkv, D)`` under ``"attn"``, one per application of the shared block.

    Encoder-decoder: the decoder's paged self-attention pools under
    ``"self"``, the cross-attention cache ``cross_k`` / ``cross_v``
    ``(L, batch, enc_len, Hkv, D)`` of the encoder output, and the int32
    encoder length of each row, ``enc_len``.
    """
    layout = cache_layout(cfg)
    if layout == "ssm":
        return {"layers": _ssm_cache_specs(cfg, cfg.num_layers, batch)}
    if layout == "hybrid":
        return {
            "layers": _ssm_cache_specs(cfg, cfg.num_layers, batch),
            "attn": _paged_cache_specs(cfg, n_shared_attn(cfg), batch,
                                       max_seq, pool_slack),
        }
    if layout == "rolling":
        return {"layers": _kv_cache_specs(
            cfg, cfg.num_layers, batch, min(cfg.sliding_window, max_seq))}
    if cfg.is_encdec:
        Hkv = cfg.num_kv_heads or cfg.num_heads
        D = cfg.resolved_head_dim
        dtype = getattr(torch, cfg.dtype)
        cross = ((cfg.num_layers, batch, enc_len, Hkv, D),
                 ("layers", "batch", "kv_seq", "kv_heads", None))
        return {
            "self": _paged_cache_specs(cfg, cfg.num_layers, batch, max_seq,
                                       pool_slack),
            "cross_k": ParamSpec(*cross, dtype=dtype, init="zeros"),
            "cross_v": ParamSpec(*cross, dtype=dtype, init="zeros"),
            "enc_len": ParamSpec((batch,), ("batch",), dtype=torch.int32,
                                 init="zeros"),
        }
    return {"layers": _paged_cache_specs(cfg, cfg.num_layers, batch,
                                         max_seq, pool_slack)}


def _layer(tree, i: int):
    """Layer ``i`` of a tree stacked over a leading layers axis (views)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _stack(trees):
    """Per-layer trees -> one tree stacked over a leading layers axis."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _copy_into(dst, src) -> None:
    """Write a tree into a tree of the same layout, in place."""
    if isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k])
    else:
        dst.copy_(src)


# ---------------------------------------------------------------------------
# Whole-sequence stacks
# ---------------------------------------------------------------------------
#: the matrix products that the "dots" policy saves: products without
#: batch dimensions, as ``jax.checkpoint_policies.
#: checkpoint_dots_with_no_batch_dims`` saves them (``torch.matmul`` of an
#: activation and a weight lowers to ``mm``; batched products and
#: everything else are recomputed)
_DOTS = frozenset((torch.ops.aten.mm.default, torch.ops.aten.addmm.default))


def _save_dots(ctx, op, *args, **kwargs):
    if op in _DOTS:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(body, policy: Optional[str]):
    """``body`` under the JAX package's remat policy: ``None`` / "none"
    keeps every activation, "full" recomputes the body in the backward
    pass (``torch.utils.checkpoint``), "dots" recomputes it but keeps the
    outputs of its weight products.  All four give the same numbers."""
    if policy is None or policy == "none":
        return body
    if policy == "full":
        return functools.partial(ckpt.checkpoint, body, use_reentrant=False)
    if policy == "dots":
        return functools.partial(
            ckpt.checkpoint, body, use_reentrant=False,
            context_fn=functools.partial(
                ckpt.create_selective_checkpoint_contexts, _save_dots))
    raise ValueError(f"unknown remat policy {policy!r}")


def _mlp_or_moe(lp, x, cfg: ModelConfig):
    """The feed-forward half of a decoder layer, after its attention."""
    m_in = L.apply_norm(lp["norm2"], x, cfg)
    if cfg.family == "moe":
        return x + L.apply_moe(lp["moe"], m_in, cfg)
    return x + L.apply_mlp(lp["mlp"], m_in, cfg)


def run_decoder_stack(params, x, cfg: ModelConfig, *,
                      remat: Optional[str] = None, emit_kv: bool = False,
                      impl: Optional[str] = None):
    """Full-sequence pass over the stacked decoder layers (dense, MoE or
    the vlm's backbone): causal self-attention (the flash kernel, with the
    config's sliding window) and the MLP or the MoE.  Returns (x, (K, V)
    stacked ``(L, B, S, Hkv, D)``) with ``emit_kv``, else (x, None): a
    training pass keeps no K/V."""

    def body(x, lp):
        a_in = L.apply_norm(lp["norm1"], x, cfg)
        a, kv = L.attention_full(lp["attn"], a_in, cfg, causal=True,
                                 impl=impl)
        return _mlp_or_moe(lp, x + a, cfg), kv

    run = _remat(lambda x, lp: body(x, lp)[0], remat)
    ks, vs = [], []
    for i in range(cfg.num_layers):
        lp = _layer(params["layers"], i)
        if emit_kv:
            x, (k, v) = body(x, lp)
            ks.append(k)
            vs.append(v)
        else:
            x = run(x, lp)
    return x, ((torch.stack(ks), torch.stack(vs)) if emit_kv else None)


def _mamba_layer(lp, x, cfg: ModelConfig, impl):
    """One Mamba2 layer over the whole sequence: (x, its cache)."""
    m_in = L.apply_norm(lp["norm"], x, cfg)
    m, cache = S.mamba_full(lp["mamba"], m_in, cfg, impl=impl)
    return x + m, cache


def run_ssm_stack(params, x, cfg: ModelConfig, *, emit_cache: bool = False,
                  remat: Optional[str] = None, impl: Optional[str] = None):
    """Full-sequence pass over the stacked Mamba2 layers.  Returns (x,
    caches stacked over layers, or None)."""
    run = _remat(lambda x, lp: _mamba_layer(lp, x, cfg, impl)[0], remat)
    caches = []
    for i in range(cfg.num_layers):
        lp = _layer(params["layers"], i)
        if emit_cache:
            x, cache = _mamba_layer(lp, x, cfg, impl)
            caches.append(cache)
        else:
            x = run(x, lp)
    return x, (_stack(caches) if emit_cache else None)


def _shared_mlp(shared, x, cfg: ModelConfig):
    """The MLP half of the hybrid's shared block, after its attention."""
    return x + L.apply_mlp(shared["mlp"],
                           L.apply_norm(shared["norm2"], x, cfg), cfg)


def run_hybrid_stack(params, x, cfg: ModelConfig, *,
                     emit_cache: bool = False, remat: Optional[str] = None,
                     impl: Optional[str] = None):
    """Zamba2-style: groups of ``attn_period`` Mamba2 layers, each group
    followed by the *same* shared attention block (causal, the flash
    kernel); the trailing Mamba2 layers after.  Returns (x, None) or,
    with ``emit_cache``, (x, (the Mamba2 caches stacked over all layers in
    layer order, (K, V) of the block's applications stacked
    ``(n_shared_attn, B, S, Hkv, D)``)).  ``remat`` wraps each group (its
    Mamba2 layers and the shared block) and each trailing layer, as the
    JAX package's scans do."""
    shared = params["shared_attn"]
    period = cfg.attn_period
    n_grouped = n_shared_attn(cfg) * period
    caches, ks, vs = [], [], []

    def group(x, first):
        for i in range(first, first + period):
            x, cache = _mamba_layer(_layer(params["layers"], i), x, cfg,
                                    impl)
            if emit_cache:
                caches.append(cache)
        a_in = L.apply_norm(shared["norm1"], x, cfg)
        a, (k, v) = L.attention_full(shared["attn"], a_in, cfg, causal=True,
                                     impl=impl)
        if emit_cache:
            ks.append(k)
            vs.append(v)
        return _shared_mlp(shared, x + a, cfg)

    run_group = group if emit_cache else _remat(group, remat)
    run_trail = _remat(lambda x, lp: _mamba_layer(lp, x, cfg, impl)[0],
                       remat)
    for first in range(0, n_grouped, period):
        x = run_group(x, first)
    for i in range(n_grouped, cfg.num_layers):
        lp = _layer(params["layers"], i)
        if emit_cache:
            x, cache = _mamba_layer(lp, x, cfg, impl)
            caches.append(cache)
        else:
            x = run_trail(x, lp)
    if not emit_cache:
        return x, None
    return x, (_stack(caches), (torch.stack(ks), torch.stack(vs)))


def run_encoder_stack(params, x, cfg: ModelConfig, *,
                      remat: Optional[str] = None,
                      impl: Optional[str] = None):
    """The encoder: non-causal self-attention (with RoPE) and the MLP over
    the stacked ``enc_layers``."""

    def body(x, lp):
        a_in = L.apply_norm(lp["norm1"], x, cfg)
        a, _ = L.attention_full(lp["attn"], a_in, cfg, causal=False,
                                impl=impl)
        x = x + a
        m_in = L.apply_norm(lp["norm2"], x, cfg)
        return x + L.apply_mlp(lp["mlp"], m_in, cfg)

    run = _remat(body, remat)
    for i in range(cfg.encoder_layers):
        x = run(x, _layer(params["enc_layers"], i))
    return x


def run_decoder_xattn_stack(params, x, enc_out, cfg: ModelConfig, *,
                            remat: Optional[str] = None,
                            emit_kv: bool = False,
                            impl: Optional[str] = None):
    """The decoder: causal self-attention, cross-attention over
    ``enc_out`` and the MLP over the stacked ``dec_layers``.  Returns (x,
    the cache {"self_k", "self_v", "cross_k", "cross_v"} stacked over
    layers) with ``emit_kv``, else (x, None)."""

    def body(x, enc_out, lp):
        a_in = L.apply_norm(lp["norm1"], x, cfg)
        a, (sk, sv) = L.attention_full(lp["self_attn"], a_in, cfg,
                                       causal=True, impl=impl)
        x = x + a
        x_in = L.apply_norm(lp["norm_x"], x, cfg)
        xa, (ck, cv) = L.attention_full(lp["cross_attn"], x_in, cfg,
                                        causal=False, kv_x=enc_out,
                                        impl=impl)
        x = x + xa
        m_in = L.apply_norm(lp["norm2"], x, cfg)
        x = x + L.apply_mlp(lp["mlp"], m_in, cfg)
        return x, {"self_k": sk, "self_v": sv, "cross_k": ck,
                   "cross_v": cv}

    run = _remat(lambda x, e, lp: body(x, e, lp)[0], remat)
    caches = []
    for i in range(cfg.num_layers):
        lp = _layer(params["dec_layers"], i)
        if emit_kv:
            x, cache = body(x, enc_out, lp)
            caches.append(cache)
        else:
            x = run(x, enc_out, lp)
    return x, (_stack(caches) if emit_kv else None)


def _embed_inputs(params, batch, cfg: ModelConfig):
    """Token embeddings (B, S, M); the vlm's ``frontend_embeds`` (B, P,
    M), cast to the compute dtype, go before them, as in the JAX
    package."""
    x = L.embed_tokens(params["embed"], batch["tokens"], cfg)
    if cfg.family == "vlm" and "frontend_embeds" in batch:
        fe = batch["frontend_embeds"].to(device=x.device, dtype=x.dtype)
        x = torch.cat([fe, x], dim=1)
    return x


def forward_train(params, batch, cfg: ModelConfig, *,
                  remat: Optional[str] = "full",
                  impl: Optional[str] = None):
    """Next-token LM loss of every family (encoder-decoder: the seq2seq
    loss on the decoder), as the JAX package's ``forward_train``.

    ``batch``: {"tokens", "labels": (B, S) int32, optional "loss_mask"
    (B, S)}; the encoder-decoder also "enc_embeds" (B, S_enc, M), the vlm
    "frontend_embeds" (B, P, M) — its loss is on the text positions only
    (the logits past the ``P`` frontend positions; the labels are
    text-aligned).  The log-sum-exp and the gold logit are taken in f32.
    ``remat``: None, "none", "full" or "dots" (:func:`_remat`).  Returns
    (loss, {"loss", "ntokens"}), both 0-d f32 tensors.
    """
    if cfg.is_encdec:
        enc = batch["enc_embeds"].to(getattr(torch, cfg.dtype))
        enc_out = run_encoder_stack(params, enc, cfg, remat=remat, impl=impl)
        enc_out = L.apply_norm(params["enc_norm"], enc_out, cfg)
        x = L.embed_tokens(params["embed"], batch["tokens"], cfg)
        x, _ = run_decoder_xattn_stack(params, x, enc_out, cfg, remat=remat,
                                       impl=impl)
    elif cfg.family == "ssm":
        x = _embed_inputs(params, batch, cfg)
        x, _ = run_ssm_stack(params, x, cfg, remat=remat, impl=impl)
    elif cfg.family == "hybrid":
        x = _embed_inputs(params, batch, cfg)
        x, _ = run_hybrid_stack(params, x, cfg, remat=remat, impl=impl)
    else:
        x = _embed_inputs(params, batch, cfg)
        x, _ = run_decoder_stack(params, x, cfg, remat=remat, impl=impl)
    x = L.apply_norm(params["final_norm"], x, cfg)
    logits = L.unembed(params["embed"], x, cfg)

    labels = batch["labels"].to(logits.device).long()
    if cfg.family == "vlm" and "frontend_embeds" in batch:
        # loss only on text positions (labels already text-aligned)
        logits = logits[:, batch["frontend_embeds"].shape[1]:]
    lf = logits.float()
    nll = torch.logsumexp(lf, dim=-1) - lf.gather(-1, labels[..., None])[
        ..., 0]
    mask = batch.get("loss_mask")
    mask = (torch.ones_like(nll) if mask is None
            else mask.to(device=nll.device, dtype=nll.dtype))
    ntokens = mask.sum()
    loss = (nll * mask).sum() / torch.clamp(ntokens, min=1.0)
    return loss, {"loss": loss, "ntokens": ntokens}


def forward_prefill(params, batch, cfg: ModelConfig, *,
                    impl: Optional[str] = None):
    """Prefill: full-sequence pass emitting last-position logits + the
    per-layer caches.

    SSM: ``batch`` = {"tokens": (B, S) int32, "last_index": optional (B,)
    — the per-sequence logit position; default: position -1}; the cache
    holds each layer's final state and conv tails.

    Hybrid: as SSM; the cache is {"mamba": every Mamba2 layer's cache
    stacked, "attn_k", "attn_v": (n_shared_attn, B, S, Hkv, D)}.

    Encoder-decoder: ``batch`` also holds "enc_embeds" (B, S_enc, M), the
    frame embeddings of the audio frontend (a stub in both packages); the
    encoder runs over them, then the decoder over "tokens".  The cache is
    {"self_k", "self_v": (L, B, S, Hkv, D), "cross_k", "cross_v": (L, B,
    S_enc, Hkv, D)}.

    Decoder-only (dense, MoE): ``batch`` as SSM; the cache is {"k",
    "v": (L, B, S, Hkv, D)}, each layer's keys (after RoPE) and values.

    VLM: ``batch`` also holds "frontend_embeds" (B, P, M), the patch
    embeddings of the vision frontend (a stub in both packages), which go
    before the tokens: the sequence, the positions, the cache and
    ``last_index`` count P + S positions.

    ``impl="plain"`` runs the plain kernels' versions (comparison only).
    """
    if cfg.is_encdec:
        enc = batch["enc_embeds"].to(getattr(torch, cfg.dtype))
        enc_out = run_encoder_stack(params, enc, cfg, impl=impl)
        enc_out = L.apply_norm(params["enc_norm"], enc_out, cfg)
        x = L.embed_tokens(params["embed"], batch["tokens"], cfg)
        x, cache = run_decoder_xattn_stack(params, x, enc_out, cfg,
                                           emit_kv=True, impl=impl)
    elif cfg.family == "ssm":
        x = _embed_inputs(params, batch, cfg)
        x, cache = run_ssm_stack(params, x, cfg, emit_cache=True, impl=impl)
    elif cfg.family == "hybrid":
        x = _embed_inputs(params, batch, cfg)
        x, (mcache, (k, v)) = run_hybrid_stack(params, x, cfg,
                                               emit_cache=True, impl=impl)
        cache = {"mamba": mcache, "attn_k": k, "attn_v": v}
    else:
        x = _embed_inputs(params, batch, cfg)
        x, (k, v) = run_decoder_stack(params, x, cfg, emit_kv=True,
                                      impl=impl)
        cache = {"k": k, "v": v}
    x = L.apply_norm(params["final_norm"], x, cfg)
    last_index = batch.get("last_index")
    if last_index is None:
        x_last = x[:, -1]
    else:
        rows = torch.arange(x.shape[0], device=x.device)
        x_last = x[rows, last_index.to(x.device).long()]
    return L.unembed(params["embed"], x_last, cfg), cache


# ---------------------------------------------------------------------------
# Chunked prefill
# ---------------------------------------------------------------------------
def prefill_chunk(params, cache, batch, cfg: ModelConfig, *,
                  n_kv: Optional[int] = None, global_pages: bool = False,
                  impl: Optional[str] = None):
    """One chunk of an incremental (chunked) prefill.

    Processes ``C = tokens.shape[1]`` prompt positions starting at
    absolute position ``start`` for one slot: every layer writes the
    chunk's K/V into its pages (``pages``; spare entries name the scratch
    page 0) and attends the chunk's queries causally over the first
    ``n_kv`` pages of ``row`` (:func:`layers.attention_chunk`).

    ``batch``: {"tokens": (1, C) int32, "start": int, "slot": int — the
                admitting slot, "row": (mb,) int32 block-table row,
                "pages": (C // BLOCK_SIZE,) int32, "last_index": int —
                position of the final prompt token WITHIN the chunk}
    ``row`` and ``pages`` hold page ids inside ``slot``'s own pool, or,
    with ``global_pages`` (the serving engine's mode), global ids into
    the slot-flattened pool; "slot" is then not read.  ``start``,
    ``slot`` and ``last_index`` are host integers: the host chose them,
    so the chunk lane never reads the device.  Returns (logits (1, V) at
    ``last_index``, cache), the pools updated in place.

    The paged layout's families: dense (the MLP) and MoE without a
    window (:func:`layers.apply_moe` over the chunk's ``C`` positions,
    its capacity worked out from ``C``, so a chunk may drop (token,
    expert) pairs that a decode step of one token never drops — as in
    the JAX package).  Other layouts raise.
    """
    if cache_layout(cfg) != "paged" or cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"chunked prefill of family {cfg.family!r} (layout "
            f"{cache_layout(cfg)!r}) is not ported: it is paged-only")
    slot = None if global_pages else int(batch["slot"])
    tokens = batch["tokens"]
    C = tokens.shape[1]
    row, pages = batch["row"], batch["pages"]
    start = int(batch["start"])
    if n_kv is None:
        n_kv = row.shape[0]
    positions = start + torch.arange(C, dtype=torch.int32,
                                     device=tokens.device)
    x = L.embed_tokens(params["embed"], tokens, cfg)
    for i in range(cfg.num_layers):
        lp = _layer(params["layers"], i)
        cl = _layer(cache["layers"], i)
        a_in = L.apply_norm(lp["norm1"], x, cfg)
        a, _ = L.attention_chunk(lp["attn"], a_in, cfg, cl, row=row,
                                 pages=pages, positions=positions,
                                 q_offset=start, n_kv=n_kv, slot=slot,
                                 global_pages=global_pages, impl=impl)
        x = _mlp_or_moe(lp, x + a, cfg)
    x = L.apply_norm(params["final_norm"], x, cfg)
    x_last = x[:, int(batch["last_index"])]
    return L.unembed(params["embed"], x_last, cfg), cache


# ---------------------------------------------------------------------------
# Decode step
# ---------------------------------------------------------------------------
def _mamba_decode_layer(params, cache, i: int, x, cfg: ModelConfig):
    """Mamba2 layer ``i`` on one token; its state and conv tails in
    ``cache["layers"]`` are replaced in place."""
    lp = _layer(params["layers"], i)
    cl = _layer(cache["layers"], i)
    m, new_c = S.mamba_decode(lp["mamba"], L.apply_norm(lp["norm"], x, cfg),
                              cfg, cl)
    _copy_into(cl, new_c)
    return x + m


def decode_step(params, cache, batch, cfg: ModelConfig, *,
                n_kv: Optional[int] = None, global_pages: bool = False,
                impl: Optional[str] = None):
    """One token for every sequence in the batch against the cache.

    ``batch``: {"tokens": (B, 1) int32, "lengths": (B,) int32,
                "block_table": (B, MB) int32 page ids (paged layouts)}
    ``n_kv`` bounds the paged KV sweep.  ``global_pages``: block-table
    entries are slot-flattened global page ids (the serving engine's
    mode); by default they are page ids inside each row's own pool, as in
    the JAX package.  Returns (logits (B, V), cache), the pools updated
    in place.

    Rolling layout (MoE or dense with a sliding window): no block table;
    each layer writes the token's K/V into its ring (or contiguous cache)
    and attends over it with the decode kernel, then runs its MLP or MoE.

    SSM layout: ``batch`` needs only "tokens"; each layer's state and
    conv tails are replaced in place by the step's new f32 values.

    Hybrid: the Mamba2 layers as in the SSM layout; after each group of
    ``attn_period`` layers the shared block attends over its
    application's paged pool (``cache["attn"]``, the paged kernel) as the
    dense layers do over theirs.

    Encoder-decoder: each decoder layer writes the token's K/V into its
    paged self-attention pool and attends over it (the paged kernel),
    then cross-attends over the fixed cross cache of the encoder output,
    masked by ``cache["enc_len"]`` (the decode kernel).
    """
    layout = cache_layout(cfg)
    x = L.embed_tokens(params["embed"], batch["tokens"], cfg)
    if layout == "ssm":
        for i in range(cfg.num_layers):
            x = _mamba_decode_layer(params, cache, i, x, cfg)
        x = L.apply_norm(params["final_norm"], x, cfg)
        return L.unembed(params["embed"], x[:, 0], cfg), cache
    lengths = batch["lengths"]
    block_table = batch.get("block_table")
    paged = dict(block_table=block_table, n_kv=n_kv,
                 global_pages=global_pages, impl=impl)
    if layout == "hybrid":
        shared = params["shared_attn"]
        for i in range(cfg.num_layers):
            x = _mamba_decode_layer(params, cache, i, x, cfg)
            if (i + 1) % cfg.attn_period == 0:  # the end of a group
                pools = _layer(cache["attn"], (i + 1) // cfg.attn_period - 1)
                a_in = L.apply_norm(shared["norm1"], x, cfg)
                a, _ = L.attention_decode(shared["attn"], a_in, cfg, pools,
                                          lengths, **paged)
                x = _shared_mlp(shared, x + a, cfg)
    elif cfg.is_encdec:
        for i in range(cfg.num_layers):
            lp = _layer(params["dec_layers"], i)
            a_in = L.apply_norm(lp["norm1"], x, cfg)
            a, _ = L.attention_decode(lp["self_attn"], a_in, cfg,
                                      _layer(cache["self"], i), lengths,
                                      **paged)
            x = x + a
            x_in = L.apply_norm(lp["norm_x"], x, cfg)
            xa, _ = L.attention_decode(
                lp["cross_attn"], x_in, cfg,
                {"k": cache["cross_k"][i], "v": cache["cross_v"][i],
                 "len": cache["enc_len"]}, lengths, cross=True, impl=impl)
            x = x + xa
            m_in = L.apply_norm(lp["norm2"], x, cfg)
            x = x + L.apply_mlp(lp["mlp"], m_in, cfg)
    else:
        for i in range(cfg.num_layers):
            lp = _layer(params["layers"], i)
            cl = _layer(cache["layers"], i)
            a_in = L.apply_norm(lp["norm1"], x, cfg)
            a, _ = L.attention_decode(lp["attn"], a_in, cfg, cl, lengths,
                                      **paged)
            x = _mlp_or_moe(lp, x + a, cfg)
    x = L.apply_norm(params["final_norm"], x, cfg)
    return L.unembed(params["embed"], x[:, 0], cfg), cache
