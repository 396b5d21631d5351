"""Transformer building blocks of the dense paged-KV serving path.

Plain functions over parameter dicts, as in the JAX package
(``repro/models/layers.py``), with the same tree layout.  This is the
dense subset the serving engine runs: RMS/LayerNorm, RoPE, the QKV
projection, paged decode attention over global page ids, chunked-prefill
attention, the SwiGLU MLP and the (tied) embedding.

Weights are used in the activation dtype; each function casts with
``.to(dt)``, which is free when the caller already cast the tree once
(``Model.compute_params``) — the numbers are the same either way.

KV writes update the pools IN PLACE (``index_put_`` / ``index_copy_``):
JAX's ``.at[].set`` on donated buffers becomes a write into the one
pool tensor, so a step never holds two copies of the cache.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels import ops
from .param import ParamSpec


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def apply_norm(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "layernorm":
        xf = xf - xf.mean(-1, keepdim=True)
    var = xf.square().mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + cfg.norm_eps) * p["scale"].float()
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D) with positions (..., S) — rotate pairs."""
    D = x.shape[-1]
    half = D // 2
    freqs = 1.0 / (theta ** (
        torch.arange(0, half, dtype=torch.float32, device=x.device) / half))
    angles = positions[..., None].float() * freqs  # (..., S, half)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------
def attention_specs(cfg: ModelConfig, layers: int) -> Dict[str, ParamSpec]:
    H = cfg.num_heads
    Hkv = cfg.num_kv_heads or H
    D = cfg.resolved_head_dim
    M = cfg.d_model
    lead = (layers,) if layers else ()
    la = ("layers",) if layers else ()
    specs = {
        "wq": ParamSpec(lead + (M, H, D), la + ("embed", "heads", None),
                        init="scaled"),
        "wk": ParamSpec(lead + (M, Hkv, D), la + ("embed", "kv_heads", None),
                        init="scaled"),
        "wv": ParamSpec(lead + (M, Hkv, D), la + ("embed", "kv_heads", None),
                        init="scaled"),
        "wo": ParamSpec(lead + (H, D, M), la + ("heads", None, "embed"),
                        init="scaled"),
    }
    if cfg.qkv_bias:
        specs["bq"] = ParamSpec(lead + (H, D), la + ("heads", None),
                                init="zeros")
        specs["bk"] = ParamSpec(lead + (Hkv, D), la + ("kv_heads", None),
                                init="zeros")
        specs["bv"] = ParamSpec(lead + (Hkv, D), la + ("kv_heads", None),
                                init="zeros")
    return specs


def _in_proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsm,mhd->bshd")`` as one matmul."""
    M, H, D = w.shape
    return torch.matmul(x, w.reshape(M, H * D)).unflatten(-1, (H, D))


def _out_proj(o: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("b...hd,hdm->b...m")`` as one matmul."""
    H, D, M = w.shape
    return torch.matmul(o.flatten(-2), w.reshape(H * D, M))


def _project_qkv(p, x: torch.Tensor, cfg: ModelConfig):
    dt = x.dtype
    q = _in_proj(x, p["wq"].to(dt))
    k = _in_proj(x, p["wk"].to(dt))
    v = _in_proj(x, p["wv"].to(dt))
    if "bq" in p:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    return q, k, v


def attention_decode(
    p,
    x: torch.Tensor,  # (B, 1, M) — one new token per sequence
    cfg: ModelConfig,
    cache: Dict[str, torch.Tensor],  # per-layer pools (no leading L dim)
    lengths: torch.Tensor,  # (B,) int32 tokens already in cache
    *,
    block_table: torch.Tensor,  # (B, max_blocks) int32 global page ids
    n_kv: Optional[int] = None,  # bound on the paged KV sweep
    impl: Optional[str] = None,
):
    """Single-token decode against the paged cache, global page ids.

    Table entries are ``slot * N_pool + page`` into the slot-flattened
    pool, so a row may name pages another slot owns.  The new token's K/V
    land at ``lengths`` (inactive slots' rows are all zero, so their
    writes fall on global page 0, slot 0's scratch page, which nothing
    reads), then the paged kernel attends over ``lengths + 1`` positions.
    Returns ``(out (B, 1, M), cache)``; the pools are updated in place.
    """
    B = x.shape[0]
    dt = x.dtype
    q, k_new, v_new = _project_qkv(p, x, cfg)
    pos = lengths[:, None]
    q1 = apply_rope(q, pos, cfg.rope_theta)[:, 0]  # (B, H, D)
    k1 = apply_rope(k_new, pos, cfg.rope_theta)[:, 0]  # (B, Hkv, D)
    v1 = v_new[:, 0]

    kp, vp = cache["k_pool"], cache["v_pool"]
    n_slots, n_pool, block, Hkv, D = kp.shape
    rows = torch.arange(B, device=x.device)
    page_g = block_table[rows, (lengths // block).long()].long()
    offs = (lengths % block).long()
    kp.view(n_slots * n_pool, block, Hkv, D).index_put_(
        (page_g, offs), k1.to(kp.dtype))
    vp.view(n_slots * n_pool, block, Hkv, D).index_put_(
        (page_g, offs), v1.to(vp.dtype))
    out = ops.paged_attention(q1, kp, vp, block_table, lengths + 1,
                              n_kv=n_kv, global_pages=True, impl=impl)
    out = _out_proj(out, p["wo"].to(dt))
    return out[:, None], cache


def attention_chunk(
    p,
    x: torch.Tensor,  # (1, C, M) — one prefill chunk for one slot
    cfg: ModelConfig,
    cache: Dict[str, torch.Tensor],  # per-layer pools (no leading L dim)
    *,
    row: torch.Tensor,        # (mb,) int32 block-table row incl. this chunk
    pages: torch.Tensor,      # (nc,) int32 global pages this chunk writes
    positions: torch.Tensor,  # (C,) int32 absolute token positions
    q_offset: int,            # positions[0], as the host knows it
    n_kv: int,                # bound on the prior-KV page sweep
    impl: Optional[str] = None,
):
    """Chunked-prefill attention against the paged cache, global ids.

    The chunk's K/V are written into its pages FIRST (in place), then
    the queries attend causally (``q_offset`` masking) over the first
    ``n_kv`` pages of the row, gathered into one contiguous K/V — which
    now hold every earlier chunk AND this one.  Padded and unallocated
    positions sit past the causal horizon and mask to exact zeros.
    """
    B, C, M = x.shape
    dt = x.dtype
    q, k, v = _project_qkv(p, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    kp, vp = cache["k_pool"], cache["v_pool"]
    n_slots, n_pool, block, Hkv, D = kp.shape
    nc = C // block
    kfl = kp.view(n_slots * n_pool, block, Hkv, D)
    vfl = vp.view(n_slots * n_pool, block, Hkv, D)
    idx = pages.long()
    kfl.index_copy_(0, idx, k[0].reshape(nc, block, Hkv, D).to(kfl.dtype))
    vfl.index_copy_(0, idx, v[0].reshape(nc, block, Hkv, D).to(vfl.dtype))
    sweep = row[:n_kv].long()
    gk = kfl[sweep].reshape(1, n_kv * block, Hkv, D)
    gv = vfl[sweep].reshape(1, n_kv * block, Hkv, D)
    out = ops.flash_attention(q, gk, gv, causal=True, q_offset=q_offset,
                              impl=impl)
    out = _out_proj(out, p["wo"].to(dt))
    return out, cache


# ---------------------------------------------------------------------------
# Dense MLP (SwiGLU)
# ---------------------------------------------------------------------------
def mlp_specs(cfg: ModelConfig, layers: int) -> Dict[str, ParamSpec]:
    M, Fd = cfg.d_model, cfg.d_ff
    lead = (layers,) if layers else ()
    la = ("layers",) if layers else ()
    return {
        "wi_gate": ParamSpec(lead + (M, Fd), la + ("embed", "mlp"),
                             init="scaled"),
        "wi_up": ParamSpec(lead + (M, Fd), la + ("embed", "mlp"),
                           init="scaled"),
        "wo": ParamSpec(lead + (Fd, M), la + ("mlp", "embed"),
                        init="scaled"),
    }


def apply_mlp(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dt = x.dtype
    g = torch.matmul(x, p["wi_gate"].to(dt))
    u = torch.matmul(x, p["wi_up"].to(dt))
    return torch.matmul(F.silu(g) * u, p["wo"].to(dt))


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------
def embed_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    specs = {
        "tok": ParamSpec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"))
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = ParamSpec(
            (cfg.d_model, cfg.vocab_size), ("embed", "vocab"), init="scaled"
        )
    return specs


def embed_tokens(p, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return p["tok"].to(getattr(torch, cfg.dtype))[tokens.long()]


def unembed(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dt = x.dtype
    if cfg.tie_embeddings:
        return torch.matmul(x, p["tok"].to(dt).t())
    return torch.matmul(x, p["unembed"].to(dt))
