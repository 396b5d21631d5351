"""Transformer building blocks of the ported paths.

Plain functions over parameter dicts, as in the JAX package
(``repro/models/layers.py``), with the same tree layout: RMS/LayerNorm,
RoPE, the QKV projection, whole-sequence attention (the encoder, the
decoder's self-attention and cross-attention of the encoder-decoder
family, and the sliding window of mixtral), single-token decode
attention over the paged cache (global or per-slot page ids), over a
rolling (sliding-window ring) or contiguous cache and over the fixed
cross-attention cache, chunked-prefill attention, the SwiGLU MLP, the
top-k MoE and the embedding.

Weights are used in the activation dtype; each function casts with
``.to(dt)``, which is free when the caller already cast the tree once
(``Model.compute_params``) — the numbers are the same either way.

KV writes update the pools and caches IN PLACE (``index_put_`` /
``index_copy_``): JAX's ``.at[].set`` on donated buffers becomes a write
into the one cache tensor, so a step never holds two copies of it.
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


def attention_full(
    p,
    x: torch.Tensor,  # (B, S, M)
    cfg: ModelConfig,
    *,
    causal: bool = True,
    kv_x: Optional[torch.Tensor] = None,  # cross-attention source (B, S_kv, M)
    impl: Optional[str] = None,
):
    """Full-sequence attention: the encoder (``causal=False``), the
    decoder's causal self-attention, and cross-attention over ``kv_x``.
    RoPE at positions 0 .. S-1 is applied to q and k unless ``kv_x`` is
    given, as in the JAX package: cross-attention keys carry no
    positions.  A config with ``sliding_window > 0`` attends over the
    last ``sliding_window`` keys of each row (the flash kernel's window).

    Returns ``(out (B, S, M), (k, v))`` so a prefill can fill the cache.
    """
    S = x.shape[1]
    dt = x.dtype
    src = kv_x if kv_x is not None else x
    q = _in_proj(x, p["wq"].to(dt))
    k = _in_proj(src, p["wk"].to(dt))
    v = _in_proj(src, p["wv"].to(dt))
    if "bq" in p:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    if kv_x is None:
        pos = torch.arange(S, device=x.device)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    out = ops.flash_attention(q, k, v, causal=causal,
                              window=cfg.sliding_window, impl=impl)
    return _out_proj(out, p["wo"].to(dt)), (k, v)


def attention_decode(
    p,
    x: torch.Tensor,  # (B, 1, M) — one new token per sequence
    cfg: ModelConfig,
    cache: Dict[str, torch.Tensor],  # per-layer slice (no leading L dim)
    lengths: torch.Tensor,  # (B,) int32 tokens already in cache
    *,
    block_table: Optional[torch.Tensor] = None,  # (B, max_blocks) int32
    n_kv: Optional[int] = None,  # bound on the paged KV sweep
    global_pages: bool = False,  # table holds slot-flattened global ids
    cross: bool = False,
    impl: Optional[str] = None,
):
    """Single-token decode against the paged, rolling or contiguous cache,
    or cross-attention.

    Paged (``block_table`` given): the new token's K/V land at position
    ``lengths`` of each row, then the paged kernel attends over
    ``lengths + 1`` positions.  With ``global_pages`` table entries are
    ``slot * N_pool + page`` into the slot-flattened pool, so a row may
    name pages another slot owns (inactive slots' rows are all zero, so
    their writes fall on global page 0, slot 0's scratch page, which
    nothing reads); otherwise they are page ids inside the row's own pool
    (an inactive row writes its own scratch page 0).

    Rolling (no table, ``cache["k"]`` of ``cfg.sliding_window`` rows):
    a ring ``{"k", "v"}`` of shape (B, W, Hkv, D) in which position p
    lives in slot ``p % W``; the token's K/V overwrite slot ``lengths %
    W`` (the position that left the window) and the decode kernel attends
    over ``min(lengths + 1, W)`` slots.  Softmax does not care about the
    slots' order: the positions are in the keys' RoPE.  Contiguous (no
    table, fewer rows than the window, or no window): the token's K/V land
    at row ``lengths`` and the kernel attends over ``lengths + 1`` rows.

    Cross-attention (``cross=True``): the query, without RoPE, attends
    over the fixed cache ``{"k", "v", "len"}`` of the encoder output;
    nothing is written.

    Returns ``(out (B, 1, M), cache)``; the pools and caches are updated
    in place.
    """
    B = x.shape[0]
    dt = x.dtype
    if cross:
        q = _in_proj(x, p["wq"].to(dt))
        if "bq" in p:
            q = q + p["bq"].to(dt)
        out = ops.decode_attention(q[:, 0], cache["k"], cache["v"],
                                   cache["len"], impl=impl)
        return _out_proj(out, p["wo"].to(dt))[:, None], cache
    q, k_new, v_new = _project_qkv(p, x, cfg)
    pos = lengths[:, None]
    q1 = apply_rope(q, pos, cfg.rope_theta)[:, 0]  # (B, H, D)
    k1 = apply_rope(k_new, pos, cfg.rope_theta)[:, 0]  # (B, Hkv, D)
    v1 = v_new[:, 0]
    rows = torch.arange(B, device=x.device)

    if block_table is None:
        k_c, v_c = cache["k"], cache["v"]
        W = cfg.sliding_window
        if W and k_c.shape[1] == W:  # the ring
            slot = (lengths % W).long()
            valid = torch.clamp(lengths + 1, max=W)
            q1 = q_rolling(q1, cfg)
        else:  # contiguous
            slot = lengths.long()
            valid = lengths + 1
        k_c.index_put_((rows, slot), k1.to(k_c.dtype))
        v_c.index_put_((rows, slot), v1.to(v_c.dtype))
        out = ops.decode_attention(q1, k_c, v_c, valid, impl=impl)
        return _out_proj(out, p["wo"].to(dt))[:, None], cache

    kp, vp = cache["k_pool"], cache["v_pool"]
    n_slots, n_pool, block, Hkv, D = kp.shape
    page = block_table[rows, (lengths // block).long()].long()
    offs = (lengths % block).long()
    if global_pages:
        kp.view(n_slots * n_pool, block, Hkv, D).index_put_(
            (page, offs), k1.to(kp.dtype))
        vp.view(n_slots * n_pool, block, Hkv, D).index_put_(
            (page, offs), v1.to(vp.dtype))
    else:
        kp.index_put_((rows, page, offs), k1.to(kp.dtype))
        vp.index_put_((rows, page, offs), v1.to(vp.dtype))
    out = ops.paged_attention(q1, kp, vp, block_table, lengths + 1,
                              n_kv=n_kv, global_pages=global_pages,
                              impl=impl)
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
    slot: Optional[int] = None,  # the admitting slot (per-slot ids only)
    global_pages: bool = False,  # row/pages hold slot-flattened global ids
    impl: Optional[str] = None,
):
    """Chunked-prefill attention against the paged cache.

    The chunk's K/V are written into its pages FIRST (in place), then
    the queries attend causally (``q_offset`` masking) over the first
    ``n_kv`` pages of the row, gathered into one contiguous K/V — which
    now hold every earlier chunk AND this one.  Padded and unallocated
    positions sit past the causal horizon and mask to exact zeros.
    With ``global_pages`` ``row`` and ``pages`` hold global ids into the
    slot-flattened pool; otherwise page ids inside ``slot``'s own pool.
    """
    B, C, M = x.shape
    dt = x.dtype
    q, k, v = _project_qkv(p, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    kp, vp = cache["k_pool"], cache["v_pool"]
    n_slots, n_pool, block, Hkv, D = kp.shape
    nc = C // block
    if global_pages:
        kfl = kp.view(n_slots * n_pool, block, Hkv, D)
        vfl = vp.view(n_slots * n_pool, block, Hkv, D)
    else:
        kfl, vfl = kp[slot], vp[slot]
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


def q_rolling(q1: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Rolling caches lose absolute slot order; attention over a ring is
    order-invariant under softmax (positions already baked into k via
    RoPE), so q passes through unchanged."""
    return q1


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
# MoE (top-k, capacity-bounded per-row scatter dispatch)
# ---------------------------------------------------------------------------
def moe_specs(cfg: ModelConfig, layers: int) -> Dict[str, ParamSpec]:
    M, Fd, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    lead = (layers,) if layers else ()
    la = ("layers",) if layers else ()
    return {
        "router": ParamSpec(lead + (M, E), la + ("embed", None),
                            init="scaled"),
        "wi_gate": ParamSpec(lead + (E, M, Fd),
                             la + ("experts", "embed", "mlp"), init="scaled"),
        "wi_up": ParamSpec(lead + (E, M, Fd),
                           la + ("experts", "embed", "mlp"), init="scaled"),
        "wo": ParamSpec(lead + (E, Fd, M),
                        la + ("experts", "mlp", "embed"), init="scaled"),
    }


def moe_route(p, x: torch.Tensor, cfg: ModelConfig):
    """The router: ``(gate_w, ids)``, each (B, S, k), for the top
    ``experts_per_token`` experts of each token by the f32 softmax of its
    router logits; ``gate_w`` renormalised to sum 1 in f32.  The order
    is ``jax.lax.top_k``'s: descending, the lower expert index first on a
    tie (a stable descending sort; ``torch.topk`` promises no order, and
    bf16 logits tie often enough to matter at the k-th place)."""
    k = cfg.experts_per_token
    logits = torch.matmul(x, p["router"].to(x.dtype))
    probs = torch.softmax(logits.float(), dim=-1)
    gate_w, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_w, ids = gate_w[..., :k], ids[..., :k]
    return gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9), ids


def apply_moe(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Top-k MoE with a capacity-bounded dispatch per batch row, as the
    JAX package's ``apply_moe``: each row's (token, expert) pairs are
    sorted by expert (a stable sort, so tokens keep their order within an
    expert), each expert takes the first ``C = min(max(int(cf * S * k /
    E), k), S * k)`` of its pairs and the rest fall into an overflow slot
    ``C`` that is dropped.  The experts' SwiGLU runs as batched products
    of each expert over its slots; each pair's output, times its gate
    weight (cast to the compute dtype), is added back to its token
    (:func:`combine_pairs`)."""
    B, S, M = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    C = min(max(int(cfg.moe_capacity_factor * S * k / E), k), S * k)
    dt, dev = x.dtype, x.device
    gate_w, ids = moe_route(p, x, cfg)

    flat_ids = ids.reshape(B, S * k)
    order = torch.argsort(flat_ids, dim=-1, stable=True)
    sorted_ids = flat_ids.gather(-1, order)
    sorted_tok = torch.arange(S, device=dev).repeat_interleave(k)[order]
    sorted_w = gate_w.reshape(B, S * k).gather(-1, order)
    counts = torch.zeros((B, E), dtype=torch.long, device=dev)
    counts.scatter_add_(1, flat_ids, torch.ones_like(flat_ids))
    starts = torch.cumsum(counts, -1) - counts
    pos = (torch.arange(S * k, device=dev)[None]
           - starts.gather(-1, sorted_ids))
    valid = pos < C
    pos_c = torch.where(valid, pos, torch.full_like(pos, C))  # overflow slot

    # each expert's buffer holds C + 1 slots a batch row, the last the
    # overflow slot; the products run over all of them (one batched
    # product an expert, its weights read once) and the overflow slots'
    # outputs are zeroed, as the JAX package pads them with zeros
    b_ix = torch.arange(B, device=dev)[:, None]
    slot = b_ix * (C + 1) + pos_c  # (B, S * k)
    buf = torch.zeros((E, B * (C + 1), M), dtype=dt, device=dev)
    buf[sorted_ids, slot] = x[b_ix, sorted_tok]
    h = F.silu(torch.bmm(buf, p["wi_gate"].to(dt)))  # (E, B * (C+1), F)
    h.mul_(torch.bmm(buf, p["wi_up"].to(dt)))
    del buf
    y = torch.bmm(h, p["wo"].to(dt))  # (E, B * (C + 1), M)
    del h
    y.view(E, B, C + 1, M)[:, :, C] = 0
    contrib = y[sorted_ids, slot] * (
        sorted_w * valid.float()).to(dt)[..., None]
    del y
    return combine_pairs(contrib, ids, order)


def combine_pairs(contrib: torch.Tensor, ids: torch.Tensor,
                  order: torch.Tensor) -> torch.Tensor:
    """Each token's k pair outputs summed onto zero: ``contrib`` (B, S *
    k, M) holds the pairs in the expert-sorted ``order`` (B, S * k) of
    the router's ``ids`` (B, S, k).  The sum runs in ascending expert
    order, each add rounded to the compute dtype: the order the JAX
    package's scatter-add of the sorted pairs sums them in (on the CPU;
    bit for bit).  Each pair moves to (token, rank of its expert among
    the token's), one write a slot, so the sum is the same on every run
    (an atomic ``index_add_`` on the card sums in no fixed order: with
    k > 2 a bf16 token's sum would change from run to run).  With k = 2
    the sum is one rounding whatever the order."""
    B, S, k = ids.shape
    M, dev = contrib.shape[-1], contrib.device
    b_ix = torch.arange(B, device=dev)[:, None]
    rank = (ids[..., None, :] < ids[..., :, None]).sum(-1)  # (B, S, k)
    dest = (torch.arange(S, device=dev)[:, None] * k + rank).reshape(
        B, S * k).gather(-1, order)
    by_token = torch.empty((B, S * k, M), dtype=contrib.dtype, device=dev)
    by_token[b_ix, dest] = contrib
    by_token = by_token.view(B, S, k, M)
    out = torch.zeros((B, S, M), dtype=contrib.dtype, device=dev)
    for j in range(k):
        out = out + by_token[:, :, j]
    return out


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
    """The rows of the embedding table (``F.embedding``: its gradient on
    the card sums each row's contributions in a fixed order, where the
    backward of an indexing gather accumulates by atomics)."""
    w = p["tok"].to(getattr(torch, cfg.dtype))
    return F.embedding(tokens.to(w.device).long(), w)


def unembed(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dt = x.dtype
    if cfg.tie_embeddings:
        return torch.matmul(x, p["tok"].to(dt).t())
    return torch.matmul(x, p["unembed"].to(dt))
