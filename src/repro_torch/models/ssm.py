"""Mamba2 (state-space duality) blocks — used by mamba2-2.7b.

Mirrors the JAX package's ``repro/models/ssm.py`` line for line, with the
same tree layout.  Projections are kept per-component (z / x / B / C /
dt) instead of one fused in_proj, as there.

JAX promotes mixed dtypes silently (a bf16 input against an f32 conv
state computes in f32); ``torch.einsum`` and ``@`` refuse mixed dtypes,
so each mixed product here casts both sides to the type JAX promotes to
(:func:`_promote`).  In the decode step that is f32: the conv window,
the conv and output products, and the SSM update run in f32, and the
block's output is cast back to the activation dtype at the end, as the
JAX package does.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels import ops
from .param import ParamSpec


def mamba_specs(cfg: ModelConfig, layers: int) -> Dict[str, ParamSpec]:
    M = cfg.d_model
    DI = cfg.ssm_inner
    H = cfg.ssm_heads
    G, N = cfg.ssm_groups, cfg.ssm_state
    W = cfg.ssm_conv_width
    lead = (layers,) if layers else ()
    la = ("layers",) if layers else ()
    return {
        "wz": ParamSpec(lead + (M, DI), la + ("embed", "ssm_inner"),
                        init="scaled"),
        "wx": ParamSpec(lead + (M, DI), la + ("embed", "ssm_inner"),
                        init="scaled"),
        "wb": ParamSpec(lead + (M, G * N), la + ("embed", None),
                        init="scaled"),
        "wc": ParamSpec(lead + (M, G * N), la + ("embed", None),
                        init="scaled"),
        "wdt": ParamSpec(lead + (M, H), la + ("embed", None), init="scaled"),
        "dt_bias": ParamSpec(lead + (H,), la + (None,), init="zeros"),
        "a_log": ParamSpec(lead + (H,), la + (None,), init="zeros"),
        "d_skip": ParamSpec(lead + (H,), la + (None,), init="ones"),
        "conv_x": ParamSpec(lead + (W, DI), la + ("conv", "ssm_inner"),
                            init="scaled"),
        "conv_b": ParamSpec(lead + (W, G * N), la + ("conv", None),
                            init="scaled"),
        "conv_c": ParamSpec(lead + (W, G * N), la + ("conv", None),
                            init="scaled"),
        "norm": ParamSpec(lead + (DI,), la + ("ssm_inner",), init="ones"),
        "wo": ParamSpec(lead + (DI, M), la + ("ssm_inner", "embed"),
                        init="scaled"),
    }


def _promote(a: torch.Tensor, b: torch.Tensor):
    """Both operands in the dtype JAX would promote the pair to."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: x (B,S,C), w (W,C) -> (B,S,C)."""
    W = w.shape[0]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = torch.zeros_like(x)
    S = x.shape[1]
    for i in range(W):  # W is tiny (4); unrolled shifts, no conv primitive
        out = out + xp[:, i:i + S, :] * w[i][None, None, :]
    return out


def _conv_step(
    state: torch.Tensor, x_new: torch.Tensor, w: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token conv: state (B,W-1,C), x_new (B,C) -> (out, new_state)."""
    state, x_new = _promote(state, x_new)
    window = torch.cat([state, x_new[:, None, :]], dim=1)  # (B,W,C)
    window, w = _promote(window, w)
    out = torch.einsum("bwc,wc->bc", window, w)
    return out, window[:, 1:, :]


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                eps: float) -> torch.Tensor:
    yf = y.float() * F.silu(z.float())
    var = yf.square().mean(-1, keepdim=True)
    return (yf * torch.rsqrt(var + eps) * scale.float()).to(y.dtype)


def _tail(t: torch.Tensor, W: int) -> torch.Tensor:
    """The last ``W - 1`` positions of (B, S, C), zero-padded in front."""
    S = t.shape[1]
    if S >= W - 1:
        return t[:, S - (W - 1):, :]
    return F.pad(t, (0, 0, W - 1 - S, 0))


def mamba_full(
    p,
    xin: torch.Tensor,  # (B, S, M)
    cfg: ModelConfig,
    *,
    init_state: Optional[torch.Tensor] = None,
    impl: Optional[str] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence Mamba2 block.  Returns (out, cache_slice) where the
    cache slice carries the final SSM state + conv tails for decode.
    ``init_state`` (B, H, P, N) starts the scan from a state, as in the
    JAX package (the plain scan takes it; the kernel refuses it).
    ``impl="plain"`` runs the plain scan in place of the kernel
    (comparison only)."""
    B, S, M = xin.shape
    dt_ = xin.dtype
    H, P = cfg.ssm_heads, cfg.ssm_head_dim
    G, N = cfg.ssm_groups, cfg.ssm_state
    W = cfg.ssm_conv_width

    z = torch.matmul(xin, p["wz"].to(dt_))
    x = torch.matmul(xin, p["wx"].to(dt_))
    b = torch.matmul(xin, p["wb"].to(dt_))
    c = torch.matmul(xin, p["wc"].to(dt_))
    dt = torch.matmul(xin, p["wdt"].to(dt_))

    # the conv tails are the raw projections, before the conv
    x_tail, b_tail, c_tail = _tail(x, W), _tail(b, W), _tail(c, W)

    x = F.silu(_causal_conv(x, p["conv_x"].to(dt_)))
    b = F.silu(_causal_conv(b, p["conv_b"].to(dt_)))
    c = F.silu(_causal_conv(c, p["conv_c"].to(dt_)))

    dt = F.softplus(dt.float() + p["dt_bias"].float())
    a = -torch.exp(p["a_log"].float())  # (H,) negative

    y, final_state = ops.ssd_chunk_scan(
        x.reshape(B, S, H, P),
        dt,
        a,
        b.reshape(B, S, G, N),
        c.reshape(B, S, G, N),
        chunk=min(cfg.ssm_chunk, S),
        d_skip=p["d_skip"],
        init_state=init_state,
        impl=impl,
    )
    y = y.reshape(B, S, H * P)
    y = _gated_norm(y, z, p["norm"], cfg.norm_eps)
    out = torch.matmul(y, p["wo"].to(dt_))
    cache = {
        "state": final_state,  # (B, H, P, N) f32
        "conv_x": x_tail,
        "conv_b": b_tail,
        "conv_c": c_tail,
    }
    return out, cache


def mamba_decode(
    p,
    xin: torch.Tensor,  # (B, 1, M)
    cfg: ModelConfig,
    cache: Dict[str, torch.Tensor],
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token against the layer's SSM state and conv tails.  Returns
    (out (B, 1, M) in the activation dtype, new cache slice in f32)."""
    B = xin.shape[0]
    dt_ = xin.dtype
    H, P = cfg.ssm_heads, cfg.ssm_head_dim
    G, N = cfg.ssm_groups, cfg.ssm_state
    x1 = xin[:, 0]

    z = torch.matmul(x1, p["wz"].to(dt_))
    x = torch.matmul(x1, p["wx"].to(dt_))
    b = torch.matmul(x1, p["wb"].to(dt_))
    c = torch.matmul(x1, p["wc"].to(dt_))
    dt = torch.matmul(x1, p["wdt"].to(dt_))

    x_conv, conv_x = _conv_step(cache["conv_x"], x, p["conv_x"].to(dt_))
    b_conv, conv_b = _conv_step(cache["conv_b"], b, p["conv_b"].to(dt_))
    c_conv, conv_c = _conv_step(cache["conv_c"], c, p["conv_c"].to(dt_))
    x_conv = F.silu(x_conv)
    b_conv = F.silu(b_conv)
    c_conv = F.silu(c_conv)

    dt = F.softplus(dt.float() + p["dt_bias"].float())
    a = -torch.exp(p["a_log"].float())

    y, state = ops.ssd_decode_step(
        x_conv.reshape(B, H, P),
        dt,
        a,
        b_conv.reshape(B, G, N),
        c_conv.reshape(B, G, N),
        cache["state"],
        d_skip=p["d_skip"],
    )
    y = y.reshape(B, H * P)
    y = _gated_norm(y, z, p["norm"], cfg.norm_eps)
    out = torch.matmul(*_promote(y, p["wo"].to(dt_)))
    new_cache = {
        "state": state,
        "conv_x": conv_x.float(),
        "conv_b": conv_b.float(),
        "conv_c": conv_c.float(),
    }
    # cast back: the f32 conv-state path must not promote the residual
    return out[:, None].to(dt_), new_cache
