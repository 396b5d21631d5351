"""Plain PyTorch versions of the kernels on the ported paths.

Each function computes what its CUDA kernel computes, with tensor ops
only.  The CPU tests run them (there is no card there), ``ops`` routes
CPU tensors to them, and ``chip_smoke.py`` holds each kernel against
them on the card.  They follow the JAX package's oracles
(``repro/kernels/ref.py``) step for step: the same ``NEG_INF`` fill for
masked scores, the same ``max(l, 1e-30)`` clamp, and the same cast of
the softmax weights to the value dtype before the PV product, so fully
masked rows and tiles behave identically.

  * ``flash_attention``   — chunked online-softmax causal attention with
                            a query offset and GQA (O(S * chunk) memory),
                            optionally with its rows' statistics
  * ``flash_attention_bwd`` — its gradients from those statistics, the
                            formula the backward kernel implements
  * ``decode_attention``  — one query token against a contiguous cache
                            with per-sequence lengths
  * ``paged_attention``   — decode attention over a paged KV pool and
                            block tables (gathers the pages first)
  * ``ssd_chunk_scan``    — the Mamba2 SSD chunked scan (dual form
                            within a chunk, state recurrence across)
  * ``ssd_chunk_scan_bwd`` — its gradients, the formula the SSD backward
                            kernel implements
  * ``ssd_decode_step``   — the single-token SSD recurrence
  * ``block_gather``      — whole pages out of a pool by index
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e30
LOG2E = 1.4426950408889634


# ---------------------------------------------------------------------------
# Flash attention (prefill chunk)
# ---------------------------------------------------------------------------
def flash_attention(
    q: torch.Tensor,  # (B, S_q, H, D)
    k: torch.Tensor,  # (B, S_kv, Hkv, D)
    v: torch.Tensor,  # (B, S_kv, Hkv, D)
    *,
    causal: bool = True,
    window: int = 0,  # 0 = full; >0 = sliding window (causal only)
    q_offset: int = 0,  # absolute position of q[0] relative to kv[0]
    chunk: int = 2048,
    with_stats: bool = False,
):
    """Online-softmax attention over KV chunks (the flash recurrence).

    Scores and the accumulator are f32; operands are widened from their
    storage dtype, which is exact, so each product equals the bf16 x bf16
    -> f32 product of the tensor cores.  GQA: H must be a multiple of
    Hkv.  Returns (B, S_q, H, D) in q.dtype.

    With ``with_stats`` it returns ``(out, stats)``: ``stats`` (B, S_q, H,
    2) f32 holds each row's ``(m, l)`` in the log2 domain of the kernels,
    so that the row's weights are ``2^(s2 - m) / l`` with ``s2`` the
    score times ``log2 e`` where the key is visible and ``NEG_INF``
    itself where it is not: ``m`` is the largest ``s2`` (``NEG_INF`` in a
    row that sees no key) and ``l`` the sum of the weights before the
    division.
    """
    B, S_q, H, D = q.shape
    S_kv, Hkv = k.shape[1], k.shape[2]
    if H % Hkv:
        raise ValueError(f"{H} query heads do not group over {Hkv} kv heads")
    G = H // Hkv
    chunk = max(min(chunk, S_kv), 1)
    scale = 1.0 / math.sqrt(D)
    dev = q.device

    qg = q.permute(0, 2, 1, 3).reshape(B, Hkv, G, S_q, D).float()
    kT = k.permute(0, 2, 1, 3)  # (B, Hkv, S_kv, D)
    vT = v.permute(0, 2, 1, 3)
    q_pos = q_offset + torch.arange(S_q, device=dev)

    acc = torch.zeros((B, Hkv, G, S_q, D), dtype=torch.float32, device=dev)
    m = torch.full((B, Hkv, G, S_q), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((B, Hkv, G, S_q), dtype=torch.float32, device=dev)
    for j0 in range(0, S_kv, chunk):
        kj = kT[:, :, j0:j0 + chunk]
        vj = vT[:, :, j0:j0 + chunk]
        kv_pos = j0 + torch.arange(kj.shape[2], device=dev)
        s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kj.float()) * scale
        mask = torch.ones((S_q, kj.shape[2]), dtype=torch.bool, device=dev)
        if causal:
            mask = mask & (kv_pos[None, :] <= q_pos[:, None])
        if window:
            mask = mask & (kv_pos[None, :] > q_pos[:, None] - window)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhgqk,bhkd->bhgqd", p.to(v.dtype).float(), vj.float())
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    out = out.reshape(B, H, S_q, D).permute(0, 2, 1, 3).to(q.dtype)
    if not with_stats:
        return out
    m2 = torch.where(m == NEG_INF, m, m * LOG2E)
    stats = torch.stack((m2, l), dim=-1).reshape(B, H, S_q, 2)
    return out, stats.permute(0, 2, 1, 3).contiguous()


def flash_attention_bwd(
    q: torch.Tensor,      # (B, S_q, H, D)
    k: torch.Tensor,      # (B, S_kv, Hkv, D)
    v: torch.Tensor,      # (B, S_kv, Hkv, D)
    out: torch.Tensor,    # (B, S_q, H, D): the forward's output
    dout: torch.Tensor,   # (B, S_q, H, D)
    stats: torch.Tensor,  # (B, S_q, H, 2): the forward's (m, l)
    *,
    causal: bool = True,
    window: int = 0,
    chunk: int = 1024,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``flash_attention`` at ``q_offset`` 0 from the
    forward's statistics: the formula the backward kernel implements, in
    f32, ``chunk`` query rows at a time.  With ``P = 2^(s2 - m) / l``
    (``s2`` as in ``flash_attention``'s statistics, so that a masked key
    weighs 0, or ``1 / l`` in a row that sees no key) and ``D_i =
    rowsum(dout_i * out_i)``:

        dV = sum_i P_i^T dout_i,   dP = dout V^T,
        dS = P (dP - D_i) where the key is visible, else 0,
        dQ = scale dS K,           dK = scale sum_i dS_i^T q_i,

    dK and dV summed over each kv head's query heads.  Each gradient in
    its input's dtype."""
    B, S_q, H, D = q.shape
    S_kv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = 1.0 / math.sqrt(D)
    dev = q.device

    def heads(x):  # (B, S, H, D) -> (B, Hkv, G, S, D) f32
        return x.float().permute(0, 2, 1, 3).reshape(B, Hkv, G, S_q, D)

    kf = k.float().permute(0, 2, 1, 3)  # (B, Hkv, S_kv, D)
    vf = v.float().permute(0, 2, 1, 3)
    st = stats.float().permute(0, 2, 1, 3).reshape(B, Hkv, G, S_q, 2)
    qf, of, gf = heads(q), heads(out), heads(dout)
    kv_pos = torch.arange(S_kv, device=dev)
    dq = torch.zeros_like(qf)
    dk = torch.zeros((B, Hkv, S_kv, D), dtype=torch.float32, device=dev)
    dv = torch.zeros_like(dk)
    for i0 in range(0, S_q, chunk):
        sl = slice(i0, i0 + chunk)
        q_pos = torch.arange(i0, min(i0 + chunk, S_q), device=dev)
        mask = torch.ones((len(q_pos), S_kv), dtype=torch.bool, device=dev)
        if causal:
            mask = mask & (kv_pos[None, :] <= q_pos[:, None])
        if window:
            mask = mask & (kv_pos[None, :] > q_pos[:, None] - window)
        s2 = torch.einsum("bhgqd,bhkd->bhgqk", qf[..., sl, :], kf) * (
            scale * LOG2E)
        s2 = torch.where(mask, s2, torch.full_like(s2, NEG_INF))
        m, l = st[..., sl, 0], st[..., sl, 1]
        p = torch.exp2(s2 - m[..., None]) / l[..., None]
        d_i = (gf[..., sl, :] * of[..., sl, :]).sum(-1)
        dp = torch.einsum("bhgqd,bhkd->bhgqk", gf[..., sl, :], vf)
        ds = torch.where(mask, p * (dp - d_i[..., None]),
                         torch.zeros_like(p))
        dv += torch.einsum("bhgqk,bhgqd->bhkd", p, gf[..., sl, :])
        dk += torch.einsum("bhgqk,bhgqd->bhkd", ds, qf[..., sl, :]) * scale
        dq[..., sl, :] = torch.einsum("bhgqk,bhkd->bhgqd", ds, kf) * scale
    dq = dq.reshape(B, H, S_q, D).permute(0, 2, 1, 3)
    return (dq.to(q.dtype), dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


# ---------------------------------------------------------------------------
# Decode attention (contiguous cache)
# ---------------------------------------------------------------------------
def decode_attention(
    q: torch.Tensor,        # (B, H, D) — one new token per sequence
    k_cache: torch.Tensor,  # (B, S_max, Hkv, D)
    v_cache: torch.Tensor,  # (B, S_max, Hkv, D)
    lengths: torch.Tensor,  # (B,) int32 — valid cache prefix per sequence
) -> torch.Tensor:
    B, H, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, Hkv, G, D).float()
    kT = k_cache.permute(0, 2, 1, 3)  # (B, Hkv, S, D) storage dtype
    vT = v_cache.permute(0, 2, 1, 3)
    s = torch.einsum("bhgd,bhsd->bhgs", qg, kT.float()) * scale
    mask = (torch.arange(S, device=q.device)[None, :]
            < lengths.to(q.device)[:, None])  # (B, S)
    s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bhsd->bhgd", p.to(vT.dtype).float(),
                       vT.float())
    return out.reshape(B, H, D).to(q.dtype)


# ---------------------------------------------------------------------------
# Paged decode attention (block tables)
# ---------------------------------------------------------------------------
def paged_attention(
    q: torch.Tensor,            # (B, H, D)
    k_pool: torch.Tensor,       # (B, N_pool, block, Hkv, D) per-slot pools
    v_pool: torch.Tensor,       # (B, N_pool, block, Hkv, D)
    block_table: torch.Tensor,  # (B, max_blocks) int32
    lengths: torch.Tensor,      # (B,) int32
    *,
    n_kv: Optional[int] = None,
    global_pages: bool = False,
) -> torch.Tensor:
    """Gather the pages each row names, then run decode attention.

    ``global_pages`` flattens the slot axis away: table entries are then
    GLOBAL ids ``slot * N_pool + page`` and a row may name pages that
    another slot owns.  Otherwise entries are page ids within the row's
    own slot.  ``n_kv`` bounds the sweep to the first ``n_kv`` table
    columns; positions at or past a row's length are masked either way.
    """
    if n_kv is not None and n_kv < block_table.shape[1]:
        block_table = block_table[:, :n_kv]
    B, H, D = q.shape
    n_pool, block, Hkv = k_pool.shape[1], k_pool.shape[2], k_pool.shape[3]
    max_blocks = block_table.shape[1]
    idx = block_table.long()
    if global_pages:
        kfl = k_pool.reshape(-1, block, Hkv, D)
        vfl = v_pool.reshape(-1, block, Hkv, D)
        k = kfl[idx]  # (B, MB, block, Hkv, D)
        v = vfl[idx]
    else:
        rows = torch.arange(B, device=q.device)[:, None]
        k = k_pool[rows, idx]
        v = v_pool[rows, idx]
    k = k.reshape(B, max_blocks * block, Hkv, D)
    v = v.reshape(B, max_blocks * block, Hkv, D)
    return decode_attention(q, k, v, lengths)


# ---------------------------------------------------------------------------
# Mamba2 SSD chunked scan
# ---------------------------------------------------------------------------
def ssd_chunk_scan(
    x: torch.Tensor,    # (B, S, H, P)
    dt: torch.Tensor,   # (B, S, H)   — positive step sizes (post-softplus)
    a: torch.Tensor,    # (H,)        — negative state decay rates
    b: torch.Tensor,    # (B, S, G, N)
    c: torch.Tensor,    # (B, S, G, N)
    *,
    chunk: int = 128,
    d_skip: Optional[torch.Tensor] = None,  # (H,) skip connection
    init_state: Optional[torch.Tensor] = None,  # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """State-space duality (Dao & Gu 2024), chunked form.

    Returns (y: (B,S,H,P) in x's dtype, final_state: (B,H,P,N) f32).
    Heads are grouped over b/c (G groups; H % G == 0).  All arithmetic is
    f32.  The intra-chunk decay is ``where(tri, exp(diff), 0)``: above the
    diagonal ``diff > 0`` can overflow, and ``inf * 0`` would be NaN.  The
    exponent is selected too (``exp(where(tri, diff, 0))``), which gives
    the same values: autograd would otherwise multiply the select's zero
    gradient by the overflowed ``exp`` and make the gradients of dt and a
    NaN, as ``jax.vjp`` of the JAX package's oracle does.
    """
    Bb, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    if H % G:
        raise ValueError(f"{H} heads do not group over {G} B/C groups")
    hg = H // G
    if S % chunk:
        raise ValueError(f"seq {S} must be a multiple of chunk {chunk}")
    nc = S // chunk

    xf = x.float().reshape(Bb, nc, chunk, H, P)
    dtf = dt.float().reshape(Bb, nc, chunk, H)
    bf = b.float().reshape(Bb, nc, chunk, G, N)
    cf = c.float().reshape(Bb, nc, chunk, G, N)
    af = a.float()

    # broadcast groups to heads
    bh = torch.repeat_interleave(bf, hg, dim=3)  # (B,nc,L,H,N)
    ch = torch.repeat_interleave(cf, hg, dim=3)

    da = dtf * af[None, None, None, :]          # (B,nc,L,H)  (negative)
    cum = torch.cumsum(da, dim=2)               # within-chunk cumulative
    total = cum[:, :, -1, :]                    # (B,nc,H)

    # ---- intra-chunk (quadratic within the chunk) ----
    # decay[i,j] = exp(cum_i - cum_j) for j <= i
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,nc,L,L,H)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))[None, None, :, :, None]
    zero = torch.zeros((), device=x.device)
    decay = torch.where(tri, torch.exp(torch.where(tri, diff, zero)), zero)
    scores = torch.einsum("bclhn,bcshn->bclsh", ch, bh)   # C_i . B_j
    w = scores * decay * dtf[:, :, None, :, :]            # weight x_j by dt_j
    y_intra = torch.einsum("bclsh,bcshp->bclhp", w, xf)

    # ---- chunk states ----
    # state_c = sum_j exp(total - cum_j) * dt_j * B_j (x) x_j
    to_end = torch.exp(total[:, :, None, :] - cum)        # (B,nc,L,H)
    sw = to_end * dtf                                     # (B,nc,L,H)
    states = torch.einsum("bclhn,bclh,bclhp->bchpn", bh, sw, xf)

    # ---- inter-chunk recurrence over nc ----
    s_prev = (init_state.float() if init_state is not None
              else torch.zeros((Bb, H, P, N), dtype=torch.float32,
                               device=x.device))
    entering = []  # the state *entering* each chunk
    for ic in range(nc):
        entering.append(s_prev)
        s_prev = (s_prev * torch.exp(total[:, ic])[:, :, None, None]
                  + states[:, ic])
    final_state = s_prev
    entering = torch.stack(entering, dim=1)  # (B,nc,H,P,N)

    # ---- inter-chunk contribution ----
    from_start = torch.exp(cum)                           # (B,nc,L,H)
    y_inter = torch.einsum("bclhn,bclh,bchpn->bclhp", ch, from_start,
                           entering)

    y = y_intra + y_inter
    if d_skip is not None:
        y = y + d_skip.float()[None, None, None, :, None] * xf
    return y.reshape(Bb, S, H, P).to(x.dtype), final_state


def ssd_chunk_scan_bwd(
    x: torch.Tensor,    # (B, S, H, P)
    dt: torch.Tensor,   # (B, S, H)
    a: torch.Tensor,    # (H,)
    b: torch.Tensor,    # (B, S, 1, N)
    c: torch.Tensor,    # (B, S, 1, N)
    dy: torch.Tensor,   # (B, S, H, P): the gradient of y
    *,
    chunk: int = 128,
    d_skip: Optional[torch.Tensor] = None,
    dstate: Optional[torch.Tensor] = None,  # (B, H, P, N): of the final state
):
    """(dx, ddt, da, db, dc, dd) of ``ssd_chunk_scan`` (one B/C group, no
    initial state) for the cotangents ``dy`` and ``dstate`` (None: 0),
    each in its input's shape and dtype (dd None without ``d_skip``): the
    formula the backward kernel implements, in f32, not autograd.

    Per chunk, with cum = cumsum(dt a), E_ij = e^{cum_i - cum_j} (j <= i,
    a select: above the diagonal the exponent can overflow), CB_ij = C_i .
    B_j, Q_ij = dy_i . x_j, u_j = e^{total - cum_j} dt_j, S_c the state
    entering chunk c and G_c the gradient of the state leaving it (G of
    the last chunk is ``dstate``; G_{c-1} = e^{total_c} G_c + sum_i
    e^{cum_i} dy_i (x) C_i, walked from the last chunk back):

      dx_j  = dt_j sum_i CB_ij E_ij dy_i + u_j G_c B_j + d dy_j
      db_j  = sum_heads [dt_j sum_i E_ij Q_ij C_i + u_j G_c^T x_j]
      dc_i  = sum_heads [sum_j E_ij dt_j Q_ij B_j + e^{cum_i} S_c^T dy_i]
      ddt_j = sum_i W_ij + V_j + a dda_j,   W_ij = CB_ij E_ij Q_ij,
              V_j = e^{total - cum_j} x_j^T G_c B_j
      dcum_i = sum_j dt_j W_ij - dt_i sum_k W_ki + dy_i . y_inter_i
               - dt_i V_i  (+ e^{total} <G_c, S_c> + sum_j dt_j V_j at the
               chunk's last row, the gradient of ``total``)
      dda_k = sum_{i >= k} dcum_i,  da = sum dt dda,  dd = sum dy . x

    da is summed pairwise (the exponents' gaps cumsum(dt)_i - cumsum(dt)_j
    times each pair's term), where the row and column terms cancel.

    B and C are shared by the heads (G == 1), so db and dc sum over them;
    da and dd sum over batch and sequence."""
    Bb, S, H, P = x.shape
    N = b.shape[3]
    if b.shape[2] != 1:
        raise ValueError(f"the SSD backward takes one B/C group, got "
                         f"G={b.shape[2]}")
    chunk = min(int(chunk), S)
    if S % chunk:
        raise ValueError(f"seq {S} must be a multiple of chunk {chunk}")
    nc, L = S // chunk, chunk
    xf = x.float().reshape(Bb, nc, L, H, P)
    dyf = dy.float().reshape(Bb, nc, L, H, P)
    dtf = dt.float().reshape(Bb, nc, L, H)
    bf = b.float().reshape(Bb, nc, L, N)
    cf = c.float().reshape(Bb, nc, L, N)
    af = a.float()

    cum = torch.cumsum(dtf * af, dim=2)                   # (B,nc,L,H)
    total = cum[:, :, -1, :]                              # (B,nc,H)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,nc,i,j,H)
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    E = torch.where(tri[None, None, :, :, None], torch.exp(diff),
                    torch.zeros((), device=x.device))
    ecum = torch.exp(cum)
    to_end = torch.exp(total[:, :, None, :] - cum)
    u = to_end * dtf

    # the states entering each chunk, and the state gradients leaving it
    states = torch.einsum("bcjn,bcjh,bcjhp->bchpn", bf, u, xf)
    pulls = torch.einsum("bcih,bcihp,bcin->bchpn", ecum, dyf, cf)
    decay = torch.exp(total)[:, :, :, None, None]
    s = torch.zeros((Bb, H, P, N), dtype=torch.float32, device=x.device)
    g = (dstate.float() if dstate is not None
         else torch.zeros_like(s))
    entering, leaving = [], [None] * nc
    for ic in range(nc):
        entering.append(s)
        s = s * decay[:, ic] + states[:, ic]
    for ic in reversed(range(nc)):
        leaving[ic] = g
        g = g * decay[:, ic] + pulls[:, ic]
    S_in = torch.stack(entering, dim=1)                   # (B,nc,H,P,N)
    G_out = torch.stack(leaving, dim=1)

    # within the chunk
    CB = torch.einsum("bcin,bcjn->bcij", cf, bf)[..., None]
    Q = torch.einsum("bcihp,bcjhp->bcijh", dyf, xf)
    dtj = dtf[:, :, None, :, :]
    W = CB * E * Q
    R = E * dtj * Q
    dx = torch.einsum("bcijh,bcihp->bcjhp", CB * E * dtj, dyf)
    db = torch.einsum("bcijh,bcin->bcjn", R, cf)
    dc = torch.einsum("bcijh,bcjn->bcin", R, bf)
    ddt = W.sum(dim=2)
    dcum = (W * dtj).sum(dim=3) - dtf * ddt

    # the inter-chunk term and the state update
    dc_inter = torch.einsum("bcih,bcihp,bchpn->bcihn", ecum, dyf, S_in)
    dc = dc + dc_inter.sum(dim=3)
    inter = torch.einsum("bcihn,bcin->bcih", dc_inter, cf)
    dcum = dcum + inter
    xg = torch.einsum("bcjhp,bchpn->bcjhn", xf, G_out)
    V = to_end * torch.einsum("bcjhn,bcjn->bcjh", xg, bf)
    dx = dx + u[..., None] * torch.einsum("bcjn,bchpn->bcjhp", bf, G_out)
    db = db + torch.einsum("bcjh,bcjhn->bcjn", u, xg)
    ddt = ddt + V
    dcum = dcum - dtf * V
    carried = torch.exp(total) * (G_out * S_in).sum(dim=(-2, -1))
    dcum[:, :, -1, :] += carried + (dtf * V).sum(dim=2)

    dda = torch.flip(torch.cumsum(torch.flip(dcum, (2,)), dim=2), (2,))
    ddt = ddt + af * dda
    # da = sum_k dt_k dda_k = sum_i cdt_i dcum_i (cdt = cumsum(dt)),
    # summed pairwise: the row and column terms of W, and V against the
    # gradient of total, cancel to rounding in that sum
    cdt = torch.cumsum(dtf, dim=2)
    gap = cdt[:, :, :, None, :] - cdt[:, :, None, :, :]
    last = cdt[:, :, -1:, :]
    da = ((W * dtj * gap).sum(dim=(2, 3)) + (cdt * inter).sum(dim=2)
          + last[:, :, 0] * carried
          + (dtf * V * (last - cdt)).sum(dim=2)).sum(dim=(0, 1))
    dd = None
    if d_skip is not None:
        dx = dx + d_skip.float()[:, None] * dyf
        dd = (dyf * xf).sum(dim=(0, 1, 2, 4)).to(d_skip.dtype)
    return (dx.reshape(Bb, S, H, P).to(x.dtype),
            ddt.reshape(Bb, S, H).to(dt.dtype), da.to(a.dtype),
            db.reshape(Bb, S, 1, N).to(b.dtype),
            dc.reshape(Bb, S, 1, N).to(c.dtype), dd)


def ssd_decode_step(
    x: torch.Tensor,      # (B, H, P)
    dt: torch.Tensor,     # (B, H)
    a: torch.Tensor,      # (H,)
    b: torch.Tensor,      # (B, G, N)
    c: torch.Tensor,      # (B, G, N)
    state: torch.Tensor,  # (B, H, P, N)
    *,
    d_skip: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token SSD recurrence: s' = s*exp(dt*a) + dt * (B (x) x).
    Returns (y (B,H,P) in x's dtype, new state f32)."""
    Bb, H, P = x.shape
    G = b.shape[1]
    hg = H // G
    xf = x.float()
    dtf = dt.float()
    bh = torch.repeat_interleave(b.float(), hg, dim=1)  # (B,H,N)
    ch = torch.repeat_interleave(c.float(), hg, dim=1)
    decay = torch.exp(dtf * a.float()[None, :])  # (B,H)
    upd = dtf[:, :, None, None] * xf[:, :, :, None] * bh[:, :, None, :]
    state_new = state.float() * decay[:, :, None, None] + upd
    y = torch.einsum("bhpn,bhn->bhp", state_new, ch)
    if d_skip is not None:
        y = y + d_skip.float()[None, :, None] * xf
    return y.to(x.dtype), state_new


# ---------------------------------------------------------------------------
# Block gather (page copies)
# ---------------------------------------------------------------------------
def block_gather(
    pool: torch.Tensor,     # (N_pool, block, Hkv, D)
    indices: torch.Tensor,  # (M,) integer page ids
) -> torch.Tensor:
    """Gather M pages out of the pool: ``pool[indices]``."""
    return pool[indices.long()]
