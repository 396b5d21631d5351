"""The bf16 SSD backward kernel's arithmetic, held against the JAX package
on the CPU.

The bf16 route of ``csrc/ssd_scan_bwd.cu`` runs its products on the
tensor cores with bf16 operands and f32 accumulators, so it rounds where
the plain backward does not:

* each chunk's local state and state gradient take u_j x_j and
  e^{cum_i} dy_i as bf16 operands (u_j = e^{cum_L - cum_j} dt_j); the
  carry across chunks is f32; the states S and G enter the chunk
  products as bf16 copies, and the carried term e^{total} <G, S> is an
  f32 sum of G against S's bf16 copy;
* the column pass (rows j) forms dt_j CB_ij E_ij and dt_j E_ij Q_ij on
  f32 fragments and rounds them to bf16 as A operands (dx's and dB's
  intra products); the row pass (rows i) rounds E_ij dt_j Q_ij (dC's);
  sum_i W_ij, sum_j dt_j W_ij and the pairs' gaps for da come from the
  f32 fragments, W_ij = CB_ij E_ij Q_ij;
* cum = cumsum(dt a log2 e) and cumsum(dt) are warp scans (Hillis-Steele
  over 32 lanes) plus the four warp totals added in order; dda, the
  reverse cumsum of dcum, is the same scan mirrored;
* dB and dC sum each head group's heads in order in f32, then the
  groups in order; da and dd sum the chunks in order.

The kernel runs only on the card, so this file emulates that arithmetic
in plain PyTorch and holds it against ``jax.vjp`` of the JAX package's
``ref.ssd_chunk_scan`` and the port's ``ref.ssd_chunk_scan_bwd``: smoke
shapes, a ragged chunk (S 127), a head count that the head group does not
divide, steep decay (where ``jax.vjp`` of the chunked oracle is NaN, so
it is taken at chunk 1, the same function).  Tolerance
``SSD_BWD_TOL["bfloat16"]``: each gradient's largest error within 1e-2
of its largest magnitude, as the card tests hold the kernel (dx, dB and
dC are stored in bf16: half an ulp is 2**-9 of a value)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref as tref
from repro_torch.kernels.ssd_scan import plan_bwd_groups

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

SSD_BWD_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
LOG2E = 1.4426950408889634
TILE = 128  # rows of the kernel's chunk tile
WARP = 32
NAMES = ("dx", "ddt", "da", "db", "dc", "dd")


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _scan(v):
    """Inclusive cumsum over the last axis (TILE values) in the kernel's
    order: a shuffle scan within each warp of 32 lanes, then each warp
    adds the totals of the warps before it, summed in order from 0."""
    w = v.reshape(*v.shape[:-1], TILE // WARP, WARP)
    o = 1
    while o < WARP:
        shifted = torch.zeros_like(w)
        shifted[..., o:] = w[..., :-o]
        w = w + shifted
        o *= 2
    tot = w[..., -1]
    off = torch.zeros_like(tot)
    acc = torch.zeros_like(tot[..., 0])
    for k in range(TILE // WARP):
        off[..., k] = acc
        acc = acc + tot[..., k]
    return (w + off[..., None]).reshape(v.shape)


def _rscan(v):
    """The reverse inclusive cumsum in the kernel's order: the scan
    mirrored (shuffles down, the later warps' totals added from the last
    warp back)."""
    return _scan(v.flip(-1)).flip(-1)


def _pad(v):
    out = torch.zeros(*v.shape[:-1], TILE)
    out[..., :v.shape[-1]] = v
    return out


def emulate_bf16_bwd(x, dt, a, b, c, d, dy, ds, chunk, heads_per_group):
    """What the bf16 backward kernels compute, step by step in f32 with
    their bf16 operand roundings.  x, dy (B, S, H, P) and b, c (B, S, 1,
    N) hold bf16 values; dt (B, S, H), a, d (H,) and ds (B, H, P, N) or
    None are f32.  Returns (dx, ddt, da, db, dc, dd) as f32, dx, db and
    dc rounded to bf16."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    L, nc = chunk, S // chunk

    def heads(t):  # (B, S, H, ...) -> (B, nc, H, L, ...)
        t = t.reshape(B, nc, L, H, *t.shape[3:])
        return t.permute(0, 1, 3, 2, *range(4, t.dim()))

    xs, dys, dts = heads(x), heads(dy), heads(dt)
    bs, cs = b.reshape(B, nc, L, N), c.reshape(B, nc, L, N)

    # the row arrays: warp scans over the tile's 128 rows, dt 0 past L
    cum = _scan(_pad(dts) * (a * LOG2E)[None, None, :, None])
    tot = cum[..., -1]
    cum = cum[..., :L]
    cdt = _scan(_pad(dts))[..., :L]
    ecum = torch.exp2(cum)
    eto = torch.exp2(tot[..., None] - cum)
    u = eto * dts
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool))
    diff = cum[..., :, None] - cum[..., None, :]          # (.., i, j)
    E = torch.where(tri, torch.exp2(torch.where(tri, diff, 0.0)), 0.0)

    # each chunk's local state and state gradient, one bf16 operand each
    d_s = torch.einsum("bchjp,bcjn->bchpn", _bf16(xs * u[..., None]), bs)
    d_g = torch.einsum("bchip,bcin->bchpn", _bf16(dys * ecum[..., None]),
                       cs)
    # the carry, f32: S entering each chunk, G leaving it, and e^{total}
    # <G, S> against S's bf16 copy
    decay = torch.exp2(tot)
    s = torch.zeros((B, H, P, N))
    g = ds.clone() if ds is not None else torch.zeros((B, H, P, N))
    s_in, g_out = [None] * nc, [None] * nc
    for k in reversed(range(nc)):
        g_out[k] = g
        g = decay[:, k, :, None, None] * g + d_g[:, k]
    for k in range(nc):
        s_in[k] = s
        s = decay[:, k, :, None, None] * s + d_s[:, k]
    s_in, g_out = torch.stack(s_in, 1), torch.stack(g_out, 1)
    sb, gb = _bf16(s_in), _bf16(g_out)
    carried = decay * (g_out * sb).sum(dim=(-2, -1))

    cb = torch.einsum("bcin,bcjn->bcij", cs, bs)[:, :, None]
    q = torch.einsum("bchip,bchjp->bchij", dys, xs)
    w = cb * E * q
    dtj = dts[..., None, :]

    # the column pass: rows j
    xg = torch.einsum("bchjp,bchpn->bchjn", xs, gb)
    v = eto * (xg * bs[:, :, None]).sum(-1)
    a_dx = _bf16(cb * E * dtj)                            # (.., i, j)
    dx = (u[..., None] * torch.einsum("bcjn,bchpn->bchjp", bs, gb)
          + torch.einsum("bchij,bchip->bchjp", a_dx, dys))
    dx = _bf16(dx + d[None, None, :, None, None] * dys)
    colw = w.sum(-2)
    r = _bf16(E * dtj * q)                                # (.., i, j)
    db_h = u[..., None] * xg + torch.einsum("bchij,bcin->bchjn", r, cs)

    # the row pass: rows i
    dci = torch.einsum("bchip,bchpn->bchin", dys, sb)
    inter = ecum * (dci * cs[:, :, None]).sum(-1)
    dc_h = ecum[..., None] * dci + torch.einsum("bchij,bcjn->bchin", r, bs)
    roww = (w * dtj).sum(-1)
    pair = (w * dtj * (cdt[..., :, None] - cdt[..., None, :])).sum(-1)
    dd_c = torch.diagonal(q, dim1=-2, dim2=-1).sum(-1)

    # the rows of each (chunk, head): dcum, its reverse cumsum, ddt, da
    dcum = roww - dts * colw + inter - dts * v
    dcum[..., L - 1] += carried + (dts * v).sum(-1)
    dda = _rscan(_pad(dcum))[..., :L]
    ddt = colw + v + a[None, None, :, None] * dda
    last = cdt[..., -1:]
    da_c = (pair.sum(-1) + (cdt * inter).sum(-1) + last[..., 0] * carried
            + (dts * v * (last - cdt)).sum(-1))

    # dB and dC: each group's heads in order, then the groups in order
    db = torch.zeros((B, nc, L, N))
    dc = torch.zeros((B, nc, L, N))
    for h0 in range(0, H, heads_per_group):
        pb = torch.zeros((B, nc, L, N))
        pc = torch.zeros((B, nc, L, N))
        for h in range(h0, min(H, h0 + heads_per_group)):
            pb = pb + db_h[:, :, h]
            pc = pc + dc_h[:, :, h]
        db, dc = db + pb, dc + pc
    da = torch.zeros(H)
    dd = torch.zeros(H)
    for bi in range(B):
        for k in range(nc):
            da = da + da_c[bi, k]
            dd = dd + dd_c[bi, k]

    def tokens(t):  # (B, nc, H, L, ...) -> (B, S, H, ...)
        t = t.permute(0, 1, 3, 2, *range(4, t.dim()))
        return t.reshape(B, S, H, *t.shape[4:])

    return (tokens(dx), tokens(ddt), da, _bf16(db).reshape(B, S, 1, N),
            _bf16(dc).reshape(B, S, 1, N), dd)


def _inputs(seed, B, S, H, P, N, steep):
    """Scan operands as ``mamba_full`` makes them, x / B / C and dy
    rounded to bf16; steep: dt ~ 3 and |a| ~ 7, so cum falls by ~20 a row
    and the decay above the diagonal overflows."""
    rs = np.random.RandomState(seed)
    f = np.float32
    shift, a_shift = (3.0, 2.0) if steep else (-1.0, 0.0)

    def bf(v):
        return _bf16(torch.from_numpy(v.astype(f))).numpy()

    x = bf(rs.standard_normal((B, S, H, P)) * 0.3)
    dt = np.logaddexp(rs.standard_normal((B, S, H)) + shift, 0.0).astype(f)
    a = (-np.exp(rs.standard_normal(H) * 0.3 + a_shift)).astype(f)
    b = bf(rs.standard_normal((B, S, 1, N)) * 0.3)
    c = bf(rs.standard_normal((B, S, 1, N)) * 0.3)
    d = rs.standard_normal(H).astype(f)
    dy = bf(rs.standard_normal((B, S, H, P)))
    ds = rs.standard_normal((B, H, P, N)).astype(f)
    return x, dt, a, b, c, d, dy, ds


@functools.partial(jax.jit, static_argnames=("chunk",))
def _jax_vjp(x, dt, a, b, c, d, dy, ds, *, chunk):
    def f(x, dt, a, b, c, d):
        return jref.ssd_chunk_scan(x, dt, a, b, c, chunk=chunk, d_skip=d)

    _, vjp = jax.vjp(f, x, dt, a, b, c, d)
    return vjp((dy, ds))


def _within(got, want, what, tol=SSD_BWD_TOL["bfloat16"]):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), f"{what}: not finite"
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: err {err} at scale {scale}"


#: (B, S, H, P, N, chunk, steep, heads a group or None for the planner's,
#: the chunk of the jax.vjp): the smoke form (P 32, N 16), mamba2's widths,
#: a ragged chunk (S 127, zamba2's N 64), 13 heads in groups of 4 (the last
#: takes 1), steep decay.  Where e^{cum_i - cum_j} above the diagonal
#: passes e^88 in a chunk of 128 (some of the 13 heads, and steep decay)
#: the chunked oracle's vjp is NaN; at chunk 1 it is the same function and
#: never overflows, but its f32 da cancels there, so da is held to the
#: plain backward's pairwise sum only
CASES = [
    (1, 128, 4, 32, 16, 64, False, None, 64),
    (2, 256, 6, 64, 128, 128, False, None, 128),
    (1, 127, 5, 64, 64, 127, False, 2, 127),
    (2, 256, 13, 64, 32, 128, False, 4, 1),
    (1, 128, 3, 32, 16, 64, True, None, 1),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(
    str(int(v)) for v in c[:7]))
def test_bf16_backward_arithmetic_matches_jax_and_plain(case):
    B, S, H, P, N, chunk, steep, hpg, jchunk = case
    ins = _inputs(B * S + H + N, B, S, H, P, N, steep)
    t = [torch.from_numpy(v) for v in ins]
    hpg = hpg or plan_bwd_groups(B, S, H, chunk).heads_per_group
    got = emulate_bf16_bwd(*t, chunk, hpg)
    plain = tref.ssd_chunk_scan_bwd(*t[:5], t[6], chunk=chunk, d_skip=t[5],
                                    dstate=t[7])
    jax_g = [np.asarray(g) for g in _jax_vjp(
        *map(jnp.asarray, ins), chunk=jchunk)]
    for name, g, p, j in zip(NAMES, got, plain, jax_g):
        _within(g.numpy(), p.float().numpy(), f"{name} vs plain")
        if not (jchunk == 1 and name == "da"):
            _within(g.numpy(), j, f"{name} vs jax.vjp")


def test_kernel_scans_are_cumsums():
    """The scan orders change rounding only: the forward and reverse
    scans agree with torch's cumsums to f32 rounding, and exactly on
    integers."""
    rs = np.random.RandomState(3)
    v = torch.from_numpy(rs.standard_normal((5, TILE)).astype(np.float32))
    rev = torch.flip(torch.cumsum(torch.flip(v, (-1,)), -1), (-1,))
    np.testing.assert_allclose(_scan(v).numpy(), torch.cumsum(v, -1).numpy(),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(_rscan(v).numpy(), rev.numpy(), rtol=0,
                               atol=1e-5)
    ints = torch.from_numpy(rs.randint(-50, 50, (3, TILE)).astype(np.float32))
    assert torch.equal(_scan(ints), torch.cumsum(ints, -1))
    assert torch.equal(_rscan(ints), torch.flip(torch.cumsum(
        torch.flip(ints, (-1,)), -1), (-1,)))


#: (B, S, H, chunk): both train shapes, the planted-fault shape, a
#: remainder group (H 13), one group over long sequences, one chunk
PLAN_SHAPES = [(2, 4096, 80, 128), (2, 4096, 112, 128), (2, 1024, 80, 128),
               (2, 4096, 13, 128), (2, 12288, 6, 128), (1, 127, 5, 127),
               (1, 96, 6, 96), (8, 1024, 80, 128)]


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=lambda s: "x".join(
    map(str, s)))
def test_head_groups_cover_every_head_once(shape):
    """The kernels' grid is (groups, chunks, sequences) and group g takes
    heads g * heads_per_group up to H: every (chunk, sequence, head) once,
    and the plan a function of the shapes alone."""
    B, S, H, chunk = shape
    plan = plan_bwd_groups(B, S, H, chunk)
    assert plan == plan_bwd_groups(B, S, H, chunk)
    nc = S // chunk
    assert plan.blocks == plan.groups * nc * B
    seen = np.zeros((B, nc, H), dtype=np.int64)
    for g in range(plan.groups):
        hs = range(g * plan.heads_per_group,
                   min(H, (g + 1) * plan.heads_per_group))
        assert len(hs) > 0
        for bi in range(B):
            for k in range(nc):
                seen[bi, k, list(hs)] += 1
    assert (seen == 1).all()


def test_head_groups_at_the_train_shapes():
    """mamba2's and zamba2's train shapes (2 x 4096, chunks of 128): 4
    groups of 20 and of 28 heads, 256 blocks, about two an SM."""
    assert plan_bwd_groups(2, 4096, 80, 128) == (20, 4, 256)
    assert plan_bwd_groups(2, 4096, 112, 128) == (28, 4, 256)
    assert plan_bwd_groups(2, 4096, 13, 128) == (4, 4, 256)
    assert plan_bwd_groups(2, 12288, 6, 128).groups == 1
