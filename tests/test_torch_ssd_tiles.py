"""The bf16 SSD kernel's arithmetic, held against the JAX package on the
CPU.

The bf16 route of ``csrc/ssd_scan.cu`` runs its four products on the
tensor cores with bf16 operands and f32 accumulators, so it rounds where
the plain scan does not: the decayed weights W (i, j) = S e^{cum_i -
cum_j} dt_j and the copy of the state that the inter term reads are
rounded to bf16 as operands, and xu_j = e^{cum_L - cum_j} dt_j x_j of the
state update goes in as two bf16 operands (its rounding and the
remainder's); the state itself stays f32 from chunk to chunk.  Its cumsum is a warp scan
(Hillis-Steele over 32 lanes) plus the four warp totals added in order,
in the log2 domain.  The kernel runs only on the card, so this file
emulates that arithmetic in plain PyTorch and holds it against
``ssd_chunk_scan_pallas`` in interpret mode and the port's plain scan.

Tolerance: y and the state within 2e-2 of each one's largest magnitude,
the bound the card tests hold the bf16 kernel to (a bf16 operand carries
8 bits; sums over up to 128 rows).  The state is also held to 1e-4 of
its largest magnitude against the plain scan, as chip_smoke.py holds
each full-width Mamba2 layer's state: the two-part xu operand is what
keeps it there."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ssd_chunk_scan_pallas
from repro_torch.kernels import ref as tref

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

REL_TOL = 2e-2
STATE_TOL = 1e-4
LOG2E = 1.4426950408889634
TILE = 128  # rows of the kernel's chunk tile
WARP = 32


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _kernel_cumsum(v):
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


def emulate_bf16_kernel(x, dt, a, b, c, d, chunk):
    """What the bf16 kernel computes, step by step in f32 with its bf16
    operand roundings.  x (B, S, H, P) and b, c (B, S, 1, N) hold bf16
    values; returns y rounded to bf16 (as f32) and the f32 state."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    state = torch.zeros((B, H, P, N))
    y = torch.empty_like(x)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool))
    for k in range(S // chunk):
        rows = slice(k * chunk, (k + 1) * chunk)
        xs, bs, cs = x[:, rows], b[:, rows, 0], c[:, rows, 0]
        dts = dt[:, rows].permute(0, 2, 1)              # (B, H, L)
        da = torch.zeros((B, H, TILE))
        da[..., :chunk] = dts * (a * LOG2E)[None, :, None]
        cum_all = _kernel_cumsum(da)
        cum, tot = cum_all[..., :chunk], cum_all[..., -1]
        s = torch.einsum("bin,bjn->bij", cs, bs)
        diff = cum[..., :, None] - cum[..., None, :]    # (B, H, L, L)
        w = torch.where(tri, s[:, None] * torch.exp2(diff) * dts[:, :, None],
                        torch.zeros(()))
        intra = torch.einsum("bhij,bjhp->bihp", _bf16(w), xs)
        inter = torch.einsum("bin,bhpn->bihp", cs, _bf16(state))
        inter = inter * torch.exp2(cum).permute(0, 2, 1)[..., None]
        y[:, rows] = inter + intra + d[None, None, :, None] * xs
        u = torch.exp2(tot[..., None] - cum) * dts      # (B, H, L)
        xu = xs * u.permute(0, 2, 1)[..., None]
        hi = _bf16(xu)
        xu = hi + _bf16(xu - hi)
        state = (state * torch.exp2(tot)[..., None, None]
                 + torch.einsum("bjhp,bjn->bhpn", xu, bs))
    return _bf16(y), state


def _case(seed, B, S, H, P, N, steep):
    """Scan operands as mamba_full makes them, x / B / C rounded to bf16;
    steep: dt ~ 3 and |a| ~ 7, so cum falls by ~20 a row and the decay
    above the diagonal overflows."""
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
    return x, dt, a, b, c, d


def _within(got, want, what, tol=REL_TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.isfinite(got).all(), f"{what}: not finite"
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: err {err} at scale {scale}"


# smoke shapes, chunk 64 / 127 / 128, steep decay, P 32 with N 16, and a
# head and state dim that only the bf16 kernel takes (P 48, N 96)
CASES = [
    (1, 128, 4, 32, 16, 64, False),
    (1, 254, 2, 48, 96, 127, False),
    (2, 256, 8, 64, 32, 128, False),
    (1, 256, 6, 32, 64, 64, False),
    (2, 254, 3, 64, 64, 127, False),
    (1, 127, 4, 64, 128, 127, False),
    (1, 256, 4, 64, 32, 128, True),
    (2, 128, 6, 32, 16, 128, False),
]


@pytest.mark.parametrize("B,S,H,P,N,chunk,steep", CASES)
def test_bf16_arithmetic_matches_pallas_and_plain(B, S, H, P, N, chunk,
                                                  steep):
    x, dt, a, b, c, d = _case(B * S + H + N, B, S, H, P, N, steep)
    tx, tdt, ta, tb, tc, td = (torch.from_numpy(v) for v in
                               (x, dt, a, b, c, d))
    emu_y, emu_s = emulate_bf16_kernel(tx, tdt, ta, tb, tc, td, chunk)
    pal_y, pal_s = ssd_chunk_scan_pallas(
        *(jnp.asarray(v) for v in (x, dt, a, b, c)), chunk=chunk,
        d_skip=jnp.asarray(d), interpret=True)
    plain_y, plain_s = tref.ssd_chunk_scan(tx, tdt, ta, tb, tc, chunk=chunk,
                                           d_skip=td)
    for name, want_y, want_s in (("pallas", pal_y, pal_s),
                                 ("plain", plain_y.numpy(),
                                  plain_s.numpy())):
        _within(emu_y.numpy(), want_y, f"y vs {name}")
        _within(emu_s.numpy(), want_s, f"state vs {name}")
    _within(emu_s.numpy(), plain_s.numpy(), "state vs plain", STATE_TOL)


def test_kernel_cumsum_is_a_cumsum():
    """The scan order changes rounding only: the kernel's cumsum agrees
    with torch.cumsum to f32 rounding, and exactly on integers."""
    rs = np.random.RandomState(3)
    v = torch.from_numpy(rs.standard_normal((5, TILE)).astype(np.float32))
    np.testing.assert_allclose(_kernel_cumsum(v).numpy(),
                               torch.cumsum(v, -1).numpy(), rtol=0,
                               atol=1e-5)
    ints = torch.from_numpy(rs.randint(-50, 50, (3, TILE)).astype(np.float32))
    assert torch.equal(_kernel_cumsum(ints), torch.cumsum(ints, -1))
