"""The SSD scan's backward arithmetic, on the CPU.

``ref.ssd_chunk_scan_bwd`` is the formula the backward kernel
(``csrc/ssd_scan_bwd.cu``) implements: the states entering each chunk,
the state gradients carried back across chunks, and per chunk the
gradients of x, dt, B and C (B and C summed over the heads, which share
them), a and the skip weight d (summed over batch and sequence).  It is
held here against ``jax.vjp`` of the JAX package's ``ref.ssd_chunk_scan``
on the same numpy inputs, with cotangents on y and on the final state, in
f32: one chunk, several chunks, chunk == S, a head count that is not a
multiple of 8, with and without the skip weight and the state's
cotangent.  Tolerance: each gradient's largest error within 1e-5 of its
largest magnitude (f32 sums in another order).

At steep decay (dt ~ 3, |a| ~ 7: e^{cum_i - cum_j} above the diagonal
overflows) ``jax.vjp`` of the chunked oracle is NaN (the select's
gradient times inf), so the backward is held there against ``jax.vjp`` at
chunk 1, which is the same function and never overflows, and its da
against the complex step of a float64 token-by-token recurrence:
JAX's own f32 autograd loses ~1% of da there, where its row and column
terms cancel, and the plain backward sums da pairwise to avoid that.
It is held to 1e-4 there (``DA_STEEP_TOL``): f32 rounds what it sums.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref as tref

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

GRAD_TOL = 1e-5
#: da at steep decay against the exact complex step: f32 rounds the terms
#: it sums (measured 2e-5 to 4e-5 of its largest magnitude; JAX's f32
#: autograd at chunk 1 misses by ~1e-2 on the same inputs)
DA_STEEP_TOL = 1e-4
NAMES = ("dx", "ddt", "da", "db", "dc", "dd")


def _inputs(seed, B, S, H, P, N, decay="normal"):
    """Scan operands as ``mamba_full`` makes them (dt = softplus, a =
    -exp), the cotangents of y and of the final state.  ``decay``:
    "normal" (|dt a| ~ 0.3 a row), "mid" (~4 a row: e^{cum} spans ~e^-30
    over 8 rows) or "steep" (~20 a row, and up to ~100: overflows above
    the diagonal)."""
    rs = np.random.RandomState(seed)
    shift, a_shift = {"normal": (-1.0, 0.0), "mid": (1.0, 1.0),
                      "steep": (3.0, 2.0)}[decay]
    x = (rs.standard_normal((B, S, H, P)) * 0.3).astype(np.float32)
    dt = np.log1p(np.exp(rs.standard_normal((B, S, H)) + shift)).astype(
        np.float32)
    a = (-np.exp(rs.standard_normal(H) * 0.3 + a_shift)).astype(np.float32)
    b = (rs.standard_normal((B, S, 1, N)) * 0.3).astype(np.float32)
    c = (rs.standard_normal((B, S, 1, N)) * 0.3).astype(np.float32)
    d = rs.standard_normal(H).astype(np.float32)
    dy = rs.standard_normal((B, S, H, P)).astype(np.float32)
    ds = rs.standard_normal((B, H, P, N)).astype(np.float32)
    return x, dt, a, b, c, d, dy, ds


@functools.partial(jax.jit, static_argnames=("chunk", "skip"))
def _jax_vjp(x, dt, a, b, c, d, dy, ds, *, chunk, skip):
    def f(x, dt, a, b, c, d):
        return jref.ssd_chunk_scan(x, dt, a, b, c, chunk=chunk,
                                   d_skip=d if skip else None)

    _, vjp = jax.vjp(f, x, dt, a, b, c, d)
    return vjp((dy, ds))


def _jax_grads(x, dt, a, b, c, d, dy, ds, *, chunk, skip=True, state=True):
    ds = ds if state else np.zeros_like(ds)
    return [np.asarray(g) for g in _jax_vjp(
        *map(jnp.asarray, (x, dt, a, b, c, d, dy, ds)), chunk=chunk,
        skip=skip)]


def _plain_grads(x, dt, a, b, c, d, dy, ds, *, chunk, skip=True,
                 state=True):
    t = [torch.from_numpy(v) for v in (x, dt, a, b, c, dy)]
    return tref.ssd_chunk_scan_bwd(
        *t, chunk=chunk, d_skip=torch.from_numpy(d) if skip else None,
        dstate=torch.from_numpy(ds) if state else None)


def _hold(got, want, names=NAMES):
    for name, g, w in zip(NAMES, got, want):
        if name not in names:
            continue
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        assert g.shape == w.shape, (name, g.shape, w.shape)
        assert np.isfinite(g).all(), name
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err <= GRAD_TOL, (name, err)


#: (B, S, H, P, N, chunk, decay)
CASES = [
    (1, 32, 3, 8, 4, 32, "normal"),     # one chunk, chunk == S
    (2, 64, 5, 8, 6, 16, "normal"),     # four chunks, H 5
    (1, 48, 12, 4, 6, 48, "normal"),    # chunk == S, H 12
    (2, 96, 3, 16, 8, 32, "normal"),    # three chunks
    (2, 48, 5, 8, 4, 8, "mid"),         # decay ~e^-4 a row
]


#: (case, with the skip weight, with the final state's cotangent)
RUNS = ([(case, True, True) for case in CASES]
        + [(CASES[1], False, True), (CASES[1], True, False)])


@pytest.mark.parametrize("run", RUNS, ids=lambda r: "x".join(
    map(str, r[0])) + f"-skip{int(r[1])}-state{int(r[2])}")
def test_plain_backward_matches_jax_vjp(run):
    (B, S, H, P, N, chunk, decay), skip, state = run
    ins = _inputs(S + H, B, S, H, P, N, decay)
    want = _jax_grads(*ins, chunk=chunk, skip=skip, state=state)
    got = _plain_grads(*ins, chunk=chunk, skip=skip, state=state)
    assert (got[5] is None) == (not skip)
    _hold(got, want, NAMES if skip else NAMES[:5])
    dtypes = [g.dtype for g in got[:5]]
    assert dtypes == [torch.float32] * 5


def _recurrence_loss(x, dt, a, b, c, d, dy, ds):
    """sum(y * dy) + sum(final * ds) of the scan as a token-by-token
    recurrence in complex128 (for the complex step): s <- e^{dt a} s +
    dt x (x) B, y = s C + d x."""
    B, S, H, P = x.shape
    s = np.zeros((B, H, P, b.shape[3]), dtype=np.complex128)
    loss = 0.0
    for t in range(S):
        decay = np.exp(dt[:, t] * a[None, :])[:, :, None, None]
        s = s * decay + (dt[:, t, :, None, None] * x[:, t, :, :, None]
                         * b[:, t, 0][:, None, None, :])
        y = (np.einsum("bhpn,bn->bhp", s, c[:, t, 0])
             + d[None, :, None] * x[:, t])
        loss = loss + (y * dy[:, t]).sum()
    return loss + (s * ds).sum()


@pytest.mark.parametrize("chunk", [16, 64])
def test_plain_backward_at_steep_decay(chunk):
    """No NaN where the exponent overflows above the diagonal; dx, ddt,
    db, dc and dd against ``jax.vjp`` at chunk 1, da against the complex
    step of the float64 recurrence (Im f(a + ih) / h: no difference of
    two close values, so exact to rounding)."""
    B, S, H, P, N = 2, 64, 3, 8, 4
    ins = _inputs(7, B, S, H, P, N, "steep")
    got = _plain_grads(*ins, chunk=chunk)
    want = _jax_grads(*ins, chunk=1)
    _hold(got, want, ("dx", "ddt", "db", "dc", "dd"))
    f64 = [v.astype(np.float64) for v in ins]
    h = 1e-30
    da = []
    for k in range(H):
        a = f64[2].astype(np.complex128)
        a[k] += 1j * h
        da.append(_recurrence_loss(*f64[:2], a, *f64[3:]).imag / h)
    da = np.array(da)
    assert np.isfinite(got[2].numpy()).all()
    err = np.abs(got[2].numpy() - da).max() / np.abs(da).max()
    assert err <= DA_STEEP_TOL, err


def test_plain_backward_matches_autograd_of_the_plain_scan():
    """The formula against PyTorch's autograd of the port's own plain
    scan (several chunks, the skip weight, both cotangents)."""
    B, S, H, P, N, chunk = 2, 64, 6, 8, 8, 16
    x, dt, a, b, c, d, dy, ds = (torch.from_numpy(v) for v in
                                 _inputs(3, B, S, H, P, N))
    leaves = [t.clone().requires_grad_(True) for t in (x, dt, a, b, c, d)]
    y, final = tref.ssd_chunk_scan(*leaves[:5], chunk=chunk,
                                   d_skip=leaves[5])
    want = torch.autograd.grad((y, final), leaves, (dy, ds))
    got = tref.ssd_chunk_scan_bwd(x, dt, a, b, c, dy, chunk=chunk, d_skip=d,
                                  dstate=ds)
    _hold(got, [w.numpy() for w in want])


def test_plain_backward_keeps_each_input_dtype():
    """bf16 x, B and C give bf16 dx, dB and dC; dt, a and d stay f32."""
    B, S, H, P, N, chunk = 1, 32, 2, 8, 4, 16
    x, dt, a, b, c, d, dy, ds = (torch.from_numpy(v) for v in
                                 _inputs(5, B, S, H, P, N))
    bf = torch.bfloat16
    got = tref.ssd_chunk_scan_bwd(x.to(bf), dt, a, b.to(bf), c.to(bf),
                                  dy.to(bf), chunk=chunk, d_skip=d,
                                  dstate=ds)
    assert [g.dtype for g in got] == [bf, torch.float32, torch.float32, bf,
                                      bf, torch.float32]
    assert [tuple(g.shape) for g in got] == [
        (B, S, H, P), (B, S, H), (H,), (B, S, 1, N), (B, S, 1, N), (H,)]


def test_plain_scan_autograd_is_finite_at_steep_decay():
    """The port's plain scan selects the exponent before ``exp`` as well,
    so its autograd stays finite where e^{cum_i - cum_j} above the
    diagonal overflows (``jax.vjp`` of the JAX oracle is NaN there); its
    dx, ddt, db, dc and dd agree with the plain backward.  Its da is only
    finite: autograd's f32 sum of dt dda cancels (~5e-2 of its largest
    magnitude on these inputs), which the plain backward's pairwise sum
    avoids."""
    B, S, H, P, N, chunk = 2, 64, 3, 8, 4, 64
    x, dt, a, b, c, d, dy, ds = (torch.from_numpy(v) for v in
                                 _inputs(7, B, S, H, P, N, "steep"))
    leaves = [t.clone().requires_grad_(True) for t in (x, dt, a, b, c, d)]
    y, final = tref.ssd_chunk_scan(*leaves[:5], chunk=chunk,
                                   d_skip=leaves[5])
    want = torch.autograd.grad((y, final), leaves, (dy, ds))
    assert all(bool(torch.isfinite(w).all()) for w in want)
    got = tref.ssd_chunk_scan_bwd(x, dt, a, b, c, dy, chunk=chunk, d_skip=d,
                                  dstate=ds)
    _hold(got, [w.numpy() for w in want], ("dx", "ddt", "db", "dc", "dd"))
