"""The flash backward's arithmetic and its work plan, on the CPU.

* ``flash_attention_bwd_plain`` (the formula the backward kernel
  implements: P from the forward's saved statistics, D_i = rowsum(dO * O),
  dS masked to 0, a row that sees no key spreading its weight over every
  key) against ``jax.vjp`` of the JAX package's ``ref.flash_attention`` on
  the same numpy inputs, in f32: causal, non-causal with rows that see no
  key, a window that cuts key tiles, GQA and S_q != S_kv.  Tolerance: each
  gradient's largest error within 1e-5 of its largest magnitude (f32 sums
  in another order; the JAX gradient also flows through the running max,
  which cancels only to rounding).
* The plain forward's statistics against a numpy log-sum-exp of the
  masked scores (in f64), and the output they rebuild against the JAX
  reference's (1e-5).
* ``plan_bwd``: every (kv head, key tile, query head, query tile) pair in
  which some row sees some key of the tile, or holds a row that sees no
  key, is walked exactly once, and no other; at ``chip_smoke.py``'s
  ``BWD_SHAPES`` and at ragged S.  At qwen2's train shape the heaviest
  SM's work is within 1.15 of the mean.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import SMS
from repro_torch.kernels.flash_attention import flash_attention_bwd_plain
from repro_torch.kernels.flash_attention import plan_bwd

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
GRAD_TOL = 1e-5
STATS_TOL = 1e-5
LOG2E = 1.4426950408889634


def _smoke_bwd_shapes():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.BWD_SHAPES


def _inputs(seed, B, S_q, S_kv, H, Hkv, D):
    rs = np.random.RandomState(seed)
    return tuple(rs.standard_normal(shape).astype(np.float32)
                 for shape in ((B, S_q, H, D), (B, S_kv, Hkv, D),
                               (B, S_kv, Hkv, D), (B, S_q, H, D)))


def _visible(S_q, S_kv, causal, window):
    i = np.arange(S_q)[:, None]
    j = np.arange(S_kv)[None, :]
    vis = np.ones((S_q, S_kv), dtype=bool)
    if causal:
        vis &= j <= i
    if window:
        vis &= j > i - window
    return vis


#: (B, S_q, S_kv, H, Hkv, D, causal, window)
CASES = [
    (1, 96, 96, 4, 2, 16, True, 0),       # causal, G 2
    (1, 40, 30, 6, 3, 16, False, 4),      # rows 33..39 see no key
    (2, 70, 70, 4, 1, 8, True, 20),       # a window, G 4
    (1, 48, 80, 6, 2, 32, True, 0),       # S_q < S_kv: keys no row sees
    (1, 80, 48, 2, 2, 24, False, 0),      # non-causal, S_q > S_kv, G 1
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(
    str(int(x)) for x in c))
def test_plain_backward_matches_jax_vjp(case):
    B, S_q, S_kv, H, Hkv, D, causal, window = case
    q, k, v, do = _inputs(3 + S_q, B, S_q, S_kv, H, Hkv, D)
    kw = dict(causal=causal, window=window)
    out, vjp = jax.vjp(lambda a, b, c: jref.flash_attention(a, b, c, **kw),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    t_out, stats = tref.flash_attention(tq, tk, tv, with_stats=True, **kw)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(out), rtol=1e-5,
                               atol=1e-5)
    got = flash_attention_bwd_plain(tq, tk, tv, t_out, tdo, stats, **kw)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        b = np.asarray(b)
        err = np.abs(a.numpy() - b).max() / np.abs(b).max()
        assert err <= GRAD_TOL, (name, err)


def test_plain_backward_matches_autograd_in_chunks():
    """The plain backward's query chunks (here 32 rows) give the gradient
    of one pass, and agree with autograd of the plain forward."""
    B, S_q, S_kv, H, Hkv, D, causal, window = 1, 100, 100, 4, 2, 16, True, 30
    q, k, v, do = (torch.from_numpy(x)
                   for x in _inputs(5, B, S_q, S_kv, H, Hkv, D))
    kw = dict(causal=causal, window=window)
    out, stats = tref.flash_attention(q, k, v, with_stats=True, **kw)
    got = flash_attention_bwd_plain(q, k, v, out, do, stats, chunk=32, **kw)
    qa, ka, va = (t.clone().requires_grad_(True) for t in (q, k, v))
    want = torch.autograd.grad(tref.flash_attention(qa, ka, va, **kw),
                               (qa, ka, va), do)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        err = float((a - b).abs().max() / b.abs().max())
        assert err <= GRAD_TOL, (name, err)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(
    str(int(x)) for x in c))
def test_plain_stats_are_the_masked_log_sum_exp(case):
    B, S_q, S_kv, H, Hkv, D, causal, window = case
    q, k, v, _ = _inputs(9 + S_q, B, S_q, S_kv, H, Hkv, D)
    kw = dict(causal=causal, window=window)
    _, stats = tref.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), with_stats=True,
                                    **kw)
    stats = stats.numpy()
    assert stats.shape == (B, S_q, H, 2)
    G = H // Hkv
    kh = np.repeat(k, G, axis=2).astype(np.float64)  # (B, S_kv, H, D)
    vh = np.repeat(v, G, axis=2).astype(np.float64)
    s2 = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), kh) * (
        LOG2E / np.sqrt(D))
    vis = _visible(S_q, S_kv, causal, window)
    # the f32 fill, as the kernels and the plain versions hold it
    s2 = np.where(vis, s2, np.float64(np.float32(tref.NEG_INF)))
    m = s2.max(-1)
    w = np.exp2(s2 - m[..., None])
    l = w.sum(-1)
    got_m = stats[..., 0].transpose(0, 2, 1)
    got_l = stats[..., 1].transpose(0, 2, 1)
    empty = ~vis.any(-1)
    assert bool(empty.any()) == (case == CASES[1])
    # a row that sees no key keeps m = NEG_INF exactly, and l = S_kv
    assert np.all(got_m[..., empty] == np.float32(tref.NEG_INF))
    np.testing.assert_allclose(got_m, m, rtol=STATS_TOL, atol=STATS_TOL)
    np.testing.assert_allclose(got_l, l, rtol=STATS_TOL, atol=STATS_TOL)
    # the weights 2^(s2 - m) / l they give rebuild the JAX reference's
    # output, the empty rows' uniform average included
    p = np.exp2(s2 - got_m.astype(np.float64)[..., None]) / got_l[..., None]
    rebuilt = np.einsum("bhqk,bkhd->bqhd", p, vh)
    want = np.asarray(jref.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), **kw))
    np.testing.assert_allclose(rebuilt, want, rtol=STATS_TOL, atol=STATS_TOL)


def _walked(plan, B, Hkv, G):
    """Every (b, kv head, key tile, query head, query tile) the plan's
    blocks walk, in their order."""
    out = []
    for bh, kt, lo, hi, e in plan.items:
        for g in range(G):
            for qt in list(range(lo, hi)) + list(range(max(hi, e),
                                                       plan.n_qt)):
                out.append((bh // Hkv, bh % Hkv, kt, g, qt))
    return out


def _needed(S_q, S_kv, causal, window, rows):
    """(key tile, query tile) pairs in which some row sees some key of the
    tile, or that hold a row which sees no key."""
    vis = _visible(S_q, S_kv, causal, window)
    empty = ~vis.any(-1)
    n_qt, n_kt = -(-S_q // rows), -(-S_kv // 64)
    pad = np.zeros((n_qt * rows, n_kt * 64), dtype=bool)
    pad[:S_q, :S_kv] = vis
    tile = pad.reshape(n_qt, rows, n_kt, 64).any(axis=(1, 3))
    e_pad = np.zeros(n_qt * rows, dtype=bool)
    e_pad[:S_q] = empty
    tile |= e_pad.reshape(n_qt, rows).any(1)[:, None]
    return {(kt, qt) for qt, kt in zip(*np.nonzero(tile))}


def _check_plan(B, S_q, S_kv, H, Hkv, D, causal, window):
    plan = plan_bwd(B, S_q, S_kv, H, Hkv, causal=causal, window=window,
                    head_dim=D)
    G, n_kt = H // Hkv, -(-S_kv // 64)
    assert plan.rows == (64 if D <= 64 else 32)
    # every item once, each in one block
    items = [(bh, kt) for bh, kt, *_ in plan.items]
    assert sorted(items) == [(bh, kt) for bh in range(B * Hkv)
                             for kt in range(n_kt)]
    assert plan.offsets[0] == 0 and plan.offsets[-1] == len(items)
    assert len(plan.work) == len(plan.offsets) - 1 == min(SMS, len(items))
    walked = _walked(plan, B, Hkv, G)
    assert len(walked) == len(set(walked))
    needed = _needed(S_q, S_kv, causal, window, plan.rows)
    want = {(b, hk, kt, g, qt) for b in range(B) for hk in range(Hkv)
            for g in range(G) for kt, qt in needed}
    assert set(walked) == want
    assert sum(plan.work) == len(walked)
    return plan


@pytest.mark.parametrize("shape", _smoke_bwd_shapes(), ids=lambda s: s[0])
def test_plan_walks_every_visible_pair_once_at_smoke_shapes(shape):
    _check_plan(*shape[1:])


@pytest.mark.parametrize("shape", [
    (1, 400, 300, 6, 3, 96, False, 40),   # rows 339..399 see no key
    (1, 300, 300, 8, 2, 112, True, 100),
    (2, 640, 640, 14, 2, 64, True, 0),
    (1, 1000, 1000, 16, 16, 64, True, 0),
    (3, 129, 65, 4, 4, 32, True, 0),      # keys past the rows' horizon
    (1, 65, 200, 7, 1, 128, False, 0),
    (1, 257, 257, 2, 1, 64, True, 63),
], ids=lambda s: "x".join(str(int(x)) for x in s))
def test_plan_walks_every_visible_pair_once_at_ragged_shapes(shape):
    _check_plan(*shape)


def test_plan_balances_qwen2_train_shape():
    plan = _check_plan(2, 4096, 4096, 14, 2, 64, True, 0)
    assert len(plan.work) == SMS
    mean = sum(plan.work) / SMS
    assert max(plan.work) <= 1.15 * mean, (max(plan.work), mean)


def test_plan_is_a_function_of_shapes():
    a = plan_bwd(2, 4096, 4096, 14, 2, causal=True, head_dim=64)
    plan_bwd.cache_clear()
    b = plan_bwd(2, 4096, 4096, 14, 2, causal=True, head_dim=64)
    assert a == b
