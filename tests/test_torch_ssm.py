"""The port's SSM family against the JAX package on the same numpy
inputs: the plain SSD scan against JAX's oracle and the Pallas body in
interpret mode, the single-token recurrence, and smoke-width mamba2
(2 layers, d_model 128, 8 heads of 32, state 16, f32) through prefill,
decode and a greedy loop on bridged weights.

Tolerances, f32: y at rtol = atol = 2e-5 and the state at 1e-4, as
tests/test_kernels.py holds the Pallas body to the oracle (the scan sums
up to 128 rows in another order); logits and conv tails at 1e-4
absolute (XLA and PyTorch sum the projections in different orders); the
model's SSM state, whose entries reach ~10 here, at the scan's state
tolerance (1e-4 relative plus 1e-4 absolute)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import smoke_config as jax_smoke
from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_chunk_scan_pallas
from repro.models import Model as JaxModel
from repro_torch.configs import ARCHS, ShapeConfig, smoke_config
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.models import Model, cache_from_numpy, params_from_numpy

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

Y_TOL = dict(rtol=2e-5, atol=2e-5)
STATE_TOL = dict(rtol=1e-4, atol=1e-4)
MODEL_TOL = dict(rtol=0, atol=1e-4)
ARCH = "mamba2-2.7b"


def _softplus(v):
    return np.logaddexp(v, 0.0).astype(np.float32)


def _scan_case(seed, B, S, H, P, N, G=1):
    rs = np.random.RandomState(seed)
    f = np.float32
    x = (rs.standard_normal((B, S, H, P)) * 0.3).astype(f)
    dt = _softplus(rs.standard_normal((B, S, H)) - 1.0)
    a = (-np.exp(rs.standard_normal(H) * 0.3)).astype(f)
    b = (rs.standard_normal((B, S, G, N)) * 0.3).astype(f)
    c = (rs.standard_normal((B, S, G, N)) * 0.3).astype(f)
    d = rs.standard_normal(H).astype(f)
    return x, dt, a, b, c, d


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(v)) for v in arrays]


def _j(*arrays):
    return [jnp.asarray(v) for v in arrays]


# the shapes of tests/test_kernels.py's scan test, plus S < chunk
SCAN_SHAPES = [(1, 128, 4, 32, 16, 64), (2, 256, 8, 64, 32, 128),
               (1, 256, 16, 32, 64, 64), (2, 96, 8, 32, 16, 128)]


@pytest.mark.parametrize("B,S,H,P,N,chunk", SCAN_SHAPES)
def test_plain_scan_matches_jax_oracle_and_pallas(B, S, H, P, N, chunk):
    x, dt, a, b, c, d = _scan_case(B + S + H, B, S, H, P, N)
    chunk = min(chunk, S)
    got_y, got_s = ops.ssd_chunk_scan(*_t(x, dt, a, b, c), chunk=chunk,
                                      d_skip=torch.from_numpy(d))
    want_y, want_s = jref.ssd_chunk_scan(*_j(x, dt, a, b, c), chunk=chunk,
                                         d_skip=jnp.asarray(d))
    pal_y, pal_s = ssd_chunk_scan_pallas(*_j(x, dt, a, b, c), chunk=chunk,
                                         d_skip=jnp.asarray(d),
                                         interpret=True)
    assert got_y.dtype == torch.float32 and got_s.dtype == torch.float32
    for want in (want_y, pal_y):
        np.testing.assert_allclose(got_y.numpy(), np.asarray(want),
                                   **Y_TOL)
    for want in (want_s, pal_s):
        np.testing.assert_allclose(got_s.numpy(), np.asarray(want),
                                   **STATE_TOL)


def test_plain_scan_groups_and_init_state_match_jax_oracle():
    """The plain version is a full copy of the oracle: B/C groups and an
    initial state, which the kernel path refuses, still agree."""
    x, dt, a, b, c, d = _scan_case(11, 2, 128, 8, 32, 16, G=2)
    s0 = np.random.RandomState(12).standard_normal(
        (2, 8, 32, 16)).astype(np.float32)
    got_y, got_s = tref.ssd_chunk_scan(*_t(x, dt, a, b, c), chunk=64,
                                       d_skip=torch.from_numpy(d),
                                       init_state=torch.from_numpy(s0))
    want_y, want_s = jref.ssd_chunk_scan(*_j(x, dt, a, b, c), chunk=64,
                                         d_skip=jnp.asarray(d),
                                         init_state=jnp.asarray(s0))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **Y_TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               **STATE_TOL)


@pytest.mark.parametrize("G", [1, 2])
def test_plain_decode_step_matches_jax(G):
    rs = np.random.RandomState(20 + G)
    B, H, P, N = 3, 8, 32, 16
    f = np.float32
    x = (rs.standard_normal((B, H, P)) * 0.3).astype(f)
    dt = _softplus(rs.standard_normal((B, H)) - 1.0)
    a = (-np.exp(rs.standard_normal(H) * 0.3)).astype(f)
    b = (rs.standard_normal((B, G, N)) * 0.3).astype(f)
    c = (rs.standard_normal((B, G, N)) * 0.3).astype(f)
    s = rs.standard_normal((B, H, P, N)).astype(f)
    d = rs.standard_normal(H).astype(f)
    got_y, got_s = ops.ssd_decode_step(*_t(x, dt, a, b, c, s),
                                       d_skip=torch.from_numpy(d))
    want_y, want_s = jref.ssd_decode_step(*_j(x, dt, a, b, c, s),
                                          d_skip=jnp.asarray(d))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **Y_TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               **STATE_TOL)


def test_chunked_scan_equals_token_recurrence():
    """The chunked dual form equals the token-by-token recurrence."""
    B, S, H, P, N = 2, 64, 3, 16, 8
    x, dt, a, b, c, d = _t(*_scan_case(5, B, S, H, P, N))
    y, s_final = tref.ssd_chunk_scan(x, dt, a, b, c, chunk=16, d_skip=d)
    state = torch.zeros((B, H, P, N))
    ys = []
    for t in range(S):
        yt, state = tref.ssd_decode_step(x[:, t], dt[:, t], a, b[:, t],
                                         c[:, t], state, d_skip=d)
        ys.append(yt)
    np.testing.assert_allclose(y.numpy(), torch.stack(ys, 1).numpy(),
                               **Y_TOL)
    np.testing.assert_allclose(s_final.numpy(), state.numpy(), **STATE_TOL)


@pytest.mark.parametrize("case", ["groups", "init_state", "ragged"])
def test_ops_scan_refuses_what_the_kernel_refuses(case):
    """On the CPU ``ops.ssd_chunk_scan`` refuses only what the JAX oracle
    asserts (a sequence that is not whole chunks); what the kernel alone
    refuses, B/C groups and an initial state, the plain version computes
    as the oracle does (the card tests hold that the kernel refuses)."""
    G = 2 if case == "groups" else 1
    S = 200 if case == "ragged" else 128
    x, dt, a, b, c, d = _scan_case(9, 1, S, 4, 32, 16, G=G)
    init = None
    if case == "init_state":
        init = np.random.RandomState(10).standard_normal(
            (1, 4, 32, 16)).astype(np.float32)
    args = dict(chunk=128, d_skip=torch.from_numpy(d),
                init_state=None if init is None else torch.from_numpy(init))
    if case == "ragged":
        with pytest.raises(ValueError):
            ops.ssd_chunk_scan(*_t(x, dt, a, b, c), **args)
        return
    got_y, got_s = ops.ssd_chunk_scan(*_t(x, dt, a, b, c), **args)
    want_y, want_s = jref.ssd_chunk_scan(
        *_j(x, dt, a, b, c), chunk=128, d_skip=jnp.asarray(d),
        init_state=None if init is None else jnp.asarray(init))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **Y_TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               **STATE_TOL)


# ---------------------------------------------------------------------------
# the model on bridged weights
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def models():
    jm = JaxModel(jax_smoke(JAX_ARCHS[ARCH]))
    np_params = jax.tree.map(np.asarray, jm.init_params(0))
    # the seeded init leaves dt_bias / a_log at 0 and d_skip / norm at 1;
    # random values make those leaves matter in the comparison
    rs = np.random.RandomState(7)
    mamba = np_params["layers"]["mamba"]
    for k in ("dt_bias", "a_log", "d_skip", "norm"):
        mamba[k] = (mamba[k] + rs.standard_normal(mamba[k].shape)
                    * 0.3).astype(np.float32)
    tm = Model(smoke_config(ARCHS[ARCH]), device="cpu")
    return jm, np_params, tm


def _tokens(seed, B, S, vocab):
    return np.random.RandomState(seed).randint(1, vocab, (B, S)).astype(
        np.int32)


def _decode_cache(jm, tm, jcache_prefill, tcache_prefill, B):
    """The prefill cache loaded into the decode cache layout: a cast to
    the decode cache's dtypes (f32), as tests/test_arch_smoke.py does."""
    shape = ShapeConfig("serve", "decode", 256, B)
    jc = jm.init_cache(shape)
    jc["layers"] = jax.tree.map(lambda dst, src: src.astype(dst.dtype),
                                jc["layers"], jcache_prefill)
    tc = tm.init_cache(shape)
    for k, dst in tc["layers"].items():
        dst.copy_(tcache_prefill[k])
    return jc, tc


def _assert_cache(tcache, jcache):
    assert tcache.keys() == jcache.keys()
    for k in jcache:
        want = np.asarray(jcache[k])
        assert tuple(tcache[k].shape) == want.shape, k
        tol = STATE_TOL if k == "state" else MODEL_TOL
        np.testing.assert_allclose(tcache[k].numpy(), want, **tol,
                                   err_msg=k)


def test_prefill_logits_and_cache_match_jax(models):
    jm, np_params, tm = models
    toks = _tokens(1, 2, 128, tm.cfg.vocab_size)
    jl, jc = jm.prefill(jax.tree.map(jnp.asarray, np_params),
                        {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(params_from_numpy(np_params, "cpu"),
                        {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    _assert_cache(tc, jc)


def test_prefill_last_index_matches_jax(models):
    jm, np_params, tm = models
    toks = _tokens(2, 2, 64, tm.cfg.vocab_size)
    last = np.array([40, 63], np.int32)
    jl, _ = jm.prefill(jax.tree.map(jnp.asarray, np_params),
                       {"tokens": jnp.asarray(toks),
                        "last_index": jnp.asarray(last)})
    tl, _ = tm.prefill(params_from_numpy(np_params, "cpu"),
                       {"tokens": torch.from_numpy(toks),
                        "last_index": torch.from_numpy(last)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)


def test_decode_step_logits_and_cache_match_jax(models):
    """A random decode cache (bridged both ways) and one decode step."""
    jm, np_params, tm = models
    B = 3
    specs = jm.cache_specs(ShapeConfig("serve", "decode", 256, B))
    rs = np.random.RandomState(3)
    np_cache = {"layers": {
        k: (rs.standard_normal(s.shape) * 0.5).astype(np.float32)
        for k, s in specs["layers"].items()}}
    toks = _tokens(4, B, 1, tm.cfg.vocab_size)
    jl, jc = jm.decode_step(jax.tree.map(jnp.asarray, np_params),
                            jax.tree.map(jnp.asarray, np_cache),
                            {"tokens": jnp.asarray(toks),
                             "lengths": jnp.zeros((B,), jnp.int32)})
    tcache = cache_from_numpy(np_cache, "cpu")
    tl, tc = tm.decode_step(params_from_numpy(np_params, "cpu"), tcache,
                            {"tokens": torch.from_numpy(toks)})
    assert tc is tcache  # updated in place
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    _assert_cache(tc["layers"], jc["layers"])


def test_prefill_cache_bridges_both_ways(models):
    """The port's prefill cache, carried to the JAX decode step, gives
    the logits the JAX prefill cache gives, and the other way round."""
    jm, np_params, tm = models
    B = 2
    jp = jax.tree.map(jnp.asarray, np_params)
    tp = params_from_numpy(np_params, "cpu")
    toks = _tokens(5, B, 96, tm.cfg.vocab_size)
    nxt = _tokens(6, B, 1, tm.cfg.vocab_size)
    _, jpc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    _, tpc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    batch_j = {"tokens": jnp.asarray(nxt),
               "lengths": jnp.zeros((B,), jnp.int32)}
    # port's prefill cache -> JAX decode
    t_as_np = {k: v.numpy() for k, v in tpc.items()}
    jc_from_t, _ = _decode_cache(jm, tm, jax.tree.map(jnp.asarray, t_as_np),
                                 tpc, B)
    jl_t, _ = jm.decode_step(jp, jc_from_t, batch_j)
    # JAX prefill cache -> port decode
    j_as_t = cache_from_numpy(jax.tree.map(np.asarray, jpc), "cpu")
    jc_own, tc_from_j = _decode_cache(jm, tm, jpc, j_as_t, B)
    jl_j, _ = jm.decode_step(jp, jc_own, batch_j)
    tl_j, _ = tm.decode_step(tp, tc_from_j, {"tokens": torch.from_numpy(nxt)})
    np.testing.assert_allclose(np.asarray(jl_t), np.asarray(jl_j),
                               **MODEL_TOL)
    np.testing.assert_allclose(tl_j.numpy(), np.asarray(jl_j), **MODEL_TOL)


@pytest.mark.parametrize("S", [127, 64])
def test_prefill_then_decode_equals_longer_prefill(models, S):
    """Teacher forcing in the port: prefill S tokens + one decode step of
    token S gives the logits of a prefill of S + 1 tokens."""
    _, np_params, tm = models
    tp = params_from_numpy(np_params, "cpu")
    B = 2
    toks = torch.from_numpy(_tokens(8, B, S + 1, tm.cfg.vocab_size))
    _, pc = tm.prefill(tp, {"tokens": toks[:, :S]})
    cache = tm.init_cache(ShapeConfig("serve", "decode", 256, B))
    for k, dst in cache["layers"].items():
        dst.copy_(pc[k])
    got, _ = tm.decode_step(tp, cache, {"tokens": toks[:, S:]})
    want, _ = tm.prefill(tp, {"tokens": toks})
    np.testing.assert_allclose(got.numpy(), want.numpy(), **MODEL_TOL)


def test_greedy_tokens_match_jax(models):
    """Prefill, load the decode cache, 8 greedy decode steps: the same
    tokens as the JAX model's loop, and logits within tolerance."""
    jm, np_params, tm = models
    B, S, steps = 2, 128, 8
    jp = jax.tree.map(jnp.asarray, np_params)
    tp = params_from_numpy(np_params, "cpu")
    toks = _tokens(10, B, S, tm.cfg.vocab_size)
    jl, jpc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, tpc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    jc, tc = _decode_cache(jm, tm, jpc, tpc, B)
    jt, tt = [], []
    for _ in range(steps):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
        jnext = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        tnext = tl.argmax(-1).to(torch.int32)
        jt.append(jnext.tolist())
        tt.append(tnext.tolist())
        jl, jc = jm.decode_step(jp, jc,
                                {"tokens": jnp.asarray(jnext)[:, None],
                                 "lengths": jnp.zeros((B,), jnp.int32)})
        tl, tc = tm.decode_step(tp, tc, {"tokens": tnext[:, None]})
    assert tt == jt
