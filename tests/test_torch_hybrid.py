"""The port's hybrid family (zamba2) against the JAX package on the same
numpy inputs, at two smoke widths: the JAX smoke config (2 Mamba2 layers
and one application of the shared attention block) and a 5-layer variant
(two applications and one trailing Mamba2 layer), both at d_model 128,
8 SSD heads of 32 with state 16, 4 query heads over 2 kv heads of 32,
f32.  Checked: the spec trees leaf for leaf and the weight bridge, the
prefill logits and every cache leaf, one decode step on a loaded cache
with a different permutation of its pages in each block-table row,
prefill-then-decode against the longer prefill, and 8 greedy tokens
against the JAX loop; also ``mamba_full`` with an initial state.

Tolerances, f32: logits at rtol = atol = 1e-4, as tests/test_torch_model.py
holds the dense model (XLA and PyTorch sum the projections in different
orders); every cache leaf (SSM state, conv tails, the attention K/V and
pools) at rtol 1e-4 and an absolute 1e-4 of the leaf's largest
magnitude (at least 1e-4), as tests/test_torch_model.py holds the pools:
the residual stream grows through the Mamba2 layers, so the shared
block's K/V reach ~20 and the projections' reordering shows at ~1e-4
absolute there.  The seeded init leaves the Mamba2 ``dt_bias``, ``a_log``,
``d_skip`` and gated-norm weight at 0 or 1; they are made random, as in
tests/test_torch_ssm.py, so that they matter in the comparison.  The
shared block's attention projections are *conditioned* (rescaled to unit
variance over their true contraction, as ``chip_smoke.conditioned`` and
tests/test_torch_encdec.py do): the seeded init makes every head a
near-hard argmax that amplifies the reorderings ~100-fold (ROADMAP
Queue C)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import smoke_config as jax_smoke
from repro.models import Model as JaxModel
from repro.models.ssm import mamba_full as jax_mamba_full
from repro_torch.configs import ARCHS, ShapeConfig, smoke_config
from repro_torch.models import Model, cache_from_numpy, params_from_numpy
from repro_torch.models.ssm import mamba_full
from repro_torch.models.transformer import n_shared_attn

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "zamba2-7b"
BATCH, MAX_SEQ = 2, 256
#: layer counts: the JAX smoke config's 2, and 5 (2 groups of 2 + 1)
DEPTHS = [2, 5]


@pytest.fixture(scope="module", params=DEPTHS, ids=lambda n: f"{n}L")
def models(request):
    n = request.param
    jm = JaxModel(jax_smoke(JAX_ARCHS[ARCH]).scaled(num_layers=n))
    np_params = jax.tree.map(np.asarray, jm.init_params(0))
    rs = np.random.RandomState(7 + n)
    mamba = np_params["layers"]["mamba"]
    for k in ("dt_bias", "a_log", "d_skip", "norm"):
        mamba[k] = (mamba[k] + rs.standard_normal(mamba[k].shape)
                    * 0.3).astype(np.float32)
    a = dict(np_params["shared_attn"]["attn"])
    M, H, Hkv = jm.cfg.d_model, jm.cfg.num_heads, jm.cfg.num_kv_heads
    a["wq"] = (a["wq"] * np.sqrt(H / M)).astype(np.float32)
    a["wk"] = (a["wk"] * np.sqrt(Hkv / M)).astype(np.float32)
    a["wv"] = (a["wv"] * np.sqrt(Hkv / M)).astype(np.float32)
    a["wo"] = (a["wo"] / np.sqrt(H)).astype(np.float32)
    np_params["shared_attn"]["attn"] = a
    tm = Model(smoke_config(ARCHS[ARCH]).scaled(num_layers=n), device="cpu")
    return jm, np_params, tm


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _tokens(seed, n, vocab):
    return np.random.RandomState(seed).randint(1, vocab, (BATCH, n)).astype(
        np.int32)


def _block_table(n_pool, mb, seed):
    """Per-slot page ids: a different permutation of pages 1.. in each
    row (page 0 is the scratch page)."""
    rs = np.random.RandomState(seed)
    return np.stack([1 + rs.permutation(n_pool - 1)[:mb]
                     for _ in range(BATCH)]).astype(np.int32)


def load_decode_cache(specs, pcache, table):
    """The prefill cache in the decode cache's layout, as numpy: every
    Mamba2 layer's state and conv tails cast to the decode cache's f32,
    and each application's K/V written page by page into the pages its
    block-table row names (the last page zero-padded)."""
    cache = {p: np.zeros(s.shape, np.dtype(jnp.dtype(s.dtype)))
             for p, s in _leaves(specs).items()}
    for k in ("state", "conv_x", "conv_b", "conv_c"):
        cache[f"/layers/{k}"][...] = np.asarray(pcache["mamba"][k])
    S = pcache["attn_k"].shape[2]
    for name, pool in (("attn_k", "/attn/k_pool"),
                       ("attn_v", "/attn/v_pool")):
        kv = np.asarray(pcache[name])
        for b in range(BATCH):
            for j in range(-(-S // 128)):
                seg = kv[:, b, j * 128:(j + 1) * 128]
                cache[pool][:, b, table[b, j], :seg.shape[1]] = seg
    return {"layers": {k: cache[f"/layers/{k}"]
                       for k in ("state", "conv_x", "conv_b", "conv_c")},
            "attn": {"k_pool": cache["/attn/k_pool"],
                     "v_pool": cache["/attn/v_pool"]}}


def _setup(models, seed):
    """Both packages' params, the decode cache specs and a block table."""
    jm, np_params, tm = models
    specs = jm.cache_specs(ShapeConfig("serve", "decode", MAX_SEQ, BATCH))
    n_pool = specs["attn"]["k_pool"].shape[2]
    mb = -(-MAX_SEQ // 128) + 1
    return (jax.tree.map(jnp.asarray, np_params),
            params_from_numpy(np_params, "cpu"), specs,
            _block_table(n_pool, mb, seed))


def _assert_tree(got, want):
    """Cache leaves, each to 1e-4 of its largest magnitude."""
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    for path, w in want.items():
        g, w = np.asarray(got[path]), np.asarray(w)
        assert g.shape == w.shape, path
        atol = TOL["atol"] * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, rtol=TOL["rtol"], atol=atol,
                                   err_msg=path)


def test_bridge_and_specs_cover_every_hybrid_leaf(models):
    """Every param leaf (the stacked Mamba2 layers, the unstacked shared
    block, ...) bridges unchanged and the port declares the same tree;
    the decode cache has the same leaves, shapes and dtypes (one pool per
    application of the shared block) and a JAX cache bridges leaf for
    leaf."""
    jm, np_params, tm = models
    bridged = _leaves(params_from_numpy(np_params, "cpu"))
    src = _leaves(np_params)
    assert bridged.keys() == src.keys()
    assert {p.split("/")[1] for p in src} == {
        "embed", "layers", "shared_attn", "final_norm"}
    for path, a in src.items():
        np.testing.assert_array_equal(bridged[path].numpy(), a)
    specs = _leaves(tm.param_specs)
    assert {p: tuple(s.shape) for p, s in specs.items()} == {
        p: a.shape for p, a in src.items()}
    assert tm.n_params() == jm.n_params()

    shape = ShapeConfig("serve", "decode", MAX_SEQ, BATCH)
    jc, tc = _leaves(jm.cache_specs(shape)), _leaves(tm.cache_specs(shape))
    assert jc.keys() == tc.keys()
    for path in jc:
        assert tuple(tc[path].shape) == tuple(jc[path].shape), path
        assert (str(tc[path].dtype)
                == f"torch.{jnp.dtype(jc[path].dtype).name}"), path
    assert tc["/attn/k_pool"].shape[0] == n_shared_attn(tm.cfg)
    assert n_shared_attn(tm.cfg) == tm.cfg.num_layers // 2
    assert tm.uses_block_table() == jm.uses_block_table()
    jcache = jax.tree.map(np.asarray, jm.init_cache(shape))
    tcache = _leaves(cache_from_numpy(jcache, "cpu"))
    for path, a in _leaves(jcache).items():
        assert tcache[path].numpy().dtype == a.dtype, path
        np.testing.assert_array_equal(tcache[path].numpy(), a)


def test_prefill_logits_and_caches_match_jax(models):
    jm, _, tm = models
    jp, tp, _, _ = _setup(models, 1)
    toks = _tokens(1, 128, tm.cfg.vocab_size)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert tc.keys() == jc.keys() == {"mamba", "attn_k", "attn_v"}
    assert tc["attn_k"].shape == (n_shared_attn(tm.cfg), BATCH, 128, 2, 32)
    _assert_tree(tc, jc)


def test_decode_step_matches_jax(models):
    """One loaded cache (128 prompt tokens: the next token lands on the
    second page), per-slot tables with a different permutation in each
    row, in both packages: logits, every Mamba2 layer's state and conv
    tails, and the shared block's pools."""
    jm, _, tm = models
    jp, tp, specs, table = _setup(models, 2)
    toks = _tokens(2, 129, tm.cfg.vocab_size)
    _, jpc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :128])})
    np_cache = load_decode_cache(specs, jpc, table)
    batch = {"tokens": toks[:, 128:],
             "lengths": np.full((BATCH,), 128, np.int32),
             "block_table": table}
    jl, jc = jm.decode_step(jp, jax.tree.map(jnp.asarray, np_cache),
                            jax.tree.map(jnp.asarray, batch))
    tcache = cache_from_numpy(np_cache, "cpu")
    tl, tc = tm.decode_step(tp, tcache, {k: torch.from_numpy(v)
                                         for k, v in batch.items()})
    assert tc is tcache  # updated in place
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_tree(tc, jc)


def _teacher_forcing(model, params, specs, table, toks, bridge):
    """Prefill of t tokens plus one decode step of token t, and the
    prefill of t + 1 tokens: both last logits."""
    t = toks.shape[1] - 1
    _, pc = model.prefill(params, bridge({"tokens": toks[:, :t]}))
    cache = bridge(load_decode_cache(specs, jax.tree.map(np.asarray, pc),
                                     table))
    got, _ = model.decode_step(params, cache, bridge({
        "tokens": toks[:, t:], "lengths": np.full((BATCH,), t, np.int32),
        "block_table": table}))
    want, _ = model.prefill(params, bridge({"tokens": toks}))
    return np.asarray(got), np.asarray(want)


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_prefill_then_decode_equals_longer_prefill(models, package):
    """Teacher forcing: prefill 127 tokens + one decode step of token 127
    gives the logits of a prefill of 128 tokens, in each package."""
    jm, _, tm = models
    jp, tp, specs, table = _setup(models, 3)
    toks = _tokens(3, 128, tm.cfg.vocab_size)
    if package == "jax":
        got, want = _teacher_forcing(jm, jp, specs, table, toks,
                                     lambda t: jax.tree.map(jnp.asarray, t))
    else:
        got, want = _teacher_forcing(
            tm, tp, specs, table, toks,
            lambda t: cache_from_numpy(jax.tree.map(np.asarray, t), "cpu"))
    np.testing.assert_allclose(got, want, **TOL)


def test_greedy_tokens_match_jax(models):
    """Prefill, load the decode cache, 8 greedy decode steps: the same
    tokens as the JAX model's loop, and logits within tolerance."""
    jm, _, tm = models
    jp, tp, specs, table = _setup(models, 4)
    toks = _tokens(4, 128, tm.cfg.vocab_size)
    jl, jpc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, tpc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    jc = jax.tree.map(jnp.asarray, load_decode_cache(specs, jpc, table))
    tc = cache_from_numpy(load_decode_cache(
        specs, jax.tree.map(np.asarray, tpc), table), "cpu")
    jt, tt = [], []
    for step in range(8):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        jnext = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        tnext = tl.argmax(-1).to(torch.int32)
        jt.append(jnext.tolist())
        tt.append(tnext.tolist())
        lengths = np.full((BATCH,), 128 + step, np.int32)
        jl, jc = jm.decode_step(jp, jc, {
            "tokens": jnp.asarray(jnext)[:, None],
            "lengths": jnp.asarray(lengths),
            "block_table": jnp.asarray(table)})
        tl, tc = tm.decode_step(tp, tc, {
            "tokens": tnext[:, None], "lengths": torch.from_numpy(lengths),
            "block_table": torch.from_numpy(table)})
    assert tt == jt


def test_mamba_full_init_state_matches_jax(models):
    """``mamba_full`` started from a random state, as the JAX block takes
    one: the block output and the cache (state and conv tails)."""
    jm, np_params, tm = models
    cfg = tm.cfg
    lp = jax.tree.map(lambda a: a[0], np_params["layers"]["mamba"])
    rs = np.random.RandomState(5)
    x = (rs.standard_normal((BATCH, 64, cfg.d_model)) * 0.5).astype(
        np.float32)
    s0 = rs.standard_normal((BATCH, cfg.ssm_heads, cfg.ssm_head_dim,
                             cfg.ssm_state)).astype(np.float32)
    want, want_c = jax_mamba_full(jax.tree.map(jnp.asarray, lp),
                                  jnp.asarray(x), jm.cfg,
                                  init_state=jnp.asarray(s0))
    got, got_c = mamba_full(params_from_numpy(lp, "cpu"),
                            torch.from_numpy(x), cfg,
                            init_state=torch.from_numpy(s0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _assert_tree(got_c, want_c)
    # the state matters: from zero the block gives another output
    zero, _ = mamba_full(params_from_numpy(lp, "cpu"), torch.from_numpy(x),
                         cfg)
    assert float((zero - got).abs().max()) > 1e-2
