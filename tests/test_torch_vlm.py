"""The port's vlm family (llava-next-34b) against the JAX package on the
same numpy inputs, at the JAX smoke width (2 layers, d_model 128, 4 query
heads over 2 kv heads of 32, 8 frontend positions, f32).  Checked: the
spec tree leaf for leaf and the weight bridge; ``Model.input_specs`` for
the train, prefill and decode kinds (the vlm's and the
encoder-decoder's branches too); ``Model.prefill`` logits and K/V with
``frontend_embeds`` before the tokens; a decode step on the loaded cache
with a different permutation of pages in each block-table row;
prefill-then-decode against the longer prefill in both packages; and 8
greedy tokens against the JAX loop.

Tolerances, f32: logits and K/V at rtol = atol = 1e-4, as
tests/test_torch_model.py holds the dense model (XLA and PyTorch sum the
projections in different orders).  The attention projections are
conditioned (unit variance over their contraction), as
tests/test_torch_encdec.py does: the seeded init makes every head a
near-hard argmax that amplifies the reorderings (ROADMAP Queue C)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import ShapeConfig as JaxShape
from repro.configs import smoke_config as jax_smoke
from repro.models import Model as JaxModel
from repro_torch.configs import ARCHS, ShapeConfig, smoke_config
from repro_torch.models import Model, cache_from_numpy, params_from_numpy

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "llava-next-34b"
BATCH, MAX_SEQ = 2, 512
N_TOKENS = 122  # with the 8 frontend positions: 130, two pages


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.fixture(scope="module")
def models():
    jm = JaxModel(jax_smoke(JAX_ARCHS[ARCH]))
    np_params = jax.tree.map(np.asarray, jm.init_params(0))
    M, H, Hkv = jm.cfg.d_model, jm.cfg.num_heads, jm.cfg.num_kv_heads
    a = dict(np_params["layers"]["attn"])
    a["wq"] = (a["wq"] * np.sqrt(H / M)).astype(np.float32)
    a["wk"] = (a["wk"] * np.sqrt(Hkv / M)).astype(np.float32)
    a["wv"] = (a["wv"] * np.sqrt(Hkv / M)).astype(np.float32)
    a["wo"] = (a["wo"] / np.sqrt(H)).astype(np.float32)
    np_params["layers"]["attn"] = a
    tm = Model(smoke_config(ARCHS[ARCH]), device="cpu")
    jpre = jax.jit(jm.prefill)
    jdec = jax.jit(jm.decode_step)
    return jm, np_params, tm, jpre, jdec


def _inputs(cfg, seed, n_tokens):
    """Seeded frontend embeddings (normal x 0.02, as the synthetic
    pipeline's) and tokens."""
    rs = np.random.RandomState(seed)
    fe = (rs.randn(BATCH, cfg.frontend_positions, cfg.d_model)
          * 0.02).astype(np.float32)
    toks = rs.randint(1, cfg.vocab_size, (BATCH, n_tokens)).astype(np.int32)
    return fe, toks


def _block_table(n_pool, mb, seed):
    """Per-slot page ids: a different permutation of pages 1.. in each
    row (page 0 is the scratch page)."""
    rs = np.random.RandomState(seed)
    return np.stack([1 + rs.permutation(n_pool - 1)[:mb]
                     for _ in range(BATCH)]).astype(np.int32)


def load_decode_cache(specs, pcache, table):
    """The prefill K/V (L, B, S, Hkv, D) in the decode cache's layout, as
    numpy: each row's positions written page by page into the pages its
    block-table row names (the last page zero-padded)."""
    out = {}
    for name, pool in (("k", "k_pool"), ("v", "v_pool")):
        s = specs["layers"][pool]
        dst = np.zeros(s.shape, np.dtype(jnp.dtype(s.dtype)))
        src = np.asarray(pcache[name])
        S = src.shape[2]
        for b in range(BATCH):
            for j in range(-(-S // 128)):
                seg = src[:, b, j * 128:(j + 1) * 128]
                dst[:, b, table[b, j], :seg.shape[1]] = seg
        out[pool] = dst
    return {"layers": out}


def _setup(models, n_tokens, seed):
    jm, np_params, tm, _, _ = models
    specs = jm.cache_specs(JaxShape("serve", "decode", MAX_SEQ, BATCH))
    n_pool = specs["layers"]["k_pool"].shape[2]
    mb = -(-MAX_SEQ // 128) + 1
    fe, toks = _inputs(tm.cfg, seed, n_tokens)
    return (jax.tree.map(jnp.asarray, np_params),
            params_from_numpy(np_params, "cpu"), fe, toks, specs,
            _block_table(n_pool, mb, seed))


def test_spec_tree_and_bridge_cover_every_vlm_leaf(models):
    jm, np_params, tm, _, _ = models
    bridged = _leaves(params_from_numpy(np_params, "cpu"))
    src = _leaves(np_params)
    assert bridged.keys() == src.keys()
    for path, a in src.items():
        np.testing.assert_array_equal(bridged[path].numpy(), a)
    js, ts = _leaves(jm.param_specs), _leaves(tm.param_specs)
    assert js.keys() == ts.keys()
    for p in js:
        assert ts[p].shape == js[p].shape and ts[p].axes == js[p].axes, p
        assert (ts[p].init, ts[p].scale) == (js[p].init, js[p].scale), p
    assert tm.n_params() == jm.n_params()
    full = Model(ARCHS[ARCH], device="cpu")
    assert full.n_params() == JaxModel(JAX_ARCHS[ARCH]).n_params()
    shape = ShapeConfig("serve", "decode", MAX_SEQ, BATCH)
    jc, tc = _leaves(jm.cache_specs(shape)), _leaves(tm.cache_specs(shape))
    assert {p: s.shape for p, s in jc.items()} == {
        p: s.shape for p, s in tc.items()}
    assert tm.uses_block_table() and jm.uses_block_table()


@pytest.mark.parametrize("arch", [ARCH, "seamless-m4t-medium",
                                  "qwen2-0.5b", "zamba2-7b",
                                  "mixtral-8x7b"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_input_specs_match_jax(arch, kind):
    for cfg_of in (lambda c: c, smoke_config):
        jm = JaxModel(cfg_of(JAX_ARCHS[arch]))
        tm = Model(cfg_of(ARCHS[arch]), device="cpu")
        js = jm.input_specs(JaxShape("t", kind, 4096, 3))
        ts = tm.input_specs(ShapeConfig("t", kind, 4096, 3))
        assert js.keys() == ts.keys()
        for k in js:
            assert ts[k].shape == js[k].shape, (k, ts[k].shape)
            assert ts[k].axes == js[k].axes, k
            assert ts[k].init == js[k].init, k
            assert (str(ts[k].dtype)
                    == f"torch.{jnp.dtype(js[k].dtype).name}"), k


def test_prefill_logits_and_kv_match_jax(models):
    jm, _, tm, jpre, _ = models
    jp, tp, fe, toks, _, _ = _setup(models, N_TOKENS, 1)
    jl, jc = jpre(jp, {"frontend_embeds": jnp.asarray(fe),
                       "tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, {"frontend_embeds": torch.from_numpy(fe),
                             "tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert tc.keys() == jc.keys() == {"k", "v"}
    P = tm.cfg.frontend_positions
    for k in jc:
        assert tuple(tc[k].shape) == jc[k].shape
        assert tc[k].shape[2] == P + N_TOKENS
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), **TOL,
                                   err_msg=k)
    # the frontend embeddings matter: other ones give other logits
    tl2, _ = tm.prefill(tp, {"frontend_embeds": torch.from_numpy(fe * 3),
                             "tokens": torch.from_numpy(toks)})
    assert not torch.allclose(tl, tl2)


def test_decode_step_on_permuted_tables_matches_jax(models):
    jm, _, tm, jpre, jdec = models
    jp, tp, fe, toks, specs, table = _setup(models, N_TOKENS + 1, 2)
    S = tm.cfg.frontend_positions + N_TOKENS
    _, jpc = jpre(jp, {"frontend_embeds": jnp.asarray(fe),
                       "tokens": jnp.asarray(toks[:, :-1])})
    np_cache = load_decode_cache(specs, jpc, table)
    batch = {"tokens": toks[:, -1:], "lengths": np.full((BATCH,), S,
                                                         np.int32),
             "block_table": table}
    jl, jc = jdec(jp, jax.tree.map(jnp.asarray, np_cache),
                  jax.tree.map(jnp.asarray, batch))
    tcache = cache_from_numpy(np_cache, "cpu")
    tl, tc = tm.decode_step(tp, tcache, {k: torch.from_numpy(v)
                                         for k, v in batch.items()})
    assert tc is tcache  # updated in place
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for name in ("k_pool", "v_pool"):
        np.testing.assert_allclose(tc["layers"][name].numpy(),
                                   np.asarray(jc["layers"][name]), **TOL)


def _teacher_forcing(model, params, fe, toks, specs, table, bridge, pre,
                     dec):
    """Prefill of t tokens (after the frontend) plus one decode step of
    token t, and the prefill of t + 1 tokens: both last logits."""
    t = toks.shape[1] - 1
    _, pc = pre(params, bridge({"frontend_embeds": fe, "tokens":
                                toks[:, :t]}))
    cache = bridge(load_decode_cache(specs, pc, table))
    got, _ = dec(params, cache, bridge({
        "tokens": toks[:, t:],
        "lengths": np.full((BATCH,), fe.shape[1] + t, np.int32),
        "block_table": table}))
    want, _ = pre(params, bridge({"frontend_embeds": fe, "tokens": toks}))
    return np.asarray(got), np.asarray(want)


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_prefill_then_decode_equals_longer_prefill(models, package):
    jm, _, tm, jpre, jdec = models
    jp, tp, fe, toks, specs, table = _setup(models, 121, 3)
    if package == "jax":
        got, want = _teacher_forcing(jm, jp, fe, toks, specs, table,
                                     lambda t: jax.tree.map(jnp.asarray, t),
                                     jpre, jdec)
    else:
        got, want = _teacher_forcing(
            tm, tp, fe, toks, specs, table,
            lambda t: cache_from_numpy(jax.tree.map(np.asarray, t), "cpu"),
            tm.prefill, tm.decode_step)
    np.testing.assert_allclose(got, want, **TOL)


def test_greedy_tokens_match_jax(models):
    jm, _, tm, jpre, jdec = models
    jp, tp, fe, toks, specs, table = _setup(models, N_TOKENS, 4)
    S = tm.cfg.frontend_positions + N_TOKENS
    jl, jpc = jpre(jp, {"frontend_embeds": jnp.asarray(fe),
                        "tokens": jnp.asarray(toks)})
    tl, tpc = tm.prefill(tp, {"frontend_embeds": torch.from_numpy(fe),
                              "tokens": torch.from_numpy(toks)})
    jc = jax.tree.map(jnp.asarray, load_decode_cache(specs, jpc, table))
    tc = cache_from_numpy(load_decode_cache(
        specs, {k: v.numpy() for k, v in tpc.items()}, table), "cpu")
    jt, tt = [], []
    for step in range(8):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        jnext = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        tnext = tl.argmax(-1).to(torch.int32)
        jt.append(jnext.tolist())
        tt.append(tnext.tolist())
        lengths = np.full((BATCH,), S + step, np.int32)
        jl, jc = jdec(jp, jc, {"tokens": jnp.asarray(jnext)[:, None],
                               "lengths": jnp.asarray(lengths),
                               "block_table": jnp.asarray(table)})
        tl, tc = tm.decode_step(tp, tc, {
            "tokens": tnext[:, None], "lengths": torch.from_numpy(lengths),
            "block_table": torch.from_numpy(table)})
    assert tt == jt
