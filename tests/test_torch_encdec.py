"""The port's encoder-decoder family against the JAX package on the same
numpy inputs: the plain contiguous decode attention against JAX's oracle
and the Pallas body in interpret mode, the plain per-slot paged attention
against the Pallas body, non-causal flash attention with S_q != S_kv
against the Pallas body, and smoke-width seamless-m4t-medium (2 encoder
+ 2 decoder layers, d_model 128, 4 query heads over 2 kv heads of 32,
f32) through prefill, decode, teacher forcing and a greedy loop on
bridged weights.

Tolerances, f32: the kernels' plain versions at rtol = atol = 2e-5, as
tests/test_kernels.py holds the Pallas bodies to the oracles; the model
(logits, caches) at rtol = atol = 1e-4, as tests/test_torch_model.py
holds the dense model: XLA and PyTorch sum the projections and the
attention in different orders.  The model runs on *conditioned*
attention weights (the seeded JAX init, attention projections rescaled
to unit variance over their true contraction, as ``chip_smoke.py`` does
at full width): the seeded init makes every head a near-hard argmax that
amplifies those reorderings about a hundredfold (PERF.md, section 4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import smoke_config as jax_smoke
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.paged_attention import (decode_attention_pallas,
                                           paged_attention_pallas)
from repro.models import Model as JaxModel
from repro_torch.configs import ARCHS, ShapeConfig, smoke_config
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.decode_attention import decode_attention_kernel
from repro_torch.models import Model, cache_from_numpy, params_from_numpy

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

KERNEL_TOL = dict(rtol=2e-5, atol=2e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "seamless-m4t-medium"
BATCH, ENC_FRAMES, MAX_SEQ = 2, 200, 256


def _rand(rs, shape, scale=0.3):
    return (rs.standard_normal(shape) * scale).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# ---------------------------------------------------------------------------
# the kernels' plain versions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize(
    "B,S_max,H,Hkv,D,lengths",
    [
        (4, 256, 4, 2, 32, [0, 1, 129, 256]),    # smoke group G = 2
        (3, 384, 14, 2, 64, [256, 0, 383]),      # qwen2 group G = 7
        (2, 128, 16, 16, 64, [128, 5]),          # seamless G = 1, one tile
    ],
)
def test_plain_decode_attention_matches_jax(B, S_max, H, Hkv, D, lengths):
    """Lengths 0 (uniform weights over all S_max rows), 1, off and on
    tile boundaries, and S_max."""
    rs = np.random.RandomState(B + S_max + H)
    q = _rand(rs, (B, H, D))
    k = _rand(rs, (B, S_max, Hkv, D))
    v = _rand(rs, (B, S_max, Hkv, D))
    lens = np.asarray(lengths, np.int32)
    got = ops.decode_attention(*_t(q, k, v, lens))
    assert torch.equal(got, tref.decode_attention(*_t(q, k, v, lens)))
    for want in (jref.decode_attention(*_j(q, k, v, lens)),
                 decode_attention_pallas(*_j(q, k, v, lens),
                                         interpret=True)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **KERNEL_TOL)


@pytest.mark.parametrize("B,n_pool,mb,H,Hkv,D,n_kv",
                         [(3, 5, 4, 4, 2, 32, 3), (2, 4, 3, 16, 16, 64, 3)])
def test_plain_per_slot_paged_matches_pallas(B, n_pool, mb, H, Hkv, D,
                                             n_kv):
    """Per-slot (local) page ids from a different permutation in each
    row: reading row b's pages from another slot's pool would show."""
    rs = np.random.RandomState(20 + B + H)
    q = _rand(rs, (B, H, D))
    kp = _rand(rs, (B, n_pool, 128, Hkv, D))
    vp = _rand(rs, (B, n_pool, 128, Hkv, D))
    table = np.stack([rs.permutation(n_pool)[:mb]
                      for _ in range(B)]).astype(np.int32)
    assert len({tuple(r) for r in table}) == B
    lengths = rs.randint(1, n_kv * 128, (B,)).astype(np.int32)
    lengths[-1] = 0
    got = ops.paged_attention(*_t(q, kp, vp, table, lengths), n_kv=n_kv)
    want = paged_attention_pallas(*_j(q, kp, vp, table, lengths), n_kv=n_kv,
                                  global_pages=False, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL_TOL)


@pytest.mark.parametrize("S_q,S_kv", [(128, 256), (256, 256)])
def test_plain_noncausal_flash_matches_pallas(S_q, S_kv):
    """The encoder's self-attention (S_q = S_kv) and the decoder's
    cross-attention (S_q != S_kv), bidirectional."""
    rs = np.random.RandomState(S_q + S_kv)
    q = _rand(rs, (2, S_q, 4, 32))
    k = _rand(rs, (2, S_kv, 2, 32))
    v = _rand(rs, (2, S_kv, 2, 32))
    got = ops.flash_attention(*_t(q, k, v), causal=False)
    want = flash_attention_pallas(*_j(q, k, v), causal=False,
                                  interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL_TOL)


def test_decode_kernel_wrapper_refuses_cpu_tensors():
    q, k = torch.zeros((1, 2, 32)), torch.zeros((1, 128, 2, 32))
    lens = torch.ones((1,), dtype=torch.int32)
    before = decode_attention_kernel.launches
    with pytest.raises(ValueError):
        decode_attention_kernel(q, k, k, lens)
    ops.decode_attention(q, k, k, lens)  # CPU tensors: the plain version
    assert decode_attention_kernel.launches == before


# ---------------------------------------------------------------------------
# the model on bridged weights
# ---------------------------------------------------------------------------
def _condition(np_params, cfg):
    """Attention projections rescaled to unit variance over their true
    contraction (d_model for q/k/v, heads x head_dim for the output)."""
    M, H, Hkv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    for tree, key in ((np_params["enc_layers"], "attn"),
                      (np_params["dec_layers"], "self_attn"),
                      (np_params["dec_layers"], "cross_attn")):
        a = dict(tree[key])
        a["wq"] = (a["wq"] * np.sqrt(H / M)).astype(np.float32)
        a["wk"] = (a["wk"] * np.sqrt(Hkv / M)).astype(np.float32)
        a["wv"] = (a["wv"] * np.sqrt(Hkv / M)).astype(np.float32)
        a["wo"] = (a["wo"] / np.sqrt(H)).astype(np.float32)
        tree[key] = a
    return np_params


@pytest.fixture(scope="module")
def models():
    jm = JaxModel(jax_smoke(JAX_ARCHS[ARCH]))
    np_params = _condition(jax.tree.map(np.asarray, jm.init_params(0)),
                           jm.cfg)
    tm = Model(smoke_config(ARCHS[ARCH]), device="cpu")
    return jm, np_params, tm


def _inputs(seed, n_tokens, vocab):
    """Seeded frame embeddings (normal x 0.02, as the JAX package's
    ``Model.synthetic_batch``) and decoder tokens."""
    rs = np.random.RandomState(seed)
    enc = _rand(rs, (BATCH, ENC_FRAMES, 128), scale=0.02)
    toks = rs.randint(1, vocab, (BATCH, n_tokens)).astype(np.int32)
    return enc, toks


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _block_table(n_pool, mb, seed):
    """Per-slot page ids: a different permutation of pages 1.. in each
    row (page 0 is the scratch page)."""
    rs = np.random.RandomState(seed)
    return np.stack([1 + rs.permutation(n_pool - 1)[:mb]
                     for _ in range(BATCH)]).astype(np.int32)


def load_decode_cache(specs, pcache, table):
    """The prefill cache in the decode cache's layout, as numpy: each
    row's self-attention K/V written page by page into the pages its
    block-table row names (the last page zero-padded), the encoder
    output's K/V into the first rows of the cross cache, and ``enc_len``
    set to the encoder length."""
    cache = {p: np.zeros(s.shape, np.dtype(jnp.dtype(s.dtype)))
             for p, s in _leaves(specs).items()}
    S = pcache["self_k"].shape[2]
    for name, pool in (("self_k", "/self/k_pool"), ("self_v", "/self/v_pool")):
        for b in range(BATCH):
            for j in range(-(-S // 128)):
                seg = np.asarray(pcache[name])[:, b, j * 128:(j + 1) * 128]
                cache[pool][:, b, table[b, j], :seg.shape[1]] = seg
    n_enc = pcache["cross_k"].shape[2]
    cache["/cross_k"][:, :, :n_enc] = np.asarray(pcache["cross_k"])
    cache["/cross_v"][:, :, :n_enc] = np.asarray(pcache["cross_v"])
    cache["/enc_len"][:] = n_enc
    return {"self": {"k_pool": cache["/self/k_pool"],
                     "v_pool": cache["/self/v_pool"]},
            "cross_k": cache["/cross_k"], "cross_v": cache["/cross_v"],
            "enc_len": cache["/enc_len"]}


def _setup(models, n_tokens, seed):
    """Both packages' bridged params, inputs, decode cache specs and a
    per-slot block table."""
    jm, np_params, tm = models
    shape = ShapeConfig("serve", "decode", MAX_SEQ, BATCH)
    specs = jm.cache_specs(shape)
    n_pool = specs["self"]["k_pool"].shape[2]
    mb = -(-MAX_SEQ // 128) + 1
    enc, toks = _inputs(seed, n_tokens, tm.cfg.vocab_size)
    return (jax.tree.map(jnp.asarray, np_params),
            params_from_numpy(np_params, "cpu"), enc, toks, specs,
            _block_table(n_pool, mb, seed))


def test_bridge_and_cache_specs_cover_every_encdec_leaf(models):
    """Every param leaf (enc_layers, dec_layers, enc_norm, ...) bridges
    unchanged and the port declares the same tree; the decode cache has
    the same leaves, shapes and dtypes (the int32 ``enc_len`` too) and a
    JAX cache bridges leaf for leaf."""
    jm, np_params, tm = models
    bridged = _leaves(params_from_numpy(np_params, "cpu"))
    src = _leaves(np_params)
    assert bridged.keys() == src.keys()
    assert {p.split("/")[1] for p in src} == {
        "embed", "enc_layers", "enc_norm", "dec_layers", "final_norm"}
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
    assert tc["/cross_k"].shape[2] == 4096
    assert tm.uses_block_table() == jm.uses_block_table()
    jcache = jax.tree.map(np.asarray, jm.init_cache(shape))
    tcache = _leaves(cache_from_numpy(jcache, "cpu"))
    for path, a in _leaves(jcache).items():
        assert tcache[path].numpy().dtype == a.dtype, path
        np.testing.assert_array_equal(tcache[path].numpy(), a)


def test_prefill_logits_and_caches_match_jax(models):
    jm, _, tm = models
    jp, tp, enc, toks, _, _ = _setup(models, 130, 1)
    jl, jc = jm.prefill(jp, {"enc_embeds": jnp.asarray(enc),
                             "tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, {"enc_embeds": torch.from_numpy(enc),
                             "tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert tc.keys() == jc.keys() == {"self_k", "self_v", "cross_k",
                                      "cross_v"}
    for k in jc:
        assert tuple(tc[k].shape) == jc[k].shape, k
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), **TOL,
                                   err_msg=k)


def test_decode_step_matches_jax(models):
    """One shared loaded cache (130 decoder tokens: the next token lands
    on the second page), per-slot tables by default in both packages:
    logits, the self-attention pools, and the cross cache untouched."""
    jm, _, tm = models
    jp, tp, enc, toks, specs, table = _setup(models, 131, 2)
    _, jpc = jm.prefill(jp, {"enc_embeds": jnp.asarray(enc),
                             "tokens": jnp.asarray(toks[:, :130])})
    np_cache = load_decode_cache(specs, jpc, table)
    batch = {"tokens": toks[:, 130:], "lengths":
             np.full((BATCH,), 130, np.int32), "block_table": table}
    jl, jc = jm.decode_step(jp, jax.tree.map(jnp.asarray, np_cache),
                            jax.tree.map(jnp.asarray, batch))
    tcache = cache_from_numpy(np_cache, "cpu")
    tl, tc = tm.decode_step(tp, tcache, {k: torch.from_numpy(v)
                                         for k, v in batch.items()})
    assert tc is tcache  # updated in place
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for name in ("k_pool", "v_pool"):
        np.testing.assert_allclose(tc["self"][name].numpy(),
                                   np.asarray(jc["self"][name]), **TOL)
    for name in ("cross_k", "cross_v", "enc_len"):
        np.testing.assert_array_equal(tc[name].numpy(), np_cache[name])
        np.testing.assert_array_equal(np.asarray(jc[name]), np_cache[name])


def _teacher_forcing(model, params, enc, toks, specs, table, bridge):
    """Prefill of t tokens plus one decode step of token t, and the
    prefill of t + 1 tokens: both last logits."""
    t = toks.shape[1] - 1
    _, pc = model.prefill(params, bridge({"enc_embeds": enc,
                                          "tokens": toks[:, :t]}))
    cache = bridge(load_decode_cache(specs, pc, table))
    got, _ = model.decode_step(params, cache, bridge({
        "tokens": toks[:, t:], "lengths": np.full((BATCH,), t, np.int32),
        "block_table": table}))
    want, _ = model.prefill(params, bridge({"enc_embeds": enc,
                                            "tokens": toks}))
    return np.asarray(got), np.asarray(want)


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_prefill_then_decode_equals_longer_prefill(models, package):
    """Teacher forcing: prefill 127 decoder tokens + one decode step of
    token 127 gives the logits of a prefill of 128 tokens, in each
    package (the JAX package's own arch test skips the enc-dec family)."""
    jm, _, tm = models
    jp, tp, enc, toks, specs, table = _setup(models, 128, 3)
    if package == "jax":
        got, want = _teacher_forcing(jm, jp, enc, toks, specs, table,
                                     lambda t: jax.tree.map(jnp.asarray, t))
    else:
        got, want = _teacher_forcing(tm, tp, enc, toks, specs, table,
                                     lambda t: cache_from_numpy(
                                         jax.tree.map(np.asarray, t), "cpu"))
    np.testing.assert_allclose(got, want, **TOL)


def test_greedy_tokens_match_jax(models):
    """Prefill, load the decode cache, 8 greedy decode steps: the same
    tokens as the JAX model's loop, and logits within tolerance."""
    jm, _, tm = models
    jp, tp, enc, toks, specs, table = _setup(models, 126, 4)
    jl, jpc = jm.prefill(jp, {"enc_embeds": jnp.asarray(enc),
                              "tokens": jnp.asarray(toks)})
    tl, tpc = tm.prefill(tp, {"enc_embeds": torch.from_numpy(enc),
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
        lengths = np.full((BATCH,), 126 + step, np.int32)
        jl, jc = jm.decode_step(jp, jc, {
            "tokens": jnp.asarray(jnext)[:, None],
            "lengths": jnp.asarray(lengths),
            "block_table": jnp.asarray(table)})
        tl, tc = tm.decode_step(tp, tc, {
            "tokens": tnext[:, None], "lengths": torch.from_numpy(lengths),
            "block_table": torch.from_numpy(table)})
    assert tt == jt
