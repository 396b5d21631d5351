"""The port's MoE family (mixtral) against the JAX package on the same
numpy inputs, at the JAX smoke config: 2 layers, d_model 128, 4 query
heads over 2 kv heads of 32, 4 experts top-2 of d_ff 256, sliding window
16, f32.  Checked: ``apply_moe`` dropless, at capacity 1.25 where tokens
are dropped, with tied router columns (the top-k order on ties), and at
granite-moe-3b-a800m's routing (40 experts, top-8, capacity 1.25) in f32
and bf16; its combine (``combine_pairs``) bit for bit against the JAX
package's scatter-add at top-8 of 40 and top-2 of 4; the
spec trees and the weight bridge; the prefill logits and every cache
leaf; the rolling cache loaded from a prefill past its wrap and decode
steps on it (logits and every ring leaf), and the contiguous cache that a
sequence shorter than the window gets; teacher forcing in both packages;
8 greedy tokens; the plain flash attention with a window against the
Pallas body in interpret mode; and the dense qwen2 ``Model.prefill``,
which runs the same decoder stack.

Tolerances, f32: logits at rtol = atol = 1e-4, as tests/test_torch_model.py
holds the dense model (XLA and PyTorch sum the projections in different
orders); cache leaves at rtol 1e-4 and an absolute 1e-4 of the leaf's
largest magnitude, as there.  The attention projections are conditioned
(rescaled to unit variance over their true contraction, as
``chip_smoke.conditioned`` does): the seeded init makes every head a
near-hard argmax that amplifies the reorderings (ROADMAP Queue C).  The
smoke config is dropless (capacity factor 4 = E), as the JAX package
sets it for teacher forcing: a prefill that drops tokens computes
another function than the decode steps, which never drop.

The JAX model's prefill and decode step, and ``apply_moe``, run under
``jax.jit``: the same functions, compiled once a shape rather than
dispatched op by op (about a second a call on the CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import smoke_config as jax_smoke
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import Model as JaxModel
from repro.models import layers as JL
from repro_torch.configs import ARCHS, ShapeConfig, smoke_config
from repro_torch.kernels import ref
from repro_torch.models import Model, cache_from_numpy, params_from_numpy
from repro_torch.models import layers as TL

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "mixtral-8x7b"
BATCH = 2
#: prompt length past the smoke window (16): the ring has wrapped twice
SEQ = 40
#: decode cache rows: the window, so the cache is a ring
MAX_SEQ = 64


def _condition(np_params, cfg):
    a = dict(np_params["layers"]["attn"])
    M, H, Hkv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    a["wq"] = (a["wq"] * np.sqrt(H / M)).astype(np.float32)
    a["wk"] = (a["wk"] * np.sqrt(Hkv / M)).astype(np.float32)
    a["wv"] = (a["wv"] * np.sqrt(Hkv / M)).astype(np.float32)
    a["wo"] = (a["wo"] / np.sqrt(H)).astype(np.float32)
    return dict(np_params, layers=dict(np_params["layers"], attn=a))


class _Jitted:
    """A JAX ``Model`` whose ``prefill`` and ``decode_step`` are jitted;
    every other attribute is the model's own."""

    def __init__(self, model):
        self._model = model
        self.prefill = jax.jit(model.prefill)
        self.decode_step = jax.jit(model.decode_step)

    def __getattr__(self, name):
        return getattr(self._model, name)


@pytest.fixture(scope="module")
def models():
    jm = _Jitted(JaxModel(jax_smoke(JAX_ARCHS[ARCH])))
    np_params = jax.tree.map(np.asarray, jm.init_params(0))
    np_params = _condition(np_params, jm.cfg)
    tm = Model(smoke_config(ARCHS[ARCH]), device="cpu")
    return (jm, tm, jax.tree.map(jnp.asarray, np_params),
            params_from_numpy(np_params, "cpu"), np_params)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


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


def _tokens(seed, n, vocab):
    return np.random.RandomState(seed).randint(1, vocab, (BATCH, n)).astype(
        np.int32)


def load_ring(shape_cfg, model, pcache):
    """A prefill cache {"k", "v": (L, B, S, Hkv, D)} in the decode cache's
    layout, as numpy: the last W positions, position p in row p % W of
    the ring (or rows 0 .. S-1 of a contiguous cache, W >= S)."""
    specs = model.cache_specs(shape_cfg)["layers"]
    out = {}
    for name in ("k", "v"):
        kv = np.asarray(pcache[name])
        W, S = specs[name].shape[2], kv.shape[2]
        n = min(S, W)
        ring = np.zeros(specs[name].shape, np.float32)
        ring[:, :, np.arange(S - n, S) % W] = kv[:, :, S - n:]
        out[name] = ring
    return {"layers": out}


# ---------------------------------------------------------------------------
# apply_moe
# ---------------------------------------------------------------------------
def _moe_case(case):
    """(cfg for both packages, numpy params of one MoE layer, x)."""
    jcfg = jax_smoke(JAX_ARCHS[ARCH])
    tcfg = smoke_config(ARCHS[ARCH])
    if case == "top8":
        # granite-moe-3b-a800m's routing: 40 experts, top-8, capacity
        # 1.25 (C = 32 of the 256 pairs an expert could take at S 128)
        top8 = dict(num_experts=40, experts_per_token=8,
                    moe_capacity_factor=1.25)
        jcfg, tcfg = jcfg.scaled(**top8), tcfg.scaled(**top8)
    rs = np.random.RandomState(11)
    M, E, Fd = jcfg.d_model, jcfg.num_experts, jcfg.d_ff
    p = {"router": rs.standard_normal((M, E)) / np.sqrt(M),
         "wi_gate": rs.standard_normal((E, M, Fd)) / np.sqrt(M),
         "wi_up": rs.standard_normal((E, M, Fd)) / np.sqrt(M),
         "wo": rs.standard_normal((E, Fd, M)) / np.sqrt(Fd)}
    S = 128 if case == "top8" else 24
    x = rs.standard_normal((BATCH, S, M))
    if case == "capacity":
        # capacity 1.25 at S 64 (C = 40 of 128 pairs an expert could
        # take); the tokens share a common component, so that most pick
        # the same two experts and those overflow
        jcfg = jcfg.scaled(moe_capacity_factor=1.25)
        tcfg = tcfg.scaled(moe_capacity_factor=1.25)
        S = 64
        x = rs.standard_normal((1, 1, M)) * 2 + rs.standard_normal(
            (BATCH, S, M)) * 0.5
    elif case == "tied":
        # integer inputs and a router of small integers with columns 1
        # and 3 copies of 0 and 2: every logit is exact, and each tie is
        # exact in both packages
        x = rs.randint(-2, 3, (BATCH, S, M)).astype(np.float64)
        r = rs.randint(-1, 2, (M, E)).astype(np.float64) / 8
        r[:, 1], r[:, 3] = r[:, 0], r[:, 2]
        p["router"] = r
    p = {k: v.astype(np.float32) for k, v in p.items()}
    return jcfg, tcfg, p, x.astype(np.float32)


@pytest.mark.parametrize("case", ["dropless", "capacity", "tied", "top8"])
def test_apply_moe_matches_jax(case):
    jcfg, tcfg, p, x = _moe_case(case)
    want = jax.jit(JL.apply_moe, static_argnums=2)(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), jcfg)
    tp, tx = params_from_numpy(p, "cpu"), torch.from_numpy(x)
    got = TL.apply_moe(tp, tx, tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    B, S, _ = x.shape
    E, k = tcfg.num_experts, tcfg.experts_per_token
    C = min(max(int(tcfg.moe_capacity_factor * S * k / E), k), S * k)
    gate_w, ids = TL.moe_route(tp, tx, tcfg)
    counts = np.stack([np.bincount(r, minlength=E)
                       for r in ids.reshape(B, -1).numpy()])
    dropped = int(np.maximum(counts - C, 0).sum())
    # the router's choice and weights are JAX's top_k, ties included
    logits = jnp.einsum("bsm,me->bse", jnp.asarray(x), jnp.asarray(
        p["router"]))
    jw, jids = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(
        gate_w.numpy(), np.asarray(jw / jw.sum(-1, keepdims=True)), **TOL)
    if case in ("capacity", "top8"):
        assert dropped > 0
    else:
        assert dropped == 0
    if case == "tied":
        # ties at the k-th place: a tied pair split by the cut
        probs = torch.softmax(torch.from_numpy(x) @ torch.from_numpy(
            p["router"]), -1)
        srt = probs.sort(-1, descending=True).values
        assert bool((srt[..., k - 1] == srt[..., k]).any())


def test_apply_moe_top8_bf16_matches_jax():
    """granite-moe's routing (40 experts, top-8, capacity 1.25) in bf16,
    the dtype the engine serves in: the router picks the JAX package's
    experts, and the output is within 2e-2 of the largest magnitude of
    JAX's (the two sum each product in another order and round it to
    bf16; the combine's own bits are held by the test below)."""
    jcfg, tcfg, p, x = _moe_case("top8")
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in p.items()}
    jx = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jax.jit(JL.apply_moe, static_argnums=2)(
        jp, jx, jcfg).astype(jnp.float32))
    tp = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(
        torch.bfloat16) for k, v in jp.items()}
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        torch.bfloat16)
    got = TL.apply_moe(tp, tx, tcfg)
    assert got.dtype == torch.bfloat16
    logits = jnp.einsum("bsm,me->bse", jx, jp["router"])
    _, jids = jax.lax.top_k(jax.nn.softmax(logits.astype(jnp.float32),
                                           axis=-1), 8)
    np.testing.assert_array_equal(TL.moe_route(tp, tx, tcfg)[1].numpy(),
                                  np.asarray(jids))
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-2 * scale)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("E,k", [(40, 8), (4, 2)])
def test_combine_pairs_sums_in_jax_scatter_order(E, k, dtype):
    """``combine_pairs`` against the JAX package's scatter-add of the same
    expert-sorted pair outputs, bit for bit: each token's k outputs are
    summed in ascending expert order, each add rounded to the dtype.  The
    outputs span 2^-8 .. 2^8 in magnitude, so that at k 8 one rounding of
    the f32 sum gives other bits (checked), as another order would."""
    rs = np.random.RandomState(3)
    B, S, M = 2, 128, 64
    ids = np.stack([[rs.permutation(E)[:k] for _ in range(S)]
                    for _ in range(B)])
    order = np.argsort(ids.reshape(B, S * k), -1, kind="stable")
    sorted_tok = np.take_along_axis(
        np.broadcast_to(np.repeat(np.arange(S), k), (B, S * k)), order, -1)
    contrib = jnp.asarray(rs.standard_normal((B, S * k, M)) * np.exp2(
        rs.randint(-8, 9, (B, S * k, 1))), jnp.dtype(dtype))
    want = jax.jit(lambda c: jnp.zeros((B, S, M), c.dtype).at[
        np.arange(B)[:, None], sorted_tok].add(c))(contrib)
    want = np.asarray(want.astype(jnp.float32))
    tc = torch.from_numpy(np.array(contrib.astype(jnp.float32))).to(
        getattr(torch, dtype))
    got = TL.combine_pairs(tc, torch.from_numpy(ids), torch.from_numpy(order))
    assert got.dtype == tc.dtype
    np.testing.assert_array_equal(got.float().numpy(), want)
    if k == 8 and dtype == "bfloat16":
        once = torch.zeros((B * S, M)).index_add_(
            0, torch.from_numpy((np.arange(B)[:, None] * S
                                 + sorted_tok).reshape(-1)),
            tc.float().reshape(-1, M)).view(B, S, M).to(tc.dtype)
        assert bool((once != got).any())


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
def test_bridge_and_specs_cover_every_moe_leaf(models):
    """Every param leaf (the router (L, M, E) and experts (L, E, M, F) /
    (L, E, F, M) among them) bridges unchanged and the port declares the
    same tree; the rolling cache has the same leaves, shapes and dtypes,
    and a JAX cache bridges leaf for leaf."""
    jm, tm, _, _, np_params = models
    bridged = _leaves(params_from_numpy(np_params, "cpu"))
    src = _leaves(np_params)
    assert bridged.keys() == src.keys()
    cfg = tm.cfg
    L, M, E, Fd = cfg.num_layers, cfg.d_model, cfg.num_experts, cfg.d_ff
    assert src["/layers/moe/router"].shape == (L, M, E)
    assert src["/layers/moe/wi_gate"].shape == (L, E, M, Fd)
    assert src["/layers/moe/wo"].shape == (L, E, Fd, M)
    for path, a in src.items():
        np.testing.assert_array_equal(bridged[path].numpy(), a)
    specs = _leaves(tm.param_specs)
    assert {p: tuple(s.shape) for p, s in specs.items()} == {
        p: a.shape for p, a in src.items()}
    assert tm.n_params() == jm.n_params()
    for seq in (MAX_SEQ, 12):  # a ring, and a cache under the window
        shape = ShapeConfig("serve", "decode", seq, BATCH)
        jc, tc = _leaves(jm.cache_specs(shape)), _leaves(tm.cache_specs(shape))
        assert jc.keys() == tc.keys() == {"/layers/k", "/layers/v"}
        for path in jc:
            assert tuple(tc[path].shape) == tuple(jc[path].shape), path
            assert (str(tc[path].dtype)
                    == f"torch.{jnp.dtype(jc[path].dtype).name}"), path
        assert tc["/layers/k"].shape[2] == min(cfg.sliding_window, seq)
        jcache = jax.tree.map(np.asarray, jm.init_cache(shape))
        tcache = _leaves(cache_from_numpy(jcache, "cpu"))
        for path, a in _leaves(jcache).items():
            np.testing.assert_array_equal(tcache[path].numpy(), a)
    assert tm.uses_block_table() == jm.uses_block_table() is False


def test_prefill_logits_and_caches_match_jax(models):
    """A prefill of 40 tokens (2.5 windows): the logits, every layer's K
    and V, and the ring loaded from them."""
    jm, tm, jp, tp, _ = models
    toks = _tokens(1, SEQ, tm.cfg.vocab_size)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert tc.keys() == jc.keys() == {"k", "v"}
    assert tc["k"].shape == (tm.cfg.num_layers, BATCH, SEQ, 2, 32)
    _assert_tree(tc, jc)
    shape = ShapeConfig("serve", "decode", MAX_SEQ, BATCH)
    _assert_tree(load_ring(shape, tm, tc), load_ring(shape, tm, jc))


@pytest.mark.parametrize("max_seq", [MAX_SEQ, 12], ids=["ring", "contig"])
def test_decode_steps_match_jax(models, max_seq):
    """Decode steps on a loaded cache in both packages, logits and every
    leaf after each step.  The ring (W 16) starts from a 40-token
    prefill, so each step overwrites the slot of the position that left
    the window; the contiguous cache (12 rows, under the window) starts
    from 8 tokens and fills rows 8 .. 11."""
    jm, tm, jp, tp, _ = models
    S = SEQ if max_seq == MAX_SEQ else 8
    toks = _tokens(2, S + 4, tm.cfg.vocab_size)
    _, jpc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :S])})
    shape = ShapeConfig("serve", "decode", max_seq, BATCH)
    np_cache = load_ring(shape, tm, jpc)
    jc = jax.tree.map(jnp.asarray, np_cache)
    tcache = cache_from_numpy(np_cache, "cpu")
    for t in range(S, S + 4):
        lengths = np.full((BATCH,), t, np.int32)
        jl, jc = jm.decode_step(jp, jc, {
            "tokens": jnp.asarray(toks[:, t:t + 1]),
            "lengths": jnp.asarray(lengths)})
        tl, tc = tm.decode_step(tp, tcache, {
            "tokens": torch.from_numpy(toks[:, t:t + 1]),
            "lengths": torch.from_numpy(lengths)})
        assert tc is tcache  # updated in place
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _assert_tree(tc, jc)


def _teacher_forcing(model, params, toks, bridge, n=4):
    """A prefill of S tokens, the ring loaded, n decode steps of the next
    tokens; against the prefill of all S + n tokens, its logits at each
    step's position (``last_index``: causal and dropless, so the logits
    at position t are those of a prefill of t + 1 tokens)."""
    S = toks.shape[1] - n
    shape = ShapeConfig("serve", "decode", MAX_SEQ, BATCH)
    _, pc = model.prefill(params, bridge({"tokens": toks[:, :S]}))
    cache = bridge(load_ring(shape, model, jax.tree.map(np.asarray, pc)))
    got, want = [], []
    for t in range(S, S + n):
        lg, cache = model.decode_step(params, cache, bridge({
            "tokens": toks[:, t:t + 1],
            "lengths": np.full((BATCH,), t, np.int32)}))
        got.append(np.asarray(lg))
        lg, _ = model.prefill(params, bridge({
            "tokens": toks, "last_index": np.full((BATCH,), t, np.int32)}))
        want.append(np.asarray(lg))
    return np.stack(got), np.stack(want)


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_prefill_then_decode_equals_longer_prefill(models, package):
    """Teacher forcing past the ring's wrap: a prefill of 40 tokens and 4
    decode steps give the logits of a prefill of 44 tokens at positions
    40 .. 43, in each package."""
    jm, tm, jp, tp, _ = models
    toks = _tokens(3, SEQ + 4, tm.cfg.vocab_size)
    if package == "jax":
        got, want = _teacher_forcing(jm, jp, toks,
                                     lambda t: jax.tree.map(jnp.asarray, t))
    else:
        got, want = _teacher_forcing(
            tm, tp, toks,
            lambda t: cache_from_numpy(jax.tree.map(np.asarray, t), "cpu"))
    np.testing.assert_allclose(got, want, **TOL)


def test_greedy_tokens_match_jax(models):
    """Prefill, load the ring, 8 greedy decode steps: the same tokens as
    the JAX model's loop, and logits within tolerance."""
    jm, tm, jp, tp, _ = models
    toks = _tokens(4, SEQ, tm.cfg.vocab_size)
    shape = ShapeConfig("serve", "decode", MAX_SEQ, BATCH)
    jl, jpc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, tpc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    jc = jax.tree.map(jnp.asarray, load_ring(shape, tm, jpc))
    tc = cache_from_numpy(load_ring(shape, tm, tpc), "cpu")
    jt, tt = [], []
    for step in range(8):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        jnext = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        tnext = tl.argmax(-1).to(torch.int32)
        jt.append(jnext.tolist())
        tt.append(tnext.tolist())
        lengths = np.full((BATCH,), SEQ + step, np.int32)
        jl, jc = jm.decode_step(jp, jc, {
            "tokens": jnp.asarray(jnext)[:, None],
            "lengths": jnp.asarray(lengths)})
        tl, tc = tm.decode_step(tp, tc, {
            "tokens": tnext[:, None], "lengths": torch.from_numpy(lengths)})
    assert tt == jt


# ---------------------------------------------------------------------------
# the plain windowed flash attention against the Pallas body
# ---------------------------------------------------------------------------
@pytest.mark.parametrize(
    "S_q,S_kv,q_offset,window,causal",
    [(256, 256, 0, 1, True), (256, 256, 0, 63, True),
     (256, 256, 0, 100, True), (256, 256, 0, 129, True),
     (128, 384, 256, 100, True),   # a chunk at a q_offset
     (256, 256, 0, 100, False),    # a window without the causal mask
     (128, 128, 200, 64, True)],   # rows that see no key: every key
)
def test_plain_windowed_flash_matches_pallas(S_q, S_kv, q_offset, window,
                                             causal):
    """Windows that cut the Pallas body's 128-key blocks mid-block, with
    V rows that mark their position (so that the edge key's weight
    shows) and q scaled up for a peaked softmax."""
    rs = np.random.RandomState(window + q_offset)
    B, H, Hkv, D = 1, 4, 2, 32
    q = (rs.standard_normal((B, S_q, H, D)) * 3).astype(np.float32)
    k = rs.standard_normal((B, S_kv, Hkv, D)).astype(np.float32)
    v = rs.standard_normal((B, S_kv, Hkv, D)).astype(np.float32)
    v[..., 0] = np.arange(S_kv)[None, :, None] / S_kv
    want = flash_attention_pallas(*map(jnp.asarray, (q, k, v)),
                                  causal=causal, window=window,
                                  q_offset=q_offset, interpret=True)
    got = ref.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              causal=causal, window=window,
                              q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


# ---------------------------------------------------------------------------
# the dense family through the same decoder stack
# ---------------------------------------------------------------------------
def test_dense_prefill_matches_jax():
    """qwen2 at smoke width: ``Model.prefill`` (``run_decoder_stack``)
    logits and the K/V of every layer, against the JAX model."""
    jm = _Jitted(JaxModel(jax_smoke(JAX_ARCHS["qwen2-0.5b"])))
    np_params = jax.tree.map(np.asarray, jm.init_params(0))
    tm = Model(smoke_config(ARCHS["qwen2-0.5b"]), device="cpu")
    toks = _tokens(5, 48, tm.cfg.vocab_size)
    last = np.array([47, 30], np.int32)
    jl, jc = jm.prefill(jax.tree.map(jnp.asarray, np_params),
                        {"tokens": jnp.asarray(toks),
                         "last_index": jnp.asarray(last)})
    tl, tc = tm.prefill(params_from_numpy(np_params, "cpu"),
                        {"tokens": torch.from_numpy(toks),
                         "last_index": torch.from_numpy(last)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_tree(tc, jc)
