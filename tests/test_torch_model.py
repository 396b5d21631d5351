"""The port's model against the JAX model on bridged weights: the same
smoke-width qwen2 params (``repro`` ``Model.init_params(0)`` through
``params_from_numpy``), the same cache and block tables, two consecutive
prefill chunks and a decode step; logits and updated pools compared.

f32, atol = rtol = 1e-4: XLA and PyTorch sum the projections and the
attention in different orders.  The pools hold K/V values up to ~35 at
this width (random weights), where a reordered f32 sum differs by a few
1e-4 in absolute terms (~1e-5 of the scale), so pools are held to 1e-4
of their largest magnitude rather than 1e-4 absolute."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import smoke_config as jax_smoke
from repro.models import Model as JaxModel
from repro_torch.configs import ARCHS, ShapeConfig, smoke_config
from repro_torch.models import Model, cache_from_numpy, params_from_numpy

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
SLOTS, MAX_SEQ = 3, 512


def _pair(name):
    jm = JaxModel(jax_smoke(JAX_ARCHS[name]))
    np_params = jax.tree.map(np.asarray, jm.init_params(0))
    tm = Model(smoke_config(ARCHS[name]), device="cpu")
    return jm, np_params, tm


@pytest.fixture(scope="module")
def models():
    return _pair("qwen2-0.5b")


@pytest.fixture(scope="module")
def ssm_models():
    return _pair("mamba2-2.7b")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def test_bridge_covers_every_leaf(models, ssm_models):
    """qwen2 and mamba2: every leaf bridges unchanged, and the port
    declares the same tree, leaf for leaf."""
    for jm, np_params, tm in (models, ssm_models):
        bridged = _leaves(params_from_numpy(np_params, "cpu"))
        src = _leaves(np_params)
        assert bridged.keys() == src.keys()
        for path, a in src.items():
            t = bridged[path]
            assert tuple(t.shape) == a.shape, path
            np.testing.assert_array_equal(t.numpy(), a)
        specs = _leaves(tm.param_specs)
        assert specs.keys() == src.keys()
        for path, s in specs.items():
            assert tuple(s.shape) == src[path].shape, path
        assert tm.n_params() == jm.n_params()


def test_cache_specs_match(models, ssm_models):
    """The paged pools (qwen2) and the state and conv tails (mamba2):
    the same leaves, shapes and dtypes as the JAX package declares."""
    shape = ShapeConfig("engine", "decode", MAX_SEQ, SLOTS)
    for jm, _, tm in (models, ssm_models):
        jc = _leaves(jm.cache_specs(shape))
        tc = _leaves(tm.cache_specs(shape))
        assert jc.keys() == tc.keys()
        for path in jc:
            assert tuple(tc[path].shape) == tuple(jc[path].shape), path
            assert (str(tc[path].dtype)
                    == f"torch.{jnp.dtype(jc[path].dtype).name}"), path
        assert tm.uses_block_table() == jm.uses_block_table()


def _random_cache(jm, seed):
    shape = ShapeConfig("engine", "decode", MAX_SEQ, SLOTS)
    specs = _leaves(jm.cache_specs(shape))
    rs = np.random.RandomState(seed)
    flat = {p: (rs.standard_normal(s.shape) * 0.3).astype(np.float32)
            for p, s in specs.items()}
    return {"layers": {k.split("/")[-1]: v for k, v in flat.items()}}


def _assert_pools(jcache, tcache):
    for name in ("k_pool", "v_pool"):
        want = np.asarray(jcache["layers"][name])
        np.testing.assert_allclose(tcache["layers"][name].numpy(), want,
                                   rtol=1e-4,
                                   atol=1e-4 * float(np.abs(want).max()))


def test_prefill_chunks_and_decode_match(models):
    jm, np_params, tm = models
    cfg = tm.cfg
    jp = jax.tree.map(jnp.asarray, np_params)
    tp = params_from_numpy(np_params, "cpu")
    np_cache = _random_cache(jm, 0)
    jcache = jax.tree.map(jnp.asarray, np_cache)
    tcache = cache_from_numpy(np_cache, "cpu")
    n_pool = np_cache["layers"]["k_pool"].shape[2]
    mb = -(-MAX_SEQ // 128) + 1
    rs = np.random.RandomState(1)

    # slot 1 prefills a 200-token prompt in two chunks into pages owned by
    # slots 1 and 2 (global ids), the second chunk padded
    slot = 1
    gids = [1 * n_pool + 3, 2 * n_pool + 5]
    row = np.zeros((mb,), np.int32)
    row[:2] = gids
    prompt = rs.randint(1, cfg.vocab_size, 200).astype(np.int32)
    for start, n_kv in ((0, 1), (128, 2)):
        toks = np.zeros((1, 128), np.int32)
        seg = prompt[start:start + 128]
        toks[0, :len(seg)] = seg
        pages = np.asarray([gids[start // 128]], np.int32)
        last = len(seg) - 1
        jl, jcache = jm.prefill_chunk(
            jp, jcache,
            {"tokens": jnp.asarray(toks), "start": jnp.int32(start),
             "slot": jnp.int32(slot), "row": jnp.asarray(row),
             "pages": jnp.asarray(pages), "last_index": jnp.int32(last)},
            n_kv=n_kv, global_pages=True)
        tl, tcache = tm.prefill_chunk(
            tp, tcache,
            {"tokens": torch.from_numpy(toks), "start": start,
             "row": torch.from_numpy(row), "pages": torch.from_numpy(pages),
             "last_index": last},
            n_kv=n_kv, global_pages=True)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _assert_pools(jcache, tcache)

    # decode: slot 1 continues its prompt; slot 0 reads a page of slot 2
    # (a cross-slot row); slot 2 is idle (zero row, writes to scratch)
    table = np.zeros((SLOTS, mb), np.int32)
    table[0, :2] = [0 * n_pool + 1, 2 * n_pool + 7]
    table[1] = row
    lengths = np.array([150, 200, 0], np.int32)
    tokens = rs.randint(1, cfg.vocab_size, (SLOTS, 1)).astype(np.int32)
    jl, jcache = jm.decode_step(
        jp, jcache,
        {"tokens": jnp.asarray(tokens), "lengths": jnp.asarray(lengths),
         "block_table": jnp.asarray(table)},
        n_kv=2, global_pages=True)
    tl, tcache = tm.decode_step(
        tp, tcache,
        {"tokens": torch.from_numpy(tokens),
         "lengths": torch.from_numpy(lengths),
         "block_table": torch.from_numpy(table)},
        n_kv=2, global_pages=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_pools(jcache, tcache)


def test_decode_step_defaults_to_per_slot_pages(models):
    """Called with default arguments, both packages read block-table
    entries as page ids inside each row's own pool.  Each row's table is
    a different permutation, so reading them as global ids (other slots'
    pages) would change the logits and the pools written."""
    jm, np_params, tm = models
    cfg = tm.cfg
    np_cache = _random_cache(jm, 2)
    n_pool = np_cache["layers"]["k_pool"].shape[2]
    mb = -(-MAX_SEQ // 128) + 1
    rs = np.random.RandomState(4)
    table = np.stack([rs.permutation(n_pool)[:mb]
                      for _ in range(SLOTS)]).astype(np.int32)
    assert len({tuple(r) for r in table}) == SLOTS
    lengths = np.array([150, 300, 0], np.int32)
    tokens = rs.randint(1, cfg.vocab_size, (SLOTS, 1)).astype(np.int32)
    batch = {"tokens": tokens, "lengths": lengths, "block_table": table}
    jl, jcache = jm.decode_step(jax.tree.map(jnp.asarray, np_params),
                                jax.tree.map(jnp.asarray, np_cache),
                                jax.tree.map(jnp.asarray, batch))
    tl, tcache = tm.decode_step(params_from_numpy(np_params, "cpu"),
                                cache_from_numpy(np_cache, "cpu"),
                                {k: torch.from_numpy(v)
                                 for k, v in batch.items()})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_pools(jcache, tcache)


def test_prefill_chunks_default_to_per_slot_pages(models):
    """Two prefill chunks of one slot with default arguments: both
    packages write and read the pages the row names inside the slot's
    own pool (local page ids, different from their global ids)."""
    jm, np_params, tm = models
    cfg = tm.cfg
    jcache = jax.tree.map(jnp.asarray, _random_cache(jm, 5))
    tcache = cache_from_numpy(_random_cache(jm, 5), "cpu")
    mb = -(-MAX_SEQ // 128) + 1
    slot, pages = 2, [6, 3]
    row = np.zeros((mb,), np.int32)
    row[:2] = pages
    prompt = np.random.RandomState(6).randint(1, cfg.vocab_size, 230)
    for start, n_kv in ((0, 1), (128, 2)):
        toks = np.zeros((1, 128), np.int32)
        seg = prompt[start:start + 128]
        toks[0, :len(seg)] = seg
        page = np.asarray([pages[start // 128]], np.int32)
        jl, jcache = jm.prefill_chunk(
            jax.tree.map(jnp.asarray, np_params), jcache,
            {"tokens": jnp.asarray(toks), "start": jnp.int32(start),
             "slot": jnp.int32(slot), "row": jnp.asarray(row),
             "pages": jnp.asarray(page),
             "last_index": jnp.int32(len(seg) - 1)}, n_kv=n_kv)
        tl, tcache = tm.prefill_chunk(
            params_from_numpy(np_params, "cpu"), tcache,
            {"tokens": torch.from_numpy(toks), "start": start, "slot": slot,
             "row": torch.from_numpy(row), "pages": torch.from_numpy(page),
             "last_index": len(seg) - 1}, n_kv=n_kv)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _assert_pools(jcache, tcache)


def test_compute_params_cast_once():
    """Full-width compute dtype: weights cast to bf16 once; norm scales
    and the Mamba2 leaves the JAX package reads in f32 (dt_bias, a_log,
    d_skip, the gated-norm weight) kept f32 bit for bit — the values the
    JAX layers cast to at each call."""
    tm = Model(ARCHS["qwen2-0.5b"].scaled(num_layers=1, vocab_size=64),
               device="cpu")
    tree = {"layers": {"attn": {"wq": torch.ones(2, 3) / 3},
                       "norm1": {"scale": torch.ones(2) / 3}}}
    out = tm.compute_params(tree)
    assert out["layers"]["attn"]["wq"].dtype == torch.bfloat16
    assert out["layers"]["norm1"]["scale"].dtype == torch.float32
    np.testing.assert_array_equal(
        out["layers"]["attn"]["wq"].float().numpy(),
        np.asarray(jnp.asarray(np.ones((2, 3), np.float32) / 3)
                   .astype(jnp.bfloat16).astype(jnp.float32)))

    # mamba2 at full width: random values that bf16 cannot hold exactly
    sm = Model(ARCHS["mamba2-2.7b"].scaled(num_layers=2, vocab_size=64),
               device="cpu")
    rs = np.random.RandomState(0)
    f32_leaves = ("dt_bias", "a_log", "d_skip", "norm")
    mamba = {k: rs.standard_normal((2, 8)).astype(np.float32)
             for k in f32_leaves + ("wz", "conv_x")}
    for k in f32_leaves:
        v = mamba[k]
        assert not np.array_equal(
            np.asarray(jnp.asarray(v).astype(jnp.bfloat16)
                       .astype(jnp.float32)), v)
    out = sm.compute_params(params_from_numpy(
        {"layers": {"mamba": mamba}}, "cpu"))["layers"]["mamba"]
    for k in f32_leaves:
        assert out[k].dtype == torch.float32, k
        np.testing.assert_array_equal(out[k].numpy(), mamba[k])
    for k in ("wz", "conv_x"):
        assert out[k].dtype == torch.bfloat16, k
        np.testing.assert_array_equal(
            out[k].float().numpy(),
            np.asarray(jnp.asarray(mamba[k]).astype(jnp.bfloat16)
                       .astype(jnp.float32)))


def test_model_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(smoke_config(ARCHS["qwen2-0.5b"]))
