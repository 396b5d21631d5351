"""The four configs this slice registers — granite-3-8b, minitron-4b and
phi3-mini-3.8b (dense) and granite-moe-3b-a800m (MoE on the paged
cache) — against the JAX package, with the registry's ``get_arch`` and
``cells``.

At the JAX smoke config (2 layers, d_model 128, 4 query heads over 2 kv
heads of 32, f32; granite-moe 4 experts top-2 of d_ff 256), on the same
numpy weights through ``params_from_numpy``: the spec trees and the
bridge; ``Model.prefill`` logits and K/V; ``prefill_chunk`` chunk by
chunk (logits, and the pools at every valid position), for granite-moe
also at capacity factor 1.25, where chunks drop (token, expert) pairs;
a decode step, for granite-moe also at 16 experts top-8 (its published
routing picks 8); and the ``ServingEngine`` token for token with its
page accounting against the JAX engine under stamp-it (granite-moe
chunked, whole-prompt, and at 16 experts top-8 with capacity 1.25,
granite-3-8b chunked).

Tolerances, f32: logits to 1e-4 of their largest magnitude (XLA and
PyTorch sum the projections in different orders), pools and K/V to 1e-4
of the leaf's largest magnitude, as tests/test_torch_model.py holds the
dense model.  The attention projections are conditioned (unit variance
over their true contraction, as ``chip_smoke.conditioned``): the seeded
init makes every head a near-hard argmax that amplifies reorderings
(ROADMAP Queue C).  The JAX model's prefill, chunk and decode step run
under ``jax.jit``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import cells as jax_cells
from repro.configs import get_arch as jax_get_arch
from repro.configs import smoke_config as jax_smoke
from repro.models import Model as JaxModel
from repro.serving import ServingEngine as JaxEngine
from repro_torch import configs as tconfigs
from repro_torch.configs import ARCHS, ShapeConfig, smoke_config
from repro_torch.models import Model, cache_from_numpy, params_from_numpy
from repro_torch.models import layers as TL
from repro_torch.serving import ServingEngine

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

REL = 1e-4
FAMILIES = ("granite-3-8b", "minitron-4b", "phi3-mini-3.8b",
            "granite-moe-3b-a800m")
MOE = "granite-moe-3b-a800m"
#: JAX configs the port leaves out: none, llava-next-34b (vlm) included
NOT_PORTED = set()
SLOTS, MAX_SEQ = 3, 512
ENGINE = dict(max_slots=2, max_seq=512, prefix_cache_entries=8,
              policy="stamp-it")
MAX_NEW = 6
ACCOUNTING = ("steps", "prefill_chunks", "prefix_hits", "free_pages",
              "pool_unreclaimed", "pool_freed", "scan_steps",
              "admission_dispatches", "prefill_jit_shapes", "chunk_shapes",
              "dispatches_per_step")


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------
def test_registry_holds_every_non_vlm_jax_config():
    assert set(ARCHS) == set(JAX_ARCHS) - NOT_PORTED
    assert [n for n in JAX_ARCHS if n in ARCHS] == list(ARCHS)
    assert ARCHS["llava-next-34b"].family == "vlm"
    for name, cfg in ARCHS.items():
        assert (dataclasses.asdict(cfg)
                == dataclasses.asdict(JAX_ARCHS[name])), name


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_get_arch_matches_jax(name):
    assert tconfigs.get_arch(name) is ARCHS[name]
    assert (dataclasses.asdict(tconfigs.get_arch(name))
            == dataclasses.asdict(jax_get_arch(name)))


def test_get_arch_unknown_name_error():
    with pytest.raises(ValueError) as got:
        tconfigs.get_arch("no-such-arch")
    with pytest.raises(ValueError) as want:
        jax_get_arch("no-such-arch")
    # the JAX text, over the port's names
    assert str(got.value) == str(want.value).replace(
        repr(sorted(JAX_ARCHS)), repr(sorted(ARCHS)))
    assert str(got.value).startswith("unknown arch 'no-such-arch'; ")


def test_cells_match_jax_on_the_ported_names():
    run, skip = tconfigs.cells()
    jrun, jskip = jax_cells()
    assert run == [c for c in jrun if c[0] in ARCHS]
    assert skip == [c for c in jskip if c[0] in ARCHS]
    assert len(run) + len(skip) == len(ARCHS) * len(tconfigs.SHAPES)


# ---------------------------------------------------------------------------
# models at smoke width
# ---------------------------------------------------------------------------
def _condition(np_params, cfg):
    a = dict(np_params["layers"]["attn"])
    M, H, Hkv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    a["wq"] = (a["wq"] * np.sqrt(H / M)).astype(np.float32)
    a["wk"] = (a["wk"] * np.sqrt(Hkv / M)).astype(np.float32)
    a["wv"] = (a["wv"] * np.sqrt(Hkv / M)).astype(np.float32)
    a["wo"] = (a["wo"] / np.sqrt(H)).astype(np.float32)
    return dict(np_params, layers=dict(np_params["layers"], attn=a))


class _Pair:
    """One config in both packages on the same conditioned numpy weights;
    the JAX model's entry points jitted."""

    def __init__(self, name, **overrides):
        self.jm = JaxModel(jax_smoke(JAX_ARCHS[name]).scaled(**overrides))
        self.tm = Model(smoke_config(ARCHS[name]).scaled(**overrides),
                        device="cpu")
        self.np_params = _condition(
            jax.tree.map(np.asarray, self.jm.init_params(0)), self.jm.cfg)
        self.jp = jax.tree.map(jnp.asarray, self.np_params)
        self.tp = params_from_numpy(self.np_params, "cpu")
        self.prefill = jax.jit(self.jm.prefill)
        self.decode = jax.jit(self.jm.decode_step,
                              static_argnames=("n_kv", "global_pages"))
        self.chunk = jax.jit(self.jm.prefill_chunk,
                             static_argnames=("n_kv", "global_pages"))


@pytest.fixture(scope="module")
def pairs():
    return {name: _Pair(name) for name in FAMILIES}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _close(got, want, what):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, what
    np.testing.assert_allclose(
        got, want, rtol=REL, atol=REL * max(float(np.abs(want).max()), 1.0),
        err_msg=what)


@pytest.mark.parametrize("name", FAMILIES)
def test_spec_trees_and_bridge_cover_every_leaf(pairs, name):
    """Every param leaf bridges unchanged and the port declares the same
    tree (the router (L, M, E) and the expert stacks (L, E, M, F) /
    (L, E, F, M) for granite-moe, ``unembed`` for the untied vocab);
    the paged cache has the same leaves, shapes and dtypes."""
    p = pairs[name]
    src = _leaves(p.np_params)
    bridged = _leaves(p.tp)
    assert bridged.keys() == src.keys()
    for path, a in src.items():
        np.testing.assert_array_equal(bridged[path].numpy(), a)
    specs = _leaves(p.tm.param_specs)
    assert {k: tuple(s.shape) for k, s in specs.items()} == {
        k: a.shape for k, a in src.items()}
    assert {k: s.dtype for k, s in specs.items()} == {
        k: torch.float32 for k in src}
    assert p.tm.n_params() == p.jm.n_params()
    cfg = p.tm.cfg
    assert ("/embed/unembed" in src) == (not cfg.tie_embeddings)
    if cfg.family == "moe":
        L, M, E, Fd = (cfg.num_layers, cfg.d_model, cfg.num_experts,
                       cfg.d_ff)
        assert src["/layers/moe/router"].shape == (L, M, E)
        assert src["/layers/moe/wi_up"].shape == (L, E, M, Fd)
        assert src["/layers/moe/wo"].shape == (L, E, Fd, M)
        assert "/layers/mlp/wo" not in src
    shape = ShapeConfig("engine", "decode", MAX_SEQ, SLOTS)
    jc, tc = _leaves(p.jm.cache_specs(shape)), _leaves(p.tm.cache_specs(shape))
    assert jc.keys() == tc.keys() == {"/layers/k_pool", "/layers/v_pool"}
    for path in jc:
        assert tuple(tc[path].shape) == tuple(jc[path].shape), path
        assert (str(tc[path].dtype)
                == f"torch.{jnp.dtype(jc[path].dtype).name}"), path
    assert p.tm.uses_block_table() == p.jm.uses_block_table() is True


def test_full_width_trees_match_jax():
    """At published width the two packages declare the same param tree,
    leaf for leaf (no weights are made)."""
    for name in FAMILIES:
        jt = _leaves(JaxModel(JAX_ARCHS[name]).param_specs)
        tt = _leaves(Model(ARCHS[name], device="cpu").param_specs)
        assert {k: tuple(s.shape) for k, s in tt.items()} == {
            k: tuple(s.shape) for k, s in jt.items()}, name
    moe = _leaves(Model(ARCHS[MOE], device="cpu").param_specs)
    assert moe["/layers/moe/router"].shape == (32, 1536, 40)
    assert moe["/layers/moe/wi_gate"].shape == (32, 40, 1536, 512)


@pytest.mark.parametrize("name", FAMILIES)
def test_prefill_logits_and_kv_match_jax(pairs, name):
    p = pairs[name]
    toks = np.random.RandomState(1).randint(
        1, p.tm.cfg.vocab_size, (2, 40)).astype(np.int32)
    last = np.array([39, 17], np.int32)
    jl, jc = p.prefill(p.jp, {"tokens": jnp.asarray(toks),
                              "last_index": jnp.asarray(last)})
    tl, tc = p.tm.prefill(p.tp, {"tokens": torch.from_numpy(toks),
                                 "last_index": torch.from_numpy(last)})
    _close(tl, jl, "logits")
    assert tc.keys() == jc.keys() == {"k", "v"}
    for k in ("k", "v"):
        _close(tc[k], jc[k], k)


def _random_cache(jm, seed):
    shape = ShapeConfig("engine", "decode", MAX_SEQ, SLOTS)
    specs = _leaves(jm.cache_specs(shape))
    rs = np.random.RandomState(seed)
    return {"layers": {k.split("/")[-1]:
                       (rs.standard_normal(s.shape) * 0.3).astype(np.float32)
                       for k, s in specs.items()}}


def _record_drops(monkeypatch):
    """Wrap the port's ``moe_route``: the (token, expert) pairs each MoE
    call drops, one entry per call (its capacity from the call's
    tokens, as ``apply_moe`` works it out)."""
    drops = []
    route = TL.moe_route

    def recording(p, x, cfg):
        gate_w, ids = route(p, x, cfg)
        B, S, k = ids.shape
        E = cfg.num_experts
        C = min(max(int(cfg.moe_capacity_factor * S * k / E), k), S * k)
        counts = torch.zeros((B, E), dtype=torch.long)
        counts.scatter_add_(1, ids.reshape(B, -1),
                            torch.ones_like(ids.reshape(B, -1)))
        drops.append(int((counts - C).clamp_min(0).sum()))
        return gate_w, ids

    monkeypatch.setattr(TL, "moe_route", recording)
    return drops


def _chunks_and_decode(p):
    """Slot 1 prefills a 300-token prompt in three chunks into pages
    owned by slots 1, 2 and 0 (global ids), the last chunk padded; then
    one decode step over all three slots (slot 0 reads a page of slot 2,
    slot 2 is idle).  Logits and pools compared after every call."""
    cfg = p.tm.cfg
    np_cache = _random_cache(p.jm, 0)
    jcache = jax.tree.map(jnp.asarray, np_cache)
    tcache = cache_from_numpy(np_cache, "cpu")
    n_pool = np_cache["layers"]["k_pool"].shape[2]
    mb = -(-MAX_SEQ // 128) + 1
    rs = np.random.RandomState(2)
    gids = [1 * n_pool + 3, 2 * n_pool + 5, 0 * n_pool + 2]
    row = np.zeros((mb,), np.int32)
    row[:3] = gids
    prompt = rs.randint(1, cfg.vocab_size, 300).astype(np.int32)
    for start, n_kv in ((0, 1), (128, 2), (256, 4)):
        seg = prompt[start:start + 128]
        toks = np.zeros((1, 128), np.int32)
        toks[0, :len(seg)] = seg
        pages = np.asarray([gids[start // 128]], np.int32)
        jl, jcache = p.chunk(
            p.jp, jcache,
            {"tokens": jnp.asarray(toks), "start": jnp.int32(start),
             "slot": jnp.int32(1), "row": jnp.asarray(row),
             "pages": jnp.asarray(pages),
             "last_index": jnp.int32(len(seg) - 1)},
            n_kv=n_kv, global_pages=True)
        tl, tcache = p.tm.prefill_chunk(
            p.tp, tcache,
            {"tokens": torch.from_numpy(toks), "start": start,
             "row": torch.from_numpy(row), "pages": torch.from_numpy(pages),
             "last_index": len(seg) - 1},
            n_kv=n_kv, global_pages=True)
        _close(tl, jl, f"chunk {start} logits")
        for k in ("k_pool", "v_pool"):
            # the pages this prompt wrote, at its valid positions, and
            # every page it did not touch
            w = np.asarray(jcache["layers"][k]).reshape(
                cfg.num_layers, -1, 128, *np_cache["layers"][k].shape[4:])
            g = tcache["layers"][k].numpy().reshape(w.shape)
            for i, gid in enumerate(gids[:start // 128 + 1]):
                n = min(len(prompt) - 128 * i, 128)
                _close(g[:, gid, :n], w[:, gid, :n], f"{k} page {gid}")
            _close(g, w, f"{k} whole pool")
    table = np.zeros((SLOTS, mb), np.int32)
    table[0, :2] = [0 * n_pool + 1, 2 * n_pool + 7]
    table[1] = row
    lengths = np.array([150, 300, 0], np.int32)
    tokens = rs.randint(1, cfg.vocab_size, (SLOTS, 1)).astype(np.int32)
    jl, jcache = p.decode(
        p.jp, jcache,
        {"tokens": jnp.asarray(tokens), "lengths": jnp.asarray(lengths),
         "block_table": jnp.asarray(table)}, n_kv=4, global_pages=True)
    tl, tcache = p.tm.decode_step(
        p.tp, tcache,
        {"tokens": torch.from_numpy(tokens),
         "lengths": torch.from_numpy(lengths),
         "block_table": torch.from_numpy(table)}, n_kv=4, global_pages=True)
    _close(tl, jl, "decode logits")
    for k in ("k_pool", "v_pool"):
        _close(tcache["layers"][k], jcache["layers"][k], k)


@pytest.mark.parametrize("name", FAMILIES)
def test_prefill_chunks_and_decode_match_jax(pairs, name, monkeypatch):
    drops = _record_drops(monkeypatch)
    _chunks_and_decode(pairs[name])
    moe = pairs[name].tm.cfg.family == "moe"
    # 3 chunks and a decode step a layer: the smoke config is dropless
    assert drops == ([0] * 8 if moe else [])


def test_moe_chunks_drop_pairs_as_jax(monkeypatch):
    """granite-moe at capacity factor 1.25: each 128-token chunk keeps
    at most 80 pairs an expert (of 256) and drops the rest, the decode
    step keeps all; logits and pools as the JAX package's."""
    drops = _record_drops(monkeypatch)
    _chunks_and_decode(_Pair(MOE, moe_capacity_factor=1.25))
    assert len(drops) == 8
    assert sum(drops[:6]) > 0, drops
    assert drops[6:] == [0, 0], drops


def test_moe_top8_chunks_and_decode_match_jax(monkeypatch):
    """granite-moe at 16 experts top-8, as its published routing picks 8
    (the smoke config's top-2 sums two outputs, which any order rounds
    alike): each token's 8 expert outputs summed as the JAX package sums
    them; logits and pools as its, chunk by chunk and in the decode step.
    Dropless at the smoke capacity factor (4)."""
    drops = _record_drops(monkeypatch)
    _chunks_and_decode(_Pair(MOE, num_experts=16, experts_per_token=8))
    assert drops == [0] * 8


def test_chunked_prefill_refuses_other_layouts():
    for name in ("mixtral-8x7b", "mamba2-2.7b", "zamba2-7b",
                 "seamless-m4t-medium"):
        tm = Model(smoke_config(ARCHS[name]), device="cpu")
        with pytest.raises(NotImplementedError, match="paged-only"):
            tm.prefill_chunk({}, {}, {"tokens": torch.zeros((1, 128))})
        if name != "seamless-m4t-medium":  # its self-attention is paged
            with pytest.raises(ValueError, match="paged"):
                ServingEngine(tm, max_slots=1, max_seq=256, device="cpu")


# ---------------------------------------------------------------------------
# the serving engine
# ---------------------------------------------------------------------------
def _prompts(vocab):
    rs = np.random.RandomState(0)
    shared = list(rs.randint(1, vocab, 128))
    return [
        shared + list(rs.randint(1, vocab, 30)),  # 2 chunks, donates prefix
        list(rs.randint(1, vocab, 300)),          # 3 chunks
        list(rs.randint(1, vocab, 40)),           # 1 chunk
        shared + list(rs.randint(1, vocab, 60)),  # prefix-cache hit
    ]


def _serve(engine, vocab):
    reqs = [engine.submit(p, max_new_tokens=MAX_NEW)
            for p in _prompts(vocab)]
    engine.run_until_done()
    engine.drain()
    return [r.generated for r in reqs], engine.stats()


ENGINE_RUNS = {
    "granite-moe-chunked": (MOE, dict(chunk_tokens=128), {}),
    "granite-moe-whole-prompt": (MOE, dict(chunk_tokens=0), {}),
    # top-8 of 16 experts at capacity 1.25 (80 of a chunk's 128 tokens
    # an expert): the combine of 8 outputs, and drops when routes skew
    "granite-moe-chunked-cf1.25": (MOE, dict(chunk_tokens=128),
                                   dict(moe_capacity_factor=1.25,
                                        num_experts=16,
                                        experts_per_token=8)),
    "granite-3-8b-chunked": ("granite-3-8b", dict(chunk_tokens=128), {}),
}


@pytest.fixture(scope="module")
def engine_runs(pairs):
    out = {}
    for run, (name, kw, overrides) in ENGINE_RUNS.items():
        p = pairs[name] if not overrides else _Pair(name, **overrides)
        vocab = p.tm.cfg.vocab_size
        out[run] = (
            _serve(JaxEngine(p.jm, params=p.jp, **ENGINE, **kw), vocab),
            _serve(ServingEngine(p.tm, params=params_from_numpy(
                p.np_params, "cpu"), device="cpu", **ENGINE, **kw), vocab))
    return out


@pytest.mark.parametrize("run", sorted(ENGINE_RUNS))
def test_engine_tokens_and_accounting_match_jax(engine_runs, run):
    (want, jstats), (got, stats) = engine_runs[run]
    assert all(len(g) == MAX_NEW for g in got)
    assert got == want
    for key in ACCOUNTING:
        assert stats[key] == jstats[key], key
    assert stats["pool_unreclaimed"] == 0  # stamp-it: nothing after drain
    assert stats["pool_freed"] > 0
    assert stats["prefix_hits"] >= 1
    if ENGINE_RUNS[run][1]["chunk_tokens"]:
        assert stats["chunk_shapes"] == [128] and stats["prefill_chunks"] > 0
    else:
        assert stats["prefill_chunks"] == 0
        assert stats["prefill_jit_shapes"] == [128, 256, 512]


def test_engine_modes_agree_where_nothing_drops(engine_runs):
    """The smoke config is dropless, so chunked and whole-prompt
    granite-moe give the same tokens (at capacity 1.25 they may not)."""
    assert (engine_runs["granite-moe-chunked"][1][0]
            == engine_runs["granite-moe-whole-prompt"][1][0])
