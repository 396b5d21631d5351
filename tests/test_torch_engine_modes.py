"""The port's whole-prompt prefill and speculative lane against the JAX
engine, on the same bridged smoke-width qwen2 weights and prompts as
``tests/test_torch_engine.py``.

  * ``chunk_tokens=0``: the tokens, the bucketed prompt shapes
    (``prefill_jit_shapes``) and the admission dispatches equal the JAX
    engine's, and the tokens equal the chunked engine's;
  * ``speculate_k`` 2 and 4: the tokens, ``spec_drafted`` and
    ``spec_accepted`` equal the JAX engine's, the tokens equal the
    non-speculative engine's, and after every speculative step the K/V
    pools equal the JAX engine's over every valid position (the port's
    draft writes into the real pools, JAX's into a copy);
  * greedy best-of-3 with ``speculate_k=2`` under stamp-it and lfrc gives
    the JAX engine's tokens and page accounting.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import smoke_config as jax_smoke
from repro.models import Model as JaxModel
from repro.serving import ServingEngine as JaxEngine
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.models import Model, params_from_numpy
from repro_torch.serving import ServingEngine

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

ENGINE = dict(max_slots=2, max_seq=512, prefix_cache_entries=8)
MAX_NEW = 6
ACCOUNTING = ("steps", "prefill_chunks", "prefix_hits", "free_pages",
              "pool_unreclaimed", "pool_freed", "scan_steps",
              "admission_dispatches", "prefill_jit_shapes",
              "spec_drafted", "spec_accepted", "dispatches_per_step")
FORK_ACCOUNTING = ("steps", "cow_copies", "fork_admissions", "forks_taken",
                   "forks_released", "free_pages", "pool_unreclaimed",
                   "admission_dispatches", "spec_drafted", "spec_accepted")


def _prompts():
    rs = np.random.RandomState(0)
    shared = list(rs.randint(1, 500, 128))
    return [
        shared + list(rs.randint(1, 500, 30)),
        list(rs.randint(1, 500, 300)),
        list(rs.randint(1, 500, 40)),
        shared + list(rs.randint(1, 500, 60)),  # prefix-cache hit
    ]


@pytest.fixture(scope="module")
def models():
    jm = JaxModel(jax_smoke(JAX_ARCHS["qwen2-0.5b"]))
    jparams = jm.init_params(0)
    np_params = jax.tree.map(np.asarray, jparams)
    tm = Model(smoke_config(ARCHS["qwen2-0.5b"]), device="cpu")
    return jm, jparams, tm, np_params


def _engines(models, **kw):
    jm, jparams, tm, np_params = models
    return (JaxEngine(jm, params=jparams, **kw),
            ServingEngine(tm, params=params_from_numpy(np_params, "cpu"),
                          device="cpu", **kw))


def _pools_np(engine):
    layers = engine.dev.cache["layers"]
    out = []
    for name in ("k_pool", "v_pool"):
        a = layers[name]
        if isinstance(a, torch.Tensor):
            a = a.float()
        out.append(np.asarray(a, np.float32))
    return out


def _check_valid_kv(jeng, teng):
    """Every active slot's K/V at positions below its host length equal
    between the engines (the positions any later step reads), within
    1e-4 of the pool's largest magnitude as the model tests hold them."""
    np.testing.assert_array_equal(teng.sched.lengths, jeng.sched.lengths)
    jk, jv = _pools_np(jeng)
    tk, tv = _pools_np(teng)
    block = teng.block
    n = 0
    for slot in teng.sched.active:
        length = int(teng.sched.lengths[slot])
        refs = teng.sched.slot_pages[slot]
        assert refs == jeng.sched.slot_pages[slot]
        for i, (s, page) in enumerate(refs):
            rows = min(max(length - i * block, 0), block)
            for want, got in ((jk, tk), (jv, tv)):
                np.testing.assert_allclose(
                    got[:, s, page, :rows], want[:, s, page, :rows],
                    rtol=1e-4, atol=1e-4 * float(np.abs(want).max()))
            n += rows
    return n


def _serve(engine):
    reqs = [engine.submit(p, max_new_tokens=MAX_NEW) for p in _prompts()]
    engine.run_until_done()
    engine.drain()
    return [r.generated for r in reqs], engine.stats()


@pytest.fixture(scope="module")
def baseline(models):
    """The port's chunked, non-speculative tokens."""
    _, t = _engines(models, **ENGINE)
    return _serve(t)[0]


def test_whole_prompt_prefill_matches_jax(models, baseline):
    jeng, teng = _engines(models, chunk_tokens=0, **ENGINE)
    want, jstats = _serve(jeng)
    got, stats = _serve(teng)
    assert got == want
    assert got == baseline  # chunked == unchunked
    assert stats["prefill_jit_shapes"] == [128, 256, 512]
    assert stats["prefill_chunks"] == 0 and stats["chunk_shapes"] == []
    for key in ACCOUNTING:
        assert stats[key] == jstats[key], key
    assert stats["pool_unreclaimed"] == 0


@pytest.mark.parametrize("k,chunk", [(2, 128), (4, 128), (4, 0)])
def test_speculative_lane_matches_jax(models, baseline, k, chunk):
    """Engines stepped in lockstep: after every step the mirrors agree
    and the pools agree over every valid position; at the end the tokens
    and the lane's counters equal the JAX engine's."""
    jeng, teng = _engines(models, speculate_k=k, chunk_tokens=chunk,
                          **ENGINE)
    jreqs = [jeng.submit(p, max_new_tokens=MAX_NEW) for p in _prompts()]
    treqs = [teng.submit(p, max_new_tokens=MAX_NEW) for p in _prompts()]
    checked = 0
    while jeng.sched.has_work() or teng.sched.has_work():
        jeng.step()
        teng.step()
        assert teng.steps == jeng.steps < 500
        checked += _check_valid_kv(jeng, teng)
    assert checked > 0
    jeng.drain()
    teng.drain()
    got = [r.generated for r in treqs]
    assert got == [r.generated for r in jreqs]
    assert got == baseline  # speculative == non-speculative
    stats, jstats = teng.stats(), jeng.stats()
    for key in ACCOUNTING:
        assert stats[key] == jstats[key], key
    assert stats["spec_drafted"] > 0 and stats["speculate_k"] == k
    assert stats["spec_acceptance"] == jstats["spec_acceptance"]


@pytest.mark.parametrize("policy", ["stamp-it", "lfrc"])
def test_speculative_best_of_3_matches_jax(models, policy):
    kw = dict(max_slots=4, max_seq=512, speculate_k=2, policy=policy)
    rs = np.random.RandomState(3)
    prompt = list(rs.randint(1, 500, 150))  # a partial last page
    out = []
    for eng in _engines(models, **kw):
        group = eng.fork_submit(prompt, 3, max_new_tokens=MAX_NEW)
        eng.run_until_done()
        eng.drain()
        out.append(([b.generated for b in group.branches], eng.stats()))
    (want, jstats), (got, stats) = out
    assert got == want
    assert all(len(g) == MAX_NEW for g in got)
    assert got[0] == got[1] == got[2]  # greedy branches agree
    for key in FORK_ACCOUNTING:
        assert stats[key] == jstats[key], key
    assert stats["cow_copies"] == 2 and stats["fork_admissions"] == 2
    assert stats["forks_taken"] == stats["forks_released"]
    assert stats["pool_unreclaimed"] == 0
