"""The port's serving engine against the JAX engine: the same bridged
smoke-width qwen2 weights and the same prompts give the SAME greedy
tokens and the same pool accounting under every one of the 13
reclamation policies.  The prompts span one to three prefill chunks,
and two share a 128-token prefix, so the second admits through the
prefix cache (page copy + teacher forcing)."""

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.memory import POLICIES as JAX_POLICIES
from repro.configs import smoke_config as jax_smoke
from repro.models import Model as JaxModel
from repro.serving import ServingEngine as JaxEngine
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.models import Model, params_from_numpy
from repro_torch.serving import ServingEngine

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

POLICIES = tuple(JAX_POLICIES)
ENGINE = dict(max_slots=2, max_seq=512, prefix_cache_entries=8)
MAX_NEW = 6


def _prompts():
    rs = np.random.RandomState(0)
    shared = list(rs.randint(1, 500, 128))
    return [
        shared + list(rs.randint(1, 500, 30)),  # 2 chunks, donates prefix
        list(rs.randint(1, 500, 300)),          # 3 chunks
        list(rs.randint(1, 500, 40)),           # 1 chunk
        shared + list(rs.randint(1, 500, 60)),  # prefix-cache hit
    ]


# reclaim() calls a policy needs after drain() before it holds no page:
# epoch frees a page two epoch advances after its retire; every other
# policy holds none once drain() returns
GRACE = {"stamp-it": 2, "epoch": 2}


def _serve(engine, policy):
    """Tokens, stats after drain(), and unreclaimed pages once the
    policy's grace periods have passed."""
    reqs = [engine.submit(p, max_new_tokens=MAX_NEW) for p in _prompts()]
    engine.run_until_done()
    engine.drain()
    stats = engine.stats()
    for _ in range(GRACE.get(policy, 0)):
        engine.pool.reclaim()
    return [r.generated for r in reqs], stats, engine.pool.unreclaimed()


@pytest.fixture(scope="module")
def runs():
    jm = JaxModel(jax_smoke(JAX_ARCHS["qwen2-0.5b"]))
    jparams = jm.init_params(0)
    np_params = jax.tree.map(np.asarray, jparams)
    tm = Model(smoke_config(ARCHS["qwen2-0.5b"]), device="cpu")
    out = {}
    for policy in POLICIES:
        out["jax", policy] = _serve(JaxEngine(jm, params=jparams,
                                              policy=policy, **ENGINE),
                                    policy)
        out[policy] = _serve(ServingEngine(
            tm, params=params_from_numpy(np_params, "cpu"), policy=policy,
            device="cpu", **ENGINE), policy)
    return out


@pytest.mark.parametrize("policy", POLICIES)
def test_greedy_tokens_match_jax_engine(runs, policy):
    want, jstats, _ = runs["jax", policy]
    got, stats, unreclaimed = runs[policy]
    assert all(len(g) == MAX_NEW for g in got)
    assert got == want
    assert stats["dispatches_per_step"] == 1
    assert stats["chunk_shapes"] == [128]
    assert unreclaimed == 0
    if policy == "stamp-it":  # nothing left even before the grace periods
        assert stats["pool_unreclaimed"] == 0
    # the same schedule and the same pool state under the same policy
    for key in ("steps", "prefill_chunks", "prefix_hits", "free_pages",
                "pool_unreclaimed", "pool_freed", "scan_steps",
                "pool_scan_steps", "ledger_scan_steps",
                "admission_dispatches"):
        assert stats[key] == jstats[key], key
    assert stats["prefix_hits"] >= 1  # the teacher-forced path ran


def test_policy_changes_pressure_not_tokens(runs):
    for policy in POLICIES:
        assert runs[policy][0] == runs["stamp-it"][0], policy


def test_chunk_tokens_validation():
    """chunk_tokens 0 (whole-prompt prefill) and speculate_k > 0 build;
    a chunk width off the page size, a look-ahead of a page or more and
    the lane under sampling are refused."""
    tm = Model(smoke_config(ARCHS["qwen2-0.5b"]), device="cpu")
    for kw in (dict(speculate_k=2), dict(chunk_tokens=0)):
        ServingEngine(tm, max_slots=1, max_seq=256, device="cpu", **kw)
    for kw in (dict(chunk_tokens=100), dict(chunk_tokens=-128),
               dict(speculate_k=128), dict(speculate_k=2, temperature=0.5)):
        with pytest.raises(ValueError):
            ServingEngine(tm, max_slots=1, max_seq=256, device="cpu", **kw)
