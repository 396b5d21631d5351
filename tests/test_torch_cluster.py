"""The port's cluster plane against the JAX package's: cross-replica
holds, the three routers, the checkpoint writer and prefix migration.

Pool level (no engines): the same script of allocations, cluster holds,
retires and reclaims on both packages' ``BlockPool`` shards under a
``ClusterLedger`` gives the same unreclaimed counts after every event,
for every paper policy.

Group level, at smoke width on the same weights (the port model's
``init_params`` returns the JAX group's tree through
``params_from_numpy``): each router routes the same stream to the same
replicas, the greedy tokens are equal, and the scan steps, recycled
pages and unreclaimed pages — while a cross-replica checkpoint hold is
open and after it — equal the JAX group's.  ``migrate_prefix`` gives the
JAX report under stamp-it and hazard, and the migrated K/V equals the
JAX group's to 1e-4 of the pool's largest magnitude (and the source's
pages bit for bit).  Every other policy runs on the port alone, held to
the invariants: the tokens do not depend on the policy and every page
comes back.  Module-scoped fixtures run each JAX group once.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cluster import ClusterLedger as JaxLedger
from repro.cluster import ReplicaGroup as JaxGroup
from repro.cluster import migrate_prefix as jax_migrate
from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import smoke_config as jax_smoke
from repro.memory import BlockPool as JaxPool
from repro.memory import ShardedPoolSet as JaxShards
from repro.models import Model as JaxModel
from repro.serving.device_state import DeviceState as JaxDeviceState
from repro_torch.cluster import ClusterLedger, ReplicaGroup, migrate_prefix
from repro_torch.cluster.group import _leaves
from repro_torch.cluster.migration import prefix_keys
from repro_torch.configs import ARCHS, ShapeConfig, smoke_config
from repro_torch.memory import (
    PAPER_POLICIES,
    POLICIES,
    BlockPool,
    ShardedPoolSet,
)
from repro_torch.models import Model, params_from_numpy
from repro_torch.serving import DeviceState

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

BLOCK = 128
MAX_SEQ = 512
ROUTERS = ("round-robin", "least-loaded", "prefix-affinity")
#: the migrated K/V against the JAX group's, relative to the pool's
#: largest magnitude (XLA and PyTorch sum in different orders)
KV_REL_TOL = 1e-4


def make_prompts(n, lo=8, hi=120, seed=3):
    rs = np.random.RandomState(seed)
    return [list(rs.randint(1, 500, rs.randint(lo, hi)).astype(int))
            for _ in range(n)]


@pytest.fixture(scope="module")
def models():
    """The JAX smoke model and the port's, whose ``init_params`` gives
    the JAX group's tree (``ReplicaGroup`` builds it from the seed)."""
    jm = JaxModel(jax_smoke(JAX_ARCHS["qwen2-0.5b"]))
    tm = Model(smoke_config(ARCHS["qwen2-0.5b"]), device="cpu")
    tm.init_params = lambda seed=0: params_from_numpy(
        jax.tree.map(np.asarray, jm.init_params(seed)), "cpu")
    return jm, tm


# ---------------------------------------------------------------------------
# cross-replica holds, pool level
# ---------------------------------------------------------------------------
def _hold_script(pool_cls, shards_cls, ledger_cls, policy):
    """Two shards, two overlapping cluster holds, retires on both
    shards: the unreclaimed count of each shard after every event."""
    shards = shards_cls(2)
    pools = [pool_cls(1, 8, policy=policy, shard_id=i, shard_set=shards)
             for i in range(2)]
    ledger = ledger_cls([p.policy for p in pools])
    trace = []

    def note(what):
        for p in pools:
            for _ in range(4):  # grace-period policies advance a few times
                p.reclaim()
        trace.append((what, [p.unreclaimed() for p in pools],
                      shards.unreclaimed()))

    a = pools[0].alloc(0, 3)
    b = pools[1].alloc(0, 2)
    h1 = ledger.hold("checkpoint", owner=0)
    pools[0].free(0, a)
    note("a retired under h1")
    h2 = ledger.hold("migration")
    pools[1].free(0, b)
    note("b retired under h1, h2")
    h1.release()
    note("h1 released")
    h2.release()
    note("h2 released")
    with ledger.hold("scoped"):
        c = pools[0].alloc(0, 2)
        pools[0].free(0, c)
        note("c retired under a scoped hold")
    note("scoped hold closed")
    stats = (ledger.holds_issued, ledger.open_holds,
             [p.policy.holds_issued for p in pools],
             [p.free_pages_total() for p in pools])
    return trace, stats


@pytest.mark.parametrize("policy", PAPER_POLICIES)
def test_cluster_hold_script_matches_jax(policy):
    got, gstats = _hold_script(BlockPool, ShardedPoolSet, ClusterLedger,
                               policy)
    want, wstats = _hold_script(JaxPool, JaxShards, JaxLedger, policy)
    assert got == want
    assert gstats == wstats
    # pinned while a hold is open, everything back once none is
    assert got[0][1][0] == 3 and got[1][1] == [3, 2]
    assert got[-1][2] == 0 and gstats[3] == [8, 8]


def test_cluster_hold_is_o1_for_stamp_it():
    """Opening and closing a hold adds no scan work in the number of
    retired pages or replicas (the JAX package's bound, and its count)."""
    def run(pool_cls, shards_cls, ledger_cls):
        shards = shards_cls(4)
        pools = [pool_cls(1, 64, policy="stamp-it", shard_id=i,
                          shard_set=shards) for i in range(4)]
        ledger = ledger_cls([p.policy for p in pools])
        pages = [p.alloc(0, 30) for p in pools]
        base = shards.ledger_scan_steps()
        with ledger.hold("checkpoint"):
            for p, pg in zip(pools, pages):
                p.free(0, pg)
            held = shards.ledger_scan_steps() - base
            for p in pools:
                p.reclaim()
        for p in pools:
            p.reclaim()
        return held, shards.unreclaimed(), shards.ledger_scan_steps()

    got = run(BlockPool, ShardedPoolSet, ClusterLedger)
    assert got == run(JaxPool, JaxShards, JaxLedger)
    assert got[0] <= 4 * 4 and got[1] == 0


# ---------------------------------------------------------------------------
# page moves (DeviceState.read_pages / write_pages)
# ---------------------------------------------------------------------------
def _jax_state(cache):
    """The JAX ``DeviceState`` page-move methods over a bare cache."""
    ns = types.SimpleNamespace(cache=cache, page_move_buckets=set(),
                               migration_dispatches=0)
    ns._page_move_bucket = lambda n: JaxDeviceState._page_move_bucket(ns, n)
    return ns


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pages", [[3], [1, 4, 2], [5, 1, 2, 3, 4]])
def test_page_moves_match_jax(dtype, pages):
    """read_pages gives the JAX read bit for bit, in the pool's dtype on
    the host; write_pages installs a payload as the JAX write does, pad
    lanes on the slot's scratch page 0 only."""
    tm = Model(smoke_config(ARCHS["qwen2-0.5b"]), device="cpu")
    cache = tm.init_cache(ShapeConfig("engine", "decode", 768, 3))
    shape = tuple(cache["layers"]["k_pool"].shape)  # (L, B, N, 128, Hkv, D)
    rs = np.random.RandomState(len(pages))
    k, v = (rs.randn(*shape).astype(np.float32) for _ in range(2))
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    for name, a in (("k_pool", k), ("v_pool", v)):
        cache["layers"][name] = torch.from_numpy(a).to(tdt)
    dev = DeviceState(tm, None, cache, max_slots=3, mb=7, block=BLOCK,
                      chunk_tokens=BLOCK)
    jst = _jax_state({"layers": {"k_pool": jnp.asarray(k, jdt),
                                 "v_pool": jnp.asarray(v, jdt)}})
    got = dev.read_pages(2, pages)
    want = JaxDeviceState.read_pages(jst, 2, pages)
    for g, w in zip(got, want):
        assert g.device.type == "cpu" and g.dtype == tdt
        assert tuple(g.shape) == (shape[0], len(pages), *shape[3:])
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w, np.float32))
    # install slot 2's pages into slot 0's pages 6, 5, ...
    dst = [6, 5, 4, 3, 2][:len(pages)]
    dev.write_pages(0, dst, *got)
    JaxDeviceState.write_pages(jst, 0, dst, *want)
    for name in ("k_pool", "v_pool"):
        a = dev.cache["layers"][name].float().numpy()
        b = np.asarray(jst.cache["layers"][name], np.float32)
        np.testing.assert_array_equal(np.delete(a, 0, axis=2),
                                      np.delete(b, 0, axis=2))
        np.testing.assert_array_equal(a[:, 0, dst], a[:, 2, pages])
    assert dev.page_move_buckets == jst.page_move_buckets
    assert dev.migration_dispatches == jst.migration_dispatches == 2
    wrong = torch.float64 if dtype == "float32" else torch.float32
    with pytest.raises(TypeError):  # no silent cast of the payload
        dev.write_pages(0, dst, got[0].to(wrong), got[1].to(wrong))
    with pytest.raises(IndexError):
        dev.read_pages(0, [shape[2]])


# ---------------------------------------------------------------------------
# routers, tokens and accounting under a checkpoint hold
# ---------------------------------------------------------------------------
def _routed_run(group):
    """A cached long prompt, unrelated traffic, the long prompt again;
    a checkpoint (under its own hold) and a cluster hold open over four
    steps in the middle, with the unreclaimed count after each."""
    long = make_prompts(1, lo=2 * BLOCK + 4, hi=2 * BLOCK + 5, seed=7)[0]
    group.submit(long, max_new_tokens=3)
    group.run_until_done()
    for p in make_prompts(3, seed=9):
        group.submit(p, max_new_tokens=3)
    group.submit(long, max_new_tokens=3)
    leaves = group.checkpoint()
    hold = group.hold("checkpoint")
    held = []
    for _ in range(4):
        group.step()
        group.reclaim()
        held.append(group.shards.unreclaimed())
    hold.release()
    group.reclaim()
    released = group.shards.unreclaimed()
    group.run_until_done()
    group.drain()
    st = group.stats()
    return {
        "route": list(group.route_trace),
        "tokens": [list(r.generated) for r in group.requests],
        "held": held, "released": released,
        "unreclaimed": st["unreclaimed"],
        "scan_steps": [s["scan_steps"] for s in st["per_replica"]],
        "freed": [s["pool_freed"] for s in st["per_replica"]],
        "recycled": [e.pool.reused_total for e in group.engines],
        "prefix_hits": [s["prefix_hits"] for s in st["per_replica"]],
        "steps": st["cluster_steps"], "finished": st["finished"],
        "holds_issued": st["holds_issued"], "open_holds": st["open_holds"],
        "checkpoint_leaves": leaves,
    }


def _group_kw(router, policy="stamp-it"):
    return dict(policy=policy, router=router, max_slots=2, max_seq=MAX_SEQ,
                prefix_cache_entries=8, extra_pages_per_slot=6)


@pytest.fixture(scope="module")
def routed(models):
    jm, tm = models
    out = {}
    for router in ROUTERS:
        out["jax", router] = _routed_run(JaxGroup(jm, 2, **_group_kw(router)))
        g = ReplicaGroup(tm, 2, **_group_kw(router))
        out["port", router] = _routed_run(g)
        out["ptrs", router] = [[t.data_ptr() for t in _leaves(e.dev.params)]
                               for e in g.engines]
    return out


@pytest.mark.parametrize("router", ROUTERS)
def test_route_trace_matches_jax(routed, router):
    got, want = routed["port", router], routed["jax", router]
    assert got["route"] == want["route"]
    assert {r for _, r in got["route"]} == {0, 1}
    if router == "prefix-affinity":
        # the repeat of the cached prompt follows the cache
        assert got["route"][-1][1] == got["route"][0][1]


@pytest.mark.parametrize("router", ROUTERS)
def test_group_tokens_match_jax(routed, router):
    got, want = routed["port", router], routed["jax", router]
    assert got["tokens"] == want["tokens"]
    assert all(len(t) == 3 for t in got["tokens"])
    # the repeat of the long prompt is the same greedy stream
    assert got["tokens"][-1] == got["tokens"][0]


@pytest.mark.parametrize("router", ROUTERS)
def test_group_accounting_matches_jax(routed, router):
    got, want = routed["port", router], routed["jax", router]
    for key in ("held", "released", "unreclaimed", "scan_steps", "freed",
                "recycled", "prefix_hits", "steps", "finished",
                "holds_issued", "open_holds", "checkpoint_leaves"):
        assert got[key] == want[key], key
    # the hold pinned retired pages, which came back after it
    assert max(got["held"]) > 0
    assert got["unreclaimed"] == 0 and got["open_holds"] == 0


@pytest.mark.parametrize("router", ROUTERS)
def test_replicas_share_one_weight_tree(routed, router):
    a, b = routed["ptrs", router]
    assert a == b and len(a) > 0


# ---------------------------------------------------------------------------
# prefix migration
# ---------------------------------------------------------------------------
def _pages(eng, keys):
    """The K/V of the prefix cache's pages for ``keys`` (every layer)."""
    out = []
    for key in keys:
        e = eng.prefix_cache.get(key)
        for name in ("k_pool", "v_pool"):
            out.append(np.asarray(
                eng.dev.cache["layers"][name][:, e.slot, e.page],
                np.float32))
    return out


def _migration_run(group, migrate):
    prompt = make_prompts(1, lo=2 * BLOCK + 5, hi=2 * BLOCK + 6,
                          seed=13)[0]
    keys = prefix_keys(prompt, BLOCK)
    r1 = group.submit(prompt, max_new_tokens=5)
    group.run_until_done()
    src = group.route_trace[0][1]
    dst = 1 - src
    before = _pages(group.engines[src], keys)
    report = migrate(group, prompt, src, dst)
    after = _pages(group.engines[dst], keys)
    cached = (len(group.engines[src].prefix_cache),
              len(group.engines[dst].prefix_cache))
    reclaimed = group.shards.unreclaimed()
    r2 = group.submit(prompt, max_new_tokens=5)
    group.run_until_done()
    group.drain()
    return {"report": report, "before": before, "after": after,
            "cached": cached, "reclaimed": reclaimed,
            "r1": list(r1.generated), "r2": list(r2.generated),
            "route": list(group.route_trace),
            "dst_hits": group.engines[dst].prefix_cache.hits,
            "unreclaimed": group.shards.unreclaimed(), "src": src}


@pytest.fixture(scope="module")
def migrated(models):
    jm, tm = models
    out = {}
    for policy in ("stamp-it", "hazard"):
        kw = _group_kw("prefix-affinity", policy)
        out["jax", policy] = _migration_run(JaxGroup(jm, 2, **kw),
                                            jax_migrate)
        out["port", policy] = _migration_run(ReplicaGroup(tm, 2, **kw),
                                             migrate_prefix)
    return out


@pytest.mark.parametrize("policy", ["stamp-it", "hazard"])
def test_migrate_prefix_report_matches_jax(migrated, policy):
    got, want = migrated["port", policy], migrated["jax", policy]
    assert got["report"] == want["report"]
    rep = got["report"]
    assert rep["exported"] == rep["imported"] == rep["evicted"] == 2
    # mid-flight: the evicted source pages retired under the hold
    assert rep["src_unreclaimed_during_hold"] >= 2
    for key in ("cached", "reclaimed", "r1", "r2", "route", "dst_hits",
                "unreclaimed"):
        assert got[key] == want[key], key
    assert got["cached"] == (0, 2) and got["reclaimed"] == 0
    # the router follows the pages, and the replay is the same stream
    assert got["route"][-1][1] == 1 - got["src"]
    assert got["r2"] == got["r1"]


@pytest.mark.parametrize("policy", ["stamp-it", "hazard"])
def test_migrated_kv_matches_jax(migrated, policy):
    got, want = migrated["port", policy], migrated["jax", policy]
    for a, b, src in zip(got["after"], want["after"], got["before"]):
        np.testing.assert_array_equal(a, src)  # the move copies bits
        scale = max(float(np.abs(b).max()), 1e-6)
        assert float(np.abs(a - b).max()) <= KV_REL_TOL * scale
    assert len(got["after"]) == 4  # 2 pages x (K, V)


# ---------------------------------------------------------------------------
# every policy, the port alone
# ---------------------------------------------------------------------------
#: idle steps (a begin/complete with no pages on every replica) a policy
#: needs after ``drain()`` before it holds no page.  The core Stamp-it's
#: lowest stamp is a lower bound read from the pool's tail; after the
#: checkpoint hold's region leaves out of stamp order it lags, and the
#: engine thread's last retires wait for the next region to leave — the
#: next step of that replica.  Both packages do this (the test below).
GRACE_STEPS = {"stamp-it-core": 1}


def _idle_steps(group, n):
    for _ in range(n):
        for i in group.live_ids():
            pool = group.engines[i].pool
            pool.complete_step(pool.begin_step([]))


def test_stamp_it_core_lag_matches_jax(models):
    """The core Stamp-it leaves the same pages after the routed run's
    ``drain()`` in both packages, and one idle step frees them."""
    jm, tm = models
    left = []
    for group in (JaxGroup(jm, 2, **_group_kw("least-loaded",
                                                 "stamp-it-core")),
                  ReplicaGroup(tm, 2, **_group_kw("least-loaded",
                                                  "stamp-it-core"))):
        _routed_run(group)
        before = [e.pool.unreclaimed() for e in group.engines]
        _idle_steps(group, GRACE_STEPS["stamp-it-core"])
        left.append((before, group.shards.unreclaimed()))
    assert left[0] == left[1]
    assert sum(left[1][0]) > 0 and left[1][1] == 0


@pytest.fixture(scope="module")
def swept(models):
    _, tm = models
    out = {}
    for policy in POLICIES:
        g = ReplicaGroup(tm, 2, **_group_kw("prefix-affinity", policy))
        mig = _migration_run(g, migrate_prefix)
        g = ReplicaGroup(tm, 2, **_group_kw("least-loaded", policy))
        run = _routed_run(g)
        _idle_steps(g, GRACE_STEPS.get(policy, 0))
        run["after_grace"] = g.shards.unreclaimed()
        out[policy] = (mig, run)
    return out


@pytest.mark.parametrize("policy", POLICIES)
def test_every_policy_migrates_and_reclaims(swept, policy):
    mig, run = swept[policy]
    ref_mig, ref_run = swept["stamp-it"]
    assert mig["r1"] == mig["r2"] == ref_mig["r1"]
    # least-loaded routes by free pages, which a policy's reclaim
    # timing moves; the tokens do not depend on the replica
    assert run["tokens"] == ref_run["tokens"]
    assert mig["report"]["imported"] == 2
    if policy in PAPER_POLICIES:
        assert mig["report"]["src_unreclaimed_during_hold"] >= 2
    assert mig["unreclaimed"] == 0 and run["after_grace"] == 0
    if policy not in GRACE_STEPS:
        assert run["unreclaimed"] == 0
    assert run["open_holds"] == 0
