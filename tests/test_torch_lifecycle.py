"""The port's lifecycle plane against the JAX package's: heartbeats,
shared-fate hold expiry, request replay, the hold-age watchdog, live
drain and scale-up, and the request journal.

At smoke width on the same weights (the port model's ``init_params``
returns the JAX group's tree through ``params_from_numpy``):

  * one of four replicas killed mid-traffic while it owns a checkpoint
    hold gives the JAX group's death tick, forced expiries, replays,
    blocked-reclamation steps, unreclaimed pages step by step and
    greedy streams, under stamp-it and debra; the victim's journal holds
    the JAX journal's entries when it dies;
  * ``drain_replica`` and ``add_replica`` give the JAX group's reports,
    routes and tokens; a drain migrates the prefix cache as the JAX
    group's does;
  * ``HoldWatchdog`` warns and expires on the JAX watchdog's ticks;
  * a journaled engine records the JAX engine's entries.

Every policy runs the kill on the port alone, held to the invariants:
every request finishes with the no-fault stream and every page comes
back.  Module-scoped fixtures run each JAX group once.
"""

import jax
import numpy as np
import pytest
import torch

from repro.cluster import HoldWatchdog as JaxWatchdog
from repro.cluster import LifecycleManager as JaxLifecycle
from repro.cluster import ReplicaGroup as JaxGroup
from repro.cluster import RequestJournal as JaxJournal
from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import smoke_config as jax_smoke
from repro.memory import BlockPool as JaxPool
from repro.memory import StallInjector as JaxStall
from repro.models import Model as JaxModel
from repro.serving import ServingEngine as JaxEngine
from repro_torch.cluster import (
    HoldWatchdog,
    LifecycleManager,
    ReplicaGroup,
    RequestJournal,
)
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.memory import POLICIES, BlockPool, StallInjector
from repro_torch.models import Model, params_from_numpy
from repro_torch.serving import ServingEngine

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

BLOCK = 128
MAX_SEQ = 512
MAX_NEW = 4
#: kill -> unreclaimed back at its baseline within timeout + this slack
UNBLOCK_SLACK = 8
#: idle steps (a begin/complete with no pages on every live replica) a
#: policy needs after ``drain()`` before it holds no page: the core
#: Stamp-it's lowest stamp lags after the dead replica's holds leave out
#: of stamp order, in both packages (``tests/test_torch_cluster.py``)
GRACE_STEPS = {"stamp-it-core": 1}
LIFECYCLE_KEYS = ("ticks", "dead", "deaths", "holds_force_expired",
                  "domains_expired", "replays_submitted", "replays_finished",
                  "replays_recovered", "reclamation_blocked_steps",
                  "hold_warnings", "hold_expired_by_watchdog")


def make_prompts(n, lo=30, hi=110, seed=3):
    rs = np.random.RandomState(seed)
    return [list(rs.randint(1, 500, rs.randint(lo, hi)).astype(int))
            for _ in range(n)]


PROMPTS = make_prompts(6, seed=41)


@pytest.fixture(scope="module")
def models():
    """The JAX smoke model and the port's, whose ``init_params`` gives
    the JAX group's tree (``ReplicaGroup`` builds it from the seed)."""
    jm = JaxModel(jax_smoke(JAX_ARCHS["qwen2-0.5b"]))
    tm = Model(smoke_config(ARCHS["qwen2-0.5b"]), device="cpu")
    tm.init_params = lambda seed=0: params_from_numpy(
        jax.tree.map(np.asarray, jm.init_params(seed)), "cpu")
    return jm, tm


@pytest.fixture(scope="module")
def reference(models):
    """No-fault greedy streams from one port engine."""
    _, tm = models
    eng = ServingEngine(tm, max_slots=2, max_seq=MAX_SEQ,
                        extra_pages_per_slot=4, device="cpu")
    reqs = [eng.submit(p, max_new_tokens=MAX_NEW) for p in PROMPTS]
    eng.run_until_done()
    eng.drain()
    return {tuple(r.prompt): list(r.generated) for r in reqs}


def _entries(journal):
    return sorted((e.rid, list(e.prompt), list(e.emitted), e.remaining(),
                   e.sample_key, e.greedy, e.resumable)
                  for e in journal.open_entries())


# ---------------------------------------------------------------------------
# kill one of four replicas mid-traffic under its own checkpoint hold
# ---------------------------------------------------------------------------
def _idle_steps(group, n):
    for _ in range(n):
        for i in group.live_ids():
            pool = group.engines[i].pool
            pool.complete_step(pool.begin_step([]))


def _drive_kill(group_cls, lifecycle_cls, model, policy, timeout=3):
    group = group_cls(model, 4, policy=policy, router="round-robin",
                      max_slots=2, max_seq=MAX_SEQ, pipeline_depth=2,
                      extra_pages_per_slot=4)
    mgr = lifecycle_cls(group, heartbeat_timeout=timeout)
    reqs = [group.submit(p, max_new_tokens=MAX_NEW) for p in PROMPTS]
    baseline = group.shards.unreclaimed()
    # the checkpoint writer on replica 0 opens a cross-replica hold...
    group.hold("checkpoint", owner=0)
    for _ in range(3):
        group.step()
    # ...and replica 0 crashes with the hold open and requests in flight
    journal = _entries(group.engines[0].journal)
    group.kill_replica(0)
    killed_at = group.steps
    unblocked_at = None
    trace = []
    while group.has_work():
        group.step()
        trace.append(group.shards.unreclaimed())
        if unblocked_at is None and 0 in mgr.dead:
            group.reclaim()
            if group.shards.unreclaimed() <= baseline:
                unblocked_at = group.steps
        assert group.steps - killed_at < 500, "kill run did not converge"
    group.drain()
    st = group.stats()
    _idle_steps(group, GRACE_STEPS.get(policy, 0))
    return {
        "tokens": [list(r.generated) for r in reqs],
        "done": [r.done for r in reqs],
        "route": list(group.route_trace),
        "journal_at_kill": journal,
        "killed_at": killed_at, "unblocked_at": unblocked_at,
        "trace": trace,
        "lifecycle": {k: st["lifecycle"][k] for k in LIFECYCLE_KEYS},
        "force_expired": group.ledger.force_expired,
        "replayed_on": sorted(r.replica for _, r, _ in mgr.replays),
        "live": group.live_ids(),
        "husk_freed": group.engines[0].dev.cache is None,
        "unreclaimed": st["unreclaimed"],
        "after_grace": group.shards.unreclaimed(),
        "timeout": mgr.timeout,
    }


@pytest.fixture(scope="module")
def killed(models):
    jm, tm = models
    out = {}
    for policy in ("stamp-it", "debra"):
        out["jax", policy] = _drive_kill(JaxGroup, JaxLifecycle, jm, policy)
        out["port", policy] = _drive_kill(ReplicaGroup, LifecycleManager, tm,
                                          policy)
    return out


@pytest.mark.parametrize("policy", ["stamp-it", "debra"])
def test_kill_one_of_four_matches_jax(killed, reference, policy):
    got, want = killed["port", policy], killed["jax", policy]
    for key in ("tokens", "route", "journal_at_kill", "killed_at",
                "unblocked_at", "trace", "lifecycle", "force_expired",
                "replayed_on", "live", "unreclaimed"):
        assert got[key] == want[key], key
    # death by missed heartbeats alone, the hold revoked, recovery
    # bounded, every request finished with the no-fault stream
    lc = got["lifecycle"]
    assert lc["dead"] == [0]
    assert lc["deaths"][0][0] - got["killed_at"] >= got["timeout"] - 1
    assert lc["holds_force_expired"] == 1 == got["force_expired"]
    assert lc["reclamation_blocked_steps"] > 0
    assert got["unblocked_at"] - got["killed_at"] <= (
        got["timeout"] + UNBLOCK_SLACK)
    assert lc["replays_finished"] == lc["replays_submitted"] > 0
    assert got["journal_at_kill"]  # the kill interrupted work
    for prompt, toks, done in zip(PROMPTS, got["tokens"], got["done"]):
        assert done and toks == reference[tuple(prompt)]
    assert got["live"] == [1, 2, 3] and got["husk_freed"]
    assert got["unreclaimed"] == 0


@pytest.fixture(scope="module")
def kill_sweep(models):
    _, tm = models
    return {policy: _drive_kill(ReplicaGroup, LifecycleManager, tm, policy)
            for policy in POLICIES}


@pytest.mark.parametrize("policy", POLICIES)
def test_every_policy_replays_after_a_kill(kill_sweep, reference, policy):
    got = kill_sweep[policy]
    for prompt, toks, done in zip(PROMPTS, got["tokens"], got["done"]):
        assert done and toks == reference[tuple(prompt)], policy
    lc = got["lifecycle"]
    assert lc["dead"] == [0] and lc["holds_force_expired"] == 1
    assert lc["replays_finished"] == lc["replays_submitted"] > 0
    assert got["after_grace"] == 0 and got["husk_freed"]
    if policy not in GRACE_STEPS:
        assert got["unblocked_at"] is not None
        assert got["unreclaimed"] == 0


# ---------------------------------------------------------------------------
# live drain and scale-up
# ---------------------------------------------------------------------------
def _drain_add_run(group):
    """Queue work on replica 1, drain it live (its queue requeues),
    submit more, add a replica, submit again."""
    for p in PROMPTS[:3]:
        group.submit(p, max_new_tokens=MAX_NEW)
    group.run_until_done()
    queued = group.submit(PROMPTS[3], max_new_tokens=MAX_NEW)
    on = queued.replica
    pages = group.shards.pages_total()
    report = group.drain_replica(on)
    shrunk = group.shards.pages_total() < pages
    for p in PROMPTS[4:]:
        group.submit(p, max_new_tokens=MAX_NEW)
    added = group.add_replica()
    for p in PROMPTS[:3]:  # one round over the three live replicas
        group.submit(p, max_new_tokens=MAX_NEW)
    group.run_until_done()
    group.drain()
    st = group.stats()
    return {"report": report, "queued_on": on, "moved_to": queued.replica,
            "shrunk": shrunk, "added": added, "live": group.live_ids(),
            "route": list(group.route_trace),
            "tokens": [list(r.generated) for r in group.requests],
            "prompts": [tuple(r.prompt) for r in group.requests],
            "husk_freed": group.engines[on].dev.cache is None,
            "counts": (st["replicas_added"], st["replicas_drained"],
                       st["retired_replicas"]),
            "unreclaimed": st["unreclaimed"]}


def _prefix_drain_run(group):
    prompt = make_prompts(1, lo=2 * BLOCK + 4, hi=2 * BLOCK + 5,
                          seed=13)[0]
    r1 = group.submit(prompt, max_new_tokens=MAX_NEW)
    group.run_until_done()
    src = group.route_trace[0][1]
    report = group.drain_replica(src)
    dst = report["migrated_to"]
    cached = len(group.engines[dst].prefix_cache)
    r2 = group.submit(prompt, max_new_tokens=MAX_NEW)
    group.run_until_done()
    group.drain()
    return {"report": report, "cached": cached,
            "route": list(group.route_trace),
            "r1": list(r1.generated), "r2": list(r2.generated),
            "unreclaimed": group.shards.unreclaimed()}


@pytest.fixture(scope="module")
def membership(models):
    jm, tm = models
    kw = dict(max_slots=2, max_seq=MAX_SEQ, router="round-robin",
              extra_pages_per_slot=4)
    pkw = dict(max_slots=2, max_seq=MAX_SEQ, router="prefix-affinity",
               prefix_cache_entries=8, extra_pages_per_slot=6)
    return {
        ("jax", "drain_add"): _drain_add_run(JaxGroup(jm, 3, **kw)),
        ("port", "drain_add"): _drain_add_run(ReplicaGroup(tm, 3, **kw)),
        ("jax", "prefix"): _prefix_drain_run(JaxGroup(jm, 2, **pkw)),
        ("port", "prefix"): _prefix_drain_run(ReplicaGroup(tm, 2, **pkw)),
    }


def test_drain_and_add_replica_match_jax(membership, reference):
    got = membership["port", "drain_add"]
    assert got == membership["jax", "drain_add"]
    assert got["report"]["requeued"] == 1
    assert got["moved_to"] != got["queued_on"] and got["shrunk"]
    assert got["added"] == 3 and got["added"] in got["live"]
    assert got["queued_on"] not in got["live"] and got["husk_freed"]
    # round-robin targets the new replica
    assert any(r == got["added"] for _, r in got["route"])
    for prompt, toks in zip(got["prompts"], got["tokens"]):
        assert toks == reference[prompt]
    assert got["counts"][:2] == (1, 1) and got["unreclaimed"] == 0


def test_drain_migrates_the_prefix_cache_as_jax(membership):
    got = membership["port", "prefix"]
    assert got == membership["jax", "prefix"]
    assert got["report"]["prefix_blocks_migrated"] == 2 == got["cached"]
    # the affinity router follows the migrated pages
    assert got["route"][-1][1] == got["report"]["migrated_to"]
    assert got["r2"] == got["r1"] and got["unreclaimed"] == 0


def test_drain_last_replica_refused(models):
    _, tm = models
    group = ReplicaGroup(tm, 2, max_slots=1, max_seq=MAX_SEQ)
    group.drain_replica(0)
    with pytest.raises(ValueError):
        group.drain_replica(1)
    with pytest.raises(ValueError):
        group.kill_replica(0)  # already retired


# ---------------------------------------------------------------------------
# the hold-age watchdog
# ---------------------------------------------------------------------------
def _watchdog_script(pool_cls, stall_cls, watchdog_cls, policy):
    """A stalled actor's hold under churn: per tick the expiries, the
    unreclaimed pages after a reclaim, and the watchdog's stats."""
    pool = pool_cls(1, 16, policy=policy)
    inj = stall_cls()
    wd = watchdog_cls(expire_after=3, warn_after=2)
    inj.park_hold(pool, tag="stalled-actor")
    young = pool.hold("young")
    trace = []
    for t in range(8):
        pages = pool.alloc(0, 2)
        pool.free(0, pages)
        holds = inj.parked_holds() + [young]
        expired = wd.tick(holds)
        if t == 1:
            young.release()
        pool.reclaim()
        trace.append((expired, pool.unreclaimed()))
    return trace, wd.stats(), list(wd.warnings), inj.release_all()


@pytest.mark.parametrize("policy", ["stamp-it", "debra", "hazard",
                                    "crystalline"])
def test_watchdog_matches_jax(policy):
    got = _watchdog_script(BlockPool, StallInjector, HoldWatchdog, policy)
    want = _watchdog_script(JaxPool, JaxStall, JaxWatchdog, policy)
    assert got == want
    trace, stats, warnings, released = got
    assert stats["hold_expired_by_watchdog"] == 1
    assert warnings == [("stalled-actor", 2)]
    assert trace[-1][1] == 0 and released["holds"] == 0


def test_watchdog_validates_config():
    with pytest.raises(ValueError):
        HoldWatchdog(expire_after=0)
    with pytest.raises(ValueError):
        HoldWatchdog(expire_after=3, warn_after=5)
    assert HoldWatchdog(expire_after=8).warn_after == 4


def test_lifecycle_watchdog_expires_a_wedged_cluster_hold(models,
                                                          reference):
    """A replica that keeps beating while a hold it owns is never
    released: heartbeats cannot see it, the hold deadline does."""
    _, tm = models
    group = ReplicaGroup(tm, 2, max_slots=2, max_seq=MAX_SEQ,
                         router="round-robin", extra_pages_per_slot=4)
    mgr = LifecycleManager(group, heartbeat_timeout=3, hold_deadline=4)
    reqs = [group.submit(p, max_new_tokens=MAX_NEW) for p in PROMPTS]
    hold = group.hold("wedged-writer", owner=1)
    group.run_until_done()
    while not hold.released:
        group.step()
        assert group.steps < 100
    group.drain()
    assert hold.forced and mgr.dead == set()
    st = mgr.stats()
    assert st["hold_expired_by_watchdog"] == 1 and st["hold_warnings"] == 1
    assert [r.generated for r in reqs] == [reference[tuple(p)]
                                           for p in PROMPTS]
    assert group.shards.unreclaimed() == 0


# ---------------------------------------------------------------------------
# journal, heartbeats and replay
# ---------------------------------------------------------------------------
def _views(engine):
    """The engine's scheduler views, as the JAX serving bench reads
    them."""
    return (sorted(r.rid for r in engine.waiting),
            sorted((s, r.rid) for s, r in engine.active.items()),
            [r.rid for r in engine.finished], sorted(engine.free_slots),
            len(engine._inflight))


def _journal_run(engine):
    reqs = [engine.submit(p, max_new_tokens=8) for p in PROMPTS[:3]]
    views = [_views(engine)]
    for _ in range(6):
        engine.step()
        views.append(_views(engine))
    mid = _entries(engine.journal)
    engine.run_until_done()
    engine.drain()
    views.append(_views(engine))
    j = engine.journal
    return {"mid": mid, "after": _entries(j), "finished": j.finished_total,
            "tokens_recorded": j.tokens_recorded, "views": views,
            "tokens": [list(r.generated) for r in reqs]}


def test_journal_matches_jax_engine(models):
    jm, tm = models
    want = _journal_run(JaxEngine(jm, params=jm.init_params(0),
                                  max_slots=2, max_seq=MAX_SEQ,
                                  extra_pages_per_slot=4,
                                  journal=JaxJournal(0)))
    got = _journal_run(ServingEngine(tm, max_slots=2, max_seq=MAX_SEQ,
                                     extra_pages_per_slot=4,
                                     journal=RequestJournal(0),
                                     device="cpu"))
    assert got == want
    assert got["mid"] and any(e[2] for e in got["mid"])  # tokens emitted
    for _, prompt, emitted, remaining, _, greedy, _ in got["mid"]:
        assert greedy and remaining == 8 - len(emitted)
    assert got["after"] == [] and got["finished"] == 3
    assert got["views"][0][0] == [0, 1, 2]  # all waiting before a step
    waiting, active, finished, free, inflight = got["views"][-1]
    assert (waiting, active, sorted(finished), free, inflight) == (
        [], [], [0, 1, 2], [0, 1], 0)
    assert got["tokens_recorded"] == sum(map(len, got["tokens"]))


def test_kill_detection_is_heartbeat_only(models):
    _, tm = models
    group = ReplicaGroup(tm, 2, max_slots=1, max_seq=MAX_SEQ,
                         extra_pages_per_slot=4)
    mgr = LifecycleManager(group, heartbeat_timeout=2)
    group.hold("checkpoint", owner=1)  # idle replica 1 owns a hold
    r = group.submit(PROMPTS[0], max_new_tokens=3)
    group.run_until_done()
    assert mgr.dead == set()  # idle is not dead: replica 1 kept beating
    group.kill_replica(1)
    group.run_until_done()  # the grace window lets the deadline fire
    assert mgr.dead == {1} and mgr.holds_force_expired == 1
    assert r.done
    with pytest.raises(RuntimeError, match="crashed"):
        group.engines[1].step()
    group.drain()
    assert group.shards.unreclaimed() == 0


def test_double_fault_rechains_replay(models, reference):
    _, tm = models
    group = ReplicaGroup(tm, 3, max_slots=1, max_seq=MAX_SEQ,
                         router="round-robin", extra_pages_per_slot=4)
    mgr = LifecycleManager(group, heartbeat_timeout=2)
    r = group.submit(PROMPTS[0], max_new_tokens=MAX_NEW)  # -> replica 0
    for _ in range(3):
        group.step()
    group.kill_replica(0)
    while not mgr.replays:
        group.step()
    host = mgr.replays[0][1].replica
    assert host != 0
    group.kill_replica(host)  # the replay's host dies too
    group.run_until_done()
    assert mgr.dead == {0, host} and len(mgr.replays) == 2
    assert r.done and list(r.generated) == reference[tuple(r.prompt)]
    group.drain()
    assert group.shards.unreclaimed() == 0


def test_sampled_replay_resumes_token_for_token(models):
    _, tm = models

    def run(kill):
        group = ReplicaGroup(tm, 3, router="round-robin", max_slots=2,
                             max_seq=MAX_SEQ, pipeline_depth=2,
                             extra_pages_per_slot=4, temperature=0.8)
        mgr = LifecycleManager(group, heartbeat_timeout=2)
        reqs = [group.submit(p, max_new_tokens=6) for p in PROMPTS]
        for _ in range(4):
            group.step()
        if kill:
            group.kill_replica(0)
        group.run_until_done()
        group.drain()
        assert group.shards.unreclaimed() == 0
        return [list(r.generated) for r in reqs], mgr

    ref, _ = run(kill=False)
    got, mgr = run(kill=True)
    assert mgr.dead == {0} and mgr.replays_submitted >= 1
    assert mgr.replays_finished == mgr.replays_submitted
    # a genuine mid-stream resume under a journaled sample key
    assert any(e.emitted for _, _, e in mgr.replays)
    assert all(not e.greedy and e.resumable for _, _, e in mgr.replays)
    assert got == ref


def test_heartbeat_must_be_monotone(models):
    _, tm = models
    group = ReplicaGroup(tm, 2, max_slots=1, max_seq=MAX_SEQ)
    mgr = LifecycleManager(group, heartbeat_timeout=2)
    mgr.beat(0, 5)
    with pytest.raises(ValueError):
        mgr.beat(0, 4)
