"""The port's disaggregated prefill/decode tiers and the mid-request K/V
handoff against the JAX package's (``repro/cluster/tiers.py``).

At smoke width on the same weights (the port model's ``init_params``
returns the JAX group's tree through ``params_from_numpy``), a group of
one prefill and two decode replicas gives the JAX group's tokens, greedy
and sampled, and its handoff accounting: packets started, committed and
aborted, pages handed off, hold ticks, each replica's handoffs in and
out and tokens emitted, and — step by step — the source's retire-but-
held pages while a packet is in flight.  The prefill replica killed
before and after the import gives the JAX group's streams, tier and
lifecycle counts under stamp-it and debra; ``scale_tier`` the JAX
group's routes and tokens.  Every other policy runs on the port alone,
held to the invariants: every request finishes with the no-fault
stream, every handoff commits or aborts, and every page comes back.

A sampled token may differ from the JAX group's only where the JAX
uniform lies within 1e-5 of a ``kcum`` boundary of the JAX logits
(float associativity, as ``tests/test_torch_fork.py`` allows); the
sampled checks test that for any token that differs and fail otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cluster import LifecycleManager as JaxLifecycle
from repro.cluster import ReplicaGroup as JaxGroup
from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import smoke_config as jax_smoke
from repro.models import Model as JaxModel
from repro.serving.device_state import counter_uniform as jax_uniform
from repro.serving.sampling import nucleus_cdf
from repro_torch.cluster import HANDOFF_TAG, LifecycleManager, ReplicaGroup
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.memory import POLICIES
from repro_torch.models import Model, params_from_numpy

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

BLOCK = 128
MAX_SEQ = 512
MAX_NEW = 4
TEMPERATURE = 0.8
BOUNDARY = 1e-5  # |u - kcum| below this is a float-associativity tie
#: kill -> unreclaimed back at its baseline within timeout + this slack
UNBLOCK_SLACK = 8
TIER_KEYS = ("handoffs_started", "handoffs_completed", "handoffs_aborted",
             "import_retries", "pages_handed_off", "hold_ticks_total",
             "inflight_handoffs", "ready_queue_depth")
LIFECYCLE_KEYS = ("dead", "deaths", "holds_force_expired",
                  "domains_expired", "replays_submitted", "replays_finished",
                  "replays_recovered", "reclamation_blocked_steps")


def make_prompts(n, lo=30, hi=110, seed=7):
    rs = np.random.RandomState(seed)
    return [list(rs.randint(1, 500, rs.randint(lo, hi)).astype(int))
            for _ in range(n)]


PROMPTS = make_prompts(6)


@pytest.fixture(scope="module")
def models():
    """The JAX smoke model and the port's, whose ``init_params`` gives
    the JAX group's tree (``ReplicaGroup`` builds it from the seed)."""
    jm = JaxModel(jax_smoke(JAX_ARCHS["qwen2-0.5b"]))
    tm = Model(smoke_config(ARCHS["qwen2-0.5b"]), device="cpu")
    tm.init_params = lambda seed=0: params_from_numpy(
        jax.tree.map(np.asarray, jm.init_params(seed)), "cpu")
    return jm, tm


def make_group(cls, model, *, tiered=True, temperature=0.0,
               policy="stamp-it", import_delay=0, **kw):
    base = dict(policy=policy, router="least-loaded", max_slots=2,
                max_seq=MAX_SEQ, pipeline_depth=2, extra_pages_per_slot=4,
                temperature=temperature)
    base.update(kw)
    if tiered:
        return cls(model, prefill_replicas=1, decode_replicas=2,
                   handoff_import_delay=import_delay, **base)
    return cls(model, 3, **base)


def _jax_logits_at(jm, seq):
    S = -(-len(seq) // BLOCK) * BLOCK
    toks = np.zeros((1, S), np.int32)
    toks[0, :len(seq)] = seq
    logits, _ = jm.prefill(jm.init_params(0), {
        "tokens": jnp.asarray(toks),
        "last_index": jnp.asarray([len(seq) - 1], jnp.int32)})
    return np.asarray(logits[0], np.float32)


def assert_sampled_equal(jm, prompts, keys, got, want):
    """Sampled streams equal, or part only on a JAX kcum boundary."""
    assert len(got) == len(want)
    for prompt, key, a, b in zip(prompts, keys, got, want):
        assert len(a) == len(b)
        for k, (x, y) in enumerate(zip(a, b)):
            if x == y:
                continue
            seq = list(prompt) + b[:k]
            u = float(jax_uniform(key, len(seq)))
            _, kcum, _ = nucleus_cdf(_jax_logits_at(jm, seq), TEMPERATURE,
                                     1.0)
            assert np.min(np.abs(kcum - np.float32(u))) < BOUNDARY, (
                key, k, x, y)
            break


# ---------------------------------------------------------------------------
# the handoff, step by step
# ---------------------------------------------------------------------------
def _tiered_run(group):
    """Serve PROMPTS; after every cluster step with a packet in flight,
    the source's unreclaimed pages (after a reclaim) and whether a
    kv-handoff hold owned by it is open."""
    src = group.tiers.prefill_ids[0]
    reqs = [group.submit(p, max_new_tokens=MAX_NEW) for p in PROMPTS]
    window = []
    while group.has_work():
        group.step()
        if group.tiers.pending():
            group.engines[src].pool.reclaim()
            window.append((group.steps,
                           group.engines[src].pool.unreclaimed(),
                           sorted(p.state for p in group.tiers.packets),
                           any(h.tag == HANDOFF_TAG
                               for h in group.ledger.open_holds_of(src))))
        assert group.steps < 400
    group.engines[src].pool.reclaim()
    after_commit = group.engines[src].pool.unreclaimed()
    group.drain()
    st = group.stats()
    per = st["per_replica"]
    return {
        "tokens": [list(r.generated) for r in reqs],
        "keys": [r.sample_key for r in reqs],
        "decoded_on": [r.replica for r in reqs],
        "route": list(group.route_trace),
        "window": window, "after_commit": after_commit,
        "tiers": {k: st["tiers"][k] for k in TIER_KEYS},
        "log": list(group.tiers.log),
        "handoffs": [(s["handoffs_out"], s["handoffs_in"]) for s in per],
        "emitted": [s["tokens_emitted"] for s in per],
        "prefill_ready": [s["prefill_ready"] for s in per],
        "buckets": [sorted(e.dev.page_move_buckets) for e in group.engines],
        "moves": [e.dev.migration_dispatches for e in group.engines],
        "handed_off": [e.journal.handed_off_total for e in group.engines],
        "unreclaimed": group.shards.unreclaimed(),
        "steps": group.steps,
    }


@pytest.fixture(scope="module")
def tiered(models):
    jm, tm = models
    out = {}
    for temperature in (0.0, TEMPERATURE):
        kw = dict(temperature=temperature, import_delay=2)
        out["jax", temperature] = _tiered_run(make_group(JaxGroup, jm, **kw))
        out["port", temperature] = _tiered_run(make_group(ReplicaGroup, tm,
                                                          **kw))
        uni = make_group(ReplicaGroup, tm, tiered=False,
                         temperature=temperature)
        reqs = [uni.submit(p, max_new_tokens=MAX_NEW) for p in PROMPTS]
        uni.run_until_done()
        uni.drain()
        out["unified", temperature] = [list(r.generated) for r in reqs]
    return out


def test_tiered_greedy_tokens_match_jax_and_unified(tiered):
    got = tiered["port", 0.0]
    assert got["tokens"] == tiered["jax", 0.0]["tokens"]
    assert got["tokens"] == tiered["unified", 0.0]
    assert all(len(t) == MAX_NEW for t in got["tokens"])


def test_tiered_sampled_tokens_match_jax_and_unified(models, tiered):
    got, want = tiered["port", TEMPERATURE], tiered["jax", TEMPERATURE]
    assert got["keys"] == want["keys"]
    assert_sampled_equal(models[0], PROMPTS, got["keys"], got["tokens"],
                         want["tokens"])
    # the stream does not depend on which replica serves it
    assert got["tokens"] == tiered["unified", TEMPERATURE]


@pytest.mark.parametrize("temperature", [0.0, TEMPERATURE])
def test_handoff_accounting_matches_jax(tiered, temperature):
    got, want = tiered["port", temperature], tiered["jax", temperature]
    for key in ("route", "decoded_on", "tiers", "log", "handoffs", "emitted",
                "prefill_ready", "buckets", "moves", "handed_off", "steps",
                "unreclaimed"):
        assert got[key] == want[key], key
    ts = got["tiers"]
    # every request needs more than one token: each handed off once
    assert ts["handoffs_started"] == ts["handoffs_completed"] == len(PROMPTS)
    assert ts["handoffs_aborted"] == 0 and ts["inflight_handoffs"] == 0
    out_in = got["handoffs"]
    assert out_in[0][0] == len(PROMPTS)
    assert sum(i for _, i in out_in) == len(PROMPTS)
    assert all(b & (b - 1) == 0 for bs in got["buckets"] for b in bs)


@pytest.mark.parametrize("temperature", [0.0, TEMPERATURE])
def test_retire_but_held_window_matches_jax(tiered, temperature):
    got, want = tiered["port", temperature], tiered["jax", temperature]
    assert got["window"] == want["window"]
    # the exported pages stay unreclaimed under the kv-handoff hold...
    assert max(u for _, u, _, _ in got["window"]) > 0
    assert any(held for _, _, _, held in got["window"])
    # ...and come back once the last packet commits
    assert got["after_commit"] == want["after_commit"] == 0
    assert got["unreclaimed"] == 0


def test_decode_tier_serves_every_token_after_the_first(tiered):
    """The prefill replica emits token 1 of each request and decodes
    only the requests imported back to it (the fallback when both decode
    replicas' slots are full during the import delay)."""
    got = tiered["port", 0.0]
    assert {r for _, r in got["route"]} == {0}  # the prefill tier only
    emitted = got["emitted"]
    decoded = [0] * len(emitted)
    for toks, r in zip(got["tokens"], got["decoded_on"]):
        decoded[r] += len(toks) - 1
    assert emitted[0] == got["tiers"]["handoffs_completed"] + decoded[0]
    assert emitted[1:] == decoded[1:]
    assert sum(emitted) == sum(len(t) for t in got["tokens"])
    assert all(i > 0 for _, i in got["handoffs"][1:])


# ---------------------------------------------------------------------------
# the prefill replica dies mid-handoff
# ---------------------------------------------------------------------------
def _drive_fault(cls, lifecycle_cls, model, policy, *, kill_when,
                 timeout=2):
    """Serve PROMPTS sampled on a tiered group; with ``kill_when`` set,
    kill the prefill replica the first time a packet reaches that
    state."""
    # import_delay > timeout: the death is DECLARED before the import
    # tick, forcing the before-import window deterministically
    delay = timeout + 2 if kill_when == "exported" else 0
    group = make_group(cls, model, policy=policy, temperature=TEMPERATURE,
                       import_delay=delay)
    mgr = lifecycle_cls(group, heartbeat_timeout=timeout)
    src = group.tiers.prefill_ids[0]
    reqs = [group.submit(p, max_new_tokens=MAX_NEW) for p in PROMPTS]
    baseline = 0
    killed_at = unblocked_at = None
    while group.has_work():
        if not group.tiers.pending():
            baseline = group.shards.unreclaimed()
        group.step()
        if (kill_when and killed_at is None and any(
                p.state == kill_when for p in group.tiers.packets)):
            group.kill_replica(src)
            killed_at = group.steps
        if (killed_at is not None and unblocked_at is None
                and src in mgr.dead):
            group.reclaim()
            if group.shards.unreclaimed() <= baseline:
                unblocked_at = group.steps
        assert group.steps < 600, "fault run did not converge"
    group.drain()
    st = group.stats()
    return {
        "tokens": [list(r.generated) for r in reqs],
        "keys": [r.sample_key for r in reqs],
        "done": [r.done for r in reqs],
        "killed_at": killed_at, "unblocked_at": unblocked_at,
        "tiers": {k: st["tiers"][k] for k in TIER_KEYS},
        "lifecycle": {k: st["lifecycle"][k] for k in LIFECYCLE_KEYS},
        "unreclaimed": st["unreclaimed"],
        "husk_freed": group.engines[src].dev.cache is None,
    }


@pytest.fixture(scope="module")
def faults(models):
    jm, tm = models
    out = {}
    for policy in ("stamp-it", "debra"):
        for when in ("exported", "imported"):
            out["jax", policy, when] = _drive_fault(
                JaxGroup, JaxLifecycle, jm, policy, kill_when=when)
            out["port", policy, when] = _drive_fault(
                ReplicaGroup, LifecycleManager, tm, policy, kill_when=when)
    return out


@pytest.mark.parametrize("policy", ["stamp-it", "debra"])
@pytest.mark.parametrize("when", ["exported", "imported"])
def test_kill_prefill_mid_handoff_matches_jax(models, faults, tiered,
                                              policy, when):
    got, want = faults["port", policy, when], faults["jax", policy, when]
    assert got["keys"] == want["keys"]
    assert_sampled_equal(models[0], PROMPTS, got["keys"], got["tokens"],
                         want["tokens"])
    for key in ("killed_at", "unblocked_at", "tiers", "lifecycle",
                "unreclaimed"):
        assert got[key] == want[key], key
    # the stitched streams are the no-fault run's, every request once
    assert got["tokens"] == tiered["port", TEMPERATURE]["tokens"]
    assert all(got["done"]) and got["unreclaimed"] == 0
    assert got["lifecycle"]["dead"] == [0] and got["husk_freed"]
    assert got["tiers"]["inflight_handoffs"] == 0
    if when == "exported":
        # the kv-handoff hold went through the forced path, the packet
        # aborted and the journal replayed the request
        assert got["tiers"]["handoffs_aborted"] >= 1
        assert got["lifecycle"]["holds_force_expired"] >= 1
        assert got["lifecycle"]["replays_submitted"] >= 1
        assert (got["unblocked_at"] - got["killed_at"]
                <= 2 + UNBLOCK_SLACK)
    lc = got["lifecycle"]
    assert lc["replays_finished"] == lc["replays_submitted"]


@pytest.fixture(scope="module")
def fault_sweep(models):
    _, tm = models
    return {policy: _drive_fault(ReplicaGroup, LifecycleManager, tm, policy,
                                 kill_when="exported")
            for policy in POLICIES}


@pytest.mark.parametrize("policy", POLICIES)
def test_every_policy_survives_a_death_before_import(fault_sweep, tiered,
                                                     policy):
    got = fault_sweep[policy]
    assert all(got["done"])
    assert got["tokens"] == tiered["port", TEMPERATURE]["tokens"]
    assert got["unreclaimed"] == 0
    ts, lc = got["tiers"], got["lifecycle"]
    assert ts["handoffs_aborted"] >= 1 and ts["inflight_handoffs"] == 0
    assert (ts["handoffs_completed"] + ts["handoffs_aborted"]
            == ts["handoffs_started"])
    assert lc["dead"] == [0]
    assert lc["replays_finished"] == lc["replays_submitted"] >= 1
    assert got["unblocked_at"] is not None


# ---------------------------------------------------------------------------
# tier scaling and configuration
# ---------------------------------------------------------------------------
def _scale_run(group):
    reqs = [group.submit(p, max_new_tokens=MAX_NEW) for p in PROMPTS[:3]]
    for _ in range(3):
        group.step()
    added = group.scale_tier("decode", +1)
    reqs += [group.submit(p, max_new_tokens=MAX_NEW) for p in PROMPTS[3:]]
    group.run_until_done()
    drained = group.scale_tier("decode", -1)
    group.run_until_done()
    group.drain()
    with pytest.raises(ValueError):
        group.scale_tier("prefill", -1)  # the last live prefill replica
    st = group.stats()
    return {"added": added, "drained": drained,
            "decode_ids": list(group.tiers.decode_ids),
            "live": group.live_ids(),
            "route": list(group.route_trace),
            "tokens": [list(r.generated) for r in reqs],
            "done": [r.done for r in reqs],
            "tiers": {k: st["tiers"][k] for k in TIER_KEYS},
            "unreclaimed": st["unreclaimed"],
            "added_drained": (st["replicas_added"], st["replicas_drained"])}


def test_scale_tier_live_matches_jax(models):
    jm, tm = models
    want = _scale_run(make_group(JaxGroup, jm))
    got = _scale_run(make_group(ReplicaGroup, tm))
    assert got == want
    assert got["added"] == got["drained"] == [3]
    assert all(got["done"]) and got["unreclaimed"] == 0


def test_prefill_tier_runs_its_own_chunk_size(models):
    _, tm = models
    group = make_group(ReplicaGroup, tm, chunk_tokens=128,
                       prefill_chunk_tokens=256)
    assert group.engines[0].chunk_tokens == 256
    assert all(group.engines[i].chunk_tokens == 128
               for i in group.tiers.decode_ids)
    reqs = [group.submit(p, max_new_tokens=MAX_NEW)
            for p in make_prompts(3, lo=200, hi=400, seed=9)]
    group.run_until_done()
    group.drain()
    assert all(r.done for r in reqs)
    assert group.tiers.handoffs_completed == 3
    assert group.shards.unreclaimed() == 0


def test_tiered_group_rejects_whole_prompt_prefill(models):
    _, tm = models
    with pytest.raises(ValueError):
        make_group(ReplicaGroup, tm, chunk_tokens=0)
    with pytest.raises(ValueError):
        ReplicaGroup(tm, prefill_replicas=1, decode_replicas=None)
