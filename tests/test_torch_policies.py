"""The port's reclamation policies against the JAX package's: every one of
the 13 registry names drives the same scripted host event sequence —
alloc, begin/complete step, retire, hold/release, fork references,
reclaim — through the port's BlockPool and the JAX BlockPool, and the
free lists, unreclaimed pages and freed counts agree after every event.
The stall injector is held to the JAX one the same way."""

import pytest
import torch

from repro import memory as jmem
from repro_torch import memory as tmem

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

SLOTS, PAGES = 3, 8
POLICIES = sorted(jmem.POLICIES)


def _snapshot(pool):
    return (
        [list(f) for f in pool._free],
        pool.unreclaimed(),
        pool.freed_total,
        pool.scan_steps,
        pool.ledger_scan_steps,
        pool.forks_taken,
        pool.forks_released,
    )


def _script(mem, policy):
    """Snapshots after every event of a serving-shaped host sequence: two
    overlapping steps, retires under them and under a hold, shared
    prefix pages forked to a second slot and released, and the grace
    periods after a drain."""
    pool = mem.BlockPool(SLOTS, PAGES, policy=policy)
    out = []

    def snap():
        out.append(_snapshot(pool))

    snap()
    pages = {s: pool.alloc(s, 3) for s in range(SLOTS)}
    snap()
    refs = [(s, p) for s in pages for p in pages[s]]
    s1 = pool.begin_step(refs)
    snap()
    pool.free(0, pages[0][:1])  # retired under an in-flight step
    snap()
    hold = pool.hold("chunk-prefill")
    s2 = pool.begin_step([(1, p) for p in pages[1]])
    snap()
    shared = [(2, pages[2][0]), (2, pages[2][1])]
    pool.fork_refs(shared * 2)  # two branches share slot 2's prefix
    snap()
    pool.free_refs([(1, pages[1][0]), (2, pages[2][2])])
    snap()
    pool.complete_step(s1)
    snap()
    pool.free_refs(shared)  # the primary finishes: forks keep them
    snap()
    pool.release_fork(shared)
    snap()
    hold.release()
    snap()
    pool.complete_step(s2)
    snap()
    more = pool.alloc(0, 2)
    s3 = pool.begin_step([(0, p) for p in more])
    pool.free(0, more)
    snap()
    pool.release_fork(shared)  # the last branch lets go
    snap()
    pool.complete_step(s3)
    snap()
    pool.free(0, pages[0][1:])
    pool.free(1, pages[1][1:])
    pool.reclaim()
    snap()
    for _ in range(3):  # the epoch family frees a grace period later
        pool.reclaim()
        s = pool.begin_step([])
        pool.complete_step(s)
        snap()
    return out, pool


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_matches_jax_event_by_event(policy):
    want, _ = _script(jmem, policy)
    got, pool = _script(tmem, policy)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"event {i}"
    # every retired page came back: nothing is left after the grace periods
    assert pool.unreclaimed() == 0
    assert pool.forks_taken == pool.forks_released == 4


def test_registries_equal_jax():
    assert list(tmem.POLICIES) == list(jmem.POLICIES)
    assert tmem.PAPER_POLICIES == jmem.PAPER_POLICIES
    assert tmem.ROBUST_POLICIES == jmem.ROBUST_POLICIES
    for name in tmem.POLICIES:
        assert tmem.make_policy(name).name == jmem.make_policy(name).name
    with pytest.raises(ValueError):
        tmem.make_policy("no-such-policy")
    with pytest.raises(ValueError):  # only stamp-it honours a shared ledger
        tmem.make_policy("hazard", ledger=tmem.StampLedger())


def _stall_script(mem, policy):
    """A parked hold and a parked step pin later retires until the
    injector ends the stall (the robustness bench's scenario)."""
    pool = mem.BlockPool(2, 8, policy=policy)
    inj = mem.StallInjector()
    out = []
    pages = pool.alloc(0, 4)
    inj.park_hold(pool, "stalled")
    inj.park_step(pool, [(0, p) for p in pages[:2]])
    out.append((_snapshot(pool), inj.stats()))
    for p in pages:
        pool.free(0, [p])
        s = pool.begin_step([])
        pool.complete_step(s)
        out.append((_snapshot(pool), inj.stats()))
    out.append((inj.release_all(), inj.stats()))
    for _ in range(3):
        pool.reclaim()
        s = pool.begin_step([])
        pool.complete_step(s)
        out.append((_snapshot(pool), inj.stats()))
    return out, pool


@pytest.mark.parametrize("policy", POLICIES)
def test_stall_injector_matches_jax(policy):
    want, _ = _stall_script(jmem, policy)
    got, pool = _stall_script(tmem, policy)
    assert got == want
    assert pool.unreclaimed() == 0
    assert got[-1][1]["holds_released"] == 1
    assert got[-1][1]["steps_completed"] == 1
