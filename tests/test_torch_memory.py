"""The port's memory plane against the JAX package's: the same alloc /
begin_step / retire / complete_step / hold / prefix-cache sequence driven
through both BlockPools gives the same free counts, unreclaimed pages and
bookkeeping scan counts after every operation."""

import pytest
import torch

from repro import memory as jmem
from repro_torch import memory as tmem

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

SLOTS, PAGES = 3, 6


def _snapshot(pool, cache):
    return (
        [pool.free_slot_pages(s) for s in range(pool.n_slots)],
        pool.unreclaimed(),
        pool.scan_steps,
        pool.ledger_scan_steps,
        pool.freed_total,
        len(cache),
    )


def _script(mem, policy):
    """Snapshots after every operation of a serving-shaped sequence."""
    pool = mem.BlockPool(SLOTS, PAGES, policy=policy)
    cache = mem.PrefixCache(pool, 2)
    out = [_snapshot(pool, cache)]
    pages = {s: pool.alloc(s, 2) for s in range(SLOTS)}
    out.append(_snapshot(pool, cache))
    steps = [pool.begin_step([(s, p) for s in pages for p in pages[s]])]
    out.append(_snapshot(pool, cache))
    pool.free(0, pages[0][:1])  # retired under an in-flight step
    out.append(_snapshot(pool, cache))
    hold = pool.hold("chunk-prefill")
    steps.append(pool.begin_step([(1, p) for p in pages[1]]))
    pool.free_refs([(1, pages[1][0]), (2, pages[2][1])])
    out.append(_snapshot(pool, cache))
    pool.complete_step(steps.pop(0))
    out.append(_snapshot(pool, cache))
    cache.insert(("a",), 2, pages[2][0])
    cache.insert(("b",), 0, pages[0][1])
    cache.insert(("c",), 1, pages[1][1])  # evicts "a" (FIFO)
    out.append(_snapshot(pool, cache))
    hold.release()
    out.append(_snapshot(pool, cache))
    pool.complete_step(steps.pop(0))
    out.append(_snapshot(pool, cache))
    hits = cache.lookup([("b",), ("c",)])
    more = pool.alloc(0, 2)
    steps.append(pool.begin_step([(0, p) for p in more]))
    pool.free(0, more)
    out.append(_snapshot(pool, cache))
    cache.unpin(hits)
    pool.complete_step(steps.pop(0))
    cache.drain()
    pool.reclaim()
    out.append(_snapshot(pool, cache))
    pool.reclaim()  # epoch frees two advances after the retire
    pool.reclaim()
    out.append(_snapshot(pool, cache))
    return out


@pytest.mark.parametrize("policy", ["stamp-it", "epoch"])
def test_pool_matches_jax_pool_step_by_step(policy):
    jax_states = _script(jmem, policy)
    torch_states = _script(tmem, policy)
    assert torch_states == jax_states
    free, unreclaimed = torch_states[-1][0], torch_states[-1][1]
    assert unreclaimed == 0 and sum(free) == SLOTS * PAGES


def test_registry_holds_only_ported_policies():
    # every policy of the JAX package is ported, and nothing else
    assert set(tmem.POLICIES) == set(jmem.POLICIES)
    with pytest.raises(ValueError):
        tmem.make_policy("no-such-policy")
    assert tmem.BlockPool(1, 2, policy="stamp-it").ledger is not None
    for name in tmem.POLICIES:
        if name != "stamp-it":
            assert tmem.BlockPool(1, 2, policy=name).ledger is None
