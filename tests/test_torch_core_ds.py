"""The port's copy of the paper's benchmark data structures
(``repro_torch.core.ds``) against the JAX package's ``repro.core.ds``.

Scripted single-thread sequences through the Michael & Scott queue, the
Harris-Michael list set, ``HashMap`` and ``BoundedHashMap`` under each of
the eight ``core`` schemes give, in both packages, the same return
values, the same final contents and the same freed-node order (the
reclaimer's ``_free`` is wrapped to log each node as it is freed).  A
threaded stress runs on the port alone: daemon threads joined under a
timeout, so a livelock fails the test instead of hanging the run.  One
interleaving of the list set's find that the stress hits only now and
then (a splice, then its predecessor deleted) is played step by step in
one thread."""

import random
import sys
import threading
import time

import pytest
import torch

from repro import core as jcore
from repro.core import ds as jds
from repro_torch import core as tcore
from repro_torch.core import ds as tds
from repro_torch.core.atomics import DELETE_MARK

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

SCHEMES = sorted(jcore.SCHEMES)
PACKAGES = {"jax": (jcore, jds), "torch": (tcore, tds)}
#: seconds the stress threads may take in all before the test fails
JOIN_S = 30.0
#: stress threads: more than the machine's cores
THREADS = 10


def _ident(node):
    """A node's name in the freed log: the list's key or the queue's
    value (the queue's first dummy holds None)."""
    kind = type(node).__name__
    return (kind, getattr(node, "key", getattr(node, "value", None)))


def _logged(core, scheme):
    """A reclaimer whose frees are logged in order."""
    r = core.make_reclaimer(scheme, max_threads=8)
    freed = []
    free = r._free

    def logged_free(node):
        freed.append(_ident(node))
        free(node)

    r._free = logged_free
    return r, freed


def _quiesce(r, n=120):
    """Empty regions (the amortized schemes advance on region exits),
    then a flush."""
    for _ in range(n):
        with r.region_guard():
            pass
    r.flush()


def _queue_script(core, ds, scheme):
    r, freed = _logged(core, scheme)
    q = ds.MichaelScottQueue(r)
    log = []
    with r.thread_context():
        for i in range(30):
            q.enqueue(i)
        got = [q.dequeue() for _ in range(10)]
        log.append(("dequeued", got, tuple(freed), r.unreclaimed()))
        # a guard on the head dummy pins it across the next dequeues
        pin = r.guard()
        pin.acquire(q.head)
        got = [q.dequeue() for _ in range(5)]
        _quiesce(r)
        log.append(("pinned", got, tuple(freed), r.unreclaimed()))
        pin.reset()
        _quiesce(r)
        log.append(("released", tuple(freed), r.unreclaimed()))
        for i in range(30, 40):
            q.enqueue(i)
        rest = []
        while True:
            v = q.dequeue()
            if v is None:
                break
            rest.append(v)
        log.append(("drained", rest, q.dequeue(), q.drain()))
        _quiesce(r)
        log.append(("quiet", tuple(freed), r.stats()))
    r.adopt_orphans()
    r.flush()
    log.append(("detached", tuple(freed), r.stats()))
    return log


def _set_ops(rng, n_ops, key_range):
    ops = []
    for _ in range(n_ops):
        op = rng.choice(("insert", "insert", "remove", "contains", "get"))
        ops.append((op, rng.randrange(key_range)))
    return ops


def _list_script(core, ds, scheme):
    r, freed = _logged(core, scheme)
    s = ds.HarrisMichaelListSet(r)
    rng = random.Random(7)
    log = []
    with r.thread_context():
        for i, (op, key) in enumerate(_set_ops(rng, 160, 40)):
            if op == "insert":
                out = s.insert(key, f"v{key}")
            else:
                out = getattr(s, op)(key)
            log.append((op, key, out, len(freed)))
            if i % 40 == 39:
                _quiesce(r, 40)
                log.append(("freed", tuple(freed), r.unreclaimed()))
        # a guard on the first node pins it across its removal
        pin = r.guard()
        pin.acquire(s.head)
        first = pin.get().key
        log.append(("remove pinned", first, s.remove(first)))
        _quiesce(r)
        log.append(("pinned", tuple(freed), r.unreclaimed()))
        pin.reset()
        _quiesce(r)
        log.append(("released", tuple(freed), r.unreclaimed()))
        log.append(("contents", s.size(),
                    [k for k in range(40) if s.contains(k)]))
    r.adopt_orphans()
    r.flush()
    log.append(("detached", tuple(freed), r.stats()))
    return log


def _map_script(core, ds, scheme):
    r, freed = _logged(core, scheme)
    m = ds.HashMap(r, n_buckets=8)
    rng = random.Random(11)
    log = []
    with r.thread_context():
        for i, (op, key) in enumerate(_set_ops(rng, 200, 64)):
            if op == "insert":
                out = m.insert(key, key * 3)
            else:
                out = getattr(m, op)(key)
            log.append((op, key, out, len(freed)))
            if i % 50 == 49:
                _quiesce(r, 40)
                log.append(("freed", tuple(freed), r.unreclaimed()))
        log.append(("contents", {k: m.get(k) for k in range(64)
                                 if m.contains(k)},
                    [b.size() for b in m.buckets]))
        _quiesce(r)
        log.append(("quiet", tuple(freed), r.stats()))
    r.adopt_orphans()
    r.flush()
    log.append(("detached", tuple(freed), r.stats()))
    return log


def _bounded_script(core, ds, scheme):
    r, freed = _logged(core, scheme)
    m = ds.BoundedHashMap(r, n_buckets=8, max_entries=10,
                          payload_bytes=16)
    rng = random.Random(13)
    log = []
    with r.thread_context():
        for i in range(120):
            key = rng.randrange(24)
            value = m.get_or_compute(key)
            log.append((key, len(value), m.count.load(), len(freed)))
            if i % 30 == 29:
                _quiesce(r, 40)
                log.append(("freed", tuple(freed), r.unreclaimed()))
        log.append(("contents", [k for k in range(24) if m.contains(k)],
                    m.count.load()))
        _quiesce(r)
        log.append(("quiet", tuple(freed), r.stats()))
    r.adopt_orphans()
    r.flush()
    log.append(("detached", tuple(freed), r.stats()))
    return log


SCRIPTS = {"queue": _queue_script, "list_set": _list_script,
           "hash_map": _map_script, "bounded_hash_map": _bounded_script}


def test_ds_exports_equal_jax():
    assert tds.__all__ == jds.__all__
    for name in tds.__all__:
        assert getattr(tcore, name) is getattr(tds, name)
        assert getattr(tds, name).__name__ == getattr(jds, name).__name__


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("structure", sorted(SCRIPTS))
def test_scripted_sequence_matches_jax(structure, scheme):
    script = SCRIPTS[structure]
    want = script(*PACKAGES["jax"], scheme)
    got = script(*PACKAGES["torch"], scheme)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == w, g[0]
    # the script retired nodes, and the scheme freed some of them
    assert any(entry[0] == "detached" and entry[1] for entry in got)


def test_hash_map_bucket_is_hash_mod_n():
    r = tcore.make_reclaimer("stamp-it")
    m = tds.HashMap(r, n_buckets=7)
    with r.thread_context():
        for key in (0, 5, 13, -4, 2 ** 40, 7, 14):
            assert m._bucket(key) is m.buckets[hash(key) % 7]
            assert m.insert(key, 1)
            assert m.buckets[hash(key) % 7].contains(key)


# ---------------------------------------------------------------------------
# threaded stress, the port alone
# ---------------------------------------------------------------------------
def _run_bounded(workers):
    """One daemon thread per worker: a thread that never stops (a
    livelock) cannot hang the run.  The interpreter switches threads
    every 10 µs while they run, so their steps interleave finely.
    Returns the names of the threads still alive after JOIN_S in all."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=w, daemon=True) for w in workers]
        for t in threads:
            t.start()
        deadline = time.monotonic() + JOIN_S
        for t in threads:
            t.join(timeout=max(deadline - time.monotonic(), 0.0))
    finally:
        sys.setswitchinterval(interval)
    return [t.name for t in threads if t.is_alive()]


@pytest.mark.parametrize("scheme", SCHEMES)
def test_queue_stress_dequeues_each_item_once_in_producer_order(scheme):
    """Five producers and five consumers on one queue: every item is
    dequeued exactly once, and each consumer sees each producer's items
    in the order they were enqueued."""
    r = tcore.make_reclaimer(scheme, max_threads=2 * THREADS)
    q = tds.MichaelScottQueue(r)
    P, N = THREADS // 2, 150
    seen = [[] for _ in range(THREADS - P)]
    taken = tcore.AtomicInt(0)
    errors = []

    def producer(pid):
        def run():
            try:
                with r.thread_context():
                    for i in range(N):
                        with r.region_guard():
                            q.enqueue((pid, i))
            except Exception as e:  # pragma: no cover
                errors.append(repr(e))
        return run

    def consumer(cid):
        def run():
            try:
                with r.thread_context():
                    while taken.load() < P * N:
                        with r.region_guard():
                            v = q.dequeue()
                        if v is not None:
                            seen[cid].append(v)
                            taken.fetch_add(1)
            except Exception as e:  # pragma: no cover
                errors.append(repr(e))
        return run

    alive = _run_bounded([producer(p) for p in range(P)]
                         + [consumer(c) for c in range(THREADS - P)])
    assert not alive, f"threads still spinning: {alive}"
    assert not errors, errors[:3]
    got = sorted(v for s in seen for v in s)
    assert got == sorted((p, i) for p in range(P) for i in range(N))
    for s in seen:
        for p in range(P):
            mine = [i for pid, i in s if pid == p]
            assert mine == sorted(mine), (p, mine[:10])
    assert q.dequeue() is None


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("structure", ["list_set", "hash_map"])
def test_set_stress_membership_is_last_write(structure, scheme):
    """Ten threads insert and remove keys of their own (interleaved, so
    they share lists and buckets) in one set or map: after the join
    each key is present exactly when its thread's last write was an
    insert, with that insert's value."""
    r = tcore.make_reclaimer(scheme, max_threads=2 * THREADS)
    s = (tds.HarrisMichaelListSet(r) if structure == "list_set"
         else tds.HashMap(r, n_buckets=4))
    T, KEYS, OPS = THREADS, 8, 120
    last = [dict() for _ in range(T)]
    errors = []

    def worker(tid):
        def run():
            rng = random.Random(100 + tid)
            try:
                with r.thread_context():
                    for i in range(OPS):
                        key = rng.randrange(KEYS) * T + tid
                        if rng.random() < 0.55:
                            if s.insert(key, (tid, i)):
                                last[tid][key] = (tid, i)
                            elif key not in last[tid]:
                                errors.append(f"insert of absent {key} "
                                              "refused")
                        else:
                            removed = s.remove(key)
                            if removed != (key in last[tid]):
                                errors.append(f"remove {key} -> {removed}")
                            last[tid].pop(key, None)
            except Exception as e:  # pragma: no cover
                errors.append(repr(e))
        return run

    alive = _run_bounded([worker(t) for t in range(T)])
    assert not alive, f"threads still spinning: {alive}"
    assert not errors, errors[:3]
    want = {k: v for d in last for k, v in d.items()}
    with r.thread_context():
        for key in range(KEYS * T):
            assert s.contains(key) == (key in want), key
            assert s.get(key) == want.get(key), key


@pytest.mark.parametrize("scheme", SCHEMES)
def test_find_after_a_splice_does_not_revive_a_deleted_node(scheme):
    """One interleaving of the Harris-Michael list, played step by step
    in one thread.  The list holds 1 (S), 2 (C), 3 (D), 4; C and D are
    logically deleted.  A find for 4 splices C out of S's link; as it
    retires C, another remover marks S (deleting key 1) and is about to
    unlink it from the head.  The find must not run on from S's link
    now that it is marked: a splice against the marked value would
    clear S's mark, and the remover's unlink of S would re-link D,
    already retired, for a second retire.  Each node is retired once and
    the set holds 4 alone."""
    r = tcore.make_reclaimer(scheme, max_threads=8)
    s = tds.HarrisMichaelListSet(r)
    retired, retire = [], r.retire
    with r.thread_context():
        for key in (1, 2, 3, 4):
            assert s.insert(key)
        S = s.head.load().obj
        C = S.next.load().obj
        D = C.next.load().obj
        E = D.next.load().obj
        assert [n.key for n in (S, C, D, E)] == [1, 2, 3, 4]
        for node, nxt in ((C, D), (D, E)):
            assert node.next.compare_exchange(node.next.load(), nxt,
                                              DELETE_MARK)
        head_at_s = s.head.load()  # the remover of 1 found S here

        def retire_and_mark_s(node):
            retired.append(node.key)
            if node is C:  # the remover marks S, after the splice of C
                sv = S.next.load()
                assert sv.obj is D and not sv.mark
                assert S.next.compare_exchange(sv, D, DELETE_MARK)
            retire(node)

        r.retire = retire_and_mark_s
        assert s.contains(4)
        # the remover's unlink of S, with the head it saw
        if s.head.compare_exchange(head_at_s, D, 0):
            retire_and_mark_s(S)
        else:  # someone else unlinked S: the remover cleans up by a find
            assert not s.contains(1)
        assert [k for k in (1, 2, 3, 4) if s.contains(k)] == [4]
        assert sorted(retired) == [1, 2, 3]
