"""The port's copy of the paper's host plane against the JAX package's:
each of the eight schemes on the same deterministic single-thread
guard/retire sequence frees the same nodes in the same order, and the
Stamp Pool gives the same stamps and the same answers on sequential
push/remove orders.  Concurrency runs only under a time bound: every
thread is joined with a timeout and a thread still alive fails the test
(the reference pool livelocks under the staggered stress; the copy's
repair is in ``repro_torch/core/stamp_pool.py``).  Two races are forced
step by step with events: LFRC's last guard release against the
retire, and a scan against a record's first attach."""

import random
import threading
import time

import pytest
import torch

from repro import core as jcore
from repro_torch import core as tcore

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

SCHEMES = sorted(jcore.SCHEMES)
#: seconds each stamp-pool stress repetition runs
STRESS_S = 1.5
#: seconds a stress thread may take to finish after it was told to stop
JOIN_S = 20.0


def _scheme_script(core, scheme):
    """Freed-node order after every event of a guarded workload: nodes
    published behind cells, guards taken in regions, retires while a
    guard or a parked second thread pins them, then quiescence."""
    r = core.make_reclaimer(scheme, max_threads=8)
    freed = []

    class Node(core.ReclaimableNode):
        __slots__ = ("ident",)

        def __init__(self, ident):
            super().__init__()
            self.ident = ident
            self.finalizer = lambda: freed.append(ident)

    nodes = [Node(i) for i in range(24)]
    for n in nodes:
        r.on_allocate(n)
    cells = [core.AtomicMarkedRef(n) for n in nodes]
    log = []

    def note(tag):
        log.append((tag, tuple(freed), r.unreclaimed()))

    with r.thread_context():
        # a second paper-thread parked inside a region, guarding node 0
        rec2 = r._acquire_record()
        rec2.region_depth = 1
        r._enter_region(rec2)
        pin = core.Guard(r, rec2)
        pin.acquire(cells[0])
        for rnd in range(4):
            with r.region_guard():
                guards = []
                for i in range(rnd * 6, rnd * 6 + 6):
                    g = r.guard()
                    g.acquire(cells[i])
                    guards.append(g)
                note(f"acquired {rnd}")
                for i in range(rnd * 6, rnd * 6 + 4):
                    cells[i].store(None)
                    r.retire(nodes[i])
                note(f"retired {rnd}")
                for g in guards[::2]:
                    g.reset()
                note(f"half reset {rnd}")
                for g in guards[1::2]:
                    g.reset()
            note(f"left {rnd}")
        for i in range(24):
            if i % 6 >= 4:
                cells[i].store(None)
                r.retire(nodes[i])
        note("retired rest")
        for _ in range(250):  # empty regions advance the amortized schemes
            with r.region_guard():
                pass
        r.flush()
        note("flushed, pinned")
        pin.reset()
        rec2.region_depth = 0
        r._leave_region(rec2)
        r._on_thread_detach(rec2)
        rec2.in_use.store(0)
        for _ in range(250):
            with r.region_guard():
                pass
        r.flush()
        note("flushed")
    r.adopt_orphans()
    r.flush()
    note("after detach")
    return log, r.stats()


@pytest.mark.parametrize("scheme", SCHEMES)
def test_scheme_frees_as_jax(scheme):
    want, want_stats = _scheme_script(jcore, scheme)
    got, got_stats = _scheme_script(tcore, scheme)
    for g, w in zip(got, want):
        assert g == w, g[0]
    assert len(got) == len(want)
    assert got_stats == want_stats
    assert got_stats["allocated"] == 24


def test_scheme_registry_equals_jax():
    assert sorted(tcore.SCHEMES) == sorted(jcore.SCHEMES)
    assert tcore.AMORTIZED_REGION_SCHEMES == jcore.AMORTIZED_REGION_SCHEMES
    for name in tcore.SCHEMES:
        assert type(tcore.make_reclaimer(name)).__name__ == \
            type(jcore.make_reclaimer(name)).__name__
    with pytest.raises(ValueError):
        tcore.make_reclaimer("no-such-scheme")


def _pool_script(core, seed):
    """Answers of a sequential push/remove order over reused blocks."""
    rng = random.Random(seed)
    pool = core.StampPool()
    blocks = [core.Block(f"b{i}") for i in range(6)]
    inside = []
    out = []
    for _ in range(200):
        out_of = [b for b in blocks if b not in inside]
        if out_of and (not inside or rng.random() < 0.55):
            b = rng.choice(out_of)
            out.append(("push", b.name, pool.push(b)))
            inside.append(b)
        else:
            b = rng.choice(inside)
            out.append(("remove", b.name, pool.remove(b)))
            inside.remove(b)
        out.append((pool.lowest_stamp(), pool.highest_stamp(),
                    [x.name for x in pool.prev_chain()[1:-1]]))
        pool.check_quiescent_invariants()
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stamp_pool_sequential_as_jax(seed):
    assert _pool_script(tcore, seed) == _pool_script(jcore, seed)


def test_stamp_it_reclaimer_frees_in_stamp_order():
    """Stamp-it frees a retired node once every thread that entered before
    its retire has left, in retire order."""
    r = tcore.StampItReclaimer(max_threads=8)
    freed = []
    nodes = []
    for i in range(3):
        n = tcore.ReclaimableNode()
        n.finalizer = (lambda i=i: freed.append(i))
        r.on_allocate(n)
        nodes.append(n)
    with r.thread_context():
        rec2 = r._acquire_record()
        rec2.region_depth = 1
        r._enter_region(rec2)  # an older reader
        with r.region_guard():
            for n in nodes:
                r.retire(n)
        r.flush()
        assert freed == []
        rec2.region_depth = 0
        r._leave_region(rec2)
        r._on_thread_detach(rec2)
        rec2.in_use.store(0)
        with r.region_guard():
            pass
        r.flush()
    assert freed == [0, 1, 2]


def _run_bounded(workers):
    """Start one daemon thread per worker: a thread that never stops (a
    livelock) cannot hang the run."""
    threads = [threading.Thread(target=w, daemon=True) for w in workers]
    for t in threads:
        t.start()
    return threads


def _join_all(threads):
    """Join the threads within JOIN_S in all; the names of those still
    alive."""
    deadline = time.monotonic() + JOIN_S
    for t in threads:
        t.join(timeout=max(deadline - time.monotonic(), 0.0))
    return [t.name for t in threads if t.is_alive()]


@pytest.mark.parametrize("rep", range(10))
def test_stamp_pool_staggered_stress_is_bounded(rep):
    """The staggered-lifetime stress that livelocks the reference: six
    threads push and remove their own reused blocks for STRESS_S; every
    thread must stop within the bound and the pool be empty and
    consistent.  (Run against the reference pool, these ten repetitions
    caught its livelock in each of three runs.)"""
    pool = tcore.StampPool()
    stop = threading.Event()
    errors = []

    def make(idx):
        def worker():
            block = tcore.Block(f"s{idx}")
            try:
                while not stop.is_set():
                    s = pool.push(block)
                    if pool.highest_stamp() < s:
                        errors.append("highest_stamp below an assigned stamp")
                    if pool.lowest_stamp() > s:
                        errors.append("lowest_stamp above an in-pool stamp")
                    pool.remove(block)
            except Exception as e:  # pragma: no cover
                errors.append(repr(e))
        return worker

    threads = _run_bounded([make(i) for i in range(6)])
    time.sleep(STRESS_S)
    stop.set()
    alive = _join_all(threads)
    assert not alive, f"threads still spinning: {alive}"
    assert not errors, errors[:3]
    pool.check_quiescent_invariants()
    assert pool.prev_chain() == [pool.head, pool.tail]


@pytest.mark.parametrize("scheme", SCHEMES)
def test_scheme_concurrent_retire_is_bounded(scheme):
    """Four threads retire their own nodes inside regions while reading a
    shared cell under guards; all threads finish within the bound, no
    node is freed twice (``_free`` asserts) and quiescence frees all."""
    r = tcore.make_reclaimer(scheme, max_threads=16)
    shared = tcore.ReclaimableNode()
    r.on_allocate(shared)
    cell = tcore.AtomicMarkedRef(shared)
    errors = []

    def make(idx):
        def worker():
            try:
                with r.thread_context():
                    for i in range(150):
                        n = tcore.ReclaimableNode()
                        r.on_allocate(n)
                        with r.region_guard():
                            g = r.guard()
                            g.acquire(cell)
                            if g.get() is not shared:
                                errors.append("guard lost the shared node")
                            r.retire(n)
                            g.reset()
            except Exception as e:  # pragma: no cover
                errors.append(repr(e))
        return worker

    alive = _join_all(_run_bounded([make(i) for i in range(4)]))
    assert not alive, f"threads still running: {alive}"
    assert not errors, errors[:3]
    with r.thread_context():
        r.adopt_orphans()
        for _ in range(250):
            with r.region_guard():
                pass
        r.flush()
    stats = r.stats()
    assert stats["allocated"] == 4 * 150 + 1
    assert stats["unreclaimed"] == 1  # only the published node is live


def test_lfrc_frees_once_when_retire_races_the_last_release():
    """LFRC: thread B drops the last guard on a node that thread A has
    marked retired, and decides to free it; A's retire then checks the
    node while B's free is still under way (B's ``_free`` waits up to
    0.5 s for A to finish).  The node is freed once: the check and
    ``_reclaimed`` change together under the node's lock, so A sees the
    node freed (or waits for it).  Checked and freed apart, A also frees
    it, and B's free asserts "double reclaim"."""
    r = tcore.make_reclaimer("lfrc", max_threads=8)
    node = tcore.ReclaimableNode()
    r.on_allocate(node)
    cell = tcore.AtomicMarkedRef(node)
    held, entered, a_done = (threading.Event() for _ in range(3))
    errors, frees = [], []
    free, retire = r._free, r._retire

    def slow_free(n):
        frees.append(n)
        if len(frees) == 1:  # B's free: let A's retire run meanwhile
            entered.set()
            a_done.wait(0.5)
        free(n)

    def late_retire(rec, n):  # A: the node is marked; B frees; A checks
        entered.wait(5.0)
        retire(rec, n)

    r._free, r._retire = slow_free, late_retire

    def thread_a():
        try:
            held.wait(5.0)
            with r.thread_context():
                r.retire(node)
        except Exception as e:  # pragma: no cover
            errors.append(repr(e))
        finally:
            a_done.set()

    def thread_b():
        try:
            with r.thread_context():
                g = r.guard()
                g.acquire(cell)
                held.set()
                deadline = time.monotonic() + 5.0
                while not node._retired and time.monotonic() < deadline:
                    time.sleep(1e-3)
                g.reset()
        except Exception as e:  # pragma: no cover
            errors.append(repr(e))

    alive = _join_all(_run_bounded([thread_a, thread_b]))
    assert not alive, f"threads still running: {alive}"
    assert not errors, errors
    assert frees == [node] and node._reclaimed
    assert r.unreclaimed() == 0


#: per scheme, a key of a record's state that another thread's scan reads
SCANNED = {"qsr": "participating", "er": "active", "ner": "active",
           "debra": "quiescent", "ibr": "lo"}


@pytest.mark.parametrize("scheme", sorted(SCANNED))
def test_scan_skips_a_record_while_it_attaches(scheme):
    """Thread "late" attaches a record, and its state is filled but for
    one key when thread "scanner" attaches, retires a node in a region
    and runs empty regions and a flush, each scanning every record.  The
    scans skip the record being attached (``in_use`` is ``ATTACHING``
    until the state is whole); reading it would fail on the missing
    key."""
    r = tcore.make_reclaimer(scheme, max_threads=8)
    attach = r._on_thread_attach
    partial, scanned = threading.Event(), threading.Event()
    errors = []

    def slow_attach(rec):
        attach(rec)
        if threading.current_thread().name == "late":
            key = SCANNED[scheme]
            value = rec.scheme_state.pop(key)
            partial.set()
            scanned.wait(5.0)
            rec.scheme_state[key] = value

    r._on_thread_attach = slow_attach

    def late():
        try:
            with r.thread_context():
                with r.region_guard():
                    pass
        except Exception as e:  # pragma: no cover
            errors.append(repr(e))

    def scanner():
        try:
            partial.wait(5.0)
            with r.thread_context():
                node = tcore.ReclaimableNode()
                r.on_allocate(node)
                with r.region_guard():
                    r.retire(node)
                for _ in range(120):
                    with r.region_guard():
                        pass
                r.flush()
        except Exception as e:  # pragma: no cover
            errors.append(repr(e))
        finally:
            scanned.set()

    threads = [threading.Thread(target=late, name="late", daemon=True),
               threading.Thread(target=scanner, daemon=True)]
    for t in threads:
        t.start()
    alive = _join_all(threads)
    assert not alive, f"threads still running: {alive}"
    assert partial.is_set() and scanned.is_set()
    assert not errors, errors
