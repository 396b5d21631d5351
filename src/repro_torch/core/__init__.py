"""The paper's primary contribution: Stamp-it concurrent memory reclamation
(host plane), the competitor schemes behind one Robison-style interface,
and the benchmark data structures (:mod:`.ds`).

A copy of the JAX package's ``repro/core`` (pure Python, no JAX) with the
Stamp Pool's livelock repaired (see :mod:`.stamp_pool`).  The device-plane
adaptation (stamped block pools for the serving engine) lives in
:mod:`repro_torch.memory`.
"""

from .atomics import (
    DELETE_MARK,
    AtomicInt,
    AtomicMarkedRef,
    AtomicRef,
    MarkedValue,
)
from .interface import (
    ConcurrentPtr,
    Guard,
    ReclaimableNode,
    Reclaimer,
    ThreadRecord,
)
from .stamp_pool import (
    NOT_IN_LIST,
    PENDING_PUSH,
    STAMP_INC,
    Block,
    StampPool,
)
from .stamp_it import StampItReclaimer
from .schemes import (
    IntervalReclaimer,
    DebraReclaimer,
    EpochReclaimer,
    HazardPointerReclaimer,
    LockFreeRefCountReclaimer,
    NewEpochReclaimer,
    QuiescentStateReclaimer,
)
from .ds import (
    BoundedHashMap,
    HarrisMichaelListSet,
    HashMap,
    MichaelScottQueue,
)

#: registry of all seven schemes compared in the paper (§4)
SCHEMES = {
    "stamp-it": StampItReclaimer,
    "er": EpochReclaimer,
    "ner": NewEpochReclaimer,
    "qsr": QuiescentStateReclaimer,
    "hpr": HazardPointerReclaimer,
    "lfrc": LockFreeRefCountReclaimer,
    "debra": DebraReclaimer,
    # beyond-paper: IR (Wen et al. 2018), cited by the paper as too recent
    "ibr": IntervalReclaimer,
}

#: schemes whose regions amortize across operations (paper §4.2 wraps 100
#: benchmark operations per region_guard for exactly these)
AMORTIZED_REGION_SCHEMES = ("stamp-it", "ner", "qsr")


def make_reclaimer(name: str, max_threads: int = 256) -> Reclaimer:
    try:
        return SCHEMES[name](max_threads=max_threads)
    except KeyError:
        raise ValueError(
            f"unknown scheme {name!r}; available: {sorted(SCHEMES)}"
        ) from None


__all__ = [
    "AtomicInt",
    "AtomicMarkedRef",
    "AtomicRef",
    "MarkedValue",
    "DELETE_MARK",
    "ConcurrentPtr",
    "Guard",
    "ReclaimableNode",
    "Reclaimer",
    "ThreadRecord",
    "Block",
    "StampPool",
    "STAMP_INC",
    "PENDING_PUSH",
    "NOT_IN_LIST",
    "StampItReclaimer",
    "EpochReclaimer",
    "NewEpochReclaimer",
    "QuiescentStateReclaimer",
    "HazardPointerReclaimer",
    "LockFreeRefCountReclaimer",
    "DebraReclaimer",
    "IntervalReclaimer",
    "SCHEMES",
    "AMORTIZED_REGION_SCHEMES",
    "make_reclaimer",
    "MichaelScottQueue",
    "HarrisMichaelListSet",
    "HashMap",
    "BoundedHashMap",
]
