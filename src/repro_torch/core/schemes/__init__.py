"""The six (re)implemented competitor schemes from the paper (§1, §4).

All schemes sit behind the same :class:`repro_torch.core.interface.Reclaimer`
interface, exactly as the paper builds every scheme behind the adapted
Robison interface so the benchmark data structures are scheme-agnostic.
"""

from .epoch import EpochReclaimer, NewEpochReclaimer
from .interval import IntervalReclaimer
from .qsr import QuiescentStateReclaimer
from .hazard import HazardPointerReclaimer
from .lfrc import LockFreeRefCountReclaimer
from .debra import DebraReclaimer

__all__ = [
    "IntervalReclaimer",
    "EpochReclaimer",
    "NewEpochReclaimer",
    "QuiescentStateReclaimer",
    "HazardPointerReclaimer",
    "LockFreeRefCountReclaimer",
    "DebraReclaimer",
]
