"""Scheme-agnostic lock-free data structures used by the paper's benchmarks
(§4.1): Michael & Scott queue, Michael's improved version of Harris'
list-based set, and the hash-map built from it (plus the FIFO-bounded
variant used by the HashMap benchmark).

A copy of the JAX package's ``repro/core/ds`` (pure Python) over this
package's :mod:`repro_torch.core` atomics and Robison interface, so every
scheme of :data:`repro_torch.core.SCHEMES` (Stamp-it on the repaired
Stamp Pool included) drives them.
"""

from .queue import MichaelScottQueue
from .list_set import HarrisMichaelListSet
from .hash_map import HashMap, BoundedHashMap

__all__ = [
    "MichaelScottQueue",
    "HarrisMichaelListSet",
    "HashMap",
    "BoundedHashMap",
]
