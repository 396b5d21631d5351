"""Memory plane: the paged BlockPool written once against the
reclamation-policy interface, the stamp ledger and the prefix cache."""

from .block_pool import BlockPool, PoolExhausted, ShardedPoolSet
from .policy import (
    POLICIES,
    EpochPolicy,
    PolicyHold,
    ReclamationPolicy,
    StampItPolicy,
    make_policy,
)
from .prefix_cache import PrefixCache, block_key, prefix_block_keys
from .stamp_ledger import StampLedger

__all__ = [
    "BlockPool", "PoolExhausted", "ShardedPoolSet", "PrefixCache",
    "block_key", "prefix_block_keys", "StampLedger",
    "ReclamationPolicy", "PolicyHold", "StampItPolicy", "EpochPolicy",
    "POLICIES", "make_policy",
]
