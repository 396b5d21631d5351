"""Memory plane: the paged BlockPool written once against the
reclamation-policy interface — every scheme of the paper's comparison,
the native analogues and the robust pair — the stamp ledger, the prefix
cache and the stall injector."""

from .block_pool import BlockPool, PoolExhausted, ShardedPoolSet
from .policy import (
    PAPER_POLICIES,
    POLICIES,
    ROBUST_POLICIES,
    CoreSchemeAdapter,
    CrystallinePolicy,
    EpochPolicy,
    HyalinePolicy,
    PolicyHold,
    ReclamationPolicy,
    RefcountPolicy,
    ScanPolicy,
    StampItPolicy,
    make_policy,
)
from .prefix_cache import PrefixCache, block_key, prefix_block_keys
from .stall import StallInjector
from .stamp_ledger import StampLedger

__all__ = [
    "BlockPool", "PoolExhausted", "ShardedPoolSet", "PrefixCache",
    "block_key", "prefix_block_keys", "StampLedger",
    "ReclamationPolicy", "PolicyHold",
    "StampItPolicy", "EpochPolicy", "ScanPolicy", "RefcountPolicy",
    "HyalinePolicy", "CrystallinePolicy", "CoreSchemeAdapter",
    "StallInjector",
    "POLICIES", "PAPER_POLICIES", "ROBUST_POLICIES", "make_policy",
]
