"""Paged decode attention: the Hopper kernel's wrapper and its plain version.

Replaces the TPU kernel ``repro/kernels/paged_attention.py:
paged_attention_pallas`` (body ``_paged_kernel``), both branches: global
page ids into the slot-flattened pool (``global_pages=True``, the serving
engine) and page ids local to each row's own pool (``global_pages=False``,
the encoder-decoder's self-attention cache and the hybrid's shared-block
pools).  One build serves both; the mode is a runtime argument.

The kernel (``csrc/paged_attention.cu``) runs the contiguous decode
kernel's block body (``csrc/decode_split.cuh``): each row's key range is
split across blocks, a block per (split, kv head, sequence), a split
being whole tiles of at most 64 rows that never cross a page.  The
block reads its pages' ids from the table itself; K and V tiles arrive by
16-byte ``cp.async``; a second small kernel combines the splits' partial
softmax states.  :func:`plan_splits` picks the split from shapes only
(``lengths`` lives on the card).  On the H100 it is bound by bytes: each
key and value row is read once for a handful of flops.  Its times are in
PERF.md.

:func:`paged_attention_plain` is the plain PyTorch version (gather the
pages, then softmax attention); ``ops.paged_attention`` sends CPU tensors
to it and CUDA tensors to :func:`paged_attention_kernel`.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import torch

from . import _build
from .ref import paged_attention as paged_attention_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the most rows a tile holds: half a page of 128.  A block's shared
#: memory holds one tile of K and V, so at zamba2's D 112 a 64-row tile
#: lets 7 blocks share an SM where a 128-row one lets 3 (measured faster
#: on the H100: PERF.md)
MAX_TILE = 64
#: the fewest rows a tile holds when pages are cut to fill the card: at
#: the serving engine's first steps (n_kv 1 and 2) 32-row tiles measured
#: 11-15% faster than 64-row ones on the H100, and level at n_kv 4
#: (tools/paged_tile_rows.py; PERF.md)
MIN_TILE = 32
#: streaming multiprocessors of the H100
SMS = 132
#: the most blocks a launch should hold, 32 a streaming multiprocessor:
#: past it a split takes more tiles (at zamba2's shape two tiles a split
#: measured faster than twice the blocks: PERF.md)
MAX_BLOCKS = 32 * SMS

_launch = _build.Entry("paged_attention", "repro_paged_attention",
                       "17qd5q")


class PagedPlan(NamedTuple):
    block: int            # pool rows per tile; divides the page's rows
    splits: int           # key ranges per (sequence, kv head)
    tiles_per_split: int  # tiles in each range


@functools.lru_cache(maxsize=256)
def plan_splits(B: int, Hkv: int, n_kv: int, page_rows: int) -> PagedPlan:
    """The kernel's launch shape, from shapes only.  A tile is the
    largest divisor of ``page_rows`` up to :data:`MAX_TILE`; where the
    ``B * Hkv`` rows' tiles number fewer than :data:`SMS`, tiles are
    halved (down to :data:`MIN_TILE` rows) so that more blocks share the
    sweep.  One tile a split unless the tiles would pass
    :data:`MAX_BLOCKS` blocks; split ``s`` covers tiles ``[s * t, (s + 1)
    * t)`` with ``t = tiles_per_split``, ``n_kv * page_rows / block``
    tiles in all."""
    block = max(d for d in range(1, min(MAX_TILE, page_rows) + 1)
                if page_rows % d == 0)
    while (B * Hkv * n_kv * (page_rows // block) < SMS
           and block % 2 == 0 and block // 2 >= MIN_TILE):
        block //= 2
    n_tiles = n_kv * (page_rows // block)
    per = min(n_tiles, max(1, -(-(B * Hkv * n_tiles) // MAX_BLOCKS)))
    return PagedPlan(block, -(-n_tiles // per), per)


def paged_attention_kernel(
    q: torch.Tensor,            # (B, H, D)
    k_pool: torch.Tensor,       # (B, N_pool, block, Hkv, D)
    v_pool: torch.Tensor,       # (B, N_pool, block, Hkv, D)
    block_table: torch.Tensor,  # (B, max_blocks) int32 page ids
    lengths: torch.Tensor,      # (B,) int32
    *,
    n_kv: Optional[int] = None,
    global_pages: bool = False,
) -> torch.Tensor:
    """Launch the paged decode kernel on ``q``'s stream.

    With ``global_pages`` table entries are GLOBAL page ids ``slot *
    N_pool + page`` into the slot-flattened pool; otherwise they are page
    ids inside row b's own pool ``k_pool[b]``.  Only the first ``n_kv``
    columns are swept.  The caller guarantees every swept entry is a
    valid id (the engine's rows pad with the scratch page 0).  Returns (B, H, D) in q.dtype.
    """
    if not q.is_cuda:
        raise ValueError("paged_attention_kernel takes CUDA tensors")
    dtype = _DTYPES.get(q.dtype)
    if dtype is None:
        raise TypeError(f"unsupported dtype {q.dtype}")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError("q, k_pool and v_pool must share one dtype")
    if k_pool.dim() != 5 or k_pool.shape != v_pool.shape:
        raise ValueError("pools must be (B, N_pool, block, Hkv, D), equal")
    B, H, D = q.shape
    _, n_pool, page_rows, Hkv, Dk = k_pool.shape
    if Dk != D or H % Hkv:
        raise ValueError(f"q {tuple(q.shape)} vs pool {tuple(k_pool.shape)}")
    if block_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("block_table and lengths must be int32")
    if block_table.dim() != 2 or block_table.shape[0] != B \
            or lengths.shape != (B,):
        raise ValueError("block_table / lengths batch mismatch")
    if not global_pages and k_pool.shape[0] != B:
        raise ValueError(f"per-slot pages need one pool per row: "
                         f"{k_pool.shape[0]} pools for {B} rows")
    device, stream = _build.device_stream(q)
    if (k_pool.get_device() != device or v_pool.get_device() != device
            or block_table.get_device() != device
            or lengths.get_device() != device):
        raise ValueError("all operands must be on q's device")
    mb = block_table.shape[1]
    n_kv = mb if n_kv is None else min(int(n_kv), mb)
    plan = plan_splits(B, Hkv, n_kv, page_rows)
    q = q.contiguous()
    k_pool = k_pool.contiguous()
    v_pool = v_pool.contiguous()
    block_table = block_table.contiguous()
    lengths = lengths.contiguous()
    out = torch.empty_like(q)
    ws = None
    if plan.splits > 1:  # partial (acc, m, l) of each split, f32
        ws = torch.empty(plan.splits * B * H * (D + 2), dtype=torch.float32,
                         device=q.device)
    _launch(device, dtype, q.data_ptr(), k_pool.data_ptr(),
            v_pool.data_ptr(), block_table.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), B, H, Hkv, D, page_rows, n_pool, mb, n_kv,
            1 if global_pages else 0, 1.0 / math.sqrt(D), *plan,
            0 if ws is None else ws.data_ptr(), stream)
    paged_attention_kernel.launches += 1
    if plan.splits > 1:
        paged_attention_kernel.combine_launches += 1
    return out


#: wrapper calls that launched the kernel since the count was last set to 0
paged_attention_kernel.launches = 0
#: of those, the calls that also launched the split combine
paged_attention_kernel.combine_launches = 0

__all__ = ["PagedPlan", "paged_attention_kernel", "paged_attention_plain",
           "plan_splits"]
