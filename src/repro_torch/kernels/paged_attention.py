"""Paged decode attention: the Hopper kernel's wrapper and its plain version.

Replaces the TPU kernel ``repro/kernels/paged_attention.py:
paged_attention_pallas`` (body ``_paged_kernel``), both branches: global
page ids into the slot-flattened pool (``global_pages=True``, the serving
engine) and page ids local to each row's own pool (``global_pages=False``,
the encoder-decoder's self-attention cache).  One build serves both; the
mode is a runtime argument.

The kernel (``csrc/paged_attention.cu``) runs one block per (sequence,
kv head), streams the pages its block-table row names through shared
memory in table order and keeps the online softmax of the whole GQA
group in f32.  On the H100 it is bound by bytes: each key and value row
is read once for a handful of flops.  At small batch B * Hkv blocks leave
most of the 132 SMs idle; splitting the page sweep across blocks is the
first thing a later version fixes.  Its times are in PERF.md.

:func:`paged_attention_plain` is the plain PyTorch version (gather the
pages, then softmax attention); ``ops.paged_attention`` sends CPU tensors
to it and CUDA tensors to :func:`paged_attention_kernel`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build
from .ref import paged_attention as paged_attention_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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
    valid id (the engine's rows pad with the scratch page 0).  Returns
    (B, H, D) in q.dtype.
    """
    if not q.is_cuda:
        raise ValueError("paged_attention_kernel takes CUDA tensors")
    if q.dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {q.dtype}")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError("q, k_pool and v_pool must share one dtype")
    if k_pool.dim() != 5 or k_pool.shape != v_pool.shape:
        raise ValueError("pools must be (B, N_pool, block, Hkv, D), equal")
    B, H, D = q.shape
    n_pool, block, Hkv = k_pool.shape[1], k_pool.shape[2], k_pool.shape[3]
    if k_pool.shape[4] != D or H % Hkv:
        raise ValueError(f"q {tuple(q.shape)} vs pool {tuple(k_pool.shape)}")
    if block_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("block_table and lengths must be int32")
    if block_table.shape[0] != B or lengths.shape != (B,):
        raise ValueError("block_table / lengths batch mismatch")
    if not global_pages and k_pool.shape[0] != B:
        raise ValueError(f"per-slot pages need one pool per row: "
                         f"{k_pool.shape[0]} pools for {B} rows")
    for t in (k_pool, v_pool, block_table, lengths):
        if t.device != q.device:
            raise ValueError("all operands must be on q's device")
    mb = block_table.shape[1]
    n_kv = mb if n_kv is None else min(int(n_kv), mb)
    q = q.contiguous()
    k_pool = k_pool.contiguous()
    v_pool = v_pool.contiguous()
    block_table = block_table.contiguous()
    lengths = lengths.contiguous()
    out = torch.empty_like(q)
    lib = _build.load("paged_attention")
    err = lib.repro_paged_attention(
        q.device.index, _DTYPES[q.dtype], q.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), block_table.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), B, H, Hkv, D, block, n_pool, mb, n_kv,
        1 if global_pages else 0, 1.0 / math.sqrt(D),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, err, "paged_attention kernel launch")
    paged_attention_kernel.launches += 1
    return out


#: launches of the kernel since the count was last set to 0
paged_attention_kernel.launches = 0

__all__ = ["paged_attention_kernel", "paged_attention_plain"]
