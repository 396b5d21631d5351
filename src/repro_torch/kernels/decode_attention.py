"""Contiguous-cache decode attention: the Hopper kernel's wrapper and its
plain version.

Replaces the TPU kernel ``repro/kernels/paged_attention.py:
decode_attention_pallas`` (body ``_decode_kernel``): one query token per
sequence against a contiguous ``(B, S_max, Hkv, D)`` cache whose first
``lengths[b]`` rows are valid.  On the ported path it is the
encoder-decoder's cross-attention decode (``layers.attention_decode``
with ``cross=True``), over the cross cache of the encoder output.

The kernel (``csrc/decode_attention.cu``, its block body in
``csrc/decode_split.cuh``, shared with the paged kernel) splits each
row's key range across blocks: a block per (split, kv head, sequence), a
split being whole tiles of 128 cache rows.  :func:`plan_splits` picks the split from
``S_max`` and ``B * Hkv`` alone (``lengths`` lives on the card); splits
past a row's length leave at once, and a second small kernel combines
the splits' partial softmax states.  On the H100 it is bound by bytes:
each K and V row is read once for about one flop per byte at G = 1.
Its times are in PERF.md.

:func:`decode_attention_plain` is the plain PyTorch version;
``ops.decode_attention`` sends CPU tensors to it and CUDA tensors to
:func:`decode_attention_kernel`.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import _build
from .ref import decode_attention as decode_attention_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: rows of the cache per tile, as the TPU kernel's ``block_k``
BLOCK_K = 128
#: the most blocks a launch should hold: 32 a streaming multiprocessor of
#: the H100's 132 (most of them leave at once past a row's length)
MAX_BLOCKS = 32 * 132

_launch = _build.Entry("decode_attention", "repro_decode_attention",
                       "13qd4q")


class DecodePlan(NamedTuple):
    block: int            # cache rows per tile
    splits: int           # key ranges per (sequence, kv head)
    tiles_per_split: int  # tiles in each range


def plan_splits(B: int, Hkv: int, S_max: int) -> DecodePlan:
    """The kernel's launch shape, from shapes only: tiles of ``min(128,
    S_max)`` rows, one tile a split unless ``B * Hkv * tiles`` blocks
    would pass :data:`MAX_BLOCKS`; split ``s`` covers tiles ``[s * t, (s
    + 1) * t)`` with ``t = tiles_per_split``."""
    block = min(BLOCK_K, S_max)
    n_tiles = S_max // block
    per = min(n_tiles, max(1, -(-(B * Hkv * n_tiles) // MAX_BLOCKS)))
    return DecodePlan(block, -(-n_tiles // per), per)


def decode_attention_kernel(
    q: torch.Tensor,        # (B, H, D)
    k_cache: torch.Tensor,  # (B, S_max, Hkv, D)
    v_cache: torch.Tensor,  # (B, S_max, Hkv, D)
    lengths: torch.Tensor,  # (B,) int32
) -> torch.Tensor:
    """Launch the decode kernel on ``q``'s stream; returns (B, H, D) in
    q.dtype.  ``S_max`` must be a multiple of ``min(128, S_max)``, as the
    TPU kernel asserts.  D 32, 64, 112 and 128 take the kernel's 16-byte
    key slices; any other D takes its run-time-D form.  Tiles load by 16-byte
    ``cp.async`` where rows are whole 16-byte chunks and the caches are
    16-byte aligned, element by element otherwise.  A row with
    ``lengths <= 0`` attends uniformly over all ``S_max`` rows, as the TPU
    kernel and the plain softmax do."""
    if not q.is_cuda:
        raise ValueError("decode_attention_kernel takes CUDA tensors")
    _build.refuse_grad("decode_attention_kernel", q, k_cache, v_cache)
    if q.dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {q.dtype}")
    if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError("q, k_cache and v_cache must share one dtype")
    if k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError("caches must be (B, S_max, Hkv, D), equal")
    B, H, D = q.shape
    S_max, Hkv = k_cache.shape[1], k_cache.shape[2]
    if k_cache.shape[0] != B or k_cache.shape[3] != D or H % Hkv:
        raise ValueError(f"q {tuple(q.shape)} vs cache "
                         f"{tuple(k_cache.shape)}")
    plan = plan_splits(B, Hkv, S_max)
    if S_max % plan.block:
        raise ValueError(f"S_max {S_max} is not a multiple of {plan.block}")
    if lengths.dtype != torch.int32 or lengths.shape != (B,):
        raise TypeError("lengths must be (B,) int32")
    device, stream = _build.device_stream(q)
    if (k_cache.get_device() != device or v_cache.get_device() != device
            or lengths.get_device() != device):
        raise ValueError("all operands must be on q's device")
    q = q.contiguous()
    k_cache = k_cache.contiguous()
    v_cache = v_cache.contiguous()
    lengths = lengths.contiguous()
    out = torch.empty_like(q)
    ws = None
    if plan.splits > 1:  # partial (acc, m, l) of each split, f32
        ws = torch.empty(plan.splits * B * H * (D + 2), dtype=torch.float32,
                         device=q.device)
    _launch(device, _DTYPES[q.dtype], q.data_ptr(), k_cache.data_ptr(),
            v_cache.data_ptr(), lengths.data_ptr(), out.data_ptr(), B, H,
            Hkv, D, S_max, plan.block, 1.0 / math.sqrt(D), plan.splits,
            plan.tiles_per_split, 0 if ws is None else ws.data_ptr(), stream)
    decode_attention_kernel.launches += 1
    if plan.splits > 1:
        decode_attention_kernel.combine_launches += 1
    return out


#: wrapper calls that launched the kernel since the count was last set to 0
decode_attention_kernel.launches = 0
#: of those, the calls that also launched the split combine
decode_attention_kernel.combine_launches = 0

__all__ = ["DecodePlan", "decode_attention_kernel", "decode_attention_plain",
           "plan_splits"]
