"""Contiguous-cache decode attention: the Hopper kernel's wrapper and its
plain version.

Replaces the TPU kernel ``repro/kernels/paged_attention.py:
decode_attention_pallas`` (body ``_decode_kernel``): one query token per
sequence against a contiguous ``(B, S_max, Hkv, D)`` cache whose first
``lengths[b]`` rows are valid.  On the ported path it is the
encoder-decoder's cross-attention decode (``layers.attention_decode``
with ``cross=True``), over the cross cache of the encoder output.

The kernel (``csrc/decode_attention.cu``) runs one block per (sequence,
kv head) and streams the row's valid prefix in tiles of 128 rows through
the decode body it shares with the paged kernel (``csrc/common.cuh``).
On the H100 it is bound by bytes: each K and V row is read once for
about one flop per byte at G = 1.  Its times are in PERF.md.

:func:`decode_attention_plain` is the plain PyTorch version;
``ops.decode_attention`` sends CPU tensors to it and CUDA tensors to
:func:`decode_attention_kernel`.
"""

from __future__ import annotations

import math

import torch

from . import _build
from .ref import decode_attention as decode_attention_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: rows of the cache per tile, as the TPU kernel's ``block_k``
BLOCK_K = 128


def decode_attention_kernel(
    q: torch.Tensor,        # (B, H, D)
    k_cache: torch.Tensor,  # (B, S_max, Hkv, D)
    v_cache: torch.Tensor,  # (B, S_max, Hkv, D)
    lengths: torch.Tensor,  # (B,) int32
) -> torch.Tensor:
    """Launch the decode kernel on ``q``'s stream; returns (B, H, D) in
    q.dtype.  ``S_max`` must be a multiple of ``min(128, S_max)``, as the
    TPU kernel asserts.  A row with ``lengths <= 0`` attends uniformly
    over all ``S_max`` rows, as the TPU kernel and the plain softmax do."""
    if not q.is_cuda:
        raise ValueError("decode_attention_kernel takes CUDA tensors")
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
    block = min(BLOCK_K, S_max)
    if S_max % block:
        raise ValueError(f"S_max {S_max} is not a multiple of {block}")
    if lengths.dtype != torch.int32 or lengths.shape != (B,):
        raise TypeError("lengths must be (B,) int32")
    for t in (k_cache, v_cache, lengths):
        if t.device != q.device:
            raise ValueError("all operands must be on q's device")
    q = q.contiguous()
    k_cache = k_cache.contiguous()
    v_cache = v_cache.contiguous()
    lengths = lengths.contiguous()
    out = torch.empty_like(q)
    lib = _build.load("decode_attention")
    err = lib.repro_decode_attention(
        q.device.index, _DTYPES[q.dtype], q.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), lengths.data_ptr(), out.data_ptr(), B, H, Hkv, D,
        S_max, block, 1.0 / math.sqrt(D),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, err, "decode_attention kernel launch")
    decode_attention_kernel.launches += 1
    return out


#: launches of the kernel since the count was last set to 0
decode_attention_kernel.launches = 0

__all__ = ["decode_attention_kernel", "decode_attention_plain"]
