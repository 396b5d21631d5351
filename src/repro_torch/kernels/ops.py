"""Device dispatch for the kernels of the ported paths.

The tensor's device decides: a CUDA tensor goes to the hand-written
kernel, a CPU tensor to the plain PyTorch version.  There is no
environment switch and no fallback: a kernel that fails to build or to
launch raises.  ``impl="plain"`` forces the plain version on any device;
it exists so tests and ``chip_smoke.py`` can hold the kernels against
the plain versions on the card.  Flash attention and the SSD scan have
backward kernels (``FlashAttention``, ``SSDChunkScan``); the inference
kernels (decode, paged attention, the block gather) raise when autograd
would need their gradient (``_build.refuse_grad``).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import ref
from .block_gather import block_gather_kernel
from .decode_attention import decode_attention_kernel
from .flash_attention import FlashAttention, flash_attention_kernel
from .paged_attention import paged_attention_kernel
from .ssd_scan import SSDChunkScan, ssd_chunk_scan_kernel


def _plain(x: torch.Tensor, impl: Optional[str]) -> bool:
    if impl == "plain":
        return True
    if impl is not None:
        raise ValueError(f"impl must be None or 'plain', got {impl!r}")
    if x.device.type == "cuda":
        return False
    if x.device.type == "cpu":
        return True
    raise ValueError(f"no kernel path for device {x.device}")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0, impl: Optional[str] = None):
    """Attention over a whole chunk.  On the card, where grad mode is on
    and an input requires grad, the kernel runs with its backward kernel
    (``FlashAttention``, ``q_offset`` 0 only); the plain version keeps
    PyTorch's own autograd."""
    if _plain(q, impl):
        return ref.flash_attention(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if q_offset:
            raise ValueError("the flash backward kernel takes q_offset 0, "
                             f"got {q_offset}")
        return FlashAttention.apply(q, k, v, causal, window)
    return flash_attention_kernel(q, k, v, causal=causal, window=window,
                                  q_offset=q_offset)


def paged_attention(q, k_pool, v_pool, block_table, lengths, *,
                    n_kv: Optional[int] = None, global_pages: bool = False,
                    impl: Optional[str] = None):
    """``n_kv`` bounds the page sweep to the first ``n_kv`` table
    columns; ``global_pages`` makes table entries slot-flattened global
    page ids (``slot * N_pool + page``)."""
    if _plain(q, impl):
        return ref.paged_attention(q, k_pool, v_pool, block_table, lengths,
                                   n_kv=n_kv, global_pages=global_pages)
    return paged_attention_kernel(q, k_pool, v_pool, block_table, lengths,
                                  n_kv=n_kv, global_pages=global_pages)


def decode_attention(q, k_cache, v_cache, lengths, *,
                     impl: Optional[str] = None):
    """One query token per sequence against a contiguous ``(B, S_max,
    Hkv, D)`` cache whose first ``lengths[b]`` rows are valid."""
    if _plain(q, impl):
        return ref.decode_attention(q, k_cache, v_cache, lengths)
    return decode_attention_kernel(q, k_cache, v_cache, lengths)


def ssd_chunk_scan(x, dt, a, b, c, *, chunk: int = 128, d_skip=None,
                   init_state=None, impl: Optional[str] = None):
    """The Mamba2 SSD scan over whole chunks of ``min(chunk, S)`` tokens.
    The plain version takes what the JAX package's oracle takes: G B/C
    groups with ``H % G == 0`` and an ``init_state``; it raises where that
    oracle asserts.  The kernel keeps the TPU kernel's limits (one group,
    no initial state) and raises on the others.  On the card, where grad
    mode is on and an input requires grad, the kernel runs with its
    backward kernel (``SSDChunkScan``); the plain version keeps PyTorch's
    own autograd."""
    chunk = min(int(chunk), x.shape[1])
    if _plain(x, impl):
        return ref.ssd_chunk_scan(x, dt, a, b, c, chunk=chunk,
                                  d_skip=d_skip, init_state=init_state)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, a, b, c, d_skip, init_state)):
        if init_state is not None:
            raise ValueError("the SSD backward kernel starts from a zero "
                             "state; init_state is not supported")
        return SSDChunkScan.apply(x, dt, a, b, c, d_skip, chunk)
    return ssd_chunk_scan_kernel(x, dt, a, b, c, chunk=chunk, d_skip=d_skip,
                                 init_state=init_state)


def ssd_decode_step(x, dt, a, b, c, state, *, d_skip=None):
    """The single-token SSD recurrence.  The plain version on every
    device, as in the JAX package: it is not a TPU kernel there either."""
    return ref.ssd_decode_step(x, dt, a, b, c, state, d_skip=d_skip)


def block_gather(pool, indices, *, impl: Optional[str] = None):
    """``pool[indices]`` for whole pages of a ``(N_pool, *page)`` pool;
    ``indices`` is 1-D int32 (on the CPU or the pool's device)."""
    if _plain(pool, impl):
        return ref.block_gather(pool, indices.to(pool.device))
    return block_gather_kernel(pool, indices)
