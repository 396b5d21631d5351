"""KV-page gather: the Hopper kernel's wrapper and its plain version.

Replaces the TPU kernel ``repro/kernels/block_gather.py:
block_gather_pallas`` (body ``_kernel``): ``out[i] = pool[idx[i]]`` for
M whole pages of a ``(N_pool, *page)`` pool.  On the ported path it is
the read half of ``DeviceState.copy_pages`` — the copy-on-write fork
admission and the prefix-cache replay admission — one launch per pool
over every layer at once.

The kernel (``csrc/block_gather.cu``) copies bytes, so it takes any
dtype: one block per (gathered page, piece of the page), 16-byte vector
loads and stores where the page size and addresses allow, narrower words
otherwise.  It runs on the current stream, so a copy is ordered before
every later step on that stream — the order the engine's early release
of a forked partial page relies on.  Its times are in PERF.md.

:func:`block_gather_plain` is the plain PyTorch version (``pool[idx]``);
``ops.block_gather`` sends CPU tensors to it and CUDA tensors to
:func:`block_gather_kernel`.
"""

from __future__ import annotations

import torch

from . import _build
from .ref import block_gather as block_gather_plain


def block_gather_kernel(pool: torch.Tensor,
                        indices: torch.Tensor) -> torch.Tensor:
    """Launch the gather on the current stream of ``pool``'s device;
    returns ``(M, *pool.shape[1:])`` in ``pool.dtype``.

    ``pool`` must be a contiguous CUDA tensor: the wrapper never copies
    it, since a gather from a copy would read stale pages silently.
    ``indices`` is a 1-D int32 tensor.  On the CPU (the host built it) it
    is checked against ``[0, N_pool)`` and uploaded; on the card it is
    used as it is, and an index out of range gives a zero page."""
    if not pool.is_cuda:
        raise ValueError("block_gather_kernel takes a CUDA pool")
    if not pool.is_contiguous():
        raise ValueError("block_gather_kernel needs a contiguous pool")
    if pool.dim() < 2:
        raise ValueError(f"pool {tuple(pool.shape)} is not (N_pool, *page)")
    if indices.dtype != torch.int32 or indices.dim() != 1:
        raise TypeError("indices must be a 1-D int32 tensor")
    n_pool = pool.shape[0]
    if not indices.is_cuda:
        if indices.numel() and (int(indices.min()) < 0
                                or int(indices.max()) >= n_pool):
            raise IndexError(f"page index outside [0, {n_pool})")
        indices = indices.to(pool.device)
    elif indices.device != pool.device:
        raise ValueError("indices must be on the pool's device")
    indices = indices.contiguous()
    m = indices.shape[0]
    out = torch.empty((m, *pool.shape[1:]), dtype=pool.dtype,
                      device=pool.device)
    page_bytes = pool[0].numel() * pool.element_size()
    lib = _build.load("block_gather")
    err = lib.repro_block_gather(
        pool.device.index, pool.data_ptr(), indices.data_ptr(),
        out.data_ptr(), m, n_pool, page_bytes,
        torch.cuda.current_stream(pool.device).cuda_stream,
    )
    _build.check(lib, err, "block_gather kernel launch")
    block_gather_kernel.launches += 1
    return out


#: launches of the kernel since the count was last set to 0
block_gather_kernel.launches = 0

__all__ = ["block_gather_kernel", "block_gather_plain"]
