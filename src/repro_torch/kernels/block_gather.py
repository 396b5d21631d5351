"""KV-page gather: the Hopper kernel's wrapper, its launch plan and its
plain version.

Replaces the TPU kernel ``repro/kernels/block_gather.py:
block_gather_pallas`` (body ``_kernel``): ``out[i] = pool[idx[i]]`` for
M whole pages of a ``(N_pool, *page)`` pool, any dtype.  On the ported
path it is the read half of ``DeviceState.copy_pages`` (a copy-on-write
fork admission, a prefix-cache replay) and the whole of ``read_pages``
(a handoff or migration read), one launch per pool over every layer.

Its bound on the H100 is bytes (each page read once and written once):
0.47 µs at M 24 of qwen2's 32 KB pages, under one launch.  What a call
pays is fixed: on a cold L2 (the pages were written long before) an
empty kernel from the same library takes ~5 µs and a kernel that only
reads the index ~0.6 µs more, of the ~7 µs a gather of 24 pages takes
(PERF.md, ``tools/gather_probe.py``).  So the kernel
(``csrc/block_gather.cu``) keeps the chain short and starts every SM:
a 2-D grid of (page, piece) blocks of 256 threads; thread 0 reads the
page id once, and each thread loads all its words of the piece before
its first store.  :func:`plan_gather` picks the piece, 4, 2 or 1 words
a thread (the most that still gives each of the H100's 132 SMs a block
at the call's M), and the word, the widest of 16, 8, 4, 2 or 1 bytes
that the page size and both base addresses allow (a 30-byte page, a pool
viewed at an odd offset).  The C entry refuses a plan it cannot run, and
the wrapper raises.  An index outside ``[0, N_pool)`` gives a zero page.
The kernel runs on the current stream, so a copy is ordered before
every later step on that stream — the order the engine's early release
of a forked partial page relies on.

:func:`block_gather_plain` is the plain PyTorch version (``pool[idx]``);
``ops.block_gather`` sends CPU tensors to it and CUDA tensors to
:func:`block_gather_kernel`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import _build
from .ref import block_gather as block_gather_plain

#: SMs of the H100 SXM the plan fills
SMS = 132
#: threads a block; a piece of a page is 4, 2 or 1 words a thread, all
#: loaded before the first store
THREADS = 256
WORDS = (4, 2, 1)

_PROBES = {"empty": 0, "index": 1}


class GatherPlan(NamedTuple):
    """How one call copies its M pages, in the order the C entry reads the
    fields: block ``(i, p)`` of an ``(M, pieces)`` grid copies bytes ``[p
    * piece_bytes, min((p + 1) * piece_bytes, page))`` of gathered page
    ``i`` in words of ``word_bytes``."""

    piece_bytes: int
    pieces: int  # a page's
    word_bytes: int


def plan_gather(page_bytes: int, m: int, pool_ptr: int,
                out_ptr: int) -> GatherPlan:
    """The plan for gathering ``m`` pages of ``page_bytes`` from a pool at
    address ``pool_ptr`` into an output at ``out_ptr``: the word the
    widest (16, 8, 4, 2 or 1 bytes) that divides the page size and both
    addresses, the piece 4, 2 or 1 words a thread, the most that still
    gives every SM a block."""
    align = pool_ptr | out_ptr | page_bytes
    return _plan(page_bytes, m, min(align & -align, 16))


@functools.lru_cache(maxsize=256)
def _plan(page_bytes: int, m: int, word: int) -> GatherPlan:
    if page_bytes <= 0 or m < 0:
        raise ValueError(f"page of {page_bytes} bytes, M {m}")
    for words in WORDS:
        piece = min(THREADS * words * word, page_bytes)
        pieces = -(-page_bytes // piece)
        if m * pieces >= SMS:
            break
    return GatherPlan(piece, pieces, word)


_launch = _build.Entry("block_gather", "repro_block_gather", "11q")
_launch_probe = _build.Entry("block_gather", "repro_block_gather_probe", "7q")


def block_gather_kernel(pool: torch.Tensor,
                        indices: torch.Tensor) -> torch.Tensor:
    """Launch the gather on the current stream of ``pool``'s device;
    returns ``(M, *pool.shape[1:])`` in ``pool.dtype``.

    ``pool`` must be a contiguous CUDA tensor: the wrapper never copies
    it, since a gather from a copy would read stale pages silently.
    ``indices`` is a 1-D int32 tensor.  On the CPU (the host built it) it
    is checked against ``[0, N_pool)`` and uploaded; on the card it is
    used as it is, and an index out of range gives a zero page.  M 0
    launches nothing.  The plan is ``plan_gather(page_bytes, M,
    pool.data_ptr(), out.data_ptr())``.

    The host path is kept short, since at the engine's sizes a call's
    enqueue outlasts its copy: the page size comes from the pool's size
    (no view), the stream from :func:`_build.device_stream` (no
    ``torch.cuda.Stream``), the plan from a cache, and the C entry takes
    one packed argument block and sets the device only when it is not
    current."""
    if not pool.is_cuda:
        raise ValueError("block_gather_kernel takes a CUDA pool")
    _build.refuse_grad("block_gather_kernel", pool)
    if not pool.is_contiguous():
        raise ValueError("block_gather_kernel needs a contiguous pool")
    if pool.dim() < 2:
        raise ValueError(f"pool {tuple(pool.shape)} is not (N_pool, *page)")
    if indices.dtype != torch.int32 or indices.dim() != 1:
        raise TypeError("indices must be a 1-D int32 tensor")
    device, stream = _build.device_stream(pool)
    shape = pool.shape
    n_pool = shape[0]
    if not indices.is_cuda:
        if indices.numel() and (int(indices.min()) < 0
                                or int(indices.max()) >= n_pool):
            raise IndexError(f"page index outside [0, {n_pool})")
        indices = indices.to(pool.device)
    elif indices.get_device() != device:
        raise ValueError("indices must be on the pool's device")
    if not indices.is_contiguous():
        indices = indices.contiguous()
    m = indices.numel()
    out = pool.new_empty((m, *shape[1:]))
    if m == 0:
        return out
    # numel, not stride(0): a contiguous pool of one page may have any
    # stride on its first axis
    page_bytes = pool.numel() // n_pool * pool.element_size()
    src, dst = pool.data_ptr(), out.data_ptr()
    _launch(device, src, indices.data_ptr(), dst, m, n_pool, page_bytes,
            stream, *plan_gather(page_bytes, m, src, dst))
    block_gather_kernel.launches += 1
    return out


#: launches of the kernel since the count was last set to 0
block_gather_kernel.launches = 0


def block_gather_probe(indices: torch.Tensor, grid: int,
                       kind: str = "empty") -> None:
    """Launch a probe from the gather's library on the current stream:
    ``"empty"`` (an empty kernel of ``grid`` one-warp blocks: the launch
    floor) or ``"index"`` (each block reads one entry of ``indices``, a
    1-D int32 CUDA tensor).  For timing the gather's fixed cost; not a
    gather, and not counted in ``block_gather_kernel.launches``."""
    device, stream = _build.device_stream(indices)
    sink = indices.new_empty(1)
    _launch_probe(device, indices.data_ptr(), sink.data_ptr(),
                  indices.shape[0], grid, _PROBES[kind], stream)


__all__ = ["GatherPlan", "block_gather_kernel", "block_gather_plain",
           "block_gather_probe", "plan_gather"]
