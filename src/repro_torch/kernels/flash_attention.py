"""Flash attention: the Hopper kernel's wrapper, its split planner and its
plain version.

Replaces the TPU kernel ``repro/kernels/flash_attention.py:
flash_attention_pallas`` (body ``_kernel``) on the chunked-prefill path
(``layers.attention_chunk``), the encoder's full attention and the
whole-sequence prefill (``layers.attention_full``), mixtral's with its
sliding window.  The TPU kernel binds ``q_offset`` and ``window`` as
Python constants; here they are runtime arguments of the kernel, so one
build serves every chunk start and window and the host passes the start
it already knows (no device read).

bf16 runs ``csrc/flash_attention.cu``'s warpgroup-MMA kernel: 64-row
query tiles per consumer warpgroup (one or two a block), K and V tiles
of 64 or 128 keys brought by TMA through a ring of mbarrier-guarded stages,
both products on the tensor cores and the online softmax in registers.
Where the query tiles alone would leave SMs idle, :func:`plan_splits`
splits the key range across blocks (from shapes only) and a second
small kernel combines the partial softmax states.  f32 runs the first
version's CUDA-core body, kept for the correctness checks held to 1e-4
(TF32 products would miss them).  Times are in PERF.md.

Sliding window (``window > 0``): row ``q_pos`` keeps key ``kv_pos`` only
if ``kv_pos > q_pos - window``, as the Pallas body does, causal or not,
at any ``q_offset``.  Key tiles before a block's first visible key are
not read, and :func:`plan_splits` splits only the keys the chunk can see,
``[kv_begin, kv_end)`` (:func:`key_range`).  A row that sees no key at
all (``q_pos - window + 1 >= S_kv``) averages every key, as the Pallas
body's fully masked rows do.

Head dims: D 32, 64 and 128 are compiled forms; any other D with
``D % 8 == 0`` and ``D <= 128`` (phi3's 96, zamba2's 112) runs a
run-time-D form, whose bf16 tiles are laid out for 64 or 128 columns and
filled with zeros past D by TMA (a tensor map's row stride must be whole
16-byte units).  That form runs one consumer warpgroup over key tiles of
64.  Other head dims raise.

:func:`flash_attention_plain` is the plain PyTorch version;
``ops.flash_attention`` sends CPU tensors to it and CUDA tensors, where
autograd needs a gradient, to the :class:`FlashAttention` function (its
forward the kernel above with ``with_stats``, which also writes each
row's softmax statistics; its backward :func:`flash_attention_bwd_kernel`,
``csrc/flash_attention_bwd.cu``: dQ, dK and dV of exactly what the
forward computes from those statistics, at ``q_offset`` 0, causal or
not, with any window, GQA, D as the forward takes it, bf16 and f32),
else to the kernel alone.  The bf16 backward is three kernels a call: a
row pass (D_i = rowsum(dO * O) beside the statistics), dK/dV on
``wgmma`` over the work :func:`plan_bwd` balances across the SMs, and dQ
on ``wgmma`` a query tile a block.  :func:`flash_attention_bwd_plain` is
its plain version, the same formula in PyTorch.
"""

from __future__ import annotations

import functools
import heapq
import math
from typing import NamedTuple

import torch

from . import _build
from .ref import flash_attention as flash_attention_plain
from .ref import flash_attention_bwd as flash_attention_bwd_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: head dims with a compiled form; others up to _MAX_HEAD_DIM run at run time
_COMPILED_HEAD_DIMS = (32, 64, 128)
_MAX_HEAD_DIM = 128
#: the H100's streaming multiprocessors: the blocks a launch should fill
SMS = 132
#: query rows per consumer warpgroup
ROWS = 64

_launch = _build.Entry("flash_attention", "repro_flash_attention", "15qd7q")
_launch_bwd = _build.Entry("flash_attention_bwd", "repro_flash_attention_bwd",
                           "21qd4q")
#: kernels a backward call launches at most (``timing``'s slots after the
#: count)
BWD_KERNELS = 3


class FlashPlan(NamedTuple):
    consumers: int        # consumer warpgroups per block: 64 rows each
    keys: int             # keys per K/V tile: 64 or 128
    splits: int           # key ranges per (q tile, head, sequence)
    tiles_per_split: int  # key tiles in each range


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def key_range(S_q: int, S_kv: int, *, q_offset: int = 0,
              causal: bool = True, window: int = 0) -> tuple:
    """``(kv_begin, kv_end)``: the keys the chunk's rows can see.  The end
    is ``min(S_kv, q_offset + S_q)`` when causal, else ``S_kv``; the begin
    is the window's lower edge for the first row, ``q_offset - window +
    1`` (at least 0), or 0 without a window.  Where the last row sees no
    key at all (``q_offset + S_q - window >= S_kv``) the begin is 0: that
    row averages every key.  The kernel computes the same from its
    arguments (``first_key`` in ``csrc/flash_attention.cu``)."""
    kv_end = min(S_kv, q_offset + S_q) if causal else S_kv
    kv_begin = 0
    if window > 0 and q_offset + S_q - window < S_kv:
        kv_begin = max(0, q_offset - window + 1)
    return kv_begin, kv_end


def plan_splits(B: int, S_q: int, H: int, S_kv: int, *, q_offset: int = 0,
                causal: bool = True, window: int = 0,
                head_dim: int) -> FlashPlan:
    """The bf16 kernel's launch shape, from shapes only.  Two consumer
    warpgroups (128-row tiles, which halve the K/V traffic) where those
    tiles alone fill the SMs and ``head_dim`` has a compiled form, else
    one.  The run-time-D form takes key tiles of 64 throughout: with
    tiles laid out for 128 columns, 128-key tiles would hold one block an
    SM and 64-key tiles hold two.  Where the query tiles give
    :data:`SMS` blocks or more, key tiles of 128 and no split.  Else the
    keys the chunk can see, ``[kv_begin, kv_end)`` (:func:`key_range`),
    are cut into tiles of 64 and equal ranges of whole tiles, enough to
    reach :data:`SMS` blocks; split ``s`` covers key tiles ``[b + s * t,
    b + (s + 1) * t)`` with ``b = kv_begin // 64`` and ``t =
    tiles_per_split``."""
    kv_begin, kv_end = key_range(S_q, S_kv, q_offset=q_offset, causal=causal,
                                 window=window)
    consumers = 1
    if (head_dim in _COMPILED_HEAD_DIMS
            and B * H * _cdiv(S_q, 2 * ROWS) >= SMS):
        consumers = 2
    blocks = B * H * _cdiv(S_q, consumers * ROWS)
    if blocks >= SMS:
        keys = 128 if head_dim in _COMPILED_HEAD_DIMS else 64
        tiles = _cdiv(kv_end, keys) - kv_begin // keys
        return FlashPlan(consumers, keys, 1, max(1, tiles))
    n_tiles = max(1, _cdiv(kv_end, 64) - kv_begin // 64)
    per = _cdiv(n_tiles, min(n_tiles, _cdiv(SMS, blocks)))
    return FlashPlan(1, 64, _cdiv(n_tiles, per), per)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """TMA reads from 16-byte aligned addresses: copy a view that is not."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention_kernel(
    q: torch.Tensor,  # (B, S_q, H, D)
    k: torch.Tensor,  # (B, S_kv, Hkv, D)
    v: torch.Tensor,  # (B, S_kv, Hkv, D)
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
    with_stats: bool = False,
):
    """Launch the flash kernel on ``q``'s stream; returns (B, S_q, H, D).
    With ``with_stats`` it returns ``(out, stats)``: ``stats`` (B, S_q, H,
    2) f32 holds each row's softmax statistics ``(m, l)`` in the log2
    domain (``ref.flash_attention``'s ``with_stats``), which the backward
    kernel reads; without it the kernel writes none and runs the code it
    ran before the statistics existed."""
    if not q.is_cuda:
        raise ValueError("flash_attention_kernel takes CUDA tensors")
    if q.dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if not isinstance(q_offset, int) or q_offset < 0:
        raise ValueError(f"q_offset must be a non-negative int, got "
                         f"{q_offset!r}")
    if not isinstance(window, int) or window < 0:
        raise ValueError(f"window must be a non-negative int, got "
                         f"{window!r}")
    B, S_q, H, D = q.shape
    S_kv, Hkv = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if H % Hkv or D % 8 or not 0 < D <= _MAX_HEAD_DIM:
        raise ValueError(f"H={H} Hkv={Hkv} D={D}: the kernel takes whole "
                         f"GQA groups and D % 8 == 0, D <= {_MAX_HEAD_DIM}")
    device, stream = _build.device_stream(q)
    if k.get_device() != device or v.get_device() != device:
        raise ValueError("all operands must be on q's device")
    if q.dtype == torch.bfloat16 and S_kv < 1:
        raise ValueError("the bf16 kernel needs at least one key")
    q, k, v = (_aligned(x.contiguous()) for x in (q, k, v))
    out = torch.empty_like(q)
    stats = (torch.empty((B, S_q, H, 2), dtype=torch.float32, device=q.device)
             if with_stats else None)
    plan, ws = FlashPlan(1, 128, 1, 1), None
    if q.dtype == torch.bfloat16:
        plan = plan_splits(B, S_q, H, S_kv, q_offset=q_offset,
                           causal=causal, window=window, head_dim=D)
        if plan.splits > 1:  # partial (acc, m, l) of each split, f32
            ws = torch.empty(plan.splits * B * S_q * H * (D + 2),
                             dtype=torch.float32, device=q.device)
    _launch(device, _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), B, S_q, S_kv, H, Hkv, D, q_offset,
            1 if causal else 0, window, 1.0 / math.sqrt(D), *plan,
            0 if ws is None else ws.data_ptr(),
            0 if stats is None else stats.data_ptr(), stream)
    flash_attention_kernel.launches += 1
    if plan.splits > 1:
        flash_attention_kernel.combine_launches += 1
    return (out, stats) if with_stats else out


#: wrapper calls that launched the kernel since the count was last set to 0
flash_attention_kernel.launches = 0
#: of those, the calls that also launched the split combine
flash_attention_kernel.combine_launches = 0


class BwdPlan(NamedTuple):
    rows: int        # query rows a dK/dV stage: 64, or 32 at head_dim > 64
    n_qt: int        # query tiles of ``rows`` rows
    items: tuple     # (b * Hkv + kv head, key tile, lo, hi, e) each
    offsets: tuple   # block i's items: items[offsets[i]:offsets[i + 1]]
    work: tuple      # (query head, query tile) pairs each block walks


def _item_tiles(S_q: int, S_kv: int, kt: int, *, rows: int, causal: bool,
                window: int) -> tuple:
    """``(lo, hi, e)``: the query tiles of ``rows`` rows that read some key
    of key tile ``kt`` (64 keys) are ``[lo, hi)`` and ``[max(hi, e),
    n_qt)``, the second those that hold a row which sees no key (it
    averages every key).  The same test per tile as the f32 kernel's
    ``tile_needed`` (``csrc/flash_attention_bwd.cu``)."""
    n_qt = _cdiv(S_q, rows)
    k0, k1 = 64 * kt, min(64 * kt + 64, S_kv)

    def empty(q1):  # the tile's last row sees no key
        return window > 0 and q1 - 1 >= S_kv + window - 1

    def needed(qt):
        q0, q1 = qt * rows, min(qt * rows + rows, S_q)
        if empty(q1):
            return True
        if causal and q1 - 1 < k0:
            return False
        return not (window > 0 and q0 - window + 1 > k1 - 1)

    e = next((qt for qt in range(n_qt)
              if empty(min(qt * rows + rows, S_q))), n_qt)
    seen = [qt for qt in range(e) if needed(qt)]
    lo, hi = (seen[0], seen[-1] + 1) if seen else (0, 0)
    if hi - lo != len(seen):
        raise AssertionError(f"key tile {kt}: query tiles {seen} are not "
                             f"one range")
    return lo, hi, e


@functools.lru_cache(maxsize=64)
def plan_bwd(B: int, S_q: int, S_kv: int, H: int, Hkv: int, *,
             causal: bool = True, window: int = 0,
             head_dim: int) -> BwdPlan:
    """The bf16 dK/dV kernel's work, from shapes only.  An item is one
    (sequence, kv head, 64-key tile): its block walks the G query heads
    and, for each, the query tiles that read its keys
    (:func:`_item_tiles`), and sums dK and dV over all of them, so that no
    sum crosses blocks.  Causal work falls from the first key tile (read
    by every query tile) to the last (read by one); the items go longest
    first, each to the block with the least work so far (ties to the
    lowest), over ``min(SMS, items)`` persistent blocks, so that no SM
    carries much more than the mean.  An item's cost is its (head, query
    tile) pairs plus one for its K and V tiles and its stores."""
    rows = 64 if head_dim <= 64 else 32
    G, n_kt, n_qt = H // Hkv, _cdiv(S_kv, 64), _cdiv(S_q, rows)
    tiles = [_item_tiles(S_q, S_kv, kt, rows=rows, causal=causal,
                         window=window) for kt in range(n_kt)]
    pairs = [G * ((hi - lo) + max(0, n_qt - max(hi, e)))
             for lo, hi, e in tiles]
    order = sorted(((bh, kt) for bh in range(B * Hkv) for kt in range(n_kt)),
                   key=lambda it: -pairs[it[1]])
    n_blocks = min(SMS, len(order))
    heap = [(0, i) for i in range(n_blocks)]
    lists = [[] for _ in range(n_blocks)]
    for bh, kt in order:
        load, i = heapq.heappop(heap)
        lists[i].append((bh, kt) + tiles[kt])
        heapq.heappush(heap, (load + pairs[kt] + 1, i))
    offsets = [0]
    for lst in lists:
        offsets.append(offsets[-1] + len(lst))
    work = tuple(sum(pairs[it[1]] for it in lst) for lst in lists)
    return BwdPlan(rows, n_qt, tuple(it for lst in lists for it in lst),
                   tuple(offsets), work)


@functools.lru_cache(maxsize=64)
def _plan_tensor(B: int, S_q: int, S_kv: int, H: int, Hkv: int,
                 causal: bool, window: int, head_dim: int,
                 device: torch.device):
    """:func:`plan_bwd`'s plan as the kernel reads it, an int32 tensor on
    ``device`` (the offsets, then 5 ints an item), its block count and the
    query rows its tiles are counted in (the kernel refuses a plan cut for
    other rows than its own): copied to the card once per shape."""
    plan = plan_bwd(B, S_q, S_kv, H, Hkv, causal=causal, window=window,
                    head_dim=head_dim)
    flat = list(plan.offsets) + [x for it in plan.items for x in it]
    return (torch.tensor(flat, dtype=torch.int32, device=device),
            len(plan.work), plan.rows)


def flash_attention_bwd_kernel(q, k, v, out, dout, stats, *,
                               causal: bool = True, window: int = 0,
                               timing=None):
    """Launch the backward kernels on ``q``'s stream: (dq, dk, dv) of the
    forward ``out, stats = flash_attention_kernel(q, k, v, causal=causal,
    window=window, with_stats=True)`` (``q_offset`` 0) for the output
    gradient ``dout``, each in its input's shape and dtype.  Three
    kernels: D_i = rowsum(dout * out) beside the forward's statistics,
    dK and dV per planned item (:func:`plan_bwd`; summed over each kv
    head's query heads), dQ per query tile; no atomics, so the result is
    the same on every run.  ``timing``, a CPU f32 tensor of
    ``BWD_KERNELS + 1``, asks for each kernel's device time: the call
    writes the number of kernels it launched, then each one's
    milliseconds in launch order (CUDA events around each), and waits
    for them."""
    if not q.is_cuda:
        raise ValueError("flash_attention_bwd_kernel takes CUDA tensors")
    if q.dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {q.dtype}")
    if any(t.dtype != q.dtype for t in (k, v, out)):
        raise TypeError("q, k, v and out must share one dtype")
    if not isinstance(window, int) or window < 0:
        raise ValueError(f"window must be a non-negative int, got "
                         f"{window!r}")
    B, S_q, H, D = q.shape
    S_kv, Hkv = k.shape[1], k.shape[2]
    if (k.shape != v.shape or k.shape[0] != B or k.shape[3] != D
            or out.shape != q.shape or dout.shape != q.shape):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, out {tuple(out.shape)}, "
                         f"dout {tuple(dout.shape)}")
    if H % Hkv or D % 8 or not 0 < D <= _MAX_HEAD_DIM or S_kv < 1:
        raise ValueError(f"H={H} Hkv={Hkv} D={D} S_kv={S_kv}: the kernel "
                         f"takes whole GQA groups, D % 8 == 0, D <= "
                         f"{_MAX_HEAD_DIM} and at least one key")
    if (stats.shape != (B, S_q, H, 2) or stats.dtype != torch.float32
            or not stats.is_contiguous()):
        raise ValueError(f"stats must be the forward's contiguous f32 "
                         f"({B}, {S_q}, {H}, 2), got {tuple(stats.shape)} "
                         f"{stats.dtype}")
    if timing is not None and (
            timing.device.type != "cpu" or timing.dtype != torch.float32
            or not timing.is_contiguous()
            or timing.numel() != BWD_KERNELS + 1):
        raise ValueError(f"timing must be a contiguous CPU f32 tensor of "
                         f"{BWD_KERNELS + 1}")
    device, stream = _build.device_stream(q)
    if any(t.get_device() != device for t in (k, v, out, dout, stats)):
        raise ValueError("all operands must be on q's device")
    q, k, v, out = (_aligned(x.contiguous()) for x in (q, k, v, out))
    dout = _aligned(dout.to(q.dtype).contiguous())
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    rows = torch.empty(B * H * _cdiv(S_q, 64) * 64 * 4, dtype=torch.float32,
                       device=q.device)
    plan_t, blocks, plan_rows = None, 0, 0
    if q.dtype == torch.bfloat16:
        plan_t, blocks, plan_rows = _plan_tensor(
            B, S_q, S_kv, H, Hkv, bool(causal), window, D, q.device)
    _launch_bwd(device, _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr(), dout.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
                rows.data_ptr(), 0 if plan_t is None else plan_t.data_ptr(),
                B, S_q, S_kv, H, Hkv, D, 1 if causal else 0, window,
                1.0 / math.sqrt(D), blocks, plan_rows,
                0 if timing is None else timing.data_ptr(), stream)
    flash_attention_bwd_kernel.launches += 1
    return dq, dk, dv


#: wrapper calls that launched the backward kernels since the count was
#: last set to 0
flash_attention_bwd_kernel.launches = 0


class FlashAttention(torch.autograd.Function):
    """The flash kernel under autograd: the forward is
    :func:`flash_attention_kernel` with its row statistics, the backward
    :func:`flash_attention_bwd_kernel` on them.  Saves q, k, v, the output
    and the statistics."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        out, stats = flash_attention_kernel(q, k, v, causal=causal,
                                            window=window, with_stats=True)
        ctx.save_for_backward(q, k, v, out, stats)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, stats = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_kernel(
            q, k, v, out, dout, stats, causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


__all__ = ["BWD_KERNELS", "BwdPlan", "FlashAttention", "FlashPlan",
           "flash_attention_bwd_kernel", "flash_attention_bwd_plain",
           "flash_attention_kernel", "flash_attention_plain", "key_range",
           "plan_bwd", "plan_splits"]
