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
forward the kernel above, its backward
:func:`flash_attention_bwd_kernel`, ``csrc/flash_attention_bwd.cu``: dQ,
dK and dV of exactly what the forward computes, at ``q_offset`` 0,
causal or not, with any window, GQA, D as the forward takes it, bf16 and
f32), else to the kernel alone.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import _build
from .ref import flash_attention as flash_attention_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: head dims with a compiled form; others up to _MAX_HEAD_DIM run at run time
_COMPILED_HEAD_DIMS = (32, 64, 128)
_MAX_HEAD_DIM = 128
#: the H100's streaming multiprocessors: the blocks a launch should fill
SMS = 132
#: query rows per consumer warpgroup
ROWS = 64

_launch = _build.Entry("flash_attention", "repro_flash_attention", "15qd6q")
_launch_bwd = _build.Entry("flash_attention_bwd", "repro_flash_attention_bwd",
                           "19qdq")


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
) -> torch.Tensor:
    """Launch the flash kernel on ``q``'s stream; returns (B, S_q, H, D)."""
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
            0 if ws is None else ws.data_ptr(), stream)
    flash_attention_kernel.launches += 1
    if plan.splits > 1:
        flash_attention_kernel.combine_launches += 1
    return out


#: wrapper calls that launched the kernel since the count was last set to 0
flash_attention_kernel.launches = 0
#: of those, the calls that also launched the split combine
flash_attention_kernel.combine_launches = 0


def flash_attention_bwd_kernel(q, k, v, out, dout, *, causal: bool = True,
                               window: int = 0):
    """Launch the backward kernel on ``q``'s stream: (dq, dk, dv) of the
    forward ``out = flash_attention_kernel(q, k, v, causal=causal,
    window=window)`` (``q_offset`` 0) for the output gradient ``dout``,
    each in its input's shape and dtype.  Three kernels: the rows'
    softmax statistics, dK and dV per key tile (summed over each kv
    head's query heads), dQ per query tile; no atomics, so the result is
    the same on every run."""
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
    device, stream = _build.device_stream(q)
    q, k, v, out = (x.contiguous() for x in (q, k, v, out))
    dout = dout.to(q.dtype).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    ws = torch.empty(3 * B * H * S_q, dtype=torch.float32, device=q.device)
    _launch_bwd(device, _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr(), dout.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), ws.data_ptr(), B, S_q, S_kv, H,
                Hkv, D, 1 if causal else 0, window, 1.0 / math.sqrt(D),
                stream)
    flash_attention_bwd_kernel.launches += 1
    return dq, dk, dv


#: wrapper calls that launched the backward kernels since the count was
#: last set to 0
flash_attention_bwd_kernel.launches = 0


class FlashAttention(torch.autograd.Function):
    """The flash kernel under autograd: the forward is
    :func:`flash_attention_kernel` as it stands, the backward
    :func:`flash_attention_bwd_kernel`.  Saves q, k, v and the output."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        out = flash_attention_kernel(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, out)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_kernel(
            q, k, v, out, dout, causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


__all__ = ["FlashAttention", "FlashPlan", "flash_attention_bwd_kernel",
           "flash_attention_kernel", "flash_attention_plain", "key_range",
           "plan_splits"]
