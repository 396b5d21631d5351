"""Mamba2 SSD chunked scan: the Hopper kernel's wrapper and its plain version.

Replaces the TPU kernel ``repro/kernels/ssd_scan.py:
ssd_chunk_scan_pallas`` (body ``_kernel``) on the SSM prefill path
(``models/ssm.py: mamba_full``).  It takes what that kernel takes: one
B/C group (G == 1), no initial state, ``S`` a multiple of ``chunk``.
``chunk`` is a runtime argument up to 128, so a 127-token prefill runs
one chunk of 127.

bf16 runs ``csrc/ssd_scan.cu``'s warpgroup-MMA kernel: a block takes one
(head, sequence) and loops over the chunks in order; TMA brings each
chunk's C, B and x tiles through a two-stage ring while the previous
chunk computes; the scores C . B^T, the intra-chunk product, the
inter-chunk term and the state update run on the tensor cores with bf16
operands and f32 accumulators, and the (P, N) state stays f32 in
registers for the whole sequence, as the TPU kernel holds it in VMEM (a
bf16 copy of it is the inter term's operand; the state update takes its
f32 factor as two bf16 operands, so that the state keeps ~16 bits).  f32
runs the first version's CUDA-core body, kept for the correctness checks
held to 1e-4 (bf16 operands would miss them).  Times are in PERF.md.
bf16 takes any head dim P % 8 == 0 up to 64 and state dim N % 8 == 0 up
to 128 (its tiles are laid out for 64 and 64 or 128 columns, zero past P
and N); f32 takes its compiled forms, P 32 or 64 and N 16, 32, 64 or 128.

:func:`ssd_chunk_scan_plain` is the plain PyTorch version;
``ops.ssd_chunk_scan`` sends CPU tensors to it and CUDA tensors to
:func:`ssd_chunk_scan_kernel`.  The plain version takes more than the
kernel (B/C groups, an initial state), as the JAX package's oracle does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from .ref import ssd_chunk_scan as ssd_chunk_scan_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# f32: the compiled forms of the CUDA-core body
_HEAD_DIMS = (32, 64)
_STATE_DIMS = (16, 32, 64, 128)
# bf16: tiles laid out for 64 columns of x and 64 or 128 of B and C, zero
# past P and N; a TMA row stride is whole 16-byte units
_MAX_HEAD_DIM, _MAX_STATE_DIM = 64, 128
MAX_CHUNK = 128

_launch = _build.Entry("ssd_scan", "repro_ssd_chunk_scan", "17q")
_plan = _build.Entry("ssd_scan", "repro_ssd_plan", "6q")
#: the keys of :func:`bf16_plan`, in the order the C entry writes them
PLAN_FIELDS = ("blocks", "threads", "stages", "smem_bytes", "registers",
               "local_bytes", "max_threads")


def _check_args(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor, *,
                chunk: int, init_state: Optional[torch.Tensor]) -> int:
    """Raise where the TPU kernel's wrapper asserts; return the chunk
    it runs (``min(chunk, S)``)."""
    if x.dim() != 4 or b.dim() != 4 or c.shape != b.shape:
        raise ValueError(f"x {tuple(x.shape)}, b {tuple(b.shape)}, "
                         f"c {tuple(c.shape)}: want (B,S,H,P), (B,S,G,N)")
    S = x.shape[1]
    if b.shape[2] != 1:
        raise ValueError(f"the SSD scan takes one B/C group, got "
                         f"G={b.shape[2]}")
    if init_state is not None:
        raise ValueError("the SSD scan starts from a zero state; "
                         "init_state is not supported")
    chunk = min(int(chunk), S)
    if chunk <= 0 or S % chunk:
        raise ValueError(f"seq {S} must be a multiple of chunk {chunk}")
    return chunk


def ssd_chunk_scan_kernel(
    x: torch.Tensor,    # (B, S, H, P)
    dt: torch.Tensor,   # (B, S, H)
    a: torch.Tensor,    # (H,)
    b: torch.Tensor,    # (B, S, 1, N)
    c: torch.Tensor,    # (B, S, 1, N)
    *,
    chunk: int = 128,
    d_skip: Optional[torch.Tensor] = None,
    init_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the scan on ``x``'s stream; returns (y (B,S,H,P) in x's
    dtype, final state (B,H,P,N) f32)."""
    if not x.is_cuda:
        raise ValueError("ssd_chunk_scan_kernel takes CUDA tensors")
    _build.refuse_grad("ssd_chunk_scan_kernel", x, dt, a, b, c, d_skip,
                       init_state)
    chunk = _check_args(x, b, c, chunk=chunk, init_state=init_state)
    if x.dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {x.dtype}")
    if b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError("x, b and c must share one dtype")
    B, S, H, P = x.shape
    N = b.shape[3]
    if x.dtype == torch.float32:
        shapes_ok = P in _HEAD_DIMS and N in _STATE_DIMS
        takes = f"P in {_HEAD_DIMS}, N in {_STATE_DIMS}"
    else:
        shapes_ok = (0 < P <= _MAX_HEAD_DIM and P % 8 == 0
                     and 0 < N <= _MAX_STATE_DIM and N % 8 == 0)
        takes = (f"P % 8 == 0 up to {_MAX_HEAD_DIM}, N % 8 == 0 up to "
                 f"{_MAX_STATE_DIM}")
    if not shapes_ok or chunk > MAX_CHUNK:
        raise ValueError(f"P={P} N={N} chunk={chunk}: the {x.dtype} kernel "
                         f"takes {takes}, chunk <= {MAX_CHUNK}")
    if (dt.shape != (B, S, H) or a.shape != (H,) or b.shape[:2] != (B, S)
            or (d_skip is not None and d_skip.shape != (H,))):
        raise ValueError(f"dt {tuple(dt.shape)}, a {tuple(a.shape)}, "
                         f"b {tuple(b.shape)} for x {tuple(x.shape)}")
    device, stream = _build.device_stream(x)
    operands = [dt, a, b, c] + ([d_skip] if d_skip is not None else [])
    if any(t.get_device() != device for t in operands):
        raise ValueError("all operands must be on x's device")
    d = (d_skip if d_skip is not None
         else torch.zeros((H,), dtype=torch.float32, device=x.device))
    # TMA reads the bf16 tensors from 16-byte aligned bases
    x, b, c = (t.contiguous() for t in (x, b, c))
    x, b, c = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (x, b, c))
    dt, a, d = (t.float().contiguous() for t in (dt, a, d))
    y = torch.empty_like(x)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    _launch(device, _DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(),
            a.data_ptr(), b.data_ptr(), c.data_ptr(), d.data_ptr(),
            y.data_ptr(), state.data_ptr(), B, S, H, P, N, chunk, stream)
    ssd_chunk_scan_kernel.launches += 1
    return y, state


#: launches of the kernel since the count was last set to 0
ssd_chunk_scan_kernel.launches = 0


def bf16_plan(B: int, H: int, P: int, N: int, device: int = 0) -> dict:
    """The bf16 kernel's launch plan at (B, H, P, N), read from the built
    library: blocks, threads a block, ring stages, dynamic shared memory,
    and the compiled kernel's registers a thread, local memory a thread
    (spills) and most threads a block.  Builds the library if need be;
    raises on a shape the bf16 kernel refuses."""
    out = torch.zeros(len(PLAN_FIELDS), dtype=torch.int64)
    _plan(device, B, H, P, N, out.data_ptr())
    return dict(zip(PLAN_FIELDS, out.tolist()))


__all__ = ["bf16_plan", "ssd_chunk_scan_kernel", "ssd_chunk_scan_plain"]
