"""Mamba2 SSD chunked scan: the Hopper kernel's wrapper and its plain version.

Replaces the TPU kernel ``repro/kernels/ssd_scan.py:
ssd_chunk_scan_pallas`` (body ``_kernel``) on the SSM prefill path
(``models/ssm.py: mamba_full``).  It takes what that kernel takes: one
B/C group (G == 1), no initial state, ``S`` a multiple of ``chunk``.
``chunk`` is a runtime argument up to 128, so a 127-token prefill runs
one chunk of 127.

The kernel (``csrc/ssd_scan.cu``) runs one block per (head, sequence)
and loops over the chunks in order, the (P, N) f32 state held in shared
memory for the whole sequence, as the TPU kernel holds it in VMEM.
Within a chunk it forms the scores C . B, the causal decay and the
intra-chunk product, the inter-chunk term from the carried state and
the skip term, then folds the chunk into the state.  All arithmetic is
f32 on CUDA cores; on the H100 the scan is bound by the bytes of x and
y when its flops run on the tensor cores, which this first version does
not use.  Its times are in PERF.md.

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
_HEAD_DIMS = (32, 64)
_STATE_DIMS = (16, 32, 64, 128)
MAX_CHUNK = 128


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
    chunk = _check_args(x, b, c, chunk=chunk, init_state=init_state)
    if x.dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {x.dtype}")
    if b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError("x, b and c must share one dtype")
    B, S, H, P = x.shape
    N = b.shape[3]
    if P not in _HEAD_DIMS or N not in _STATE_DIMS or chunk > MAX_CHUNK:
        raise ValueError(f"P={P} N={N} chunk={chunk}: the kernel takes P in "
                         f"{_HEAD_DIMS}, N in {_STATE_DIMS}, chunk <= "
                         f"{MAX_CHUNK}")
    if (dt.shape != (B, S, H) or a.shape != (H,) or b.shape[:2] != (B, S)
            or (d_skip is not None and d_skip.shape != (H,))):
        raise ValueError(f"dt {tuple(dt.shape)}, a {tuple(a.shape)}, "
                         f"b {tuple(b.shape)} for x {tuple(x.shape)}")
    operands = [dt, a, b, c] + ([d_skip] if d_skip is not None else [])
    if any(t.device != x.device for t in operands):
        raise ValueError("all operands must be on x's device")
    d = (d_skip if d_skip is not None
         else torch.zeros((H,), dtype=torch.float32, device=x.device))
    x, b, c = x.contiguous(), b.contiguous(), c.contiguous()
    dt, a, d = (t.float().contiguous() for t in (dt, a, d))
    y = torch.empty_like(x)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    lib = _build.load("ssd_scan")
    err = lib.repro_ssd_chunk_scan(
        x.device.index, _DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(),
        a.data_ptr(), b.data_ptr(), c.data_ptr(), d.data_ptr(),
        y.data_ptr(), state.data_ptr(), B, S, H, P, N, chunk,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, err, "ssd_chunk_scan kernel launch")
    ssd_chunk_scan_kernel.launches += 1
    return y, state


#: launches of the kernel since the count was last set to 0
ssd_chunk_scan_kernel.launches = 0

__all__ = ["ssd_chunk_scan_kernel", "ssd_chunk_scan_plain"]
