"""Causal flash attention: the Hopper kernel's wrapper and its plain version.

Replaces the TPU kernel ``repro/kernels/flash_attention.py:
flash_attention_pallas`` (body ``_kernel``) on the chunked-prefill path
(``layers.attention_chunk``).  The TPU kernel binds ``q_offset`` as a
Python constant; here it is a runtime argument of the kernel, so one
build serves every chunk start and the host passes the start it already
knows (no device read).

The kernel (``csrc/flash_attention.cu``) runs one block per (q tile,
query head, sequence) and loops over key tiles up to the causal horizon
of its tile, with the online softmax in f32.  On the H100 a prefill
chunk over ~1k keys is compute bound; this first version multiplies with
scalar f32 FMAs, far from the tensor cores' rate — ``wgmma`` tiles fed
by TMA are later work.  Its times are in PERF.md.  Sliding windows are
not supported by the kernel (the plain version has them).

:func:`flash_attention_plain` is the plain PyTorch version;
``ops.flash_attention`` sends CPU tensors to it and CUDA tensors to
:func:`flash_attention_kernel`.
"""

from __future__ import annotations

import math

import torch

from . import _build
from .ref import flash_attention as flash_attention_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)


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
    if window:
        raise NotImplementedError(
            "the flash kernel has no sliding-window mask; no caller on the "
            "serving path passes one")
    if q.dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if not isinstance(q_offset, int) or q_offset < 0:
        raise ValueError(f"q_offset must be a non-negative int, got "
                         f"{q_offset!r}")
    B, S_q, H, D = q.shape
    S_kv, Hkv = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if H % Hkv or D not in _HEAD_DIMS:
        raise ValueError(f"H={H} Hkv={Hkv} D={D}: the kernel takes whole "
                         f"GQA groups and D in {_HEAD_DIMS}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("all operands must be on q's device")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lib = _build.load("flash_attention")
    err = lib.repro_flash_attention(
        q.device.index, _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
        v.data_ptr(), out.data_ptr(), B, S_q, S_kv, H, Hkv, D, q_offset,
        1 if causal else 0, 1.0 / math.sqrt(D),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, err, "flash_attention kernel launch")
    flash_attention_kernel.launches += 1
    return out


#: launches of the kernel since the count was last set to 0
flash_attention_kernel.launches = 0

__all__ = ["flash_attention_kernel", "flash_attention_plain"]
