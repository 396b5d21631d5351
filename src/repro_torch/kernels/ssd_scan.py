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
Under autograd (``SSDChunkScan``) the backward is
:func:`ssd_chunk_scan_bwd_kernel` (``csrc/ssd_scan_bwd.cu``), P 32 or 64
and N 16, 32, 64 or 128.  bf16 runs five kernels on the tensor cores, fed
by TMA: each chunk's local state and state gradient in parallel over the
chunks, a short f32 carry of both across the chunks (and e^{total} <G,
S>, against S's bf16 copy), then the column products (dx, dB, rows j)
and the row products (dC, rows i, then ddt, da and dd from both passes'
row sums), each block a
chunk of one sequence and a group of heads (:func:`plan_bwd_groups`),
with C . B^T formed once a block and dB / dC summed over the group's
heads in f32 registers; last the groups' and chunks' partials in a fixed
order.  Operands are bf16, accumulators and the carried states f32; the
scores' weighted tiles are rounded only as operands, and the row sums
for ddt and da come from the f32 fragments.  What bounds it, the bytes
of the chunks' states beside the products, is in the source's header.
f32 runs the first version's four CUDA-core kernels, kept for the checks
held to 1e-4.
bf16 takes any head dim P % 8 == 0 up to 64 and state dim N % 8 == 0 up
to 128 (its tiles are laid out for 64 and 64 or 128 columns, zero past P
and N); f32 takes its compiled forms, P 32 or 64 and N 16, 32, 64 or 128.

:func:`ssd_chunk_scan_plain` is the plain PyTorch version;
``ops.ssd_chunk_scan`` sends CPU tensors to it and CUDA tensors to
:func:`ssd_chunk_scan_kernel`.  The plain version takes more than the
kernel (B/C groups, an initial state), as the JAX package's oracle does.
:func:`ssd_chunk_scan_bwd_plain` is the backward's plain version.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from . import _build
from .ref import ssd_chunk_scan as ssd_chunk_scan_plain
from .ref import ssd_chunk_scan_bwd as ssd_chunk_scan_bwd_plain

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
_launch_bwd = _build.Entry("ssd_scan_bwd", "repro_ssd_chunk_scan_bwd", "27q")
_bwd_plan = _build.Entry("ssd_scan_bwd", "repro_ssd_bwd_plan", "3q")
#: the kernels a backward call launches, in order, by dtype.  bf16: each
#: chunk's local state and state gradient, the carry across chunks, the
#: column products (dx, dB), the row products and the rows (dC, ddt, da,
#: dd), the sums over head groups and chunks.  f32 (the first version):
#: the carry, the chunks' gradients, the sums over heads of dB and dC, the
#: sums of da and dd
BWD_KERNEL_NAMES = {
    torch.bfloat16: ("states_kernel", "pass_kernel", "col_kernel",
                     "row_kernel", "sums_kernel"),
    torch.float32: ("carry_kernel", "chunk_kernel", "reduce_bc_kernel",
                    "reduce_heads_kernel"),
}
#: the most kernels a backward call launches (the length of ``timing``
#: is one more)
BWD_KERNELS = max(len(v) for v in BWD_KERNEL_NAMES.values())
#: the keys of :func:`bwd_plan`, in the order the C entry writes them
BWD_PLAN_FIELDS = ("states_registers", "states_local_bytes",
                   "col_registers", "col_local_bytes", "row_registers",
                   "row_local_bytes", "smem_bytes")
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


#: streaming multiprocessors of an H100 SXM: the bf16 backward's head
#: groups aim at two blocks for each
_SMS = 132


class BwdGroups(NamedTuple):
    """The bf16 backward's head groups: a block of its wgmma kernels takes
    one chunk of one sequence and the heads ``g * heads_per_group`` up to
    ``min(H, (g + 1) * heads_per_group)`` of group g, in order."""
    heads_per_group: int
    groups: int
    blocks: int


def plan_bwd_groups(B: int, S: int, H: int, chunk: int) -> BwdGroups:
    """Head groups from shapes alone: the group count nearest to two
    blocks an SM over the (chunk, sequence) pairs (the kernels hold one
    block an SM), at most one group a head; the last group takes what
    is left of H."""
    pairs = (S // chunk) * B
    want = max(1, min(H, int(2 * _SMS / pairs + 0.5)))
    hpg = -(-H // want)
    groups = -(-H // hpg)
    return BwdGroups(hpg, groups, groups * pairs)


def _bwd_workspace(B: int, S: int, H: int, P: int, N: int, chunk: int,
                   dtype: torch.dtype, groups: int) -> int:
    """f32 elements of the backward's workspace (``workspace_floats`` in
    ``csrc/ssd_scan_bwd.cu``).  bf16: each chunk's local state and state
    gradient, (B, S / chunk, H, P, N) f32 each; the carried states as
    bf16 operands, half as many floats again; the chunks' totals, da's and
    dd's partials, (B, S / chunk, H) each, and the carried term in up to 4
    slices; the column pass's sum_i W_ij and V_j and the rows' ddt, (B, S
    / chunk, H, chunk) each; dB's and dC's partials a head group, (B, S,
    groups, N) each.  f32 (the first version): the states and state
    gradients, (B, S / chunk, H, P, N) each; dB's and dC's per-head
    partials, (B, S, H, N) each; da's and dd's partials."""
    nc = S // chunk
    if dtype == torch.float32:
        return 2 * B * nc * H * P * N + 2 * B * S * H * N + 2 * B * nc * H
    return (3 * B * nc * H * P * N + 7 * B * nc * H + 3 * B * S * H
            + 2 * B * S * groups * N)


def ssd_chunk_scan_bwd_kernel(
    x: torch.Tensor,    # (B, S, H, P)
    dt: torch.Tensor,   # (B, S, H)
    a: torch.Tensor,    # (H,)
    b: torch.Tensor,    # (B, S, 1, N)
    c: torch.Tensor,    # (B, S, 1, N)
    dy: torch.Tensor,   # (B, S, H, P)
    *,
    chunk: int = 128,
    d_skip: Optional[torch.Tensor] = None,
    dstate: Optional[torch.Tensor] = None,  # (B, H, P, N)
    timing: Optional[torch.Tensor] = None,
):
    """Launch the backward kernels on ``x``'s stream: (dx, ddt, da, db, dc,
    dd) of ``ssd_chunk_scan_kernel(x, dt, a, b, c, chunk=chunk,
    d_skip=d_skip)`` for the cotangents ``dy`` of y and ``dstate`` of the
    final state (None: 0), each in its input's shape and dtype (dd None
    without ``d_skip``).  The kernels of ``BWD_KERNEL_NAMES[x.dtype]``, no
    atomics: the same bits on every run.  ``timing``, a CPU f32 tensor of
    ``BWD_KERNELS + 1``, asks for each kernel's device time: the call
    writes the number of kernels it launched, then each one's
    milliseconds in launch order, and waits for them."""
    if not x.is_cuda:
        raise ValueError("ssd_chunk_scan_bwd_kernel takes CUDA tensors")
    chunk = _check_args(x, b, c, chunk=chunk, init_state=None)
    if x.dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {x.dtype}")
    if b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError("x, b and c must share one dtype")
    B, S, H, P = x.shape
    N = b.shape[3]
    if P not in _HEAD_DIMS or N not in _STATE_DIMS or chunk > MAX_CHUNK:
        raise ValueError(f"P={P} N={N} chunk={chunk}: the backward takes P "
                         f"in {_HEAD_DIMS}, N in {_STATE_DIMS}, chunk <= "
                         f"{MAX_CHUNK}")
    if (dt.shape != (B, S, H) or a.shape != (H,) or b.shape[:2] != (B, S)
            or dy.shape != x.shape
            or (d_skip is not None and d_skip.shape != (H,))
            or (dstate is not None and dstate.shape != (B, H, P, N))):
        raise ValueError(f"dt {tuple(dt.shape)}, a {tuple(a.shape)}, "
                         f"b {tuple(b.shape)}, dy {tuple(dy.shape)} for x "
                         f"{tuple(x.shape)}")
    if timing is not None and (
            timing.device.type != "cpu" or timing.dtype != torch.float32
            or not timing.is_contiguous()
            or timing.numel() != BWD_KERNELS + 1):
        raise ValueError(f"timing must be a contiguous CPU f32 tensor of "
                         f"{BWD_KERNELS + 1}")
    device, stream = _build.device_stream(x)
    operands = [dt, a, b, c, dy] + [t for t in (d_skip, dstate)
                                    if t is not None]
    if any(t.get_device() != device for t in operands):
        raise ValueError("all operands must be on x's device")
    d = (d_skip if d_skip is not None
         else torch.zeros((H,), dtype=torch.float32, device=x.device))
    # TMA reads the bf16 tensors, and the carry the state's cotangent in
    # 16-byte pieces, from 16-byte aligned bases
    x, b, c = (t.contiguous() for t in (x, b, c))
    dy = dy.to(x.dtype).contiguous()
    x, b, c, dy = (t if t.data_ptr() % 16 == 0 else t.clone()
                   for t in (x, b, c, dy))
    dtf, af, d = (t.float().contiguous() for t in (dt, a, d))
    ds = dstate.float().contiguous() if dstate is not None else None
    if ds is not None and ds.data_ptr() % 16:
        ds = ds.clone()
    dx = torch.empty_like(x)
    db, dc = torch.empty_like(b), torch.empty_like(c)
    ddt = torch.empty((B, S, H), dtype=torch.float32, device=x.device)
    da = torch.empty((H,), dtype=torch.float32, device=x.device)
    dd = torch.empty((H,), dtype=torch.float32, device=x.device)
    groups = plan_bwd_groups(B, S, H, chunk)
    n_work = _bwd_workspace(B, S, H, P, N, chunk, x.dtype, groups.groups)
    work = torch.empty((n_work,), dtype=torch.float32, device=x.device)
    _launch_bwd(device, _DTYPES[x.dtype], x.data_ptr(), dtf.data_ptr(),
                af.data_ptr(), b.data_ptr(), c.data_ptr(), d.data_ptr(),
                dy.data_ptr(), 0 if ds is None else ds.data_ptr(),
                dx.data_ptr(), ddt.data_ptr(), da.data_ptr(), db.data_ptr(),
                dc.data_ptr(), dd.data_ptr(), work.data_ptr(), n_work, B, S,
                H, P, N, chunk, groups.heads_per_group,
                0 if timing is None else timing.data_ptr(), stream)
    ssd_chunk_scan_bwd_kernel.launches += 1
    return (dx, ddt.to(dt.dtype), da.to(a.dtype), db, dc,
            dd.to(d_skip.dtype) if d_skip is not None else None)


#: wrapper calls that launched the backward kernels since the count was
#: last set to 0
ssd_chunk_scan_bwd_kernel.launches = 0


class SSDChunkScan(torch.autograd.Function):
    """The SSD kernel under autograd: the forward is
    :func:`ssd_chunk_scan_kernel`, the backward
    :func:`ssd_chunk_scan_bwd_kernel`, which recomputes the chunks' states
    from the inputs.  Saves x, dt, a, b, c and d_skip through
    ``save_for_backward`` (so that ``torch.utils.checkpoint`` can drop and
    recompute them); a missing gradient of y or of the final state is
    0."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, d_skip, chunk: int):
        y, state = ssd_chunk_scan_kernel(x, dt, a, b, c, chunk=chunk,
                                         d_skip=d_skip)
        ctx.save_for_backward(x, dt, a, b, c, d_skip)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, a, b, c, d_skip = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        dx, ddt, da, db, dc, dd = ssd_chunk_scan_bwd_kernel(
            x, dt, a, b, c, dy, chunk=ctx.chunk, d_skip=d_skip,
            dstate=dstate)
        return dx, ddt, da, db, dc, dd, None


def bf16_plan(B: int, H: int, P: int, N: int, device: int = 0) -> dict:
    """The bf16 kernel's launch plan at (B, H, P, N), read from the built
    library: blocks, threads a block, ring stages, dynamic shared memory,
    and the compiled kernel's registers a thread, local memory a thread
    (spills) and most threads a block.  Builds the library if need be;
    raises on a shape the bf16 kernel refuses."""
    out = torch.zeros(len(PLAN_FIELDS), dtype=torch.int64)
    _plan(device, B, H, P, N, out.data_ptr())
    return dict(zip(PLAN_FIELDS, out.tolist()))


def bwd_plan(N: int, device: int = 0) -> dict:
    """The bf16 backward's wgmma kernels as built (N <= 64 and N 128 are
    two forms): registers and local memory a thread (spills) of
    states_kernel, col_kernel and row_kernel, and their dynamic shared
    memory.  Builds the library if need be."""
    out = torch.zeros(len(BWD_PLAN_FIELDS), dtype=torch.int64)
    _bwd_plan(device, N, out.data_ptr())
    return dict(zip(BWD_PLAN_FIELDS, out.tolist()))


__all__ = ["BWD_KERNELS", "BWD_KERNEL_NAMES", "BwdGroups", "SSDChunkScan",
           "bf16_plan", "bwd_plan", "plan_bwd_groups",
           "ssd_chunk_scan_bwd_kernel", "ssd_chunk_scan_bwd_plain",
           "ssd_chunk_scan_kernel", "ssd_chunk_scan_plain"]
