#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--profile]

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc,
holds each kernel against its plain PyTorch version at the full-width
shapes of its path, and drives these paths at published width with
random weights from a seed (mixtral over 6 of its 32 layers):

  * qwen2-0.5b through ``Model`` and a ``ServingEngine`` that serves 8
    requests (paged decode and flash prefill kernels, global page ids),
    then a sampled ``ServingEngine`` (temperature 0.8, top_p 0.9) with
    two best-of-4 fork groups, ``select_winner`` and a prefix-cache
    replay, every page copy through the block-gather kernel; then the
    same 8 requests by whole-prompt prefill (``chunk_tokens=0``), with
    the speculative lane (``speculate_k=4``, a 12-layer draft), greedy
    best-of-4 with the lane under stamp-it and lfrc, and under each of
    the 13 reclamation policies; then the cluster plane: a
    ``ReplicaGroup`` of 2 replicas over one weight tree (a checkpoint, a
    cross-replica hold, a prefix migration through the block-gather
    kernel), 1 prefill and 2 decode replicas with the mid-request K/V
    handoff (each payload held bit for bit against the source's and the
    destination's pages), and 3 replicas under the lifecycle plane with one killed
    mid-run (its hold force-expired, its requests replayed, its pools
    given back) and a wedged hold the watchdog expires — each also in f32
    over 4 layers against one engine, token for token;
  * mamba2-2.7b through ``Model.prefill`` (8 prompts of 1024 tokens, the
    SSD scan kernel) and 32 greedy ``Model.decode_step`` calls;
  * seamless-m4t-medium through ``Model.prefill`` (an encoder over 8 x
    1024 frame embeddings, a decoder over 128-token prompts: the flash
    kernel, non-causal and causal) and 32 greedy ``Model.decode_step``
    calls (per-slot paged self-attention and the contiguous cross-
    attention decode kernel);
  * zamba2-7b through ``Model.prefill`` (8 prompts of 1024 tokens: 81
    Mamba2 layers on the SSD kernel and 13 applications of the shared
    attention block on the flash kernel at head dim 112, its run-time-D
    form) and 32 greedy ``Model.decode_step`` calls (per-slot paged
    attention over the shared block's pools);
  * mixtral-8x7b at full width over 6 layers through ``Model.prefill``
    (4 prompts of 6144 tokens: the flash kernel with the 4096-key
    sliding window, the top-2 MoE) and 32 greedy ``Model.decode_step``
    calls on the rolling cache (the decode kernel over a wrapped ring);
  * granite-3-8b, minitron-4b, phi3-mini-3.8b and granite-moe-3b-a800m
    (40 experts top-8), nothing cut, one after the other: qwen2's 8
    requests through a ``ServingEngine`` (the paged and flash kernels at
    G 4 / D 128, G 3 / D 128, G 1 / D 96 and G 3 / D 64; the MoE over
    each 128-token chunk), and each config over 4 layers in f32, the
    engine on the kernels against the engine on the plain versions,
    token for token;
  * llava-next-34b at full width over 16 of its 60 layers through
    ``Model.prefill`` (4 requests of 1152 frontend embeddings and 896
    text tokens: the flash kernel at 56/8 heads of 128) and 32 greedy
    ``Model.decode_step`` calls on per-slot pages (the paged kernel at
    G 7, D 128), its first 4 layers in f32 kernel against plain;
  * the training plane: the flash kernel's backward kernels (fed by the
    forward's row statistics) against autograd of the plain version at
    six shapes (three planted faults that the check must catch, and two
    runs bit for bit), qwen2-0.5b's first 4 layers in f32 (one
    step's loss and every gradient leaf, kernels against plain), and a
    ``Trainer`` over 8 full-width qwen2 steps of 2 x 4096 tokens (the
    flash kernel forward and backward), then again with a checkpoint
    every 4 steps and a failure before step 6: the replayed losses
    identical to the first run's;
  * SSM and hybrid training: the SSD scan's backward kernels against the
    plain backward and autograd of the plain scan at mamba2's and
    zamba2's train shapes and four more (two runs bit for bit, three
    planted faults), then mamba2-2.7b at full width and zamba2-7b over
    39 of its 81 layers (6 groups and the shared block, 3 trailing
    layers), each: its first layers in f32 (every gradient leaf, kernels
    against plain), one step's gradients (every leaf finite and nonzero,
    the SSD and flash launches of a remat "full" step) and a ``Trainer``
    over 4 steps of 2 x 4096 tokens, twice, the losses identical;
  * the four examples (``examples/*_torch.py``) through their own
    ``main``: the quickstart at its defaults under each of the eight
    schemes, each joined with a timeout; ``serve_paged`` (granite-3-8b
    at smoke width, f32) four ways and ``serve_cluster`` (qwen2-0.5b at
    smoke width: a trace, a killed replica, prefill and decode tiers)
    three, each on the card and then on the CPU on the same weights, the
    greedy runs' tokens, stats and printed lines equal; ``train_lm``'s
    qwen2-100m in f32 over 200 steps with a checkpoint every 50, then
    again with a failure before step 120 (every loss the first run's,
    bit for bit).

It checks that each path went through its kernels (launch counts, and
the split combines beside them), and times each kernel beside its plain
version, its bound and a library call.  The page gather is held bit
for bit, at every handoff read's shape too (a replica's pool, a
host-built index), on a pool at an odd base, with ids out of range (zero
pages) and at M 0, each case naming its plan;
its rows time kernel and ``index_select`` on a cold L2 in turns beside
the launch floor.  The sampling uniforms and the sampler are held
against their host versions.  Every phase prints one
JSON line; the card's name and power limit
print as ``nvidia-smi`` gives them; the line before the last is the
``{"kernels": [...]}`` table and the last line is ``{"ok": true,
"device": {...}}``.  Any failed check exits nonzero.
``--profile`` adds torch.profiler windows over engine steps, over a
prefill and decode steps of the SSM, encoder-decoder, hybrid and MoE
models, and over 8 engine steps (chunks and decode) of each of the four
families.

Needs a CUDA device and the repository's ``src/``; imports neither JAX
nor the JAX package.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM published peaks (NVIDIA data sheet, dense): the bound of a
# kernel is the larger of bytes / HBM rate and flops / peak for its type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

N_LAYERS = 24  # qwen2-0.5b
SSM_LAYERS = 64  # mamba2-2.7b
# the SSM prefill: 8 prompts of 1024 tokens; the scan runs chunks of 128
# over mamba2-2.7b's 80 heads of 64 with state 128
SSM_BATCH, SSM_SEQ, SSM_STEPS = 8, 1024, 32
SSD_SHAPE = dict(B=SSM_BATCH, S=SSM_SEQ, H=80, P=64, N=128, chunk=128)
# kernel-vs-plain tolerances: f32 sums in another order over up to ~1k
# keys; bf16 softmax weights round before (kernel) or after (plain)
# normalisation, the gap tests/test_kernels.py allows the Pallas bodies
KERNEL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# bf16 attention is also held row by row: each output row's largest error
# within 2e-2 of that row's largest magnitude.  Over ~1k keys of a near-
# uniform softmax the outputs are ~1e-2, under the absolute 2e-2, which
# then passes a split that the combine drops or weighs wrongly; relative
# to the row such a fault is 4e-2 to 1 (and one bf16 ulp is under 8e-3)
ROW_REL_TOL = 2e-2
# q scaled up for a peaked softmax (scores spread ~0.9 instead of ~0.09),
# so that the splits' maxima differ and the combine's 2^(m_s - M) matters
PEAKED_Q = 10.0
# full-width model (conditioned weights), bf16 activations through 24
# layers: kernel and plain attention round differently at each layer and
# the differences compound; held to 10% of the largest logit
LOGIT_REL_TOL = 0.10
# full-width mamba2 (seeded init) in f32 compute, kernel vs plain scan
# and prefill+decode vs prefill: the scans agree to ~1e-6, the decode
# step's recurrence sums in another order than the chunked form; held to
# 1e-3 of the largest magnitude through 64 layers
SSM_F32_REL_TOL = 1e-3
# seamless-m4t-medium: 8 utterances of 1024 frames (~20 s of audio each)
# with 128-token decoder prompts, then 32 greedy steps; the decoder's
# self-attention pool holds 256 positions (3 pages of 128 per slot)
ED_BATCH, ED_FRAMES, ED_PROMPT, ED_STEPS, ED_MAX_SEQ = 8, 1024, 128, 32, 256
# full width in f32 compute, kernels vs plain and prefill+decode vs
# prefill: held to 1e-3 of the largest magnitude through 24 layers
ED_F32_REL_TOL = 1e-3
# zamba2-7b: 81 Mamba2 layers and 13 applications of the shared block;
# 8 prompts of 1024 tokens, then 32 greedy steps.  The decode cache holds
# HY_MAX_SEQ positions: 10 pages of 128 per slot in each pool
HY_LAYERS, HY_BATCH, HY_SEQ, HY_STEPS = 81, 8, 1024, 32
HY_MAX_SEQ = HY_SEQ + HY_STEPS
HY_POOL = -(-HY_MAX_SEQ // 128) + 1
HY_SSD_SHAPE = dict(B=HY_BATCH, S=HY_SEQ, H=112, P=64, N=64, chunk=128)
# full width in f32 compute, kernels vs plain and prefill+decode vs
# prefill: held to 1e-3 of the largest magnitude through 81 layers
HY_F32_REL_TOL = 1e-3
# mixtral-8x7b at full width over 6 of its 32 layers (8.97 B parameters:
# the f32 tree and its bf16 copy fit the card together, 8 layers would
# not): 4 prompts of 6144 tokens (1.5 windows of 4096), then 32 greedy
# steps on the ring.  The f32 checks run one prompt (36 GB of f32
# weights beside f32 activations) and teacher forcing over 8 steps.
MX_LAYERS, MX_BATCH, MX_SEQ, MX_STEPS = 6, 4, 6144, 32
MX_F32_BATCH, MX_TF_STEPS = 1, 8
# f32 compute, kernels vs plain and prefill+decode vs prefill: held to
# 1e-3 of the largest magnitude through 6 layers
MX_F32_REL_TOL = 1e-3


class SmokeFailure(RuntimeError):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn`` in ms: CUDA events around ``iters``
    back-to-back calls after a warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, flops: float, dtype: str):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def cold_ms(fn, iters: int = 10) -> float:
    """Mean device time of ``fn`` with a cold L2: 256 MB (five times the
    H100's 50 MB L2) are written before each call, which also keeps the
    device busy while the host enqueues the call, so the event pair
    around each call times the device and not the host."""
    import torch

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    fn()
    pairs = []
    for _ in range(iters):
        flush.fill_(1)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def queued_ms(fn, n: int = 20) -> float:
    """Mean device time of ``fn`` over ``n`` calls enqueued behind a sleep
    kernel, so that the event pair times the device's back-to-back work
    and not the host's enqueue."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)  # ~10 ms at 2 GHz: longer than the enqueue
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def host_us(fn, n: int = 1000) -> float:
    """Host time per call of ``fn`` in µs: ``n`` calls enqueued with no
    synchronise between them (the device drains the queue after)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def device_timings(torch, kernel_fn, library_fn=None, n: int = 20) -> dict:
    """Device time per call (``dev_ms``: ``n`` calls queued behind a sleep
    kernel, every kernel a call launches included, the split combine too)
    and the cold-L2 time, for the kernel and for its library call."""
    out = {"dev_ms": queued_ms(kernel_fn, n), "cold_ms": cold_ms(kernel_fn)}
    if library_fn is not None:
        out["library_dev_ms"] = queued_ms(library_fn, n)
        out["library_cold_ms"] = cold_ms(library_fn)
    return out


# ---------------------------------------------------------------------------
# kernel inputs at the serving path's shapes
# ---------------------------------------------------------------------------
def paged_inputs(torch, dtype, lengths, *, n_pool=16, mb=9, H=14, Hkv=2,
                 D=64, seed=0, q_scale=1.0):
    """Decode-step operands: per-slot pools flattened to global ids, rows
    that cross slots, ``lengths`` already counting the new token."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    B = len(lengths)
    q = (torch.randn((B, H, D), generator=g, device=dev) * 0.3
         * q_scale).to(dtype)
    kp = (torch.randn((B, n_pool, 128, Hkv, D), generator=g, device=dev)
          * 0.3).to(dtype)
    vp = (torch.randn((B, n_pool, 128, Hkv, D), generator=g, device=dev)
          * 0.3).to(dtype)
    table = torch.randint(0, B * n_pool, (B, mb), generator=g, device=dev,
                          dtype=torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, kp, vp, table, lens


def flash_inputs(torch, dtype, S_kv, *, S_q=128, H=14, Hkv=2, D=64, B=1,
                 seed=1, q_scale=1.0):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    q = (torch.randn((B, S_q, H, D), generator=g, device=dev) * 0.3
         * q_scale)
    k = (torch.randn((B, S_kv, Hkv, D), generator=g, device=dev) * 0.3)
    v = (torch.randn((B, S_kv, Hkv, D), generator=g, device=dev) * 0.3)
    return q.to(dtype), k.to(dtype), v.to(dtype)


def decode_inputs(torch, dtype, lengths, *, S_max=4096, H=16, Hkv=16, D=64,
                  seed=3, q_scale=1.0):
    """Cross-attention decode operands: one query per sequence against a
    contiguous (B, S_max, Hkv, D) cache, ``lengths`` valid rows each."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    B = len(lengths)
    q = (torch.randn((B, H, D), generator=g, device=dev) * 0.3
         * q_scale).to(dtype)
    k = (torch.randn((B, S_max, Hkv, D), generator=g, device=dev)
         * 0.3).to(dtype)
    v = (torch.randn((B, S_max, Hkv, D), generator=g, device=dev)
         * 0.3).to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, k, v, lens


def local_table(torch, B, n_pool, mb, seed=0):
    """Per-slot page ids: each row a permutation of its own pool's pages,
    rows different from each other wherever the pool has room for it."""
    import math

    import numpy as np

    rs = np.random.RandomState(seed)
    distinct = math.perm(n_pool, mb)
    rows = []
    while len(rows) < B:
        r = tuple(int(p) for p in rs.permutation(n_pool)[:mb])
        if r not in rows or len(rows) >= distinct:
            rows.append(r)
    return torch.tensor(rows, dtype=torch.int32, device="cuda")


def paged_plan_fields(B, Hkv, n_kv, lengths) -> dict:
    """The paged kernel's launch plan at a shape (``plan_splits``, from
    shapes only) and its live blocks for these lengths: the blocks whose
    split holds at least one of its row's keys (a row of length <= 0
    sweeps every split)."""
    from repro_torch.kernels.paged_attention import plan_splits

    plan = plan_splits(B, Hkv, n_kv, 128)
    per = plan.block * plan.tiles_per_split
    live = Hkv * sum(min(plan.splits, -(-n // per)) if n > 0 else plan.splits
                     for n in lengths)
    return {"tile_rows": plan.block, "splits": plan.splits,
            "tiles_per_split": plan.tiles_per_split,
            "blocks": B * Hkv * plan.splits, "live_blocks": live}


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def row_rel_err(got, want) -> float:
    """The largest, over output rows (the last axis), of max|got - want|
    over the row divided by max|want| over the row."""
    got, want = got.float(), want.float()
    num = (got - want).abs().amax(-1)
    return float((num / want.abs().amax(-1).clamp_min(1e-30)).max())


def attention_errs(got, want, dname, what):
    """Absolute error, held to KERNEL_TOL; for bf16 also the row-relative
    error, held to ROW_REL_TOL.  Returns the two as a case's fields."""
    e = max_err(got, want)
    check(e <= KERNEL_TOL[dname], f"{what} {dname} err {e}")
    out = {"max_abs_err": e, "tol": KERNEL_TOL[dname]}
    if dname == "bfloat16":
        r = row_rel_err(got, want)
        check(r <= ROW_REL_TOL, f"{what} {dname} row-relative err {r}")
        out.update(row_rel_err=r, row_rel_tol=ROW_REL_TOL)
    return out


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    check(smi.returncode == 0 and line, f"nvidia-smi failed: {smi.stderr}")
    print(line, flush=True)
    emit({"phase": "device", "nvidia_smi": line,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})


def hgmma_counts(lib: Path) -> dict:
    """Warpgroup MMA instructions (HGMMA) in each kernel of a built
    library (``cuobjdump -sass``, from the toolkit beside nvcc): which
    kernels run on the tensor cores."""
    from repro_torch.kernels import _build

    tool = Path(_build.find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = 0
        elif fn is not None and " HGMMA" in line:
            counts[fn] += 1
    return counts


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    seconds = _build.build()
    report = {}
    for name in _build.SOURCES:
        log = _build.library_path(name).with_name(
            _build.library_path(name).name + ".log")
        report[name] = [ln.strip() for ln in log.read_text().splitlines()
                        if "Used" in ln or "spill" in ln]
    # the SSD library's kernels: the bf16 scan runs wgmma (HGMMA), the f32
    # body none
    hgmma = hgmma_counts(_build.library_path("ssd_scan"))
    bf16 = [n for n in hgmma if "ssd_wgmma_kernel" in n]
    check(len(bf16) == 2 and all(hgmma[n] > 0 for n in bf16),
          f"the bf16 SSD kernels run no warpgroup MMA: {hgmma}")
    # the SSD backward's bf16 products: states, col and row kernels (N <= 64
    # and N 128 forms) run wgmma and spill nothing
    from repro_torch.kernels.ssd_scan import bwd_plan

    hgmma_bwd = hgmma_counts(_build.library_path("ssd_scan_bwd"))
    wgmma_bwd = [n for n in hgmma_bwd if any(
        k in n for k in ("states_kernel", "col_kernel", "row_kernel"))]
    check(len(wgmma_bwd) == 6 and all(hgmma_bwd[n] > 0 for n in wgmma_bwd),
          f"the bf16 SSD backward runs no warpgroup MMA: {hgmma_bwd}")
    bwd_plans = {f"N{n}": bwd_plan(n) for n in (64, 128)}
    check(all(v == 0 for p in bwd_plans.values() for k, v in p.items()
              if k.endswith("local_bytes")),
          f"the bf16 SSD backward spills: {bwd_plans}")
    emit({"phase": "build", "ok": True, "seconds": seconds,
          "wall_s": time.perf_counter() - t0, "ptxas": report,
          "ssd_scan_hgmma": hgmma, "ssd_scan_bwd_hgmma": hgmma_bwd,
          "ssd_scan_bwd_plans": bwd_plans})


def phase_parity(torch):
    """Each kernel against its plain version at full-width shapes."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.paged_attention import paged_attention_kernel

    errs = {}
    rows = []
    # idle and fresh rows; then the split edges of a tile (the planner cuts
    # pages in two: 63 / 64 / 65 and 127 / 128 / 129) and the
    # full n_kv sweep, also with q scaled up for a peaked softmax
    cases = [([1001, 645, 129, 388, 901, 261, 0, 1], 1.0),
             ([0, 1, 63, 64, 65, 127, 129, 1024], 1.0),
             ([0, 1, 63, 64, 65, 127, 129, 1024], PEAKED_Q)]
    for (lengths, qs), dname in itertools.product(cases,
                                                  ("float32", "bfloat16")):
        dtype = getattr(torch, dname)
        q, kp, vp, table, lens = paged_inputs(torch, dtype, lengths,
                                              q_scale=qs)
        got = paged_attention_kernel(q, kp, vp, table, lens, n_kv=8,
                                     global_pages=True)
        want = ref.paged_attention(q, kp, vp, table, lens, n_kv=8,
                                   global_pages=True)
        torch.cuda.synchronize()
        case = attention_errs(got, want, dname, f"paged {lengths} x{qs}")
        rows.append({"kernel": "paged_attention", "dtype": dname,
                     "case": f"B=8 H=14 Hkv=2 D=64 n_kv=8<9 cross-slot "
                             f"q_scale={qs}", "lengths": lengths,
                     "plan": paged_plan_fields(8, 2, 8, lengths), **case})
        errs["paged_attention", dname] = max(
            case["max_abs_err"], errs.get(("paged_attention", dname), 0.0))
        for (S_kv, off), qs in itertools.product(
                ((1024, 768), (128, 0), (512, 300)), (1.0, PEAKED_Q)):
            q, k, v = flash_inputs(torch, dtype, S_kv, q_scale=qs)
            got = flash_attention_kernel(q, k, v, causal=True, q_offset=off)
            want = ref.flash_attention(q, k, v, causal=True, q_offset=off)
            torch.cuda.synchronize()
            case = attention_errs(got, want, dname, f"flash {S_kv} q x{qs}")
            rows.append({"kernel": "flash_attention", "dtype": dname,
                         "case": f"S_q=128 S_kv={S_kv} q_offset={off} "
                                 f"H=14 Hkv=2 D=64 q_scale={qs}", **case})
            errs["flash_attention", dname] = max(
                case["max_abs_err"],
                errs.get(("flash_attention", dname), 0.0))
    emit({"phase": "kernel_parity", "ok": True, "cases": rows})
    return errs


def _chunks(torch, model, params, cache, slot, prompt, n_pool, mb, impl):
    """Prefill ``prompt`` into ``slot`` chunk by chunk (own pages 1..),
    returning each chunk's logits and the block-table row."""
    dev = model.device
    row = torch.zeros((mb,), dtype=torch.int32)
    n_pages = -(-len(prompt) // 128)
    row[:n_pages] = torch.arange(1, n_pages + 1) + slot * n_pool
    logits = []
    for start in range(0, len(prompt), 128):
        seg = prompt[start:start + 128]
        toks = torch.zeros((1, 128), dtype=torch.int32)
        toks[0, :len(seg)] = torch.tensor(seg, dtype=torch.int32)
        n_kv = min(1 << ((start // 128 + 1) - 1).bit_length(), mb)
        out, cache = model.prefill_chunk(
            params, cache,
            {"tokens": toks.to(dev), "start": start, "row": row.to(dev),
             "pages": row[start // 128:start // 128 + 1].to(dev),
             "last_index": len(seg) - 1},
            n_kv=n_kv, global_pages=True, impl=impl)
        logits.append(out)
    return logits, row


def conditioned(model, params):
    """A copy of a seeded init whose attention projections have unit
    variance over their true contraction (d_model for q/k/v, heads x
    head_dim for the output).  The JAX package's init divides by
    sqrt(shape[-2]) — the head count for wq/wk/wv, head_dim for wo — so at
    full width attention scores spread ~170 wide: every head is a hard
    argmax that one rounding step can flip, and two correct attention
    paths part ways within a few layers (phase "layers" shows it).
    Dense: ``layers.attn``; encoder-decoder: ``enc_layers.attn``,
    ``dec_layers.self_attn`` and ``dec_layers.cross_attn``; hybrid:
    ``shared_attn.attn``; the SSM family has no attention and is returned
    as it is."""
    import math

    cfg = model.cfg
    if cfg.family == "ssm":
        return params
    M, H, Hkv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads

    def cond(attn):
        attn = dict(attn)
        attn["wq"] = attn["wq"] * math.sqrt(H / M)
        attn["wk"] = attn["wk"] * math.sqrt(Hkv / M)
        attn["wv"] = attn["wv"] * math.sqrt(Hkv / M)
        attn["wo"] = attn["wo"] / math.sqrt(H)
        return attn

    if cfg.family == "hybrid":
        shared = params["shared_attn"]
        return dict(params, shared_attn=dict(shared,
                                             attn=cond(shared["attn"])))
    if cfg.is_encdec:
        enc, dec = params["enc_layers"], params["dec_layers"]
        return dict(params,
                    enc_layers=dict(enc, attn=cond(enc["attn"])),
                    dec_layers=dict(dec, self_attn=cond(dec["self_attn"]),
                                    cross_attn=cond(dec["cross_attn"])))
    return dict(params, layers=dict(params["layers"],
                                    attn=cond(params["layers"]["attn"])))


def bf16_ulp(x: float) -> float:
    """Spacing of bf16 values at magnitude ``x`` (8 significant bits)."""
    import math

    return 2.0 ** (math.floor(math.log2(max(x, 1e-30))) - 7)


def phase_layers(torch, model, params):
    """Layer by layer at full width with the model's own init: at every
    layer both attention paths get the SAME input (the plain path's hidden
    state), so a difference is that layer's alone.  Held to 4 bf16 ulps of
    the layer output's largest magnitude."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    cfg, dev = model.cfg, model.device
    cache = model.init_cache(ShapeConfig("smoke", "decode", 1024, 8))
    n_pool = cache["layers"]["k_pool"].shape[2]
    mb = 9
    row = torch.zeros((mb,), dtype=torch.int32, device=dev)
    row[:2] = torch.tensor([1, 2], dtype=torch.int32)  # slot 0's pages
    # slots 1-7 decode at length 0: each writes its K/V to the first page
    # of its table row and attends over that one key, so each gets its own
    # scratch page (global id slot * n_pool).  On one shared page the 7
    # writes land in one row in an order the card does not fix, and the
    # kernel's and the plain path's calls can each read another winner.
    table = torch.zeros((8, mb), dtype=torch.int32, device=dev)
    table[:, 0] = torch.arange(8, dtype=torch.int32, device=dev) * n_pool
    table[0] = row
    lengths = torch.zeros((8,), dtype=torch.int32, device=dev)
    lengths[0] = 128
    toks = torch.arange(7, 135, dtype=torch.int32, device=dev)[None]
    pos = torch.arange(128, dtype=torch.int32, device=dev)
    worst = {}
    for kind in ("chunk", "decode"):
        if kind == "chunk":
            h = L.embed_tokens(params["embed"], toks, cfg)
        else:
            h = L.embed_tokens(params["embed"], toks[:, :8].T, cfg)
        worst[kind] = (0.0, 0.0, -1)
        for i in range(cfg.num_layers):
            lp = T._layer(params["layers"], i)
            cl = T._layer(cache["layers"], i)
            a_in = L.apply_norm(lp["norm1"], h, cfg)
            outs = []
            for impl in (None, "plain"):
                if kind == "chunk":
                    a, _ = L.attention_chunk(
                        lp["attn"], a_in, cfg, cl, row=row, pages=row[:1],
                        positions=pos, q_offset=0, n_kv=1,
                        global_pages=True, impl=impl)
                else:
                    a, _ = L.attention_decode(
                        lp["attn"], a_in, cfg, cl, lengths,
                        block_table=table, n_kv=2, global_pages=True,
                        impl=impl)
                outs.append(a)
            e = max_err(outs[0], outs[1])
            scale = float(outs[1].float().abs().max())
            check(e <= 4 * bf16_ulp(scale),
                  f"layer {i} {kind}: err {e} at scale {scale}")
            if e / scale >= worst[kind][0] / max(worst[kind][1], 1e-30):
                worst[kind] = (e, scale, i)
            h = h + outs[1]
            h = h + L.apply_mlp(lp["mlp"], L.apply_norm(lp["norm2"], h, cfg),
                                cfg)
    torch.cuda.synchronize()
    emit({"phase": "layers", "ok": True, "tol": "4 bf16 ulps of max|out|",
          "worst": {k: {"max_abs_err": v[0], "max_abs_out": v[1],
                        "layer": v[2]} for k, v in worst.items()}})


def model_logits(torch, model, params, impl):
    """Logits of three prefill chunks (slot 0, 300 tokens), one chunk
    (slot 1, 100 tokens) and a decode step over all 8 slots."""
    from repro_torch.configs import ShapeConfig

    cache = model.init_cache(ShapeConfig("smoke", "decode", 1024, 8))
    n_pool = cache["layers"]["k_pool"].shape[2]
    mb = -(-1024 // 128) + 1
    prompts_ = {0: list(range(7, 7 + 300)), 1: list(range(50, 150))}
    table = torch.zeros((8, mb), dtype=torch.int32)
    out = []
    for slot, prompt in prompts_.items():
        lg, row = _chunks(torch, model, params, cache, slot, prompt, n_pool,
                          mb, impl)
        out += lg
        table[slot] = row
    lengths = torch.zeros((8,), dtype=torch.int32)
    lengths[0], lengths[1] = 300, 100
    tokens = torch.full((8, 1), 11, dtype=torch.int32)
    dec, _ = model.decode_step(
        params, cache,
        {"tokens": tokens.cuda(), "lengths": lengths.cuda(),
         "block_table": table.cuda()}, n_kv=4, global_pages=True,
        impl=impl)
    torch.cuda.synchronize()
    return out + [dec]


def compare_logits(torch, got, want):
    rows = []
    for i, (a, b) in enumerate(zip(got, want)):
        check(bool(torch.isfinite(a).all()), f"non-finite logits {i}")
        rows.append({
            "call": "decode" if i == len(got) - 1 else f"chunk{i}",
            "shape": list(a.shape), "max_abs_err": max_err(a, b),
            "max_abs_logit": float(b.float().abs().max()),
            "argmax_agree": float((a.float().argmax(-1)
                                   == b.float().argmax(-1)).float().mean())})
    return rows


def phase_model(torch, model, p_cond, p_own):
    """Full-width prefill chunks and a decode step, kernels vs plain: held
    to a tolerance with conditioned weights; reported with the model's
    own init (decorrelated by the hard-argmax attention)."""
    cond = compare_logits(torch, model_logits(torch, model, p_cond, None),
                          model_logits(torch, model, p_cond, "plain"))
    for r in cond:
        check(r["max_abs_err"] <= LOGIT_REL_TOL * r["max_abs_logit"],
              f"logits {r}")
    own = compare_logits(torch, model_logits(torch, model, p_own, None),
                         model_logits(torch, model, p_own, "plain"))
    emit({"phase": "model", "ok": True, "tol_rel": LOGIT_REL_TOL,
          "conditioned": cond, "own_init_reported": own})


PROMPT_LENS = (260, 900, 520, 140, 100, 400, 777, 333)  # first 4 share
# the kernel rows' engine shapes: the 8 slots mid-decode (prompt + 16
# generated + the new token); the 900-token prompt's last chunk (start
# 768, its 8 pages of keys swept)
DECODE_LENGTHS = [n + 17 for n in PROMPT_LENS]
LAST_CHUNK_OFFSET, LAST_CHUNK_SWEEP = 768, 1024


def prompts(vocab: int = 150_000):
    """The greedy cell's 8 prompts, token ids in ``[1, vocab)`` from seed
    0 (qwen2's draw below its 151,936 ids unless ``vocab`` says)."""
    import numpy as np

    rs = np.random.RandomState(0)
    shared = list(rs.randint(1, vocab, 128))
    out = []
    for i, n in enumerate(PROMPT_LENS):
        if i < 4:
            out.append(shared + list(rs.randint(1, vocab, n - 128)))
        else:
            out.append(list(rs.randint(1, vocab, n)))
    return out


def run_engine(torch, model, params, impl=None, max_new=32, unreclaimed=None,
               prompt_list=None, **kw):
    """The 8 requests (``prompt_list``, by default qwen2's) through a
    ``ServingEngine`` (stamp-it, chunks of 128 unless ``kw`` says
    otherwise); ``unreclaimed`` collects the pool's unreclaimed pages
    after every step."""
    from repro_torch.serving import ServingEngine

    kw = {"policy": "stamp-it", **kw}
    eng = ServingEngine(model, max_slots=8, max_seq=1024,
                        prefix_cache_entries=16, params=params, impl=impl,
                        device=model.device, **kw)
    reqs = [eng.submit(p, max_new_tokens=max_new)
            for p in (prompt_list or prompts())]
    events = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while eng.sched.has_work():
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        eng.step()
        e.record()
        events.append((s, e))
        if unreclaimed is not None:
            unreclaimed.append(eng.pool.unreclaimed())
        check(eng.steps < 2000, "engine did not converge")
    eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    step_ms = [s.elapsed_time(e) for s, e in events]
    return eng, reqs, wall, step_ms


def _agreement(reqs, other) -> float:
    """Share of generated tokens equal position by position."""
    agree = sum(a == b for r, o in zip(reqs, other)
                for a, b in zip(r.generated, o.generated))
    return agree / sum(len(r.generated) for r in reqs)


def _first_diffs(reqs, other) -> dict:
    """Request index -> the first generated position where two runs
    differ (requests that agree throughout are left out)."""
    out = {}
    for i, (r, o) in enumerate(zip(reqs, other)):
        diff = [j for j, (a, b) in enumerate(zip(r.generated, o.generated))
                if a != b]
        if diff:
            out[i] = diff[0]
    return out


def _reset(kernels):
    for k in kernels:
        k.launches = 0
        if hasattr(k, "combine_launches"):
            k.combine_launches = 0


def phase_engine(torch, model, params):
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.paged_attention import paged_attention_kernel

    # warm-up pass (allocator, cuBLAS handles, kernel loads), not counted
    run_engine(torch, model, params)
    _reset((paged_attention_kernel, flash_attention_kernel))
    eng, reqs, wall, step_ms = run_engine(torch, model, params)
    launches = {"paged_attention": paged_attention_kernel.launches,
                "flash_attention": flash_attention_kernel.launches}
    # device launches of the split combine, beside the wrapper calls
    combines = {"paged_attention": paged_attention_kernel.combine_launches,
                "flash_attention": flash_attention_kernel.combine_launches}
    st = eng.stats()
    check(all(r.done and len(r.generated) == 32 for r in reqs),
          "not every request finished with 32 tokens")
    vocab = model.cfg.vocab_size
    check(all(0 <= t < vocab for r in reqs for t in r.generated),
          "token out of vocabulary range")
    check(st["dispatches_per_step"] == 1, f"dispatches/step {st}")
    check(launches["paged_attention"] == N_LAYERS * st["decode_dispatches"],
          f"paged launches {launches} vs {st['decode_dispatches']}")
    check(launches["flash_attention"] == N_LAYERS * st["prefill_chunks"],
          f"flash launches {launches} vs {st['prefill_chunks']}")
    check(all(v > 0 for v in launches.values()), f"launches {launches}")
    # every n_kv bucket of this engine splits the page sweep (its pages are
    # cut to tiles of 64 or 32 rows): each paged call also combines
    check(combines["paged_attention"] == launches["paged_attention"],
          f"paged combines {combines} vs launches {launches}")
    check(st["pool_unreclaimed"] == 0, "pages left unreclaimed")
    # the same requests through the plain attention: how many of the
    # greedy tokens agree (bf16 rounding may flip near-ties; reported)
    _, preqs, pwall, _ = run_engine(torch, model, params, impl="plain")
    first_agree = sum(r.generated[0] == p.generated[0]
                      for r, p in zip(reqs, preqs))
    emit({"phase": "engine", "ok": True, "requests": len(reqs),
          "prompt_lens": list(PROMPT_LENS), "max_new_tokens": 32,
          "wall_s": wall, "decode_tokens_per_s": st["tokens_emitted"] / wall,
          "median_step_ms": statistics.median(step_ms),
          "steps": st["steps"], "decode_dispatches": st["decode_dispatches"],
          "prefill_chunks": st["prefill_chunks"],
          "dispatches_per_step": st["dispatches_per_step"],
          "launches": launches, "combine_launches": combines,
          "host_us_per_step": st["host_us_per_step"],
          "pool": {k: st[k] for k in ("free_pages", "pool_unreclaimed",
                                      "pool_freed", "scan_steps",
                                      "prefix_hits", "prefix_misses")},
          "plain_wall_s": pwall, "plain_token_agreement":
              _agreement(reqs, preqs),
          "plain_first_token_agreement": first_agree / len(reqs)})
    base = {"reqs": reqs, "plain": preqs, "wall_s": wall,
            "median_step_ms": statistics.median(step_ms),
            "tokens_per_s": st["tokens_emitted"] / wall}
    return launches, wall, base


def phase_small_reference(torch):
    """Smoke width, f32: the engine through the kernels against the engine
    through the plain versions, token for token."""
    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.models import Model
    from repro_torch.serving import ServingEngine
    import numpy as np

    model = Model(smoke_config(ARCHS["qwen2-0.5b"]))
    params = model.init_params(0)
    rs = np.random.RandomState(3)
    ps = [list(rs.randint(1, 500, n)) for n in (20, 300, 130, 513)]
    out = {}
    for impl in (None, "plain"):
        eng = ServingEngine(model, max_slots=2, max_seq=768, params=params,
                            impl=impl)
        reqs = [eng.submit(p, max_new_tokens=8) for p in ps]
        eng.run_until_done()
        out[impl] = [r.generated for r in reqs]
    check(out[None] == out["plain"], "smoke-width tokens differ")
    emit({"phase": "small_reference", "ok": True,
          "tokens": sum(len(g) for g in out[None])})


def paged_row(torch, name, lengths, *, n_pool, H, Hkv, D, fields,
              label=""):
    """The paged kernel (global ids, n_kv 8 over 9 table columns) at one
    engine decode shape, bf16: kernel, plain and device times beside the
    bound (each K/V row read once), with the launch plan; ``fields`` (the
    launches, the error) are the caller's.  Launch counts are restored."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import paged_attention_kernel

    saved = (paged_attention_kernel.launches,
             paged_attention_kernel.combine_launches)
    elt, n_kv = 2, 8
    q, kp, vp, table, lens = paged_inputs(torch, torch.bfloat16, lengths,
                                          n_pool=n_pool, mb=9, H=H, Hkv=Hkv,
                                          D=D)
    def pfn():
        return paged_attention_kernel(q, kp, vp, table, lens, n_kv=n_kv,
                                      global_pages=True)

    k_ms = time_ms(pfn)
    p_ms = time_ms(lambda: ref.paged_attention(q, kp, vp, table, lens,
                                               n_kv=n_kv, global_pages=True))
    tok = sum(lengths)
    n_bytes = (2 * q.numel() * elt + tok * Hkv * D * 2 * elt
               + table.numel() * 4 + lens.numel() * 4)
    b_ms, b_by = bound_ms(n_bytes, 4 * H * D * tok, "bfloat16")
    dev = device_timings(torch, pfn)
    (paged_attention_kernel.launches,
     paged_attention_kernel.combine_launches) = saved
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention.py:128",
            **fields, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None, **dev,
            "bound_share_of_dev": b_ms / dev["dev_ms"],
            "plan": paged_plan_fields(8, Hkv, n_kv, lengths),
            "library_note": "no single PyTorch call attends over pages "
                            "named by a block table",
            "shape": f"{label}B=8 lengths={lengths} n_kv={n_kv} H={H} "
                     f"Hkv={Hkv} D={D} n_pool={n_pool} global ids"}


def flash_chunk_row(torch, name, off, S_kv, *, H, Hkv, D, fields, label=""):
    """The flash kernel on one 128-query chunk at ``q_offset`` ``off``
    over ``S_kv`` keys, causal, bf16: kernel, plain, SDPA and device
    times beside the bound (the keys each row sees), with the launch
    plan; ``fields`` are the caller's.  Launch counts are restored."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.flash_attention import plan_splits as flash_plan

    saved = (flash_attention_kernel.launches,
             flash_attention_kernel.combine_launches)
    elt, S_q = 2, 128
    q, k, v = flash_inputs(torch, torch.bfloat16, S_kv, H=H, Hkv=Hkv, D=D)
    def kfn():
        return flash_attention_kernel(q, k, v, causal=True, q_offset=off)

    k_ms = time_ms(kfn)
    p_ms = time_ms(lambda: ref.flash_attention(q, k, v, causal=True,
                                               q_offset=off))
    qpos = torch.arange(S_q, device=q.device)[:, None] + off
    mask = torch.arange(S_kv, device=q.device)[None, :] <= qpos
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    def lfn():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              enable_gqa=True)

    l_ms = time_ms(lfn)
    keys = sum(min(off + i + 1, S_kv) for i in range(S_q))
    n_bytes = 2 * q.numel() * elt + 2 * min(off + S_q, S_kv) * Hkv * D * elt
    b_ms, b_by = bound_ms(n_bytes, 4 * H * D * keys, "bfloat16")
    plan = flash_plan(1, S_q, H, S_kv, q_offset=off, causal=True,
                      head_dim=D)
    dev = device_timings(torch, kfn, lfn)
    (flash_attention_kernel.launches,
     flash_attention_kernel.combine_launches) = saved
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:85",
            **fields, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": l_ms, **dev,
            "bound_share_of_dev": b_ms / dev["dev_ms"],
            "library_note": "scaled_dot_product_attention, boolean causal "
                            "mask, enable_gqa=True (timed only)",
            "shape": f"{label}S_q={S_q} S_kv={S_kv} q_offset={off} H={H} "
                     f"Hkv={Hkv} D={D} warpgroups={plan.consumers} "
                     f"key_tile={plan.keys} splits={plan.splits}"
                     + ("" if D in (32, 64, 128) else " run-time D")}


def phase_kernel_table(torch, launches, errs):
    """Each kernel at the engine's shapes: kernel, plain and library time
    beside the bound, all in bf16 (the compute dtype): paged at
    DECODE_LENGTHS, flash on the 900-token prompt's last chunk and on
    the first chunk of every prompt (start 0, one page)."""
    heads = dict(H=14, Hkv=2, D=64)
    rows = [paged_row(torch, "paged_attention", DECODE_LENGTHS, n_pool=16,
                      **heads,
                      fields={"launches": launches["paged_attention"],
                              "max_abs_err": errs["paged_attention",
                                                  "bfloat16"]})]
    for name, off, S_kv in (("flash_attention", LAST_CHUNK_OFFSET,
                             LAST_CHUNK_SWEEP),
                            ("flash_attention_first_chunk", 0, 128)):
        rows.append(flash_chunk_row(
            torch, name, off, S_kv, **heads,
            fields={"launches": launches["flash_attention"],
                    "max_abs_err": errs["flash_attention", "bfloat16"]}))
    return rows


# ---------------------------------------------------------------------------
# page copies, the sampler and the copy-on-write fork plane (qwen2-0.5b)
# ---------------------------------------------------------------------------
# qwen2's engine pool, both layers' K (or V) viewed as one page array:
# L 24 x B 8 x N_pool 16 pages of (128, 2, 64) bf16 (32 KiB each)
QWEN_POOL_PAGES, QWEN_PAGE = 24 * 8 * 16, (128, 2, 64)
# one CoW copy (or a prefix migration's page read) gathers 1 page x 24
# layers; the fork_engine replay 6 x 24; the disagg_engine handoff of the
# 900-token prompt 8 x 24 (its 8 pages, a bucket of 8)
GATHER_M = (24, 144, 192)
# a handoff read's page counts: the 8 prompts hold 1 to 8 pages, padded to
# buckets of 1, 2, 4 and 8 (M 24, 48, 96, 192); 3 and 5 carry pad lanes
HANDOFF_PAGES = (1, 2, 3, 5, 8)
SAMPLE_PAIRS = ((0.7, 0.9), (1.0, 1.0), (1.3, 0.5), (0.4, 0.95))
# the sampler check skips a u this close to a kcum boundary: the host and
# the card sum the softmax in different orders (float associativity)
SAMPLE_BOUNDARY = 1e-5
FORK = dict(temperature=0.8, top_p=0.9, sample_seed=7)
FORK_PROMPTS = (900, 333)  # best-of-4 each: partial pages of 4 and 77


def gather_inputs(torch, dtype, n_pool, page, m, seed=0):
    """A pool of ``n_pool`` pages and ``m`` repeated, unordered ids."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + m)
    pool = torch.randn((n_pool, *page), generator=g, device=dev).to(dtype)
    idx = torch.randint(0, n_pool, (m,), generator=g, device=dev,
                        dtype=torch.int32)
    idx[-1] = idx[0]  # at least one repeat
    return pool, idx


def replica_pool(torch, dtype, seed=0):
    """A cluster replica's K (or V) pool viewed as ``read_pages`` views
    it: L 24 x B CLUSTER_SLOTS x N_pool 16 pages of qwen2's (128, 2, 64)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((N_LAYERS * CLUSTER_SLOTS * 16, *QWEN_PAGE),
                       generator=g, device="cuda").to(dtype)


def handoff_index(torch, n, slot=1, seed=0):
    """The host-built int32 index ``DeviceState.read_pages`` hands the
    gather for ``n`` of one slot's pages in a replica's pool: layer-major,
    each layer's pages padded to a power-of-two bucket with the slot's
    scratch page 0."""
    import numpy as np

    L, B, N = N_LAYERS, CLUSTER_SLOTS, 16
    rng = np.random.default_rng(seed + n)
    pages = rng.choice(np.arange(1, N), n, replace=False)
    nb = 1 << (n - 1).bit_length()
    pages = np.concatenate([pages, np.zeros(nb - n, np.int64)])
    idx = (np.arange(L)[:, None] * (B * N) + slot * N + pages[None, :])
    return torch.from_numpy(idx.reshape(-1).astype(np.int32))


def gather_plan(torch, pool, got) -> dict:
    """The plan the gather ran for ``got = block_gather_kernel(pool,
    idx)``, and its blocks."""
    from repro_torch.kernels.block_gather import plan_gather

    plan = plan_gather(pool[0].numel() * pool.element_size(), got.shape[0],
                       pool.data_ptr(), got.data_ptr())
    return {**plan._asdict(), "blocks": got.shape[0] * plan.pieces}


def gather_want(pool, idx):
    """``pool[idx]`` with a zero page where ``idx`` is out of range."""
    from repro_torch.kernels import ref

    idx = idx.to(pool.device)
    n = pool.shape[0]
    want = ref.block_gather(pool, idx.clamp(0, n - 1))
    want[(idx < 0) | (idx >= n)] = 0
    return want


def misaligned(torch, t):
    """``t`` copied into storage one element past a 16-byte boundary:
    contiguous, but its base takes no 16-byte word."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


def phase_block_gather_parity(torch):
    """The gather kernel against ``pool[idx]``: a copy, so bit-exact.
    qwen2's and seamless's pages and a 30-byte bf16 page (the kernel's
    narrow words); every handoff read's shape (M 24 to 192) over a
    cluster replica's pool with a host-built index, as ``read_pages``
    passes it, and M 192's index on the card; a pool one element past a
    16-byte boundary (narrow words); device indices with ids out of
    range (a zero page each); M 0 (no launch).  Each case names the plan
    it ran."""
    from repro_torch.kernels.block_gather import block_gather_kernel

    saved = block_gather_kernel.launches
    rows = []
    errs = {}

    def hold(dname, page, m, pool, idx, **extra):
        before = block_gather_kernel.launches
        got = block_gather_kernel(pool, idx)
        want = gather_want(pool, idx)
        torch.cuda.synchronize()
        err = max_err(got, want) if m else 0.0
        same = bool(torch.equal(got, want))
        launched = block_gather_kernel.launches - before
        rows.append({"dtype": dname, "page": list(page), "M": m,
                     "page_bytes": pool[0].numel() * pool.element_size(),
                     "max_abs_err": err, "bit_exact": same,
                     "plan": gather_plan(torch, pool, got) if m else None,
                     **extra})
        check(same, f"block_gather {dname} {page} M={m} {extra} differs")
        check(launched == (m > 0), f"block_gather M={m}: {launched} launches")
        key = ("block_gather", dname)
        errs[key] = max(errs.get(key, 0.0), err)

    cases = [(d, p, m) for d in ("float32", "bfloat16")
             for p in (QWEN_PAGE, (128, 16, 64)) for m in (1, 24, 144)]
    cases.append(("bfloat16", (3, 1, 5), 24))
    for dname, page, m in cases:
        pool, idx = gather_inputs(torch, getattr(torch, dname), 512, page, m)
        hold(dname, page, m, pool, idx)
    for dname in ("float32", "bfloat16"):
        pool = replica_pool(torch, getattr(torch, dname))
        for n in HANDOFF_PAGES:
            idx = handoff_index(torch, n)
            hold(dname, QWEN_PAGE, idx.numel(), pool, idx,
                 pool_pages=pool.shape[0], pages=n, index="host int32")
        hold(dname, QWEN_PAGE, 192, pool, handoff_index(torch, 8).cuda(),
             pool_pages=pool.shape[0], pages=8, index="device int32")
        del pool
    for dname in ("float32", "bfloat16"):
        pool, idx = gather_inputs(torch, getattr(torch, dname), 512,
                                  QWEN_PAGE, 24)
        odd = misaligned(torch, pool)
        hold(dname, QWEN_PAGE, 24, odd, idx, base="one element past 16 B")
        bad = idx.clone()
        bad[[0, 5, 23]] = torch.tensor([-1, 512, 2**31 - 1],
                                       dtype=torch.int32, device="cuda")
        for what, p in (("16-byte base", pool), ("odd base", odd)):
            hold(dname, QWEN_PAGE, 24, p, bad, index="ids -1, N_pool, "
                 "2^31 - 1 at rows 0, 5, 23 (zero pages)", base=what)
        hold(dname, QWEN_PAGE, 0, pool, idx[:0], index="empty")
        del pool, odd
    block_gather_kernel.launches = saved
    emit({"phase": "block_gather_parity", "ok": True, "tol": 0,
          "cases": rows})
    return errs


def phase_sampler_parity(torch):
    """``counter_uniform`` on the card against its numpy twin, bit for
    bit; ``sample_tokens`` on (8, 151936) f32 logits against the host
    reference at the four (temperature, top_p) pairs."""
    import numpy as np

    from repro_torch.serving.device_state import sample_tokens
    from repro_torch.serving.rng import counter_uniform, counter_uniform_np
    from repro_torch.serving.sampling import nucleus_cdf

    dev = torch.device("cuda")
    rs = np.random.RandomState(0)
    seeds = np.concatenate([[0, 0x7FFFFFFF, 1, 7],
                            rs.randint(0, 2**31 - 1, 16_380)])
    pos = rs.randint(0, 1 << 20, len(seeds))
    got = counter_uniform(torch.from_numpy(seeds).to(dev),
                          torch.from_numpy(pos).to(dev)).cpu().numpy()
    want = counter_uniform_np(seeds, pos)
    n_diff = int((got.view(np.uint32) != want.view(np.uint32)).sum())
    check(n_diff == 0, f"counter_uniform: {n_diff} uniforms differ")
    B, V = 8, 151936
    # at V 151936 the kcum steps are ~1e-5 apart over a wide nucleus, so
    # the boundary filter drops up to about half the cases
    us = np.linspace(0.01, 0.99, 48).astype(np.float32)
    pairs = []
    for temperature, top_p in SAMPLE_PAIRS:
        logits = (rs.randn(B, V) * rs.uniform(0.5, 3.0, (B, 1))).astype(
            np.float32)
        cdfs = [nucleus_cdf(row, temperature, top_p) for row in logits]
        lg = torch.from_numpy(logits).to(dev)
        checked = filtered = 0
        for u in us:
            toks = sample_tokens(lg, torch.full((B,), float(u), device=dev),
                                 temperature, top_p).cpu().numpy()
            for i, (order, kcum, n_keep) in enumerate(cdfs):
                if np.min(np.abs(kcum - u)) < SAMPLE_BOUNDARY:
                    filtered += 1
                    continue
                # sample_ref's draw, from the row's cdf computed once
                host = int(order[min(int(np.sum(kcum <= u)), n_keep - 1)])
                check(int(toks[i]) == host,
                      f"sampler ({temperature}, {top_p}) row {i} u {u}: "
                      f"{int(toks[i])} vs {host}")
                checked += 1
        check(checked >= 100, f"only {checked} sampler cases checked")
        pairs.append({"temperature": temperature, "top_p": top_p,
                      "checked": checked, "filtered": filtered,
                      "nucleus_sizes": [c[2] for c in cdfs]})
    # one decode step's sampler at the engine's batch: the uniforms and
    # the draw, as DeviceState._sample runs them
    lg = torch.from_numpy((rs.randn(B, V) * 2).astype(np.float32)).to(dev)
    sd = torch.arange(B, dtype=torch.int32, device=dev)
    ln = torch.full((B,), 500, dtype=torch.int32, device=dev)
    s_ms = time_ms(lambda: sample_tokens(
        lg, counter_uniform(sd, ln + 1), FORK["temperature"], FORK["top_p"]),
        iters=20)
    u_ms = time_ms(lambda: counter_uniform(sd, ln + 1), iters=20)
    a_ms = time_ms(lambda: torch.argmax(lg, dim=-1), iters=20)
    # what one step's sampler launches, against the greedy argmax
    prof = {name: _profile_window(torch, fn) for name, fn in (
        ("sampled", lambda: sample_tokens(
            lg, counter_uniform(sd, ln + 1), FORK["temperature"],
            FORK["top_p"])),
        ("greedy", lambda: torch.argmax(lg, dim=-1).to(torch.int32)))}
    emit({"phase": "sampler_parity", "ok": True,
          "uniform_pairs": len(seeds), "uniform_bits_differ": n_diff,
          "logits": [B, V], "boundary": SAMPLE_BOUNDARY, "pairs": pairs,
          "sampler_ms": s_ms, "counter_uniform_ms": u_ms,
          "argmax_ms": a_ms,
          "launches_per_call": {k: v["kernel_launches"]
                                for k, v in prof.items()},
          "device_ms_per_call": {k: v["device_busy_s"] * 1e3
                                 for k, v in prof.items()},
          "profiled_wall_ms": {k: v["wall_s"] * 1e3
                               for k, v in prof.items()},
          "sampled_top": prof["sampled"]["top"][:5]})


def fork_prompts():
    import numpy as np

    rs = np.random.RandomState(14)
    p900, p333 = (list(rs.randint(1, 150_000, n)) for n in FORK_PROMPTS)
    replay = p900[:768] + list(rs.randint(1, 150_000, 40))
    return p900, p333, replay


def run_fork_engine(torch, model, params, impl=None, sampler_events=None):
    """Best-of-4 over the 900- and 333-token prompts; ``select_winner``
    on the 333 group once each of its branches has 4 tokens; after the
    900 group's primary finishes, a prompt of its first 768 tokens plus
    40 new ones (the prefix-cache replay)."""
    from repro_torch.serving import ServingEngine

    eng = ServingEngine(model, max_slots=8, max_seq=1024, policy="stamp-it",
                        prefix_cache_entries=16, params=params, impl=impl,
                        device=model.device, **FORK)
    if sampler_events is not None:
        inner = eng.dev._sample

        def timed(*a):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = inner(*a)
            e.record()
            sampler_events.append((s, e))
            return out

        eng.dev._sample = timed
    p900, p333, replay = fork_prompts()
    g900 = eng.fork_submit(p900, 4, max_new_tokens=32)
    g333 = eng.fork_submit(p333, 4, max_new_tokens=32)
    late = None
    events = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while eng.sched.has_work() or late is None:
        if g333.winner is None and all(
                r.generated and len(r.generated) >= 4
                for r in g333.branches):
            eng.select_winner(g333, 2)
        if late is None and g900.branches[0].done:
            late = eng.submit(replay, max_new_tokens=32)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        eng.step()
        e.record()
        events.append((s, e))
        check(eng.steps < 3000, "fork engine did not converge")
    eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return eng, (g900, g333, late), wall, [s.elapsed_time(e)
                                           for s, e in events]


def _fork_tokens(groups):
    g900, g333, late = groups
    return ([r.generated for r in g900.branches]
            + [r.generated for r in g333.branches] + [late.generated])


def phase_fork_engine(torch, model, params):
    """Sampled decoding and copy-on-write forks at full width: every page
    copy through the block-gather kernel, counted over the whole run."""
    from repro_torch.kernels.block_gather import block_gather_kernel
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.paged_attention import paged_attention_kernel

    # first run: warm-up and the reference for the determinism check
    _, first, _, _ = run_fork_engine(torch, model, params)
    kernels = (block_gather_kernel, paged_attention_kernel,
               flash_attention_kernel)
    _reset(kernels)
    sampler = []
    eng, groups, wall, step_ms = run_fork_engine(torch, model, params,
                                                 sampler_events=sampler)
    launches = {"block_gather": block_gather_kernel.launches,
                "paged_attention": paged_attention_kernel.launches,
                "flash_attention": flash_attention_kernel.launches}
    st = eng.stats()
    for _ in range(4):  # settle, as the CPU tests do
        eng.pool.reclaim()
    unreclaimed = eng.pool.unreclaimed()
    g900, g333, late = groups
    survivors = list(g900.branches) + [g333.branches[2], late]
    vocab = model.cfg.vocab_size
    check(all(r.done and len(r.generated) == 32 for r in survivors),
          "a surviving request did not end with 32 tokens")
    check(all(0 <= t < vocab for r in survivors for t in r.generated),
          "token out of vocabulary range")
    check(all(g333.branches[i].done and len(g333.branches[i].generated) < 32
              for i in (0, 1, 3)), "select_winner did not stop the losers")
    replays = st["admission_dispatches"] - st["cow_copies"]
    check(st["cow_copies"] == 6, f"cow_copies {st['cow_copies']}")
    check(st["fork_admissions"] == 6,
          f"fork_admissions {st['fork_admissions']}")
    check(st["forks_taken"] == st["forks_released"] > 0,
          f"forks {st['forks_taken']} taken, {st['forks_released']} "
          "released")
    check(replays == 1 and st["prefix_hits"] == 6,
          f"replay admissions {replays}, prefix hits {st['prefix_hits']}")
    events = eng.pool.ledger.events
    check(events.get("branch-kill") == 1, f"ledger events {events}")
    check(unreclaimed == 0, f"{unreclaimed} pages left unreclaimed")
    check(st["dispatches_per_step"] == 1, f"dispatches/step {st}")
    check(launches["block_gather"] == 2 * st["admission_dispatches"] > 0,
          f"block_gather launches {launches} vs admission dispatches "
          f"{st['admission_dispatches']}")
    check(launches["paged_attention"] == N_LAYERS * st["decode_dispatches"],
          f"paged launches {launches} vs {st['decode_dispatches']}")
    check(launches["flash_attention"] == N_LAYERS * st["prefill_chunks"],
          f"flash launches {launches} vs {st['prefill_chunks']}")
    for g in (g900, g333):
        toks = [r.generated for r in g.branches]
        check(len({t[0] for t in toks}) == 1,
              f"group {g.gid}: branches differ at token 1")
        check(len({tuple(t[:4]) for t in toks}) > 1,
              f"group {g.gid}: every branch drew the same tokens")
    tokens = _fork_tokens(groups)
    check(tokens == _fork_tokens(first),
          "a second run with the same sample_seed drew other tokens")
    torch.cuda.synchronize()
    sampler_ms = [s.elapsed_time(e) for s, e in sampler]
    # the same traffic through the plain attention and the plain gather
    _, pgroups, pwall, _ = run_fork_engine(torch, model, params,
                                           impl="plain")
    ptokens = _fork_tokens(pgroups)
    agree = sum(a == b for t, p in zip(tokens, ptokens)
                for a, b in zip(t, p))
    total = sum(min(len(t), len(p)) for t, p in zip(tokens, ptokens))
    emit({"phase": "fork_engine", "ok": True, **FORK,
          "groups": {"best_of_4_prompt_lens": list(FORK_PROMPTS),
                     "winner_of_333": 2,
                     "replay_prompt": "900-prompt[:768] + 40"},
          "wall_s": wall, "decode_tokens_per_s": st["tokens_emitted"] / wall,
          "median_step_ms": statistics.median(step_ms),
          "steps": st["steps"], "decode_dispatches": st["decode_dispatches"],
          "sampler_ms_median": statistics.median(sampler_ms),
          "sampler_share_of_step_time": sum(sampler_ms) / sum(step_ms),
          "launches": launches,
          "counters": {k: st[k] for k in (
              "cow_copies", "fork_admissions", "forks_taken",
              "forks_released", "admission_dispatches", "prefix_hits",
              "prefill_chunks", "dispatches_per_step", "pool_freed",
              "pool_unreclaimed", "free_pages", "host_us_per_step")},
          "unreclaimed_after_settle": unreclaimed,
          "ledger_events": dict(events),
          "first_tokens": {"g900": g900.branches[0].generated[0],
                           "g333": g333.branches[0].generated[0]},
          "plain_wall_s": pwall,
          "plain_token_agreement": agree / max(total, 1)})
    return launches


#: rounds of paired cold-L2 timings of the gather rows: kernel and
#: index_select in turns, then the reverse order; the median of each
GATHER_COLD_ROUNDS = 7


def block_gather_table_rows(torch, launches):
    """The gather at the fork and handoff runs' sizes, bf16: kernel,
    ``pool[idx]`` and ``index_select`` time (queued back to back, and
    each call on a cold L2) beside the bound (each gathered byte read
    once and written once, plus the index), and each row's error on its
    own inputs.  M 24 and 144 gather from the engine's pool; M 192 from
    a cluster replica's pool with the index ``read_pages`` builds for a
    handoff of 8 pages (the kernel is timed on its uploaded copy).

    The cold times come first, before any profiler window: kernel,
    ``index_select`` and the launch floor (an empty kernel from the
    gather's library at the plan's grid, ``cold_floor_ms``) in turns,
    then in the reverse order, ``GATHER_COLD_ROUNDS`` times, the median
    of each; ``pool[idx]`` once after them."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.block_gather import (block_gather_kernel,
                                                  block_gather_probe)

    saved = block_gather_kernel.launches
    rows = []
    for m, what in zip(GATHER_M, ("one CoW copy or migrated page (1 page "
                                  "x 24 layers)",
                                  "the replay (6 pages x 24 layers)",
                                  "a handoff read of the 900-token prompt "
                                  "(8 pages x 24 layers)")):
        if m == GATHER_M[-1]:
            pool = replica_pool(torch, torch.bfloat16, seed=5)
            host_idx = handoff_index(torch, m // N_LAYERS)
            idx = host_idx.to("cuda")
        else:
            pool, idx = gather_inputs(torch, torch.bfloat16, QWEN_POOL_PAGES,
                                      QWEN_PAGE, m, seed=5)
            host_idx = idx
        got = block_gather_kernel(pool, host_idx)
        want = ref.block_gather(pool, idx)
        torch.cuda.synchronize()
        err = max_err(got, want)
        check(torch.equal(got, want), f"block_gather row M={m} differs")
        plan = gather_plan(torch, pool, got)
        fns = {"kernel": lambda: block_gather_kernel(pool, idx),
               "plain": lambda: ref.block_gather(pool, idx),
               "library": lambda: torch.index_select(pool, 0, idx)}
        floor = {"floor": lambda: block_gather_probe(idx, plan["blocks"])}
        paired = {k: [] for k in ("kernel", "library", "floor")}
        for _ in range(GATHER_COLD_ROUNDS):
            for k in list(paired) + list(paired)[::-1]:
                paired[k].append(cold_ms({**fns, **floor}[k]))
        cold = {k: statistics.median(v) for k, v in paired.items()}
        cold["plain"] = cold_ms(fns["plain"])
        floor_ms = cold.pop("floor")
        k_ms, p_ms, l_ms = (time_ms(f) for f in fns.values())
        # at these sizes a call's host enqueue outlasts its device work,
        # so the event times above read the host; the profiler gives the
        # device time of each call's kernels (20 queued calls re-read
        # pages that stay in the 50 MB L2)
        dev_ms = {k: _profile_window(torch, lambda f=f: [
            f() for _ in range(20)])["device_busy_s"] * 1e3 / 20
            for k, f in fns.items()}
        # the host's enqueue alone: 1,000 calls with no synchronise, kernel
        # and index_select in turns, 7 rounds, the median of each
        rounds = {"kernel": [], "library": []}
        for _ in range(7):
            for k in rounds:
                rounds[k].append(host_us(fns[k]))
        host = {k: statistics.median(v) for k, v in rounds.items()}
        page_bytes = pool[0].numel() * pool.element_size()
        n_bytes = 2 * m * page_bytes + idx.numel() * 4
        b_ms, b_by = bound_ms(n_bytes, 0, "bfloat16")
        rows.append({"name": f"block_gather_m{m}", "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/block_gather.cu",
                     "replaces": "src/repro/kernels/block_gather.py:21",
                     "launches": launches["block_gather"],
                     "max_abs_err": err,
                     "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": l_ms,
                     "host_us": host["kernel"],
                     "library_host_us": host["library"],
                     "library_note": "torch.index_select on the same "
                                     "flattened pool (timed only)",
                     "shape": f"pool ({pool.shape[0]}, 128, 2, 64) M={m}: "
                              f"{what}",
                     "plan": plan, "bytes": n_bytes, "device_ms": dev_ms,
                     "cold_ms": cold, "cold_floor_ms": floor_ms,
                     "cold_rounds": {k: paired[k] for k in ("kernel",
                                                            "library")},
                     "cold_bound_share": b_ms / cold["kernel"],
                     "cold_vs_library": cold["kernel"] / cold["library"]})
        del pool
    block_gather_kernel.launches = saved
    return rows


# ---------------------------------------------------------------------------
# the SSM path: mamba2-2.7b prefill (SSD scan kernel) and greedy decode
# ---------------------------------------------------------------------------
# ---------------------------------------------------------------------------
# whole-prompt prefill, the speculative lane and the policy plane (qwen2)
# ---------------------------------------------------------------------------
#: whole-prompt prefill pads a prompt to a power of two of pages: at
#: max_seq 1024 these are the buckets the engine can run
PREFILL_BUCKETS = (128, 256, 512, 1024)
#: speculative lane: k draft tokens a step, drafted by the first half of
#: qwen2's layers
SPEC_K, SPEC_DRAFT = 4, N_LAYERS // 2
#: paged launches per speculative dispatch: k draft steps over the draft
#: layers, k + 1 verify steps over every layer
SPEC_PAGED_PER_DISPATCH = SPEC_K * SPEC_DRAFT + (SPEC_K + 1) * N_LAYERS
#: the exact speculative check runs qwen2-0.5b at full width in f32 over
#: this many layers
SPEC_F32_LAYERS = 4
#: the policy sweep's requests generate this many tokens each
SWEEP_NEW = 16
#: reclaim() calls a policy needs after drain() before it holds no page:
#: epoch frees a page two epoch advances after its retire; every other
#: policy holds none once drain() returns
GRACE_RECLAIMS = {"epoch": 2}


def phase_flash_prefill_parity(torch):
    """The flash kernel at the whole-prompt shapes (B 1, S_q = S_kv = a
    bucket, q_offset 0, causal, H 14/2, D 64) against its plain version."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.flash_attention import plan_splits as flash_plan

    errs, rows = {}, []
    for dname, S, qs in itertools.product(
            ("float32", "bfloat16"), PREFILL_BUCKETS, (1.0, PEAKED_Q)):
        if qs != 1.0 and S != PREFILL_BUCKETS[-1]:
            continue
        q, k, v = flash_inputs(torch, getattr(torch, dname), S, S_q=S,
                               q_scale=qs)
        got = flash_attention_kernel(q, k, v, causal=True, q_offset=0)
        want = ref.flash_attention(q, k, v, causal=True, q_offset=0)
        torch.cuda.synchronize()
        case = attention_errs(got, want, dname, f"whole-prompt flash {S}")
        plan = flash_plan(1, S, 14, S, q_offset=0, causal=True, head_dim=64)
        rows.append({"dtype": dname, "case": f"S_q=S_kv={S} q_offset=0 "
                     f"H=14 Hkv=2 D=64 q_scale={qs}",
                     "plan": {"warpgroups": plan.consumers,
                              "key_tile": plan.keys, "splits": plan.splits},
                     **case})
        key = ("flash_attention_whole_prompt", dname)
        errs[key] = max(case["max_abs_err"], errs.get(key, 0.0))
    emit({"phase": "flash_prefill_parity", "ok": True, "cases": rows})
    return errs


def phase_unchunked_engine(torch, model, params, base):
    """The engine phase's requests admitted by whole-prompt prefill
    (``chunk_tokens=0``): one flash launch a layer per admission."""
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.paged_attention import paged_attention_kernel

    run_engine(torch, model, params, chunk_tokens=0)  # warm-up
    _reset((paged_attention_kernel, flash_attention_kernel))
    eng, reqs, wall, step_ms = run_engine(torch, model, params,
                                          chunk_tokens=0)
    launches = {"paged_attention": paged_attention_kernel.launches,
                "flash_attention": flash_attention_kernel.launches}
    st = eng.stats()
    check(all(r.done and len(r.generated) == 32 for r in reqs),
          "not every request finished with 32 tokens")
    check(st["dispatches_per_step"] == 1, f"dispatches/step {st}")
    check(st["prefill_chunks"] == 0 and st["prefix_hits"] == 0,
          f"chunks {st['prefill_chunks']}, hits {st['prefix_hits']}")
    check(launches["flash_attention"] == N_LAYERS * st["admissions"]
          == N_LAYERS * st["admission_dispatches"] > 0,
          f"flash launches {launches} vs {st['admissions']} admissions, "
          f"{st['admission_dispatches']} admission dispatches")
    check(launches["paged_attention"] == N_LAYERS * st["decode_dispatches"],
          f"paged launches {launches} vs {st['decode_dispatches']}")
    check(set(st["prefill_jit_shapes"]) <= set(PREFILL_BUCKETS),
          f"prefill shapes {st['prefill_jit_shapes']}")
    check(st["pool_unreclaimed"] == 0, "pages left unreclaimed")
    _, preqs, pwall, _ = run_engine(torch, model, params, impl="plain",
                                    chunk_tokens=0)
    exact = _f32_exact(torch, "whole-prompt", chunk_tokens=0)
    first = sum(r.generated[0] == b.generated[0]
                for r, b in zip(reqs, base["reqs"])) / len(reqs)
    emit({"phase": "unchunked_engine", "ok": True, "chunk_tokens": 0,
          "wall_s": wall, "decode_tokens_per_s": st["tokens_emitted"] / wall,
          "median_step_ms": statistics.median(step_ms),
          "chunked_wall_s": base["wall_s"],
          "chunked_median_step_ms": base["median_step_ms"],
          "steps": st["steps"], "decode_dispatches": st["decode_dispatches"],
          "admissions": st["admissions"],
          "admission_dispatches": st["admission_dispatches"],
          "prefill_jit_shapes": st["prefill_jit_shapes"],
          "launches": launches,
          "chunked_token_agreement": _agreement(reqs, base["reqs"]),
          "chunked_first_token_agreement": first,
          "chunked_first_diffs": _first_diffs(reqs, base["reqs"]),
          "plain_token_agreement": _agreement(reqs, preqs),
          "f32_exact": exact,
          "plain_wall_s": pwall,
          "pool": {k: st[k] for k in ("free_pages", "pool_unreclaimed",
                                      "pool_freed", "scan_steps")}})
    return launches, st["admissions"]


def _f32_exact(torch, what, **kw):
    """qwen2-0.5b at full width in f32 over SPEC_F32_LAYERS layers: the
    engine with ``kw`` against the chunked, non-speculative engine, token
    for token (bf16 at full depth flips near-ties between any two
    computations; f32 holds them)."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import Model

    model = Model(ARCHS["qwen2-0.5b"].scaled(num_layers=SPEC_F32_LAYERS,
                                             dtype="float32"))
    params = conditioned(model, model.init_params(seed=0))
    toks = {}
    for name, args in (("base", {}), ("mode", kw)):
        eng, reqs, _, _ = run_engine(torch, model, params, **args)
        toks[name] = [r.generated for r in reqs]
    check(toks["mode"] == toks["base"],
          f"f32 {what} tokens differ from the chunked engine's")
    out = {"layers": SPEC_F32_LAYERS, "tokens": sum(map(len, toks["base"])),
           "identical": True}
    if kw.get("speculate_k"):
        out.update(draft_layers=eng.draft_layers,
                   spec_acceptance=eng.stats()["spec_acceptance"])
    del model, params, eng
    torch.cuda.empty_cache()
    return out


def phase_spec_engine(torch, model, params, base):
    """The engine phase's requests with the speculative lane (k 4, draft
    over the first 12 layers) in the same fused step."""
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.paged_attention import paged_attention_kernel

    run_engine(torch, model, params, speculate_k=SPEC_K)  # warm-up
    _reset((paged_attention_kernel, flash_attention_kernel))
    eng, reqs, wall, step_ms = run_engine(torch, model, params,
                                          speculate_k=SPEC_K)
    launches = {"paged_attention": paged_attention_kernel.launches,
                "flash_attention": flash_attention_kernel.launches}
    st = eng.stats()
    check(eng.draft_layers == SPEC_DRAFT, f"draft layers {eng.draft_layers}")
    check(all(r.done and len(r.generated) == 32 for r in reqs),
          "not every request finished with 32 tokens")
    check(st["dispatches_per_step"] == 1, f"dispatches/step {st}")
    check(launches["paged_attention"]
          == SPEC_PAGED_PER_DISPATCH * st["decode_dispatches"],
          f"paged launches {launches} vs {SPEC_PAGED_PER_DISPATCH} x "
          f"{st['decode_dispatches']}")
    check(launches["flash_attention"] == N_LAYERS * st["prefill_chunks"],
          f"flash launches {launches} vs {st['prefill_chunks']}")
    check(st["spec_drafted"] > 0, "no draft token was offered")
    check(st["pool_unreclaimed"] == 0, "pages left unreclaimed")
    exact = _f32_exact(torch, "speculative", speculate_k=SPEC_K)
    emit({"phase": "spec_engine", "ok": True, "speculate_k": SPEC_K,
          "draft_layers": SPEC_DRAFT,
          "spec_acceptance": st["spec_acceptance"],
          "spec_drafted": st["spec_drafted"],
          "spec_accepted": st["spec_accepted"],
          "tokens_per_dispatch": st["tokens_per_dispatch"],
          "wall_s": wall, "decode_tokens_per_s": st["tokens_emitted"] / wall,
          "median_step_ms": statistics.median(step_ms),
          "engine_wall_s": base["wall_s"],
          "engine_decode_tokens_per_s": base["tokens_per_s"],
          "engine_median_step_ms": base["median_step_ms"],
          "steps": st["steps"], "decode_dispatches": st["decode_dispatches"],
          "launches": launches,
          "paged_launches_per_dispatch": SPEC_PAGED_PER_DISPATCH,
          "engine_token_agreement_bf16": _agreement(reqs, base["reqs"]),
          "engine_first_diffs_bf16": _first_diffs(reqs, base["reqs"]),
          "f32_exact": exact})


def phase_spec_fork_engine(torch, model, params):
    """Greedy best-of-4 over the 900- and 333-token prompts with the
    speculative lane, under the serving bench's CoW policies."""
    from repro_torch.kernels.block_gather import block_gather_kernel
    from repro_torch.serving import ServingEngine

    p900, p333, _ = fork_prompts()
    out, tokens = {}, {}
    for policy in ("stamp-it", "lfrc"):
        _reset((block_gather_kernel,))
        eng = ServingEngine(model, max_slots=8, max_seq=1024, policy=policy,
                            prefix_cache_entries=16, params=params,
                            device=model.device, speculate_k=SPEC_K)
        groups = [eng.fork_submit(p, 4, max_new_tokens=32)
                  for p in (p900, p333)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run_until_done()
        eng.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = eng.stats()
        gathers = block_gather_kernel.launches
        toks = [[r.generated for r in g.branches] for g in groups]
        check(all(len(t) == 32 for g in toks for t in g),
              f"{policy}: a branch did not end with 32 tokens")
        check(all(g[0] == t for g in toks for t in g),
              f"{policy}: greedy branches of one prompt differ")
        check(gathers > 0 and st["cow_copies"] == 6
              and st["fork_admissions"] == 6,
              f"{policy}: gathers {gathers}, {st['cow_copies']} copies, "
              f"{st['fork_admissions']} fork admissions")
        check(st["forks_taken"] == st["forks_released"] > 0,
              f"{policy}: forks {st['forks_taken']} taken, "
              f"{st['forks_released']} released")
        check(eng.pool.unreclaimed() == 0,
              f"{policy}: {eng.pool.unreclaimed()} pages unreclaimed")
        check(st["dispatches_per_step"] == 1, f"dispatches/step {st}")
        tokens[policy] = toks
        out[policy] = {"wall_s": wall, "steps": st["steps"],
                       "block_gather_launches": gathers,
                       "spec_acceptance": st["spec_acceptance"],
                       **{k: st[k] for k in (
                           "cow_copies", "fork_admissions", "forks_taken",
                           "forks_released", "pool_freed",
                           "pool_unreclaimed", "scan_steps")}}
    check(tokens["stamp-it"] == tokens["lfrc"],
          "the policy changed the tokens")
    emit({"phase": "spec_fork_engine", "ok": True, "speculate_k": SPEC_K,
          "best_of_4_prompt_lens": list(FORK_PROMPTS), "policies": out})


def phase_policy_sweep(torch, model, params):
    """The engine phase's requests under each of the 13 policies: the
    tokens do not depend on the policy, and every page comes back."""
    from repro_torch.memory import POLICIES

    t_sweep = time.perf_counter()
    rows, tokens = {}, {}
    for policy in POLICIES:
        seen = []
        eng, reqs, wall, step_ms = run_engine(
            torch, model, params, max_new=SWEEP_NEW, policy=policy,
            unreclaimed=seen)
        st = eng.stats()
        for _ in range(GRACE_RECLAIMS.get(policy, 0)):
            eng.pool.reclaim()
        left = eng.pool.unreclaimed()
        check(all(r.done and len(r.generated) == SWEEP_NEW for r in reqs),
              f"{policy}: a request did not finish")
        check(left == 0, f"{policy}: {left} pages unreclaimed after grace")
        tokens[policy] = [r.generated for r in reqs]
        rows[policy] = {"wall_s": wall, "steps": st["steps"],
                        "median_step_ms": statistics.median(step_ms),
                        "pool_freed": st["pool_freed"],
                        "scan_steps": st["scan_steps"],
                        "unreclaimed_after_drain": st["pool_unreclaimed"],
                        "peak_unreclaimed": max(seen)}
    first = tokens["stamp-it"]
    differ = [p for p, t in tokens.items() if t != first]
    check(not differ, f"tokens differ from stamp-it's under {differ}")
    emit({"phase": "policy_sweep", "ok": True, "max_new_tokens": SWEEP_NEW,
          "policies": rows, "seconds": time.perf_counter() - t_sweep})


# ---------------------------------------------------------------------------
# the cluster plane (qwen2): replica groups, disaggregated prefill/decode
# with the mid-request K/V handoff, and the lifecycle plane
# ---------------------------------------------------------------------------
#: each replica's engine: 4 slots over max_seq 1024, chunks of 128
CLUSTER_SLOTS = 4
#: the exact checks run the three groups at full width in f32 over this
#: many layers, against one ServingEngine on the same requests
CLUSTER_F32_LAYERS = 4
#: the cross-replica hold stays open this many cluster steps
CLUSTER_HOLD_STEPS = 4
#: the lifecycle phase kills replica 1 at this cluster step
KILL_STEP = 8


def shared_model(model, params):
    """A ``Model`` like ``model`` whose ``init_params`` returns
    ``params``: a ``ReplicaGroup`` builds its replicas' one weight tree
    from it (``ReplicaGroup`` takes no params), here the conditioned
    tree the other qwen2 phases serve.  A tree already in the compute
    dtype comes back from ``compute_params`` as the same tensors."""
    from repro_torch.models import Model

    m = Model(model.cfg, device=model.device)
    m.init_params = lambda seed=0: params
    return m


def pool_bytes(eng) -> int:
    layers = eng.dev.cache["layers"]
    return sum(layers[k].numel() * layers[k].element_size()
               for k in ("k_pool", "v_pool"))


def _leaf_ptrs(params):
    from repro_torch.cluster.group import _leaves

    return [t.data_ptr() for t in _leaves(params)]


def _group_engines_stats(group):
    per = group.stats()["per_replica"]
    return {k: [s[k] for s in per] for k in (
        "steps", "decode_dispatches", "prefill_chunks", "tokens_emitted",
        "handoffs_out", "handoffs_in", "pool_freed", "pool_unreclaimed",
        "scan_steps", "prefix_hits")}


def _group_kernels() -> dict:
    """The three kernels a replica group's path runs, by name."""
    from repro_torch.kernels.block_gather import block_gather_kernel
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.paged_attention import paged_attention_kernel

    return {"paged_attention": paged_attention_kernel,
            "flash_attention": flash_attention_kernel,
            "block_gather": block_gather_kernel}


def _launches(kernels) -> dict:
    return {name: k.launches for name, k in kernels.items()}


def _check_group_launches(group, launches, layers=N_LAYERS):
    """Every decode dispatch ran ``layers`` paged launches and every
    prefill chunk ``layers`` flash launches (24, qwen2-0.5b's, unless
    told), summed over the live and dead replicas."""
    per = group.stats()["per_replica"]
    dispatches = sum(s["decode_dispatches"] for s in per)
    chunks = sum(s["prefill_chunks"] for s in per)
    check(launches["paged_attention"] == layers * dispatches,
          f"paged launches {launches} vs {dispatches} dispatches")
    check(launches["flash_attention"] == layers * chunks,
          f"flash launches {launches} vs {chunks} chunks")
    check(all(s["dispatches_per_step"] <= 1 for s in per),
          "a replica ran more than one dispatch a step")


def cluster_run(torch, model, params, max_new=32):
    """The 8 requests through ``ReplicaGroup(n_replicas=2,
    router="least-loaded")``: a checkpoint mid-run, a cross-replica hold
    open for CLUSTER_HOLD_STEPS cluster steps (opened once a request is
    two tokens from its end, so retires land under it), then
    ``migrate_prefix`` of the shared 128-token prefix to the replica
    that does not hold it: the pages before and after, the page reads
    and the gather launches of the move."""
    from repro_torch.cluster import ReplicaGroup, migrate_prefix
    from repro_torch.kernels.block_gather import block_gather_kernel
    from repro_torch.memory.prefix_cache import block_key

    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    group = ReplicaGroup(shared_model(model, params), n_replicas=2,
                         router="least-loaded", max_slots=CLUSTER_SLOTS,
                         max_seq=1024, prefix_cache_entries=16)
    torch.cuda.synchronize()
    out = {"memory_growth_bytes": torch.cuda.memory_allocated() - mem0,
           "replica_pool_bytes": [pool_bytes(e) for e in group.engines]}
    # every replica reads the caller's tensors: no cast, no copy
    ptrs = [_leaf_ptrs(e.dev.params) for e in group.engines]
    out["shared_weights"] = ptrs[0] == ptrs[1] == _leaf_ptrs(params)
    reqs = [group.submit(p, max_new_tokens=max_new) for p in prompts()]
    held, hold, hold_steps = [], None, 0
    t0 = time.perf_counter()
    while group.has_work():
        group.step()
        if group.steps == 3:
            out["checkpoint_leaves"] = group.checkpoint()
        if hold is None and not held and any(
                not r.done and len(r.generated or ()) >= max_new - 2
                for r in reqs):
            hold = group.hold("smoke-hold")
        elif hold is not None:
            hold_steps += 1
            group.reclaim()
            held.append([e.pool.unreclaimed() for e in group.engines])
            if hold_steps == CLUSTER_HOLD_STEPS:
                hold.release()
                hold = None
        check(group.steps < 3000, "cluster did not converge")
    torch.cuda.synchronize()
    out["wall_s"] = time.perf_counter() - t0
    group.reclaim()
    out["held_unreclaimed"] = held
    out["released_unreclaimed"] = group.shards.unreclaimed()
    # the shared 128-token prefix: from a replica that caches it to one
    # that does not (evicted there first when both prefilled it)
    shared = prompts()[0][:128]
    key = block_key(shared)
    have = [e.prefix_cache.get(key) is not None for e in group.engines]
    check(any(have), "no replica cached the shared prefix")
    src = have.index(True)
    dst = 1 - src
    if have[dst]:
        group.engines[dst].evict_prefix([key])
        group.reclaim()
    e = group.engines[src].prefix_cache.get(key)
    before = [group.engines[src].dev.cache["layers"][n][:, e.slot, e.page]
              .clone() for n in ("k_pool", "v_pool")]
    reads0 = group.engines[src].dev.migration_dispatches
    gathers0 = block_gather_kernel.launches
    report = migrate_prefix(group, shared, src, dst)
    out["migration"] = dict(report, src=src, dst=dst,
                            evicted_at_dst_first=have[dst])
    out["migration_reads"] = (group.engines[src].dev.migration_dispatches
                              - reads0)
    out["migration_gathers"] = block_gather_kernel.launches - gathers0
    e = group.engines[dst].prefix_cache.get(key)
    check(e is not None, "the migrated prefix is not cached at dst")
    after = [group.engines[dst].dev.cache["layers"][n][:, e.slot, e.page]
             for n in ("k_pool", "v_pool")]
    out["bit_identical"] = all(torch.equal(a, b)
                               for a, b in zip(before, after))
    group.drain()
    out["unreclaimed_after_drain"] = [en.pool.unreclaimed()
                                      for en in group.engines]
    out["reqs"] = reqs
    out["tokens"] = [list(r.generated) for r in reqs]
    out["done"] = all(r.done for r in reqs)
    return group, out


def phase_cluster_engine(torch, model, params, base, f32):
    """Two replicas on the card over one shared weight tree: tokens,
    launches, holds, a checkpoint and a prefix migration."""
    from repro_torch.cluster.group import _leaves

    t_phase = time.perf_counter()
    kernels = _group_kernels()
    weight_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    _reset(kernels.values())
    group, out = cluster_run(torch, model, params)
    launches = _launches(kernels)
    _check_group_launches(group, launches)
    check(out["done"] and all(len(t) == 32 for t in out["tokens"]),
          "not every request finished with 32 tokens")
    check(out["shared_weights"], "the replicas hold separate weights")
    grow, pools = out["memory_growth_bytes"], sum(out["replica_pool_bytes"])
    # a replica's pools (plus its step state, a few MB), never a second
    # weight tree
    check(pools <= grow <= pools + (64 << 20) and grow < weight_bytes / 2,
          f"group memory grew by {grow} bytes: pools {pools}, weights "
          f"{weight_bytes}")
    check(out["held_unreclaimed"]
          and max(sum(u) for u in out["held_unreclaimed"]) > 0,
          f"nothing pinned under the hold: {out['held_unreclaimed']}")
    check(out["released_unreclaimed"] == 0,
          f"{out['released_unreclaimed']} pages after the hold released")
    rep = out["migration"]
    check(rep["exported"] == rep["imported"] == rep["evicted"] == 1,
          f"migration report {rep}")
    check(rep["src_unreclaimed_during_hold"] >= 1,
          "the evicted source page was not held during the migration")
    check(out["bit_identical"], "migrated pages differ from the source's")
    check(out["migration_gathers"] == 2 * out["migration_reads"] > 0,
          f"{out['migration_gathers']} gathers for "
          f"{out['migration_reads']} page reads")
    check(out["unreclaimed_after_drain"] == [0, 0],
          f"unreclaimed after drain {out['unreclaimed_after_drain']}")
    st = group.stats()
    exact = _cluster_f32_exact(f32, "cluster", lambda m, p: cluster_run(
        torch, m, p)[1]["tokens"])
    emit({"phase": "cluster_engine", "ok": True, "replicas": 2,
          "router": "least-loaded", "max_slots": CLUSTER_SLOTS,
          "wall_s": out["wall_s"],
          "decode_tokens_per_s": sum(map(len, out["tokens"]))
          / out["wall_s"],
          "cluster_steps": st["cluster_steps"],
          "engine_steps": st["engine_steps"],
          "scan_steps_per_step": st["scan_steps_per_step"],
          "launches": launches,
          "memory_growth_bytes": grow, "replica_pool_bytes":
              out["replica_pool_bytes"], "weight_bytes": weight_bytes,
          "checkpoint_leaves": out["checkpoint_leaves"],
          "held_unreclaimed": out["held_unreclaimed"],
          "migration": rep, "migration_reads": out["migration_reads"],
          "migration_gathers": out["migration_gathers"],
          "per_replica": _group_engines_stats(group),
          "engine_token_agreement_bf16": _agreement(out["reqs"],
                                                    base["reqs"]),
          "f32_exact": exact,
          "seconds": time.perf_counter() - t_phase})
    return launches["block_gather"]


def cluster_f32_baseline(torch) -> dict:
    """qwen2-0.5b at full width in f32 over CLUSTER_F32_LAYERS layers and
    one ServingEngine's greedy tokens on the 8 requests: what the three
    cluster phases' f32 runs are held to."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import Model

    model = Model(ARCHS["qwen2-0.5b"].scaled(num_layers=CLUSTER_F32_LAYERS,
                                             dtype="float32"))
    params = conditioned(model, model.init_params(seed=0))
    _, reqs, _, _ = run_engine(torch, model, params)
    return {"model": model, "params": params,
            "tokens": [r.generated for r in reqs]}


def _cluster_f32_exact(f32, what, run):
    """``run(model, params)``'s tokens on the f32 baseline's model against
    its one engine's, token for token."""
    got = run(f32["model"], f32["params"])
    check(got == f32["tokens"], f"f32 {what} tokens differ from one "
                                "engine's")
    return {"layers": CLUSTER_F32_LAYERS,
            "tokens": sum(map(len, f32["tokens"])), "identical": True}


def watch_page_moves(torch, group, moved):
    """Hold every page move of ``group``'s replicas against their pools,
    bit for bit, by plain indexing: a read's payload against ``pool[:,
    slot, pages]`` before the export frees the pages, and after a write
    the destination's pages against the payload.  ``moved`` counts the
    reads and writes checked."""
    def watch(dev):
        read, write = dev.read_pages, dev.write_pages

        def held(slot, pages, k, v, what):
            for name, host in (("k_pool", k), ("v_pool", v)):
                pool = dev.cache["layers"][name][:, slot, list(pages)]
                check(torch.equal(pool, host.to(pool.device)),
                      f"{what} of slot {slot} pages {list(pages)}: "
                      f"{name} differs")
            moved[what] += 1

        def read_pages(slot, pages):
            k, v = read(slot, pages)
            held(slot, pages, k, v, "reads")
            return k, v

        def write_pages(slot, pages, k, v):
            write(slot, pages, k, v)
            held(slot, pages, k, v, "writes")

        dev.read_pages, dev.write_pages = read_pages, write_pages

    for e in group.engines:
        watch(e.dev)


def disagg_run(torch, model, params, max_new=32):
    """The 8 requests through one prefill and two decode replicas
    (``disagg_bench.py``'s shape) with ``handoff_import_delay=2``; per
    cluster step with a packet in flight, the source's unreclaimed pages
    (after a reclaim) beside the pages of its packets not yet
    committed; every handoff's payload is held against the source's and
    the destination's pages (``watch_page_moves``)."""
    from repro_torch.cluster import ReplicaGroup

    group = ReplicaGroup(shared_model(model, params), prefill_replicas=1,
                         decode_replicas=2, router="least-loaded",
                         max_slots=CLUSTER_SLOTS, max_seq=1024,
                         handoff_import_delay=2)
    moved = {"reads": 0, "writes": 0}
    watch_page_moves(torch, group, moved)
    src = group.tiers.prefill_ids[0]
    reqs = [group.submit(p, max_new_tokens=max_new) for p in prompts()]
    window = []
    t0 = time.perf_counter()
    while group.has_work():
        group.step()
        if group.tiers.pending():
            group.engines[src].pool.reclaim()
            window.append((group.engines[src].pool.unreclaimed(),
                           sum(p.data["n_pages"]
                               for p in group.tiers.packets)))
        check(group.steps < 3000, "tiered group did not converge")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    group.engines[src].pool.reclaim()
    after_commit = group.engines[src].pool.unreclaimed()
    group.drain()
    return group, reqs, {"wall_s": wall, "window": window,
                         "after_commit": after_commit, "moved": moved,
                         "reqs": reqs,
                         "tokens": [list(r.generated) for r in reqs]}


def phase_disagg_engine(torch, model, params, base, f32):
    """Disaggregated prefill/decode on the card: every request hands its
    whole-prompt K/V from the prefill replica to a decode replica
    through the host (``read_pages`` on the block-gather kernel)."""
    from repro_torch.obs import chrome_trace, validate_chrome_trace

    t_phase = time.perf_counter()
    kernels = _group_kernels()
    _reset(kernels.values())
    group, reqs, out = disagg_run(torch, model, params)
    launches = _launches(kernels)
    _check_group_launches(group, launches)
    st = group.stats()
    per, ts = st["per_replica"], st["tiers"]
    need = sum(1 for r in reqs if r.max_new_tokens > 1)
    check(all(r.done and len(r.generated) == 32 for r in reqs),
          "not every request finished with 32 tokens")
    outs = [s["handoffs_out"] for s in per]
    ins = [s["handoffs_in"] for s in per]
    check(outs[0] == sum(ins) == ts["handoffs_completed"] == need
          and sum(outs[1:]) == 0 and ins[0] == 0,
          f"handoffs out {outs}, in {ins}, tiers {ts}")
    emitted = [s["tokens_emitted"] for s in per]
    check(emitted[0] == need
          and sum(emitted[1:]) == sum(len(r.generated) - 1 for r in reqs),
          f"tokens emitted per replica {emitted}")
    reads = group.engines[0].dev.migration_dispatches
    writes = sum(e.dev.migration_dispatches for e in group.engines[1:])
    check(reads == writes == need, f"{reads} reads, {writes} writes")
    check(out["moved"] == {"reads": reads, "writes": writes},
          f"page moves held against the pools {out['moved']}, "
          f"{reads} reads, {writes} writes")
    check(launches["block_gather"] == 2 * reads,
          f"{launches['block_gather']} gathers for {reads} reads")
    check(all(u >= p for u, p in out["window"]) and out["window"],
          f"exported pages reclaimed before commit: {out['window']}")
    check(out["after_commit"] == 0,
          f"{out['after_commit']} pages after the last commit")
    check(group.shards.unreclaimed() == 0, "pages left after drain")
    trace = chrome_trace(group.spans, registry=group.obs)
    n_events = validate_chrome_trace(trace)
    check({e["tid"] for e in trace["traceEvents"]}
          == {r._span_rid for r in reqs}, "a request lacks its trace row")
    exact = _cluster_f32_exact(f32, "disaggregated", lambda m, p: (
        disagg_run(torch, m, p)[2]["tokens"]))
    emit({"phase": "disagg_engine", "ok": True, "prefill_replicas": 1,
          "decode_replicas": 2, "import_delay": 2,
          "wall_s": out["wall_s"],
          "decode_tokens_per_s": sum(map(len, out["tokens"]))
          / out["wall_s"],
          "cluster_steps": st["cluster_steps"], "launches": launches,
          "tiers": {k: ts[k] for k in (
              "handoffs_started", "handoffs_completed", "handoffs_aborted",
              "import_retries", "pages_handed_off", "hold_ticks_total",
              "mean_hold_ticks")},
          "page_move_buckets": sorted(set().union(
              *(e.dev.page_move_buckets for e in group.engines))),
          "held_window_max": max(u for u, _ in out["window"]),
          "page_moves_bit_exact": out["moved"],
          "per_replica": _group_engines_stats(group),
          "trace_events": n_events,
          "engine_token_agreement_bf16": _agreement(out["reqs"],
                                                    base["reqs"]),
          "f32_exact": exact,
          "seconds": time.perf_counter() - t_phase})
    return launches["block_gather"]


def lifecycle_run(torch, model, params, max_new=32, *, probe=False):
    """The 8 requests round-robin over 3 replicas under
    ``LifecycleManager(heartbeat_timeout=3)``; replica 1 opens a
    checkpoint hold at cluster step 5 and is killed at step KILL_STEP.
    ``probe`` measures the card memory the husk's pools give back."""
    from repro_torch.cluster import LifecycleManager, ReplicaGroup

    group = ReplicaGroup(shared_model(model, params), 3,
                         router="round-robin", max_slots=CLUSTER_SLOTS,
                         max_seq=1024)
    mgr = LifecycleManager(group, heartbeat_timeout=3)
    reqs = [group.submit(p, max_new_tokens=max_new) for p in prompts()]
    husk = pool_bytes(group.engines[1])
    out = {"husk_pool_bytes": husk}
    t0 = time.perf_counter()
    while group.has_work():
        if group.steps == 5:
            group.hold("checkpoint", owner=1)
        if group.steps == KILL_STEP:
            out["victim_had_work"] = group.engines[1].sched.has_work()
            group.kill_replica(1)
        dying = probe and group.engines[1].crashed and not mgr.dead
        if dying:
            torch.cuda.synchronize()
            m0 = torch.cuda.memory_allocated()
        group.step()
        if dying and mgr.dead:
            torch.cuda.synchronize()
            out["freed_at_death_bytes"] = m0 - torch.cuda.memory_allocated()
        check(group.steps < 3000, "lifecycle run did not converge")
    torch.cuda.synchronize()
    out["wall_s"] = time.perf_counter() - t0
    group.drain()
    out["unreclaimed_after_drain"] = group.shards.unreclaimed()
    out["reqs"] = reqs
    out["tokens"] = [list(r.generated) for r in reqs]
    out["done"] = all(r.done for r in reqs)
    return group, mgr, out


def watchdog_run(torch, model, params, max_new=8):
    """A checkpoint writer on replica 0 wedges inside its hold while the
    replica keeps beating: ``LifecycleManager(hold_deadline=6)`` (its
    ``HoldWatchdog``) expires the hold."""
    from repro_torch.cluster import LifecycleManager, ReplicaGroup

    group = ReplicaGroup(shared_model(model, params), 2,
                         router="round-robin", max_slots=CLUSTER_SLOTS,
                         max_seq=1024)
    mgr = LifecycleManager(group, heartbeat_timeout=3, hold_deadline=6)
    reqs = [group.submit(p, max_new_tokens=max_new) for p in prompts()]
    hold = group.hold("wedged-writer", owner=0)
    while group.has_work() or not hold.released:
        group.step()
        check(group.steps < 3000, "watchdog run did not converge")
    group.drain()
    return {"forced": hold.forced, "dead": sorted(mgr.dead),
            "watchdog": mgr.watchdog.stats(),
            "done": all(r.done for r in reqs),
            "unreclaimed_after_drain": group.shards.unreclaimed(),
            "cluster_steps": group.steps}


def phase_lifecycle_engine(torch, model, params, base, f32):
    """Three replicas; one dies mid-run owning a cluster hold: missed
    heartbeats declare it dead, its holds force-expire, its pools go back
    to the card and its journal replays its requests on the survivors."""
    t_phase = time.perf_counter()
    kernels = _group_kernels()
    _reset(kernels.values())
    group, mgr, out = lifecycle_run(torch, model, params, probe=True)
    launches = _launches(kernels)
    _check_group_launches(group, launches)
    lc = mgr.stats()
    check(out["victim_had_work"], "the kill interrupted no work")
    check(out["done"] and all(len(t) == 32 for t in out["tokens"]),
          "not every request finished with 32 tokens")
    check(lc["dead"] == [1] and lc["holds_force_expired"] >= 1,
          f"lifecycle {lc}")
    check(lc["replays_finished"] == lc["replays_submitted"] > 0,
          f"replays {lc}")
    check(group.engines[1].dev.cache is None, "the husk kept its pools")
    freed, husk = out.get("freed_at_death_bytes", 0), out["husk_pool_bytes"]
    check(freed >= husk * 0.95,
          f"the death freed {freed} bytes, the husk's pools are {husk}")
    check(out["unreclaimed_after_drain"] == 0,
          f"{out['unreclaimed_after_drain']} pages after drain")
    t_wd = time.perf_counter()
    wd = watchdog_run(torch, model, params)
    check(wd["forced"] and wd["dead"] == []
          and wd["watchdog"]["hold_expired_by_watchdog"] == 1,
          f"watchdog {wd}")
    check(wd["done"] and wd["unreclaimed_after_drain"] == 0,
          f"watchdog run {wd}")
    wd["seconds"] = time.perf_counter() - t_wd
    def replayed_tokens(m, p):
        _, mgr32, out32 = lifecycle_run(torch, m, p)
        check(mgr32.replays_finished == mgr32.replays_submitted > 0,
              f"the f32 run replayed nothing: {mgr32.stats()}")
        return out32["tokens"]

    exact = _cluster_f32_exact(f32, "lifecycle (replayed)",
                               replayed_tokens)
    emit({"phase": "lifecycle_engine", "ok": True, "replicas": 3,
          "heartbeat_timeout": 3, "kill_step": KILL_STEP,
          "wall_s": out["wall_s"], "cluster_steps": group.steps,
          "launches": launches,
          "lifecycle": {k: lc[k] for k in (
              "dead", "deaths", "holds_force_expired", "domains_expired",
              "replays_submitted", "replays_finished", "replays_recovered",
              "reclamation_blocked_steps")},
          "husk_pool_bytes": husk, "freed_at_death_bytes": freed,
          "per_replica": _group_engines_stats(group),
          "watchdog": wd,
          "engine_token_agreement_bf16": _agreement(out["reqs"],
                                                    base["reqs"]),
          "f32_exact": exact,
          "seconds": time.perf_counter() - t_phase})
    return launches["block_gather"]


def whole_prompt_flash_row(torch, launches, admissions, errs):
    """The flash kernel at the whole-prompt bucket S 1024 (B 1, causal,
    q_offset 0), bf16: kernel, plain and SDPA beside the bound."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.flash_attention import plan_splits as flash_plan

    saved = flash_attention_kernel.launches
    bf, elt, H, Hkv, D = torch.bfloat16, 2, 14, 2, 64
    S = PREFILL_BUCKETS[-1]
    q, k, v = flash_inputs(torch, bf, S, S_q=S)
    kfn = (lambda: flash_attention_kernel(q, k, v, causal=True, q_offset=0))
    k_ms = time_ms(kfn)
    p_ms = time_ms(lambda: ref.flash_attention(q, k, v, causal=True,
                                               q_offset=0), iters=10)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lfn = (lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True))
    l_ms = time_ms(lfn)
    keys = S * (S + 1) // 2
    n_bytes = 2 * q.numel() * elt + 2 * k.numel() * elt
    flops = 4 * H * D * keys
    b_ms, b_by = bound_ms(n_bytes, flops, "bfloat16")
    plan = flash_plan(1, S, H, S, q_offset=0, causal=True, head_dim=D)
    row = {"name": "flash_attention_whole_prompt", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
           "replaces": "src/repro/kernels/flash_attention.py:85",
           "launches": launches["flash_attention"],
           "launches_per_admission":
               launches["flash_attention"] // admissions,
           "max_abs_err": errs["flash_attention_whole_prompt", "bfloat16"],
           "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": l_ms, **device_timings(torch, kfn, lfn),
           "library_note": "scaled_dot_product_attention, is_causal=True, "
                           "enable_gqa=True (timed only)",
           "shape": f"B=1 S_q=S_kv={S} q_offset=0 H={H} Hkv={Hkv} D={D} "
                    f"warpgroups={plan.consumers} key_tile={plan.keys} "
                    f"splits={plan.splits}"}
    flash_attention_kernel.launches = saved
    return row


def ssd_inputs(torch, dtype, B, S, H, P, N, seed=2, steep=False):
    """Scan operands as ``mamba_full`` makes them: x, B and C in the
    activation dtype, dt = softplus(...) and a = -exp(...) in f32.
    ``steep``: dt ~ 3 and |a| ~ 7, so cum falls by ~20 a row and the decay
    above the diagonal overflows to inf (the kernel must select it away)."""
    dev = torch.device("cuda")
    shift, a_shift = (3.0, 2.0) if steep else (-1.0, 0.0)
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((B, S, H, P), generator=g, device=dev) * 0.3
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=g, device=dev) + shift)
    a = -torch.exp(torch.randn((H,), generator=g, device=dev) * 0.3
                   + a_shift)
    b = torch.randn((B, S, 1, N), generator=g, device=dev) * 0.3
    c = torch.randn((B, S, 1, N), generator=g, device=dev) * 0.3
    d = torch.randn((H,), generator=g, device=dev)
    return x.to(dtype), dt, a, b.to(dtype), c.to(dtype), d


def phase_ssd_parity(torch):
    """The SSD kernel against the plain scan (``ssd_cases``: y to the
    dtype's tolerance, the state to f32's): the prefill shape in f32 and
    bf16, one short chunk (S = 127), chunks of 127 over two sequences (a
    tile that read the next sequence's rows would show), B 1, steep
    decay, and a smoke shape (P 32, N 16) whose head count is not a
    multiple of 8."""
    full = SSD_SHAPE
    cases = [dict(full), dict(full, S=127, chunk=127),
             dict(full, B=2, S=254, chunk=127), dict(full, B=1),
             dict(full, B=2, S=256, steep=True),
             dict(B=2, S=256, H=6, P=32, N=16, chunk=128)]
    rows, errs = ssd_cases(torch, cases, full, "ssd_scan")
    emit({"phase": "ssd_parity", "ok": True, "cases": rows})
    return errs


def ssd_cases(torch, cases, full, err_name):
    """Each case in f32 and bf16, y held to the dtype's tolerance times
    its largest magnitude and the final state to the f32 tolerance times
    its own; the errors of case ``full`` are returned under
    ``err_name``."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_chunk_scan_kernel

    rows, errs = [], {}
    for case in cases:
        for dname in ("float32", "bfloat16"):
            dtype = getattr(torch, dname)
            chunk = case["chunk"]
            shape = {k: v for k, v in case.items() if k != "chunk"}
            x, dt, a, b, c, d = ssd_inputs(torch, dtype, **shape)
            got = ssd_chunk_scan_kernel(x, dt, a, b, c, chunk=chunk,
                                        d_skip=d)
            want = ref.ssd_chunk_scan(x, dt, a, b, c, chunk=chunk, d_skip=d)
            torch.cuda.synchronize()
            row = {"kernel": "ssd_scan", "dtype": dname,
                   "case": " ".join(f"{k}={v}" for k, v in case.items()),
                   "tol_rel": KERNEL_TOL[dname]}
            # the state is f32 on both routes: the bf16 kernel carries it
            # in f32 and takes xu as two bf16 operands (~16 bits)
            row["state_tol_rel"] = KERNEL_TOL["float32"]
            for name, g_, w_, tol in (
                    ("y", got[0], want[0], KERNEL_TOL[dname]),
                    ("state", got[1], want[1], KERNEL_TOL["float32"])):
                check(bool(torch.isfinite(g_).all()), f"ssd {name} not finite")
                e, scale = max_err(g_, w_), float(w_.float().abs().max())
                row[f"{name}_max_abs_err"], row[f"{name}_max_abs"] = e, scale
                check(e <= tol * scale,
                      f"ssd {dname} {case} {name}: err {e} at scale {scale}")
            rows.append(row)
            if case == full:
                errs[err_name, dname] = row["y_max_abs_err"]
    return rows, errs


def ssm_prompts(vocab: int):
    import numpy as np

    rs = np.random.RandomState(1)
    return rs.randint(1, vocab, (SSM_BATCH, SSM_SEQ)).astype(np.int32)


def load_decode_cache(torch, model, pcache, batch: int):
    """The prefill cache (final state, bf16 conv tails) cast into the
    decode cache's f32 layout."""
    from repro_torch.configs import ShapeConfig

    cache = model.init_cache(ShapeConfig("serve", "decode", SSM_SEQ, batch))
    for k, dst in cache["layers"].items():
        dst.copy_(pcache[k])
    return cache


def rel_err(a, b) -> dict:
    scale = float(b.float().abs().max())
    e = max_err(a, b)
    return {"max_abs_err": e, "max_abs": scale, "rel": e / max(scale, 1e-30)}


def phase_ssm_layers(torch, model, params, tokens):
    """Layer by layer at full width, bf16: at every layer the kernel and
    the plain scan get the SAME input (the plain path's hidden state), so
    a difference is that layer's alone.  The block output is held to 4
    bf16 ulps of its largest magnitude, the layer's final state (f32 in
    both) to the f32 kernel tolerance of its largest magnitude."""
    from repro_torch.models import layers as L
    from repro_torch.models import ssm as S
    from repro_torch.models import transformer as T

    cfg = model.cfg
    h = L.embed_tokens(params["embed"], tokens, cfg)
    worst = {"out": (0.0, 1.0, -1), "state": (0.0, 1.0, -1)}
    for i in range(cfg.num_layers):
        lp = T._layer(params["layers"], i)
        m_in = L.apply_norm(lp["norm"], h, cfg)
        got, got_c = S.mamba_full(lp["mamba"], m_in, cfg)
        want, want_c = S.mamba_full(lp["mamba"], m_in, cfg, impl="plain")
        for name, a, b, tol in (
                ("out", got, want, None),
                ("state", got_c["state"], want_c["state"],
                 KERNEL_TOL["float32"])):
            e, scale = max_err(a, b), float(b.float().abs().max())
            limit = 4 * bf16_ulp(scale) if tol is None else tol * scale
            check(e <= limit, f"layer {i} {name}: err {e} at scale {scale}")
            if e / scale >= worst[name][0] / worst[name][1]:
                worst[name] = (e, scale, i)
        h = h + want
        del got, got_c, want, want_c
    torch.cuda.synchronize()
    emit({"phase": "ssm_layers", "ok": True, "arch": cfg.name,
          "batch": SSM_BATCH, "seq": SSM_SEQ,
          "tol": {"out": "4 bf16 ulps of max|out|",
                  "state": f"{KERNEL_TOL['float32']} of max|state|"},
          "worst": {k: {"max_abs_err": v[0], "max_abs": v[1], "layer": v[2]}
                    for k, v in worst.items()}})


def _logit_err(a, b) -> dict:
    out = rel_err(a, b)
    out["argmax_agree"] = float((a.argmax(-1) == b.argmax(-1)).float().mean())
    return out


def _prefill_pair(torch, model, params, tokens):
    """Prefill logits and every layer's final state, kernel vs plain;
    also returns the plain logits."""
    logits_k, cache_k = model.prefill(params, {"tokens": tokens})
    logits_p, cache_p = model.prefill(params, {"tokens": tokens},
                                      impl="plain")
    torch.cuda.synchronize()
    check(bool(torch.isfinite(logits_k).all()), "non-finite prefill logits")
    states = [rel_err(cache_k["state"][i], cache_p["state"][i])["rel"]
              for i in range(model.cfg.num_layers)]
    return _logit_err(logits_k, logits_p), states, logits_p


def _teacher_forcing(torch, model, params, tokens, n=127):
    """Prefill of ``n`` tokens plus one decode step against a prefill of
    ``n + 1`` tokens, on the last logits."""
    _, pc = model.prefill(params, {"tokens": tokens[:, :n]})
    cache = load_decode_cache(torch, model, pc, tokens.shape[0])
    del pc
    got, _ = model.decode_step(params, cache, {"tokens": tokens[:, n:n + 1]})
    want, _ = model.prefill(params, {"tokens": tokens[:, :n + 1]})
    torch.cuda.synchronize()
    return _logit_err(got, want)


def phase_ssm_model(torch, model, params, model32, params32, tokens):
    """Full-width prefill through the kernel against the plain scan, and
    teacher forcing (prefill 127 + one decode step against prefill 128).
    Held in f32 compute, where both scans are exact to ~1e-6 and what
    remains is the model's amplification of that; in bf16 compute (the
    serving dtype) reported: each layer may round y one bf16 ulp apart
    and 64 layers amplify it (phase ssm_layers holds each layer); the
    plain bf16 model against the plain f32 model gives the size of bf16's
    own rounding at this depth, for scale."""
    logit32, states32, plain32 = _prefill_pair(torch, model32, params32,
                                               tokens)
    check(logit32["rel"] <= SSM_F32_REL_TOL, f"f32 logits {logit32}")
    check(max(states32) <= SSM_F32_REL_TOL,
          f"f32 state rel {max(states32)}")
    tf32 = _teacher_forcing(torch, model32, params32, tokens)
    check(tf32["rel"] <= SSM_F32_REL_TOL, f"f32 teacher forcing {tf32}")
    logit16, states16, plain16 = _prefill_pair(torch, model, params,
                                               tokens)
    bf16_vs_f32 = _logit_err(plain16, plain32)
    tf16 = _teacher_forcing(torch, model, params, tokens)
    emit({"phase": "ssm_model", "ok": True, "arch": model.cfg.name,
          "batch": SSM_BATCH, "seq": SSM_SEQ, "tol_rel_f32": SSM_F32_REL_TOL,
          "f32": {"prefill_logits": logit32,
                  "state_rel_worst_layer": max(states32),
                  "teacher_forcing_127_plus_1": tf32},
          "bf16_reported": {"prefill_logits": logit16,
                            "state_rel_by_layer": states16,
                            "teacher_forcing_127_plus_1": tf16,
                            "plain_bf16_vs_plain_f32": bf16_vs_f32}})


def greedy_decode(torch, model, params, logits, cache, batch, steps,
                  impl=None):
    """``steps`` greedy decode steps from ``logits``; ``batch`` holds the
    inputs besides the tokens ("lengths" advance by one a step).  Checks
    that the last logits are finite and every token lies in the
    vocabulary; returns the tokens (B, steps + 1), each step's CUDA-event
    ms and the loop's wall seconds.  ``impl="plain"`` decodes through the
    plain versions."""
    batch = dict(batch)
    nxt = logits.argmax(-1).to(torch.int32)
    generated, events = [nxt], []
    t0 = time.perf_counter()
    for _ in range(steps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        logits, cache = model.decode_step(params, cache,
                                          dict(batch, tokens=nxt[:, None]),
                                          impl=impl)
        nxt = logits.argmax(-1).to(torch.int32)
        if "lengths" in batch:
            batch["lengths"] = batch["lengths"] + 1
        e.record()
        events.append((s, e))
        generated.append(nxt)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(bool(torch.isfinite(logits).all()), "non-finite decode logits")
    toks = torch.stack(generated, 1)
    check(toks.shape == (logits.shape[0], steps + 1), f"tokens {toks.shape}")
    check(bool(((toks >= 0) & (toks < model.cfg.vocab_size)).all()),
          "token out of vocabulary range")
    return toks, [s.elapsed_time(e) for s, e in events], wall


def phase_ssm_generate(torch, model, params, tokens):
    """The main SSM path with the launch counts set to 0: one prefill of
    the 8 prompts, the decode cache loaded, 32 greedy decode steps."""
    from repro_torch.kernels.decode_attention import decode_attention_kernel
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.paged_attention import paged_attention_kernel
    from repro_torch.kernels.ssd_scan import ssd_chunk_scan_kernel

    kernels = {"ssd_scan": ssd_chunk_scan_kernel,
               "paged_attention": paged_attention_kernel,
               "flash_attention": flash_attention_kernel,
               "decode_attention": decode_attention_kernel}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset(kernels.values())
    t0 = time.perf_counter()
    logits, pc = model.prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    cache = load_decode_cache(torch, model, pc, SSM_BATCH)
    del pc
    toks, step_ms, decode_s = greedy_decode(torch, model, params, logits,
                                            cache, {}, SSM_STEPS)
    launches = {n: k.launches for n, k in kernels.items()}
    check(launches == {"ssd_scan": SSM_LAYERS, "paged_attention": 0,
                       "flash_attention": 0, "decode_attention": 0},
          f"launches {launches}: want {SSM_LAYERS} SSD scans per prefill")
    emit({"phase": "ssm_generate", "ok": True, "arch": model.cfg.name,
          "batch": SSM_BATCH, "prompt_tokens": SSM_SEQ,
          "decode_steps": SSM_STEPS, "launches": launches,
          "prefill_ms": prefill_ms,
          "median_decode_step_ms": statistics.median(step_ms),
          "decode_tokens_per_s": SSM_BATCH * SSM_STEPS / decode_s,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "first_tokens": toks[:, :4].tolist()})
    return launches


def ssd_plan_fields(torch, B, H, P, N) -> dict:
    """The bf16 SSD kernel's launch plan at a shape, as the built library
    reports it (``ssd_scan.bf16_plan``): blocks, threads, ring stages,
    shared memory, and the compiled kernel's registers and local memory."""
    from repro_torch.kernels.ssd_scan import bf16_plan

    plan = bf16_plan(B, H, P, N, torch.cuda.current_device())
    check(0 < plan["threads"] <= plan["max_threads"],
          f"SSD plan {plan}: a block takes more threads than the kernel")
    return plan


def ssd_table_row(torch, launches, errs, name="ssd_scan", sh=SSD_SHAPE):
    """The SSD kernel at a prefill shape, bf16: kernel and plain time
    beside the bound, the kernel's device and cold-L2 times and its
    launch plan."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_chunk_scan_kernel

    saved = ssd_chunk_scan_kernel.launches
    B, S, H, P, N, L = (sh[k] for k in ("B", "S", "H", "P", "N", "chunk"))
    x, dt, a, b, c, d = ssd_inputs(torch, torch.bfloat16, B, S, H, P, N)

    def kfn():
        return ssd_chunk_scan_kernel(x, dt, a, b, c, chunk=L, d_skip=d)

    k_ms = time_ms(kfn, iters=20)
    p_ms = time_ms(lambda: ref.ssd_chunk_scan(x, dt, a, b, c, chunk=L,
                                              d_skip=d), iters=5, warmup=2)
    timings = device_timings(torch, kfn)
    plan = ssd_plan_fields(torch, B, H, P, N)
    ssd_chunk_scan_kernel.launches = saved
    # each input read once, each output written once: x and y (bf16), dt
    # (f32), B and C (bf16), a and d (f32), the final state (f32)
    n_bytes = (2 * x.numel() * 2 + dt.numel() * 4 + 2 * b.numel() * 2
               + 2 * H * 4 + B * H * P * N * 4)
    # causal pairs j <= i of each chunk; scores C.B once (shared by the
    # heads), the intra product, the chunk states and the inter term
    n_chunks, pairs = S // L, L * (L + 1) // 2
    flops = 2 * B * n_chunks * (pairs * N + H * pairs * P
                                + 2 * H * L * P * N)
    b_ms, b_by = bound_ms(n_bytes, flops, "bfloat16")
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:83",
            "launches": launches["ssd_scan"],
            "max_abs_err": errs[name, "bfloat16"],
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None, **timings,
            "library_note": "no single PyTorch call computes the SSD scan",
            "shape": " ".join(f"{k}={v}" for k, v in sh.items()),
            "plan": plan, "bytes": n_bytes, "flops": flops}


# ---------------------------------------------------------------------------
# the encoder-decoder path: seamless-m4t-medium prefill and greedy decode
# ---------------------------------------------------------------------------
def phase_decode_parity(torch):
    """The contiguous decode kernel against the plain version: seamless's
    cross-attention shape (B 8, S_max 4096, 16 heads over 16 kv heads of
    64) with lengths from 0 (uniform weights over all S_max rows) to
    S_max, a GQA group of 7 (H 14, Hkv 2), D 32 and 128, D 112 (the run-
    time-D form), and q scaled up for a peaked softmax."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention_kernel

    lengths = [0, 1, 127, 128, 1000, 1024, 4095, 4096]
    cases = [dict(H=16, Hkv=16, D=64), dict(H=14, Hkv=2, D=64),
             dict(H=16, Hkv=16, D=32), dict(H=16, Hkv=16, D=128),
             dict(H=16, Hkv=16, D=112), dict(H=16, Hkv=16, D=64,
                                             q_scale=PEAKED_Q)]
    rows, errs = [], {}
    for case in cases:
        for dname in ("float32", "bfloat16"):
            q, k, v, lens = decode_inputs(torch, getattr(torch, dname),
                                          lengths, **case)
            got = decode_attention_kernel(q, k, v, lens)
            want = ref.decode_attention(q, k, v, lens)
            torch.cuda.synchronize()
            name = "B=8 S_max=4096 " + " ".join(f"{n}={x}"
                                                for n, x in case.items())
            rows.append({"kernel": "decode_attention", "dtype": dname,
                         "case": name, "lengths": lengths,
                         **attention_errs(got, want, dname,
                                          f"decode {name}")})
            if case is cases[0]:
                errs["decode_attention", dname] = rows[-1]["max_abs_err"]
    emit({"phase": "decode_parity", "ok": True, "cases": rows})
    return errs


def phase_per_slot_parity(torch):
    """The paged kernel with per-slot (local) page ids against the plain
    version: phase kernel_parity's paged shape with a different
    permutation of each slot's pages in each row, and seamless's
    self-attention pool (3 pages of 128 per slot, 16 kv heads of 64),
    also at a tile's split edges (63 / 64 / 65, 129) and the full sweep,
    with q scaled up for a peaked softmax."""
    seamless = dict(n_pool=3, mb=3, H=16, Hkv=16, D=64)
    edges = [0, 1, 63, 64, 65, 127, 129, 384]  # a tile's split edges
    cases = [
        (dict(n_pool=16, mb=9, H=14, Hkv=2, D=64), 8,
         [1001, 645, 129, 388, 901, 261, 0, 1], 1.0),
        (seamless, 3, [160, 129, 145, 1, 0, 128, 256, 300], 1.0),
        (seamless, 3, edges, 1.0), (seamless, 3, edges, PEAKED_Q),
    ]
    rows, errs = [], {}
    for shape, n_kv, lengths, qs in cases:
        for dname in ("float32", "bfloat16"):
            rows.append(per_slot_case(torch, dname, shape, n_kv, lengths,
                                      q_scale=qs))
            if shape is seamless:
                errs["paged_attention_per_slot", dname] = max(
                    rows[-1]["max_abs_err"],
                    errs.get(("paged_attention_per_slot", dname), 0.0))
    emit({"phase": "per_slot_parity", "ok": True, "cases": rows})
    return errs


def per_slot_case(torch, dname, shape, n_kv, lengths, q_scale=1.0):
    """The paged kernel with per-slot page ids against the plain version:
    a different permutation of each slot's pages in each row."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import paged_attention_kernel

    q, kp, vp, _, lens = paged_inputs(torch, getattr(torch, dname), lengths,
                                      q_scale=q_scale, **shape)
    table = local_table(torch, len(lengths), shape["n_pool"], shape["mb"])
    got = paged_attention_kernel(q, kp, vp, table, lens, n_kv=n_kv,
                                 global_pages=False)
    want = ref.paged_attention(q, kp, vp, table, lens, n_kv=n_kv,
                               global_pages=False)
    torch.cuda.synchronize()
    name = (f"B={len(lengths)} " + " ".join(f"{n}={x}"
                                            for n, x in shape.items())
            + f" n_kv={n_kv} q_scale={q_scale}")
    case = attention_errs(got, want, dname, f"per-slot {name}")
    return {"kernel": "paged_attention (per-slot pages)", "dtype": dname,
            "case": name, "lengths": lengths,
            "plan": paged_plan_fields(len(lengths), shape["Hkv"], n_kv,
                                      lengths), **case}


def phase_flash_noncausal_parity(torch):
    """The flash kernel without the causal mask: the encoder's
    self-attention (S_q = S_kv = 1024) and the decoder prefill's
    cross-attention (S_q 128 over S_kv 1024), 16 heads of 64, B 2, each
    also with q scaled up for a peaked softmax."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_kernel

    rows, errs = [], {}
    for (S_q, S_kv), qs in itertools.product(((1024, 1024), (128, 1024)),
                                             (1.0, PEAKED_Q)):
        for dname in ("float32", "bfloat16"):
            q, k, v = flash_inputs(torch, getattr(torch, dname), S_kv,
                                   S_q=S_q, H=16, Hkv=16, D=64, B=2,
                                   q_scale=qs)
            got = flash_attention_kernel(q, k, v, causal=False)
            want = ref.flash_attention(q, k, v, causal=False)
            torch.cuda.synchronize()
            case = attention_errs(got, want, dname, f"flash non-causal "
                                                    f"{S_q}x{S_kv} q x{qs}")
            rows.append({"kernel": "flash_attention (non-causal)",
                         "dtype": dname, "case": f"B=2 S_q={S_q} "
                         f"S_kv={S_kv} H=16 Hkv=16 D=64 q_scale={qs}",
                         **case})
            if S_q == S_kv:
                errs["flash_encoder", dname] = max(
                    case["max_abs_err"],
                    errs.get(("flash_encoder", dname), 0.0))
    emit({"phase": "flash_noncausal_parity", "ok": True, "cases": rows})
    return errs


def encdec_inputs(torch, model, seed=4):
    """8 utterances of ED_FRAMES frame embeddings (seeded normal x 0.02,
    as the JAX package's ``Model.synthetic_batch`` makes them; the audio
    frontend is a stub in both packages) and ED_PROMPT decoder tokens."""
    import numpy as np

    cfg = model.cfg
    rs = np.random.RandomState(seed)
    enc = (rs.standard_normal((ED_BATCH, ED_FRAMES, cfg.d_model))
           * 0.02).astype(np.float32)
    toks = rs.randint(1, cfg.vocab_size, (ED_BATCH, ED_PROMPT))
    return (torch.from_numpy(enc).to(model.device),
            torch.from_numpy(toks.astype(np.int32)).to(model.device))


def load_encdec_cache(torch, model, pcache, table):
    """The encoder-decoder's prefill cache in its decode cache: each row's
    self-attention K/V page by page into the per-slot pages its
    block-table row names (the last page zero-padded), the encoder
    output's K/V into the first rows of the (L, B, 4096, Hkv, D) cross
    cache, and ``enc_len`` set to the encoder length."""
    from repro_torch.configs import ShapeConfig

    B = table.shape[0]
    cache = model.init_cache(ShapeConfig("serve", "decode", ED_MAX_SEQ, B))
    pages = table.tolist()
    S = pcache["self_k"].shape[2]
    for j in range(-(-S // 128)):
        for name, pool in (("self_k", "k_pool"), ("self_v", "v_pool")):
            seg = pcache[name][:, :, j * 128:(j + 1) * 128]
            for b in range(B):
                cache["self"][pool][:, b, pages[b][j], :seg.shape[2]] = \
                    seg[:, b]
    n_enc = pcache["cross_k"].shape[2]
    cache["cross_k"][:, :, :n_enc] = pcache["cross_k"]
    cache["cross_v"][:, :, :n_enc] = pcache["cross_v"]
    cache["enc_len"].fill_(n_enc)
    return cache


def phase_encdec_layers(torch, model, params, enc, toks, table):
    """Layer by layer at full width, bf16: at every layer each attention
    runs through the kernels and through the plain versions on the SAME
    input (the plain path's hidden state), so a difference is that
    layer's alone — the encoder's non-causal self-attention, the decoder
    prefill's causal self-attention and cross-attention (flash kernel),
    and one decode step's per-slot paged self-attention and cross-
    attention over the cross cache (decode kernel).  Held to 4 bf16 ulps
    of the output's largest magnitude."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    cfg = model.cfg
    worst = {}

    def hold(kind, i, outs):
        e = max_err(outs[0], outs[1])
        scale = float(outs[1].float().abs().max())
        check(e <= 4 * bf16_ulp(scale),
              f"{kind} layer {i}: err {e} at scale {scale}")
        w = worst.get(kind, (0.0, 1.0, -1))
        if e / scale >= w[0] / w[1]:
            worst[kind] = (e, scale, i)

    impls = (None, "plain")
    h = enc.to(getattr(torch, cfg.dtype))
    for i in range(cfg.encoder_layers):
        lp = T._layer(params["enc_layers"], i)
        a_in = L.apply_norm(lp["norm1"], h, cfg)
        outs = [L.attention_full(lp["attn"], a_in, cfg, causal=False,
                                 impl=impl)[0] for impl in impls]
        hold("encoder", i, outs)
        h = h + outs[1]
        h = h + L.apply_mlp(lp["mlp"], L.apply_norm(lp["norm2"], h, cfg),
                            cfg)
    enc_out = L.apply_norm(params["enc_norm"], h, cfg)
    x = L.embed_tokens(params["embed"], toks, cfg)
    kvs = {"self_k": [], "self_v": [], "cross_k": [], "cross_v": []}
    for i in range(cfg.num_layers):
        lp = T._layer(params["dec_layers"], i)
        a_in = L.apply_norm(lp["norm1"], x, cfg)
        res = [L.attention_full(lp["self_attn"], a_in, cfg, causal=True,
                                impl=impl) for impl in impls]
        hold("decoder_self", i, [r[0] for r in res])
        x = x + res[1][0]
        kvs["self_k"].append(res[1][1][0])
        kvs["self_v"].append(res[1][1][1])
        x_in = L.apply_norm(lp["norm_x"], x, cfg)
        res = [L.attention_full(lp["cross_attn"], x_in, cfg, causal=False,
                                kv_x=enc_out, impl=impl) for impl in impls]
        hold("decoder_cross", i, [r[0] for r in res])
        x = x + res[1][0]
        kvs["cross_k"].append(res[1][1][0])
        kvs["cross_v"].append(res[1][1][1])
        x = x + L.apply_mlp(lp["mlp"], L.apply_norm(lp["norm2"], x, cfg),
                            cfg)
    cache = load_encdec_cache(torch, model,
                              {k: torch.stack(v) for k, v in kvs.items()},
                              table)
    del kvs
    lengths = torch.full((ED_BATCH,), ED_PROMPT, dtype=torch.int32,
                         device=model.device)
    x = L.embed_tokens(params["embed"], toks[:, -1:], cfg)
    for i in range(cfg.num_layers):
        lp = T._layer(params["dec_layers"], i)
        a_in = L.apply_norm(lp["norm1"], x, cfg)
        # both write the same new K/V row before attending
        outs = [L.attention_decode(lp["self_attn"], a_in, cfg,
                                   T._layer(cache["self"], i), lengths,
                                   block_table=table, impl=impl)[0]
                for impl in impls]
        hold("decode_self_paged", i, outs)
        x = x + outs[1]
        x_in = L.apply_norm(lp["norm_x"], x, cfg)
        cross = {"k": cache["cross_k"][i], "v": cache["cross_v"][i],
                 "len": cache["enc_len"]}
        outs = [L.attention_decode(lp["cross_attn"], x_in, cfg, cross,
                                   lengths, cross=True, impl=impl)[0]
                for impl in impls]
        hold("decode_cross", i, outs)
        x = x + outs[1]
        x = x + L.apply_mlp(lp["mlp"], L.apply_norm(lp["norm2"], x, cfg),
                            cfg)
    torch.cuda.synchronize()
    emit({"phase": "encdec_layers", "ok": True, "arch": cfg.name,
          "batch": ED_BATCH, "frames": ED_FRAMES, "prompt": ED_PROMPT,
          "tol": "4 bf16 ulps of max|out|",
          "worst": {k: {"max_abs_err": v[0], "max_abs": v[1], "layer": v[2]}
                    for k, v in worst.items()}})


def _encdec_prefill_pair(torch, model, params, enc, toks):
    """Prefill logits and the four caches, kernels vs plain; also returns
    the plain logits."""
    batch = {"enc_embeds": enc, "tokens": toks}
    logits_k, cache_k = model.prefill(params, batch)
    logits_p, cache_p = model.prefill(params, batch, impl="plain")
    torch.cuda.synchronize()
    check(bool(torch.isfinite(logits_k).all()), "non-finite prefill logits")
    caches = {k: rel_err(cache_k[k], cache_p[k]) for k in cache_p}
    return _logit_err(logits_k, logits_p), caches, logits_p


def _encdec_teacher_forcing(torch, model, params, enc, toks, table, n=127):
    """Prefill of ``n`` decoder tokens plus one decode step of token n
    against a prefill of ``n + 1`` tokens, on the last logits."""
    _, pc = model.prefill(params, {"enc_embeds": enc, "tokens": toks[:, :n]})
    cache = load_encdec_cache(torch, model, pc, table)
    del pc
    got, _ = model.decode_step(params, cache, {
        "tokens": toks[:, n:n + 1], "block_table": table,
        "lengths": torch.full((toks.shape[0],), n, dtype=torch.int32,
                              device=toks.device)})
    want, _ = model.prefill(params, {"enc_embeds": enc,
                                     "tokens": toks[:, :n + 1]})
    torch.cuda.synchronize()
    return _logit_err(got, want)


def phase_encdec_model(torch, model, params, model32, params32, enc, toks,
                       table):
    """Full-width prefill through the kernels against the plain versions
    (logits and all four caches), and teacher forcing (prefill 127 + one
    decode step against prefill 128).  Held in f32 compute; reported in
    bf16 compute, beside the plain bf16 model against the plain f32
    model for scale."""
    logit32, caches32, plain32 = _encdec_prefill_pair(torch, model32,
                                                      params32, enc, toks)
    check(logit32["rel"] <= ED_F32_REL_TOL, f"f32 logits {logit32}")
    for k, e in caches32.items():
        check(e["rel"] <= ED_F32_REL_TOL, f"f32 cache {k} {e}")
    tf32 = _encdec_teacher_forcing(torch, model32, params32, enc, toks,
                                   table)
    check(tf32["rel"] <= ED_F32_REL_TOL, f"f32 teacher forcing {tf32}")
    logit16, caches16, plain16 = _encdec_prefill_pair(torch, model, params,
                                                      enc, toks)
    bf16_vs_f32 = _logit_err(plain16, plain32)
    tf16 = _encdec_teacher_forcing(torch, model, params, enc, toks, table)
    emit({"phase": "encdec_model", "ok": True, "arch": model.cfg.name,
          "batch": ED_BATCH, "frames": ED_FRAMES, "prompt": ED_PROMPT,
          "tol_rel_f32": ED_F32_REL_TOL,
          "f32": {"prefill_logits": logit32, "caches": caches32,
                  "teacher_forcing_127_plus_1": tf32},
          "bf16_reported": {"prefill_logits": logit16, "caches": caches16,
                            "teacher_forcing_127_plus_1": tf16,
                            "plain_bf16_vs_plain_f32": bf16_vs_f32}})


def phase_encdec_generate(torch, model, params, enc, toks, table):
    """The main encoder-decoder path with the launch counts set to 0: one
    prefill (encoder over the frames, decoder over the prompts), the
    decode cache loaded, ED_STEPS greedy decode steps with per-slot page
    ids (``decode_step``'s default).  The prompts fill exactly one page,
    so the first step writes the second page."""
    from repro_torch.kernels.decode_attention import decode_attention_kernel
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.paged_attention import paged_attention_kernel
    from repro_torch.kernels.ssd_scan import ssd_chunk_scan_kernel

    kernels = {"flash_attention": flash_attention_kernel,
               "decode_attention": decode_attention_kernel,
               "paged_attention": paged_attention_kernel,
               "ssd_scan": ssd_chunk_scan_kernel}
    L = model.cfg.num_layers
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset(kernels.values())
    t0 = time.perf_counter()
    logits, pc = model.prefill(params, {"enc_embeds": enc, "tokens": toks})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    at_prefill = {n: k.launches for n, k in kernels.items()}
    check(at_prefill == {"flash_attention": model.cfg.encoder_layers + 2 * L,
                         "decode_attention": 0, "paged_attention": 0,
                         "ssd_scan": 0},
          f"prefill launches {at_prefill}")
    cache = load_encdec_cache(torch, model, pc, table)
    del pc
    lengths = torch.full((ED_BATCH,), ED_PROMPT, dtype=torch.int32,
                         device=model.device)
    toks, step_ms, decode_s = greedy_decode(
        torch, model, params, logits, cache,
        {"lengths": lengths, "block_table": table}, ED_STEPS)
    launches = {n: k.launches for n, k in kernels.items()}
    want = dict(at_prefill, decode_attention=L * ED_STEPS,
                paged_attention=L * ED_STEPS)
    check(launches == want, f"launches {launches}, want {want}")
    combines = {
        "flash_attention": flash_attention_kernel.combine_launches,
        "decode_attention": decode_attention_kernel.combine_launches,
        "paged_attention": paged_attention_kernel.combine_launches}
    # the self pool's 3 pages a slot are 6 splits: every paged call combines
    check(combines["paged_attention"] == launches["paged_attention"],
          f"paged combines {combines} vs launches {launches}")
    emit({"phase": "encdec_generate", "ok": True, "arch": model.cfg.name,
          "batch": ED_BATCH, "frames": ED_FRAMES,
          "prompt_tokens": ED_PROMPT, "decode_steps": ED_STEPS,
          "launches": launches, "combine_launches": combines,
          "prefill_ms": prefill_ms,
          "median_decode_step_ms": statistics.median(step_ms),
          "decode_tokens_per_s": ED_BATCH * ED_STEPS / decode_s,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "first_tokens": toks[:, :4].tolist()})
    return launches


def encdec_table_rows(torch, launches, errs):
    """The three kernels of the encoder-decoder path at its shapes, bf16:
    kernel, plain and library time beside the bound."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention_kernel
    from repro_torch.kernels.decode_attention import plan_splits as decode_plan
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.flash_attention import plan_splits as flash_plan
    from repro_torch.kernels.paged_attention import paged_attention_kernel

    saved = (decode_attention_kernel.launches,
             paged_attention_kernel.launches,
             flash_attention_kernel.launches)
    bf, elt = torch.bfloat16, 2
    H, Hkv, D = 16, 16, 64
    rows = []

    # cross-attention decode: enc_len ED_FRAMES in every row of the
    # (B, 4096, Hkv, D) cross cache
    lengths = [ED_FRAMES] * ED_BATCH
    q, k, v, lens = decode_inputs(torch, bf, lengths)
    def kfn():
        return decode_attention_kernel(q, k, v, lens)

    k_ms = time_ms(kfn)
    p_ms = time_ms(lambda: ref.decode_attention(q, k, v, lens), iters=20)
    S_max = k.shape[1]
    mask = (torch.arange(S_max, device=q.device)[None, :]
            < lens[:, None])[:, None, None, :]
    qt, kt, vt = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)
    def lfn():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              enable_gqa=True)

    l_ms = time_ms(lfn)
    plan = decode_plan(ED_BATCH, Hkv, S_max)
    n_rows = sum(lengths)
    n_bytes = (2 * q.numel() * elt + n_rows * Hkv * D * 2 * elt
               + lens.numel() * 4)
    b_ms, b_by = bound_ms(n_bytes, 4 * H * D * n_rows, "bfloat16")
    rows.append({"name": "decode_attention", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
                 "replaces": "src/repro/kernels/paged_attention.py:74",
                 "launches": launches["decode_attention"],
                 "max_abs_err": errs["decode_attention", "bfloat16"],
                 "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                 "bound_by": b_by, "library_ms": l_ms,
                 **device_timings(torch, kfn, lfn),
                 "library_note": "scaled_dot_product_attention, boolean "
                                 "length mask over S_max, enable_gqa=True "
                                 "(timed only)",
                 "shape": f"B={ED_BATCH} S_max={S_max} lengths={ED_FRAMES} "
                          f"H={H} Hkv={Hkv} D={D} splits={plan.splits} of "
                          f"{plan.block * plan.tiles_per_split} rows",
                 "bytes": n_bytes})

    # per-slot paged self-attention at the last decode step: 3 pages of
    # 128 per slot, ED_PROMPT + ED_STEPS positions in every row
    lengths = [ED_PROMPT + ED_STEPS] * ED_BATCH
    q, kp, vp, _, lens = paged_inputs(torch, bf, lengths, n_pool=3, mb=3,
                                      H=H, Hkv=Hkv, D=D)
    table = local_table(torch, ED_BATCH, 3, 3)
    def pfn():
        return paged_attention_kernel(q, kp, vp, table, lens)

    k_ms = time_ms(pfn)
    p_ms = time_ms(lambda: ref.paged_attention(q, kp, vp, table, lens))
    n_rows = sum(lengths)
    n_bytes = (2 * q.numel() * elt + n_rows * Hkv * D * 2 * elt
               + table.numel() * 4 + lens.numel() * 4)
    b_ms, b_by = bound_ms(n_bytes, 4 * H * D * n_rows, "bfloat16")
    rows.append({"name": "paged_attention_per_slot", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
                 "replaces": "src/repro/kernels/paged_attention.py:128 "
                             "(global_pages=False, :171-177)",
                 "launches": launches["paged_attention"],
                 "max_abs_err": errs["paged_attention_per_slot", "bfloat16"],
                 "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                 "bound_by": b_by, "library_ms": None,
                 **device_timings(torch, pfn),
                 "plan": paged_plan_fields(ED_BATCH, Hkv, 3, lengths),
                 "library_note": "no single PyTorch call attends over pages "
                                 "named by a block table",
                 "shape": f"B={ED_BATCH} n_pool=3 lengths="
                          f"{ED_PROMPT + ED_STEPS} H={H} Hkv={Hkv} D={D}",
                 "bytes": n_bytes})

    # the encoder's self-attention: non-causal, ED_FRAMES x ED_FRAMES
    S = ED_FRAMES
    q, k, v = flash_inputs(torch, bf, S, S_q=S, H=H, Hkv=Hkv, D=D,
                           B=ED_BATCH)
    def kfn():
        return flash_attention_kernel(q, k, v, causal=False)

    k_ms = time_ms(kfn, iters=10, warmup=2)
    p_ms = time_ms(lambda: ref.flash_attention(q, k, v, causal=False),
                   iters=10, warmup=2)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    def lfn():
        return F.scaled_dot_product_attention(qt, kt, vt)

    l_ms = time_ms(lfn, iters=10, warmup=2)
    # the f32 route (the CUDA-core body kept for the f32 checks), beside
    # the plain version and SDPA in f32: PERF.md's table gives every
    # kernel row its plain and library times
    q32, k32, v32 = (x.float() for x in (q, k, v))
    f32 = {"f32_ms": time_ms(lambda: flash_attention_kernel(
               q32, k32, v32, causal=False), iters=3, warmup=1),
           "f32_plain_ms": time_ms(lambda: ref.flash_attention(
               q32, k32, v32, causal=False), iters=3, warmup=1),
           "f32_library_ms": time_ms(lambda: F.scaled_dot_product_attention(
               *(x.transpose(1, 2) for x in (q32, k32, v32))),
               iters=3, warmup=1)}
    del q32, k32, v32
    plan = flash_plan(ED_BATCH, S, H, S, causal=False, head_dim=D)
    n_bytes = 4 * q.numel() * elt
    flops = 4 * ED_BATCH * H * S * S * D
    b_ms, b_by = bound_ms(n_bytes, flops, "bfloat16")
    rows.append({"name": "flash_attention_encoder", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
                 "replaces": "src/repro/kernels/flash_attention.py:85",
                 "launches": launches["flash_attention"],
                 "max_abs_err": errs["flash_encoder", "bfloat16"],
                 "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                 "bound_by": b_by, "library_ms": l_ms,
                 **device_timings(torch, kfn, lfn, n=10), **f32,
                 "library_note": "scaled_dot_product_attention, no mask "
                                 "(timed only)",
                 "shape": f"B={ED_BATCH} S_q=S_kv={S} non-causal H={H} "
                          f"Hkv={Hkv} D={D} warpgroups={plan.consumers} "
                          f"key_tile={plan.keys} splits={plan.splits}",
                 "flops": flops})
    (decode_attention_kernel.launches, paged_attention_kernel.launches,
     flash_attention_kernel.launches) = saved
    return rows


# ---------------------------------------------------------------------------
# the hybrid path: zamba2-7b prefill (SSD scan and flash at head dim 112)
# and greedy decode (per-slot paged attention over the shared block's pools)
# ---------------------------------------------------------------------------
def phase_flash_anyd_parity(torch):
    """The flash kernel's run-time-D form (head dims outside 32/64/128)
    against the plain version: D 112 (zamba2), 96 (phi3) and 80, in f32
    and bf16, a causal chunk at a q_offset (split key ranges), non-causal
    attention (split), and zamba2's prefill shape (B 8, 1024 tokens, 32
    heads, unsplit), each also with q scaled up for a peaked softmax."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.flash_attention import plan_splits as flash_plan

    shapes = [dict(B=1, S_q=128, S_kv=1024, H=14, Hkv=2, causal=True,
                   off=768),
              dict(B=2, S_q=128, S_kv=1024, H=16, Hkv=16, causal=False,
                   off=0),
              dict(B=HY_BATCH, S_q=HY_SEQ, S_kv=HY_SEQ, H=32, Hkv=32,
                   causal=True, off=0)]
    rows, errs = [], {}
    for D, sh, qs in itertools.product((112, 96, 80), shapes,
                                       (1.0, PEAKED_Q)):
        plan = flash_plan(sh["B"], sh["S_q"], sh["H"], sh["S_kv"],
                          q_offset=sh["off"], causal=sh["causal"],
                          head_dim=D)
        for dname in ("float32", "bfloat16"):
            q, k, v = flash_inputs(torch, getattr(torch, dname), sh["S_kv"],
                                   S_q=sh["S_q"], H=sh["H"], Hkv=sh["Hkv"],
                                   D=D, B=sh["B"], q_scale=qs)
            got = flash_attention_kernel(q, k, v, causal=sh["causal"],
                                         q_offset=sh["off"])
            want = ref.flash_attention(q, k, v, causal=sh["causal"],
                                       q_offset=sh["off"])
            torch.cuda.synchronize()
            name = (" ".join(f"{n}={x}" for n, x in sh.items())
                    + f" D={D} q_scale={qs} splits={plan.splits}")
            case = attention_errs(got, want, dname, f"flash {name}")
            rows.append({"kernel": "flash_attention (run-time D)",
                         "dtype": dname, "case": name, **case})
            if D == 112 and sh["B"] == HY_BATCH:
                errs["flash_attention_zamba2", dname] = max(
                    case["max_abs_err"],
                    errs.get(("flash_attention_zamba2", dname), 0.0))
            del q, k, v, got, want
    emit({"phase": "flash_anyd_parity", "ok": True, "cases": rows})
    return errs


def phase_hybrid_kernel_parity(torch):
    """The SSD kernel at zamba2's prefill shape (112 heads of 64, state
    64; also chunks of 127 over two sequences, B 1 and steep decay) and
    the per-slot paged kernel at its shared block's decode shape (G 1,
    head dim 112, 10 pages of 128 per slot; also at a tile's split edges
    and the full sweep, with q scaled up), in f32 and bf16."""
    full = HY_SSD_SHAPE
    rows, errs = ssd_cases(
        torch, [dict(full), dict(full, B=2, S=254, chunk=127),
                dict(full, B=1), dict(full, B=2, S=256, steep=True)],
        full, "ssd_scan_zamba2")
    shape = dict(n_pool=HY_POOL, mb=HY_POOL, H=32, Hkv=32, D=112)
    cases = [([HY_SEQ, HY_MAX_SEQ - 1, 1, 0, 500, 129, 128, HY_SEQ + 16],
              1.0)]
    # a tile's split edges and the full sweep, also with a peaked softmax
    edges = [0, 1, 63, 64, 65, 129, HY_POOL * 128, HY_MAX_SEQ]
    cases += [(edges, 1.0), (edges, PEAKED_Q)]
    for (lengths, qs), dname in itertools.product(cases,
                                                  ("float32", "bfloat16")):
        rows.append(per_slot_case(torch, dname, shape, HY_POOL, lengths,
                                  q_scale=qs))
        errs["paged_attention_zamba2", dname] = max(
            rows[-1]["max_abs_err"],
            errs.get(("paged_attention_zamba2", dname), 0.0))
    emit({"phase": "hybrid_kernel_parity", "ok": True, "cases": rows})
    return errs


def hybrid_prompts(vocab: int):
    import numpy as np

    rs = np.random.RandomState(5)
    return rs.randint(1, vocab, (HY_BATCH, HY_SEQ)).astype(np.int32)


def load_hybrid_cache(torch, model, pcache, table):
    """The hybrid's prefill cache in its decode cache: every Mamba2
    layer's state and conv tails cast to f32, and each application's K/V
    page by page into the per-slot pages its block-table row names (the
    last page zero-padded)."""
    from repro_torch.configs import ShapeConfig

    B = table.shape[0]
    cache = model.init_cache(ShapeConfig("serve", "decode", HY_MAX_SEQ, B))
    for k, dst in cache["layers"].items():
        dst.copy_(pcache["mamba"][k])
    pages = table.tolist()
    S = pcache["attn_k"].shape[2]
    for j in range(-(-S // 128)):
        for name, pool in (("attn_k", "k_pool"), ("attn_v", "v_pool")):
            seg = pcache[name][:, :, j * 128:(j + 1) * 128]
            for b in range(B):
                cache["attn"][pool][:, b, pages[b][j], :seg.shape[2]] = \
                    seg[:, b]
    return cache


def _decode_batch(torch, tokens, table, length):
    return {"tokens": tokens, "block_table": table,
            "lengths": torch.full((table.shape[0],), length,
                                  dtype=torch.int32, device=table.device)}


def phase_hybrid_layers(torch, model, params, tokens, table):
    """Layer by layer at full width, bf16: at every layer the kernels and
    the plain versions get the SAME input (the plain path's hidden state),
    so a difference is that layer's alone — each Mamba2 block (SSD
    kernel) and each application of the shared block's causal attention
    (flash, head dim 112) over the prompts, then, on the loaded cache, one
    decode step's shared attention over each application's per-slot pool
    (paged kernel).  Outputs held to 4 bf16 ulps of their largest
    magnitude, attention outputs also row by row, each Mamba2 layer's
    final state (f32 in both) to the f32 kernel tolerance of its largest
    magnitude."""
    from repro_torch.models import layers as L
    from repro_torch.models import ssm as S
    from repro_torch.models import transformer as T

    cfg = model.cfg
    shared = params["shared_attn"]
    worst = {}

    def hold(kind, i, got, want, tol=None, rows=False):
        e, scale = max_err(got, want), float(want.float().abs().max())
        limit = 4 * bf16_ulp(scale) if tol is None else tol * scale
        check(e <= limit, f"{kind} {i}: err {e} at scale {scale}")
        if rows:
            r = row_rel_err(got, want)
            check(r <= ROW_REL_TOL, f"{kind} {i}: row-relative err {r}")
        w = worst.get(kind, (0.0, 1.0, -1))
        if e / scale >= w[0] / w[1]:
            worst[kind] = (e, scale, i)

    h = L.embed_tokens(params["embed"], tokens, cfg)
    caches, ks, vs = [], [], []
    for i in range(cfg.num_layers):
        lp = T._layer(params["layers"], i)
        m_in = L.apply_norm(lp["norm"], h, cfg)
        got, got_c = S.mamba_full(lp["mamba"], m_in, cfg)
        want, want_c = S.mamba_full(lp["mamba"], m_in, cfg, impl="plain")
        hold("mamba", i, got, want)
        hold("mamba_state", i, got_c["state"], want_c["state"],
             tol=KERNEL_TOL["float32"])
        h = h + want
        caches.append(want_c)
        del got, got_c
        if (i + 1) % cfg.attn_period:
            continue
        j = (i + 1) // cfg.attn_period - 1
        a_in = L.apply_norm(shared["norm1"], h, cfg)
        res = [L.attention_full(shared["attn"], a_in, cfg, causal=True,
                                impl=impl) for impl in (None, "plain")]
        hold("shared_attn", j, res[0][0], res[1][0], rows=True)
        h = T._shared_mlp(shared, h + res[1][0], cfg)
        ks.append(res[1][1][0])
        vs.append(res[1][1][1])
        del res
    cache = load_hybrid_cache(torch, model, {
        "mamba": T._stack(caches), "attn_k": torch.stack(ks),
        "attn_v": torch.stack(vs)}, table)
    del caches, ks, vs
    batch = _decode_batch(torch, tokens[:, -1:], table, HY_SEQ)
    h = L.embed_tokens(params["embed"], batch["tokens"], cfg)
    for i in range(cfg.num_layers):
        h = T._mamba_decode_layer(params, cache, i, h, cfg)
        if (i + 1) % cfg.attn_period:
            continue
        j = (i + 1) // cfg.attn_period - 1
        pools = T._layer(cache["attn"], j)
        a_in = L.apply_norm(shared["norm1"], h, cfg)
        # both write the same new K/V row before attending
        outs = [L.attention_decode(shared["attn"], a_in, cfg, pools,
                                   batch["lengths"],
                                   block_table=table, impl=impl)[0]
                for impl in (None, "plain")]
        hold("shared_attn_decode_paged", j, outs[0], outs[1], rows=True)
        h = T._shared_mlp(shared, h + outs[1], cfg)
    torch.cuda.synchronize()
    emit({"phase": "hybrid_layers", "ok": True, "arch": cfg.name,
          "batch": HY_BATCH, "seq": HY_SEQ,
          "tol": {"outputs": "4 bf16 ulps of max|out| (attention also "
                             f"row by row, {ROW_REL_TOL})",
                  "mamba_state": f"{KERNEL_TOL['float32']} of max|state|"},
          "worst": {k: {"max_abs_err": v[0], "max_abs": v[1], "index": v[2]}
                    for k, v in worst.items()}})


def _hybrid_prefill_pair(torch, model, params, tokens):
    """Prefill logits and every cache leaf, kernels vs plain (the Mamba2
    states layer by layer); also returns the plain logits."""
    logits_k, cache_k = model.prefill(params, {"tokens": tokens})
    logits_p, cache_p = model.prefill(params, {"tokens": tokens},
                                      impl="plain")
    torch.cuda.synchronize()
    check(bool(torch.isfinite(logits_k).all()), "non-finite prefill logits")
    caches = {k: rel_err(cache_k["mamba"][k], cache_p["mamba"][k])
              for k in ("conv_x", "conv_b", "conv_c")}
    caches["state_worst_layer"] = max(
        (rel_err(cache_k["mamba"]["state"][i], cache_p["mamba"]["state"][i])
         for i in range(model.cfg.num_layers)), key=lambda e: e["rel"])
    for k in ("attn_k", "attn_v"):
        caches[k] = rel_err(cache_k[k], cache_p[k])
    return _logit_err(logits_k, logits_p), caches, logits_p


def _hybrid_teacher_forcing(torch, model, params, tokens, table, n=127):
    """Prefill of ``n`` tokens plus one decode step of token n against a
    prefill of ``n + 1`` tokens, on the last logits."""
    _, pc = model.prefill(params, {"tokens": tokens[:, :n]})
    cache = load_hybrid_cache(torch, model, pc, table)
    del pc
    got, _ = model.decode_step(params, cache, _decode_batch(
        torch, tokens[:, n:n + 1], table, n))
    want, _ = model.prefill(params, {"tokens": tokens[:, :n + 1]})
    torch.cuda.synchronize()
    return _logit_err(got, want)


def phase_hybrid_model(torch, model, model32, params32, tokens, table):
    """Full-width prefill through the kernels against the plain versions
    (logits and every cache leaf), and teacher forcing (prefill 127 + one
    decode step against prefill 128).  Held in f32 compute (the f32 flash
    body, the SSD kernel in f32): bf16 rounding compounds through 81
    layers (ROADMAP Queue C), as it does for mamba2; reported in bf16
    compute beside the plain bf16 model against the plain f32 model.
    The bf16 weights are cast from ``params32`` after the f32 checks (27
    GB of f32 weights and 13.5 GB of bf16 ones would leave little room
    for the f32 activations beside them) and returned."""
    logit32, caches32, plain32 = _hybrid_prefill_pair(torch, model32,
                                                      params32, tokens)
    check(logit32["rel"] <= HY_F32_REL_TOL, f"f32 logits {logit32}")
    for k, e in caches32.items():
        check(e["rel"] <= HY_F32_REL_TOL, f"f32 cache {k} {e}")
    tf32 = _hybrid_teacher_forcing(torch, model32, params32, tokens, table)
    check(tf32["rel"] <= HY_F32_REL_TOL, f"f32 teacher forcing {tf32}")
    peak32 = torch.cuda.max_memory_allocated() / 1e9
    params = model.compute_params(params32)
    logit16, caches16, plain16 = _hybrid_prefill_pair(torch, model, params,
                                                      tokens)
    bf16_vs_f32 = _logit_err(plain16, plain32)
    tf16 = _hybrid_teacher_forcing(torch, model, params, tokens, table)
    emit({"phase": "hybrid_model", "ok": True, "arch": model.cfg.name,
          "batch": HY_BATCH, "seq": HY_SEQ, "tol_rel_f32": HY_F32_REL_TOL,
          "f32": {"prefill_logits": logit32, "caches": caches32,
                  "teacher_forcing_127_plus_1": tf32},
          "bf16_reported": {"prefill_logits": logit16, "caches": caches16,
                            "teacher_forcing_127_plus_1": tf16,
                            "plain_bf16_vs_plain_f32": bf16_vs_f32},
          "peak_mem_gb_f32_checks": peak32,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    return params


def phase_hybrid_generate(torch, model, params, tokens, table):
    """The main hybrid path with the launch counts set to 0: one prefill
    of the 8 prompts (81 SSD scans, 13 flash calls), the decode cache
    loaded, HY_STEPS greedy decode steps with per-slot page ids (13
    paged calls each)."""
    from repro_torch.kernels.decode_attention import decode_attention_kernel
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.paged_attention import paged_attention_kernel
    from repro_torch.kernels.ssd_scan import ssd_chunk_scan_kernel

    kernels = {"ssd_scan": ssd_chunk_scan_kernel,
               "flash_attention": flash_attention_kernel,
               "paged_attention": paged_attention_kernel,
               "decode_attention": decode_attention_kernel}
    n_attn = model.cfg.num_layers // model.cfg.attn_period
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset(kernels.values())
    t0 = time.perf_counter()
    logits, pc = model.prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    at_prefill = {n: k.launches for n, k in kernels.items()}
    check(at_prefill == {"ssd_scan": HY_LAYERS, "flash_attention": n_attn,
                         "paged_attention": 0, "decode_attention": 0},
          f"prefill launches {at_prefill}: want {HY_LAYERS} SSD scans and "
          f"{n_attn} flash calls")
    cache = load_hybrid_cache(torch, model, pc, table)
    del pc
    toks, step_ms, decode_s = greedy_decode(
        torch, model, params, logits, cache,
        _decode_batch(torch, None, table, HY_SEQ), HY_STEPS)
    launches = {n: k.launches for n, k in kernels.items()}
    want = dict(at_prefill, paged_attention=n_attn * HY_STEPS)
    check(launches == want, f"launches {launches}, want {want}")
    combines = {"flash_attention": flash_attention_kernel.combine_launches,
                "paged_attention": paged_attention_kernel.combine_launches}
    # 10 pages a slot are 10 splits of two tiles: every paged call combines
    check(combines["paged_attention"] == launches["paged_attention"],
          f"paged combines {combines} vs launches {launches}")
    emit({"phase": "hybrid_generate", "ok": True, "arch": model.cfg.name,
          "batch": HY_BATCH, "prompt_tokens": HY_SEQ,
          "decode_steps": HY_STEPS, "launches": launches,
          "combine_launches": combines,
          "prefill_ms": prefill_ms,
          "median_decode_step_ms": statistics.median(step_ms),
          "decode_tokens_per_s": HY_BATCH * HY_STEPS / decode_s,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "first_tokens": toks[:, :4].tolist()})
    return launches


def hybrid_table_rows(torch, launches, errs):
    """The three kernels of the hybrid path at its shapes, bf16: kernel,
    plain and library time beside the bound, device and cold-L2 times;
    for flash also the D 128 kernel at the same shape (the work the
    padded D 112 form does)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.flash_attention import plan_splits as flash_plan
    from repro_torch.kernels.paged_attention import paged_attention_kernel

    saved = (flash_attention_kernel.launches, paged_attention_kernel.launches)
    bf, elt = torch.bfloat16, 2
    B, S, H, D = HY_BATCH, HY_SEQ, 32, 112
    rows = []

    # the shared block's causal prefill attention
    q, k, v = flash_inputs(torch, bf, S, S_q=S, H=H, Hkv=H, D=D, B=B)
    def kfn():
        return flash_attention_kernel(q, k, v, causal=True)

    k_ms = time_ms(kfn, iters=20)
    p_ms = time_ms(lambda: ref.flash_attention(q, k, v, causal=True),
                   iters=5, warmup=2)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    def lfn():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    l_ms = time_ms(lfn, iters=20)
    plan = flash_plan(B, S, H, S, causal=True, head_dim=D)
    # the D 128 kernel at the same shape: the work the padded form does
    q128, k128, v128 = flash_inputs(torch, bf, S, S_q=S, H=H, Hkv=H, D=128,
                                    B=B)
    p128 = flash_plan(B, S, H, S, causal=True, head_dim=128)
    d128_ms = time_ms(lambda: flash_attention_kernel(q128, k128, v128,
                                                     causal=True), iters=20)
    del q128, k128, v128
    n_bytes = 4 * q.numel() * elt
    flops = 4 * B * H * D * (S * (S + 1) // 2)
    b_ms, b_by = bound_ms(n_bytes, flops, "bfloat16")
    rows.append({"name": "flash_attention_zamba2", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
                 "replaces": "src/repro/kernels/flash_attention.py:85",
                 "launches": launches["flash_attention"],
                 "max_abs_err": errs["flash_attention_zamba2", "bfloat16"],
                 "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                 "bound_by": b_by, "library_ms": l_ms,
                 **device_timings(torch, kfn, lfn, n=10),
                 "d128_ms": d128_ms,
                 "d128_plan": f"warpgroups={p128.consumers} "
                              f"key_tile={p128.keys}",
                 "library_note": "scaled_dot_product_attention, "
                                 "is_causal=True (timed only)",
                 "shape": f"B={B} S_q=S_kv={S} causal H={H} Hkv={H} D={D} "
                          f"(run-time D) warpgroups={plan.consumers} "
                          f"key_tile={plan.keys} splits={plan.splits}",
                 "flops": flops, "bytes": n_bytes})
    del q, k, v, qt, kt, vt

    # the SSD scan at zamba2's prefill shape
    rows.append(ssd_table_row(torch, launches, errs, "ssd_scan_zamba2",
                              HY_SSD_SHAPE))

    # the shared block's decode attention at the last step: every row
    # holds HY_SEQ + HY_STEPS positions of its 10-page per-slot pool
    lengths = [HY_MAX_SEQ] * B
    q, kp, vp, _, lens = paged_inputs(torch, bf, lengths, n_pool=HY_POOL,
                                      mb=HY_POOL, H=H, Hkv=H, D=D)
    table = local_table(torch, B, HY_POOL, HY_POOL)
    def pfn():
        return paged_attention_kernel(q, kp, vp, table, lens)

    k_ms = time_ms(pfn)
    p_ms = time_ms(lambda: ref.paged_attention(q, kp, vp, table, lens))
    n_rows = sum(lengths)
    n_bytes = (2 * q.numel() * elt + n_rows * H * D * 2 * elt
               + table.numel() * 4 + lens.numel() * 4)
    b_ms, b_by = bound_ms(n_bytes, 4 * H * D * n_rows, "bfloat16")
    rows.append({"name": "paged_attention_per_slot_zamba2", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
                 "replaces": "src/repro/kernels/paged_attention.py:128 "
                             "(global_pages=False, :171-177)",
                 "launches": launches["paged_attention"],
                 "max_abs_err": errs["paged_attention_zamba2", "bfloat16"],
                 "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                 "bound_by": b_by, "library_ms": None,
                 **device_timings(torch, pfn),
                 "plan": paged_plan_fields(B, H, HY_POOL, lengths),
                 "library_note": "no single PyTorch call attends over pages "
                                 "named by a block table",
                 "shape": f"B={B} n_pool={HY_POOL} lengths={HY_MAX_SEQ} "
                          f"H={H} Hkv={H} D={D}",
                 "bytes": n_bytes})
    flash_attention_kernel.launches, paged_attention_kernel.launches = saved
    return rows


def phase_hybrid_profile(torch, model, params, tokens, table,
                         steps: int = 8):
    """Device time by kernel over one hybrid prefill and over ``steps``
    greedy decode steps (torch.profiler)."""
    batch = {"tokens": tokens}
    out = {"prefill": _profile_window(
        torch, lambda: model.prefill(params, batch))}
    logits, pc = model.prefill(params, batch)
    cache = load_hybrid_cache(torch, model, pc, table)
    del pc
    out["decode"] = _profile_decode(
        torch, model, params, logits, cache,
        _decode_batch(torch, None, table, HY_SEQ), steps)
    emit({"phase": "hybrid_profile", "ok": True, **out})


# ---------------------------------------------------------------------------
# the MoE path: mixtral-8x7b prefill (flash with the sliding window, the
# top-2 MoE) and greedy decode (the decode kernel over the rolling cache)
# ---------------------------------------------------------------------------
def window_inputs(torch, dtype, B, S_q, S_kv, H, Hkv, D, seed=9,
                  q_scale=PEAKED_Q):
    """Flash operands with q scaled up (a peaked softmax) and V rows that
    mark their position in column 0, so that the weight of a window's
    edge key shows in the output."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, S_q, H, D), generator=g, device=dev) * 0.3 * q_scale
    k = torch.randn((B, S_kv, Hkv, D), generator=g, device=dev) * 0.3
    v = torch.randn((B, S_kv, Hkv, D), generator=g, device=dev) * 0.3
    v[..., 0] = (torch.arange(S_kv, device=dev) / S_kv)[None, :, None]
    return q.to(dtype), k.to(dtype), v.to(dtype)


def window_keys(S_q, S_kv, q_offset, window, causal=True) -> int:
    """Keys the rows of one (sequence, head) see: the band's area."""
    n = 0
    for i in range(S_q):
        p = q_offset + i
        hi = min(S_kv, p + 1) if causal else S_kv
        lo = max(0, p - window + 1) if window else 0
        n += max(0, hi - lo)
    return n


def phase_flash_window_parity(torch):
    """The flash kernel with a sliding window against the plain version,
    f32 and bf16: mixtral's prefill shape (B 4, 6144 tokens, 32/8 heads
    of 128, window 4096; two warpgroups over 128-key tiles), its last
    chunk split across blocks (128 rows at q_offset 6016 over 6144 keys),
    windows of 1 / 63 / 100 / 129 keys that cut tiles mid-tile on both
    launch shapes, head dim 112 through the run-time-D form, and a window
    of S_kv or more keys, which must equal ``window=0`` bit for bit.  q
    is scaled up and V marks its rows' positions, so that an edge key
    off by one shows."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.flash_attention import plan_splits as flash_plan

    H, Hkv = 32, 8
    cases = [dict(B=MX_BATCH, S_q=MX_SEQ, S_kv=MX_SEQ, D=128, off=0,
                  window=4096),
             dict(B=1, S_q=128, S_kv=MX_SEQ, D=128, off=MX_SEQ - 128,
                  window=4096)]
    for w in (1, 63, 100, 129):
        cases += [dict(B=2, S_q=1024, S_kv=1024, D=128, off=0, window=w),
                  dict(B=1, S_q=128, S_kv=1024, D=128, off=896, window=w),
                  dict(B=2, S_q=1024, S_kv=1024, D=112, off=0, window=w)]
    cases += [dict(B=1, S_q=128, S_kv=1024, D=112, off=896, window=100)]
    rows, errs = [], {}
    for sh in cases:
        plan = flash_plan(sh["B"], sh["S_q"], H, sh["S_kv"],
                          q_offset=sh["off"], window=sh["window"],
                          head_dim=sh["D"])
        for dname in ("float32", "bfloat16"):
            q, k, v = window_inputs(torch, getattr(torch, dname), sh["B"],
                                    sh["S_q"], sh["S_kv"], H, Hkv, sh["D"])
            got = flash_attention_kernel(q, k, v, causal=True,
                                         window=sh["window"],
                                         q_offset=sh["off"])
            want = ref.flash_attention(q, k, v, causal=True,
                                       window=sh["window"],
                                       q_offset=sh["off"])
            torch.cuda.synchronize()
            name = (" ".join(f"{n}={x}" for n, x in sh.items())
                    + f" H={H} Hkv={Hkv} warpgroups={plan.consumers} "
                      f"key_tile={plan.keys} splits={plan.splits}")
            case = attention_errs(got, want, dname, f"flash window {name}")
            rows.append({"kernel": "flash_attention (window)",
                         "dtype": dname, "case": name, **case})
            if sh["S_q"] == MX_SEQ:
                errs["flash_attention_mixtral", dname] = case["max_abs_err"]
            del q, k, v, got, want
    # a window that cuts nothing: bit for bit the window-0 call
    same = []
    for sh, dname in itertools.product(
            [dict(B=2, S_q=1024, S_kv=1024, D=128, off=0),
             dict(B=1, S_q=128, S_kv=1024, D=128, off=896),
             dict(B=2, S_q=1024, S_kv=1024, D=112, off=0)],
            ("float32", "bfloat16")):
        q, k, v = window_inputs(torch, getattr(torch, dname), sh["B"],
                                sh["S_q"], sh["S_kv"], H, Hkv, sh["D"])
        want = flash_attention_kernel(q, k, v, causal=True,
                                      q_offset=sh["off"])
        for w in (sh["S_kv"], 4096):
            got = flash_attention_kernel(q, k, v, causal=True, window=w,
                                         q_offset=sh["off"])
            check(torch.equal(got, want),
                  f"window {w} >= S_kv differs from window 0: {sh} {dname}")
        same.append(f"{dname} " + " ".join(f"{n}={x}" for n, x in sh.items()))
    torch.cuda.synchronize()
    emit({"phase": "flash_window_parity", "ok": True, "cases": rows,
          "bit_identical_to_window_0": same})
    return errs


def phase_ring_decode_parity(torch):
    """The decode kernel at mixtral's ring shape (B 4, 4096 rows, 32/8
    heads of 128) against the plain version, f32 and bf16: every row full
    (a wrapped ring), rows part full (1, 2048, 4095), and q scaled up."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention_kernel

    rows, errs = [], {}
    cases = [([4096] * MX_BATCH, 1.0), ([4096, 1, 2048, 4095], 1.0),
             ([4096] * MX_BATCH, PEAKED_Q)]
    for (lengths, qs), dname in itertools.product(cases,
                                                  ("float32", "bfloat16")):
        q, k, v, lens = decode_inputs(torch, getattr(torch, dname), lengths,
                                      S_max=4096, H=32, Hkv=8, D=128,
                                      q_scale=qs)
        got = decode_attention_kernel(q, k, v, lens)
        want = ref.decode_attention(q, k, v, lens)
        torch.cuda.synchronize()
        case = attention_errs(got, want, dname, f"ring decode {lengths}")
        rows.append({"kernel": "decode_attention (ring)", "dtype": dname,
                     "case": f"B={MX_BATCH} S_max=4096 H=32 Hkv=8 D=128 "
                             f"q_scale={qs}", "lengths": lengths, **case})
        errs["decode_attention_ring", dname] = max(
            case["max_abs_err"],
            errs.get(("decode_attention_ring", dname), 0.0))
    emit({"phase": "ring_decode_parity", "ok": True, "cases": rows})
    return errs


def mixtral_prompts(vocab: int, batch: int = MX_BATCH, seq: int = MX_SEQ):
    import numpy as np

    rs = np.random.RandomState(6)
    return rs.randint(1, vocab, (batch, seq)).astype(np.int32)


def load_ring(torch, model, pcache, max_seq):
    """The prefill cache {"k", "v": (L, B, S, Hkv, D)} in the rolling
    decode cache of ``max_seq`` positions: its last W positions, position
    p in row p % W (W = min(window, max_seq))."""
    from repro_torch.configs import ShapeConfig

    B, S = pcache["k"].shape[1], pcache["k"].shape[2]
    cache = model.init_cache(ShapeConfig("serve", "decode", max_seq, B))
    W = cache["layers"]["k"].shape[2]
    n = min(S, W)
    rows = torch.arange(S - n, S, device=pcache["k"].device) % W
    for name in ("k", "v"):
        cache["layers"][name][:, :, rows] = pcache[name][:, :, S - n:]
    return cache


def _ring_batch(torch, tokens, length):
    return {"tokens": tokens,
            "lengths": torch.full((tokens.shape[0],), length,
                                  dtype=torch.int32, device=tokens.device)}


def record_routes(fn):
    """Run ``fn`` with every MoE router call's top-k ids recorded, in
    call order (one a layer a forward); returns (fn's result, the ids)."""
    from repro_torch.models import layers as L

    routes, route = [], L.moe_route

    def recording(p, x, cfg):
        gate_w, ids = route(p, x, cfg)
        routes.append(ids)
        return gate_w, ids

    L.moe_route = recording
    try:
        return fn(), routes
    finally:
        L.moe_route = route


def route_flips(a, b) -> int:
    """Tokens whose set of top-k experts differs between two routings."""
    return int((a.sort(-1).values != b.sort(-1).values).any(-1).sum())


def dropped_pairs(ids, cfg) -> int:
    """(token, expert) pairs past an expert's capacity in a prefill's
    routing ``ids`` (B, S, k), at the config's capacity factor."""
    import torch

    B, S, k = ids.shape
    E = cfg.num_experts
    C = min(max(int(cfg.moe_capacity_factor * S * k / E), k), S * k)
    counts = torch.zeros((B, E), dtype=torch.long, device=ids.device)
    counts.scatter_add_(1, ids.reshape(B, -1), torch.ones_like(
        ids.reshape(B, -1)))
    return int((counts - C).clamp_min(0).sum())


def phase_moe_layers(torch, model, params, tokens):
    """Layer by layer at full width, bf16: at every layer the windowed
    flash kernel and the plain attention get the SAME input (the plain
    path's hidden state), then, on the ring loaded from the plain K/V,
    one decode step's attention through the decode kernel and the plain
    version (both write the same new K/V row first).  Held to 4 bf16 ulps
    of the largest magnitude and row by row.  Also counts the (token,
    expert) pairs each layer's MoE drops at capacity factor 1.25."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    cfg = model.cfg
    worst, drops, ks, vs = {}, [], [], []

    def hold(kind, i, got, want):
        e, scale = max_err(got, want), float(want.float().abs().max())
        check(e <= 4 * bf16_ulp(scale), f"{kind} {i}: err {e} at {scale}")
        r = row_rel_err(got, want)
        check(r <= ROW_REL_TOL, f"{kind} {i}: row-relative err {r}")
        w = worst.get(kind, (0.0, 1.0, -1))
        if e / scale >= w[0] / w[1]:
            worst[kind] = (e, scale, i)

    h = L.embed_tokens(params["embed"], tokens, cfg)
    for i in range(cfg.num_layers):
        lp = T._layer(params["layers"], i)
        a_in = L.apply_norm(lp["norm1"], h, cfg)
        got, _ = L.attention_full(lp["attn"], a_in, cfg, causal=True)
        want, (k, v) = L.attention_full(lp["attn"], a_in, cfg, causal=True,
                                        impl="plain")
        hold("attn", i, got, want)
        del got
        ks.append(k)
        vs.append(v)
        h = h + want
        _, ids = L.moe_route(lp["moe"], L.apply_norm(lp["norm2"], h, cfg),
                             cfg)
        drops.append(dropped_pairs(ids, cfg))
        h = T._mlp_or_moe(lp, h, cfg)
    cache = load_ring(torch, model, {"k": torch.stack(ks),
                                     "v": torch.stack(vs)},
                      MX_SEQ + MX_STEPS)
    del ks, vs
    batch = _ring_batch(torch, tokens[:, -1:], MX_SEQ)
    h = L.embed_tokens(params["embed"], batch["tokens"], cfg)
    for i in range(cfg.num_layers):
        lp = T._layer(params["layers"], i)
        ring = T._layer(cache["layers"], i)
        a_in = L.apply_norm(lp["norm1"], h, cfg)
        outs = [L.attention_decode(lp["attn"], a_in, cfg, ring,
                                   batch["lengths"], impl=impl)[0]
                for impl in (None, "plain")]
        hold("attn_decode_ring", i, outs[0], outs[1])
        h = T._mlp_or_moe(lp, h + outs[1], cfg)
    torch.cuda.synchronize()
    emit({"phase": "moe_layers", "ok": True, "arch": cfg.name,
          "layers": cfg.num_layers, "batch": MX_BATCH, "seq": MX_SEQ,
          "tol": f"4 bf16 ulps of max|out|, row by row {ROW_REL_TOL}",
          "worst": {k: {"max_abs_err": v[0], "max_abs": v[1], "layer": v[2]}
                    for k, v in worst.items()},
          "dropped_pairs_by_layer_cf_1.25": drops,
          "pairs_per_layer": MX_BATCH * MX_SEQ * cfg.experts_per_token})


def _moe_prefill_pair(torch, model, params, tokens):
    """Prefill logits and both cache leaves, kernels vs plain, with the
    routing flips between the two runs in each layer and the pairs the
    kernel run's MoE dropped; also returns the plain logits."""
    (logits_k, cache_k), routes_k = record_routes(
        lambda: model.prefill(params, {"tokens": tokens}))
    (logits_p, cache_p), routes_p = record_routes(
        lambda: model.prefill(params, {"tokens": tokens}, impl="plain"))
    torch.cuda.synchronize()
    check(bool(torch.isfinite(logits_k).all()), "non-finite prefill logits")
    caches = {k: rel_err(cache_k[k], cache_p[k]) for k in ("k", "v")}
    flips = [route_flips(a, b) for a, b in zip(routes_k, routes_p)]
    drops = [dropped_pairs(ids, model.cfg) for ids in routes_k]
    return _logit_err(logits_k, logits_p), caches, flips, drops, logits_p


def _moe_teacher_forcing(torch, model, params, tokens, n=MX_TF_STEPS):
    """A prefill of S tokens, the ring loaded, n decode steps of the next
    tokens, against the prefill of S + n tokens at each step's position;
    also the routing flips between the decode steps and that prefill,
    summed over the n tokens, in each layer."""
    S = tokens.shape[1] - n
    L = model.cfg.num_layers
    _, pc = model.prefill(params, {"tokens": tokens[:, :S]})
    cache = load_ring(torch, model, pc, S + n)
    del pc
    got, step_routes = [], []
    for t in range(S, S + n):
        (lg, cache), routes = record_routes(lambda t=t: model.decode_step(
            params, cache, _ring_batch(torch, tokens[:, t:t + 1], t)))
        got.append(lg)
        step_routes.append(routes)
    flips = [0] * L
    wants = []
    for t in range(S, S + n):
        last = torch.full((tokens.shape[0],), t, dtype=torch.int32,
                          device=tokens.device)
        (want, _), routes = record_routes(lambda last=last: model.prefill(
            params, {"tokens": tokens, "last_index": last}))
        wants.append(want)
        if t == S:  # one long prefill's routing serves every step
            for j, steps in enumerate(step_routes):
                for i in range(L):
                    flips[i] += route_flips(steps[i], routes[i][:,
                                                               S + j:S + j + 1])
    torch.cuda.synchronize()
    return _logit_err(torch.stack(got), torch.stack(wants)), flips


def phase_moe_model(torch, model, params32, tokens):
    """Full-width prefill through the kernels against the plain versions
    (logits and both cache leaves) and teacher forcing on the ring
    (prefill S, then 8 decode steps, against the prefill of S + 8 at
    each step's position), one prompt of 6144 tokens, f32 compute (the
    f32 flash body and the decode kernel in f32), held to 1e-3 of the
    largest magnitude.  Teacher forcing runs the config at a dropless
    capacity factor (E, as the JAX package's smoke config): a prefill at
    1.25 drops (token, expert) pairs that the decode steps keep, so it
    computes another function; the pairs 1.25 drops are reported.  The
    routing flips (tokens whose top-2 experts differ) between the
    compared runs are counted per layer.  bf16 compute is reported: the
    bf16 weights are cast from ``params32`` after the f32 checks and
    returned."""
    from repro_torch.models import Model

    cfg32 = model.cfg.scaled(dtype="float32")
    model32 = Model(cfg32)
    model32_dropless = Model(cfg32.scaled(
        moe_capacity_factor=float(cfg32.num_experts)))
    t32 = tokens[:MX_F32_BATCH]
    logit32, caches32, flips32, drops32, plain32 = _moe_prefill_pair(
        torch, model32, params32, t32)
    check(logit32["rel"] <= MX_F32_REL_TOL, f"f32 logits {logit32}")
    for k, e in caches32.items():
        check(e["rel"] <= MX_F32_REL_TOL, f"f32 cache {k} {e}")
    tf_tokens = torch.cat([t32, tokens[MX_F32_BATCH:MX_F32_BATCH + 1,
                                       :MX_TF_STEPS]], 1)
    tf32, tf_flips = _moe_teacher_forcing(torch, model32_dropless, params32,
                                          tf_tokens)
    check(tf32["rel"] <= MX_F32_REL_TOL, f"f32 teacher forcing {tf32}")
    peak32 = torch.cuda.max_memory_allocated() / 1e9
    params = model.compute_params(params32)
    logit16, caches16, flips16, _, plain16 = _moe_prefill_pair(
        torch, model, params, t32)
    emit({"phase": "moe_model", "ok": True, "arch": model.cfg.name,
          "layers": model.cfg.num_layers, "batch": MX_F32_BATCH,
          "seq": MX_SEQ, "tol_rel_f32": MX_F32_REL_TOL,
          "f32": {"prefill_logits": logit32, "caches": caches32,
                  "route_flips_kernel_vs_plain_by_layer": flips32,
                  "dropped_pairs_cf_1.25_by_layer": drops32,
                  f"teacher_forcing_{MX_SEQ}_plus_{MX_TF_STEPS}_dropless":
                      tf32,
                  "route_flips_teacher_forcing_by_layer": tf_flips},
          "bf16_reported": {"prefill_logits": logit16, "caches": caches16,
                            "route_flips_kernel_vs_plain_by_layer": flips16,
                            "plain_bf16_vs_plain_f32": _logit_err(plain16,
                                                                  plain32)},
          "peak_mem_gb_f32_checks": peak32,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    return params


def phase_moe_generate(torch, model, params, tokens):
    """The main MoE path with the launch counts set to 0: one prefill of
    the 4 prompts (6 windowed flash calls), the ring loaded with the last
    4096 positions, MX_STEPS greedy decode steps (6 decode calls each,
    every one split across blocks and combined)."""
    from repro_torch.kernels.decode_attention import decode_attention_kernel
    from repro_torch.kernels.decode_attention import plan_splits as decode_plan
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.flash_attention import plan_splits as flash_plan
    from repro_torch.kernels.paged_attention import paged_attention_kernel
    from repro_torch.kernels.ssd_scan import ssd_chunk_scan_kernel

    kernels = {"flash_attention": flash_attention_kernel,
               "decode_attention": decode_attention_kernel,
               "paged_attention": paged_attention_kernel,
               "ssd_scan": ssd_chunk_scan_kernel}
    L = model.cfg.num_layers
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset(kernels.values())
    t0 = time.perf_counter()
    logits, pc = model.prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    at_prefill = {n: k.launches for n, k in kernels.items()}
    check(at_prefill == {"flash_attention": L, "decode_attention": 0,
                         "paged_attention": 0, "ssd_scan": 0},
          f"prefill launches {at_prefill}: want {L} flash calls")
    cache = load_ring(torch, model, pc, MX_SEQ + MX_STEPS)
    check(cache["layers"]["k"].shape[2] == model.cfg.sliding_window,
          "the decode cache is not a ring of the window")
    del pc
    toks, step_ms, decode_s = greedy_decode(
        torch, model, params, logits, cache,
        _ring_batch(torch, tokens[:, -1:], MX_SEQ), MX_STEPS)
    launches = {n: k.launches for n, k in kernels.items()}
    want = dict(at_prefill, decode_attention=L * MX_STEPS)
    check(launches == want, f"launches {launches}, want {want}")
    combines = {"flash_attention": flash_attention_kernel.combine_launches,
                "decode_attention": decode_attention_kernel.combine_launches}
    # at full width the prefill's 4 x 32 x 48 blocks of 128 rows fill the
    # card unsplit, and the ring's 4096 rows are 32 splits: every decode
    # call combines
    cfg = model.cfg
    flash_split = flash_plan(
        MX_BATCH, MX_SEQ, cfg.num_heads, MX_SEQ, window=cfg.sliding_window,
        head_dim=cfg.resolved_head_dim).splits > 1
    ring_split = decode_plan(MX_BATCH, cfg.num_kv_heads,
                             cache["layers"]["k"].shape[2]).splits > 1
    check(combines == {"flash_attention": L * flash_split,
                       "decode_attention": L * MX_STEPS * ring_split},
          f"combines {combines}")
    emit({"phase": "moe_generate", "ok": True, "arch": model.cfg.name,
          "layers": L, "batch": MX_BATCH, "prompt_tokens": MX_SEQ,
          "window": model.cfg.sliding_window, "decode_steps": MX_STEPS,
          "launches": launches, "combine_launches": combines,
          "prefill_ms": prefill_ms,
          "median_decode_step_ms": statistics.median(step_ms),
          "decode_tokens_per_s": MX_BATCH * MX_STEPS / decode_s,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "first_tokens": toks[:, :4].tolist()})
    return launches


def moe_table_rows(torch, launches, errs):
    """The two kernels of the MoE path at its shapes, bf16: kernel, plain
    and library time beside the bound, device and cold-L2 times; flash
    also with ``window=0`` at the same shape (the work the window cuts)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention_kernel
    from repro_torch.kernels.decode_attention import plan_splits as decode_plan
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.flash_attention import plan_splits as flash_plan

    saved = (flash_attention_kernel.launches,
             decode_attention_kernel.launches)
    bf, elt = torch.bfloat16, 2
    B, S, H, Hkv, D, W = MX_BATCH, MX_SEQ, 32, 8, 128, 4096
    rows = []

    # the windowed causal prefill attention
    q, k, v = flash_inputs(torch, bf, S, S_q=S, H=H, Hkv=Hkv, D=D, B=B)
    def kfn():
        return flash_attention_kernel(q, k, v, causal=True, window=W)

    k_ms = time_ms(kfn, iters=20)
    w0_ms = time_ms(lambda: flash_attention_kernel(q, k, v, causal=True),
                    iters=20)
    w0_dev = queued_ms(lambda: flash_attention_kernel(q, k, v, causal=True),
                       10)
    p_ms = time_ms(lambda: ref.flash_attention(q, k, v, causal=True,
                                               window=W), iters=3, warmup=1)
    qt = q.transpose(1, 2)
    kt, vt = (x.transpose(1, 2).repeat_interleave(H // Hkv, 1)
              for x in (k, v))
    pos = torch.arange(S, device=q.device)
    band = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - W)
    def lfn():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=band)

    l_ms = time_ms(lfn, iters=10, warmup=2)
    plan = flash_plan(B, S, H, S, causal=True, window=W, head_dim=D)
    keys = window_keys(S, S, 0, W)
    n_bytes = (2 * q.numel() + 2 * k.numel()) * elt
    flops = 4 * B * H * D * keys
    b_ms, b_by = bound_ms(n_bytes, flops, "bfloat16")
    rows.append({"name": "flash_attention_mixtral", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
                 "replaces": "src/repro/kernels/flash_attention.py:85 "
                             "(window, :62-63)",
                 "launches": launches["flash_attention"],
                 "max_abs_err": errs["flash_attention_mixtral", "bfloat16"],
                 "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                 "bound_by": b_by, "library_ms": l_ms,
                 **device_timings(torch, kfn, lfn, n=10),
                 "window0_ms": w0_ms, "window0_dev_ms": w0_dev,
                 "keys_per_row": keys / S,
                 "library_note": "scaled_dot_product_attention, boolean "
                                 "band mask, K/V repeated to 32 heads "
                                 "outside the timing (timed only)",
                 "shape": f"B={B} S_q=S_kv={S} causal window={W} H={H} "
                          f"Hkv={Hkv} D={D} warpgroups={plan.consumers} "
                          f"key_tile={plan.keys} splits={plan.splits}",
                 "flops": flops, "bytes": n_bytes})
    del q, k, v, qt, kt, vt, band

    # decode over the wrapped ring: every row's 4096 slots valid
    lengths = [W] * B
    q, k, v, lens = decode_inputs(torch, bf, lengths, S_max=W, H=H, Hkv=Hkv,
                                  D=D)
    def dfn():
        return decode_attention_kernel(q, k, v, lens)

    k_ms = time_ms(dfn)
    p_ms = time_ms(lambda: ref.decode_attention(q, k, v, lens), iters=20)
    qt, kt, vt = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)
    def lfn():
        return F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True)

    l_ms = time_ms(lfn)
    plan = decode_plan(B, Hkv, W)
    n_rows = sum(lengths)
    n_bytes = (2 * q.numel() * elt + n_rows * Hkv * D * 2 * elt
               + lens.numel() * 4)
    b_ms, b_by = bound_ms(n_bytes, 4 * H * D * n_rows, "bfloat16")
    rows.append({"name": "decode_attention_mixtral_ring", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
                 "replaces": "src/repro/kernels/paged_attention.py:74",
                 "launches": launches["decode_attention"],
                 "max_abs_err": errs["decode_attention_ring", "bfloat16"],
                 "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                 "bound_by": b_by, "library_ms": l_ms,
                 **device_timings(torch, dfn, lfn),
                 "library_note": "scaled_dot_product_attention over the "
                                 "whole ring, enable_gqa=True (timed only)",
                 "shape": f"B={B} S_max=W={W} valid={W} H={H} Hkv={Hkv} "
                          f"D={D} splits={plan.splits} of "
                          f"{plan.block * plan.tiles_per_split} rows",
                 "bytes": n_bytes})
    flash_attention_kernel.launches, decode_attention_kernel.launches = saved
    return rows


def phase_moe_profile(torch, model, params, tokens, steps: int = 8):
    """Device time by kernel over one MoE prefill and over ``steps``
    greedy decode steps on the ring (torch.profiler)."""
    out = {"prefill": _profile_window(
        torch, lambda: model.prefill(params, {"tokens": tokens}))}
    logits, pc = model.prefill(params, {"tokens": tokens})
    cache = load_ring(torch, model, pc, MX_SEQ + MX_STEPS)
    del pc
    out["decode"] = _profile_decode(
        torch, model, params, logits, cache,
        _ring_batch(torch, tokens[:, -1:], MX_SEQ), steps)
    emit({"phase": "moe_profile", "ok": True, **out})

# ---------------------------------------------------------------------------
# the dense and MoE families on the paged engine at published width
# ---------------------------------------------------------------------------
FAMILIES = ("granite-3-8b", "minitron-4b", "phi3-mini-3.8b",
            "granite-moe-3b-a800m")
# the f32 checks run each config over its first 4 layers
FAM_F32_LAYERS = 4


def family_attention_inputs(torch, model, params):
    """Layer 0's q, K and V at full width in the compute dtype: 8
    sequences of 1024 random tokens through the embedding, the norm, the
    projections and RoPE."""
    import numpy as np

    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    cfg, dev = model.cfg, model.device
    lp = T._layer(params["layers"], 0)
    toks = np.random.RandomState(5).randint(1, cfg.vocab_size,
                                            (8, LAST_CHUNK_SWEEP))
    toks = torch.from_numpy(toks.astype(np.int32)).to(dev)
    a_in = L.apply_norm(lp["norm1"],
                        L.embed_tokens(params["embed"], toks, cfg), cfg)
    q, k, v = L._project_qkv(lp["attn"], a_in, cfg)
    pos = torch.arange(LAST_CHUNK_SWEEP, dtype=torch.int32, device=dev)
    return (L.apply_rope(q, pos, cfg.rope_theta),
            L.apply_rope(k, pos, cfg.rope_theta), v)


def phase_family_layer(torch, model, params, n_pool):
    """One full-width layer in bf16, kernel against plain on the same
    inputs: the chunk attention (the flash kernel: 128 queries at
    q_offset 768 over the 1024-key sweep) and one decode step's attention
    over the 8 slots' pages (the paged kernel: global ids, n_kv 8).
    Held to the absolute and row-relative 2e-2."""
    from repro_torch.kernels import ops

    q, k, v = family_attention_inputs(torch, model, params)
    dev = q.device
    off = LAST_CHUNK_OFFSET
    qc, kc, vc = q[1:2, off:off + 128], k[1:2], v[1:2]
    got = ops.flash_attention(qc, kc, vc, causal=True, q_offset=off)
    want = ops.flash_attention(qc, kc, vc, causal=True, q_offset=off,
                               impl="plain")
    out = {"flash": attention_errs(got, want, "bfloat16",
                                   f"{model.cfg.name} chunk")}
    # each slot's 1024 positions in its own pages 1 .. 8, named by global
    # ids; the query is each slot's last position
    B, S, Hkv, D = k.shape
    kp = torch.zeros((B, n_pool, 128, Hkv, D), dtype=k.dtype, device=dev)
    vp = torch.zeros_like(kp)
    kp[:, 1:9] = k.view(B, 8, 128, Hkv, D)
    vp[:, 1:9] = v.view(B, 8, 128, Hkv, D)
    table = torch.zeros((B, 9), dtype=torch.int32, device=dev)
    table[:, :8] = (torch.arange(B, device=dev)[:, None] * n_pool
                    + torch.arange(1, 9, device=dev)[None]).int()
    lens = torch.tensor(DECODE_LENGTHS, dtype=torch.int32, device=dev)
    qd = q[torch.arange(B, device=dev), lens.long() - 1]
    got = ops.paged_attention(qd, kp, vp, table, lens, n_kv=8,
                              global_pages=True)
    want = ops.paged_attention(qd, kp, vp, table, lens, n_kv=8,
                               global_pages=True, impl="plain")
    torch.cuda.synchronize()
    out["paged"] = attention_errs(got, want, "bfloat16",
                                  f"{model.cfg.name} decode")
    return out


def moe_chunk_drops(routes, cfg, n_layers):
    """(token, expert) pairs each chunk of a recorded engine run drops
    (its layers summed; chunk calls route (1, 128, k), the last chunk's
    pad rows included, as they take capacity), the same summed over the
    chunks layer by layer, and the pairs the decode calls drop."""
    chunk = [dropped_pairs(ids, cfg) for ids in routes
             if tuple(ids.shape[:2]) == (1, 128)]
    per_chunk = [sum(chunk[i:i + n_layers])
                 for i in range(0, len(chunk), n_layers)]
    per_layer = [sum(chunk[i::n_layers]) for i in range(n_layers)]
    decode = sum(dropped_pairs(ids, cfg) for ids in routes
                 if ids.shape[1] == 1)
    return per_chunk, per_layer, decode


def record_kept_routes(torch, model, fn):
    """``record_routes`` over an engine run on ``model``, each call's
    top-k ids beside the rows whose outputs the engine keeps: a chunk's
    rows up to its ``last_index`` (the last chunk's pad rows are
    dropped), a decode step's active slots (a nonzero first page).  One
    mask a model call, whose layers route in turn.

    An idle slot's decode row is not a function of the run's inputs: its
    block-table row is zeroed, so every idle slot writes its K/V to the
    same row (row 0 of global page 0, a scratch page) with one
    ``index_put_`` whose winner on duplicate indices the card does not
    fix, and then attends over that one key.  Its hidden state, and so
    its route, is whichever idle slot's write landed, in any two runs;
    its output is discarded (the JAX package does the same)."""
    kept = []
    chunk, decode = model.prefill_chunk, model.decode_step

    def chunk_kept(params, cache, batch, **kw):
        rows = torch.arange(batch["tokens"].shape[1],
                            device=batch["tokens"].device)
        kept.append((rows <= int(batch["last_index"]))[None])
        return chunk(params, cache, batch, **kw)

    def decode_kept(params, cache, batch, **kw):
        kept.append(batch["block_table"][:, :1] != 0)
        return decode(params, cache, batch, **kw)

    model.prefill_chunk, model.decode_step = chunk_kept, decode_kept
    try:
        out, routes = record_routes(fn)
    finally:
        del model.prefill_chunk, model.decode_step
    n = model.cfg.num_layers
    return out, [(ids, kept[i // n]) for i, ids in enumerate(routes)]


def kept_route_flips(a, b) -> dict:
    """Routing flips between two recorded runs (``record_kept_routes``):
    on the rows the engine keeps, on idle slots' decode rows and on the
    last chunks' pad rows."""
    out = {"kept": 0, "idle_decode_rows": 0, "chunk_pad_rows": 0}
    for (ia, ka), (ib, _) in zip(a, b):
        flip = (ia.sort(-1).values != ib.sort(-1).values).any(-1)
        out["kept"] += int((flip & ka).sum())
        gone = "idle_decode_rows" if ia.shape[1] == 1 else "chunk_pad_rows"
        out[gone] += int((flip & ~ka).sum())
    return out


def family_table_rows(torch, cfg, n_pool, launches, errs):
    """The paged (global ids) and causal flash chunk kernels at one
    family's engine shapes, as the qwen2 rows."""
    heads = dict(H=cfg.num_heads, Hkv=cfg.num_kv_heads,
                 D=cfg.resolved_head_dim)
    short = cfg.name.split("-")[0] if cfg.family == "dense" else "granite_moe"
    label = f"{cfg.name} "
    return [
        paged_row(torch, f"paged_attention_{short}", DECODE_LENGTHS,
                  n_pool=n_pool, **heads, label=label, fields={
                      "launches": launches["paged_attention"],
                      "combine_launches": launches["paged_combines"],
                      **errs["paged"]}),
        flash_chunk_row(torch, f"flash_attention_{short}", LAST_CHUNK_OFFSET,
                        LAST_CHUNK_SWEEP, **heads, label=label, fields={
                            "launches": launches["flash_attention"],
                            "combine_launches": launches["flash_combines"],
                            **errs["flash"]})]


def phase_family_engine(torch, name, profile=False):
    """One config of the dense or MoE family at published width, bf16,
    seeded and conditioned weights: one full-width layer's chunk and
    decode attention kernel against plain; the greedy cell's 8 requests
    through a ``ServingEngine`` (a warm-up run, then the counted run:
    launches against layers x chunks and layers x decode dispatches,
    every call split and combined, 0 unreclaimed after ``drain()``);
    for the MoE the (token, expert) pairs each chunk drops and the
    launches of one ``apply_moe`` on a chunk; then the config over its
    first 4 layers in f32, the engine on the kernels against the engine
    on the plain versions, token for token (routing flips counted for
    the MoE, and between two runs on the kernels).  With ``profile``, 8
    steps of one more engine run in a torch.profiler window give the
    device's busy share and time by kernel.  Returns the two kernel
    rows."""
    from repro_torch.configs import ARCHS, ShapeConfig
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.paged_attention import paged_attention_kernel
    from repro_torch.models import Model
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = ARCHS[name]
    moe = cfg.family == "moe"
    model = Model(cfg)
    seeded = model.init_params(seed=0)
    params = model.compute_params(conditioned(model, seeded))
    del seeded  # the f32 seed tree goes before anything else runs
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t_phase
    init_peak = torch.cuda.max_memory_allocated()
    n_pool = model.cache_specs(ShapeConfig(
        "engine", "decode", 1024, 8))["layers"]["k_pool"].shape[2]
    errs = phase_family_layer(torch, model, params, n_pool)
    ps = prompts(cfg.vocab_size)
    kernels = (paged_attention_kernel, flash_attention_kernel)

    # warm-up run (allocator, cuBLAS handles), not counted; the MoE's
    # routes are recorded here, where the host syncs cost nothing counted
    (_, wreqs, _, _), routes = record_routes(
        lambda: run_engine(torch, model, params, prompt_list=ps))
    _reset(kernels)
    eng, reqs, wall, step_ms = run_engine(torch, model, params,
                                          prompt_list=ps)
    launches = {"paged_attention": paged_attention_kernel.launches,
                "flash_attention": flash_attention_kernel.launches,
                "paged_combines": paged_attention_kernel.combine_launches,
                "flash_combines": flash_attention_kernel.combine_launches}
    st = eng.stats()
    n_layers = cfg.num_layers
    check(all(r.done and len(r.generated) == 32 for r in reqs),
          f"{name}: not every request finished with 32 tokens")
    check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.generated),
          f"{name}: token out of vocabulary range")
    check(st["dispatches_per_step"] == 1, f"{name}: dispatches/step {st}")
    want = {"paged_attention": n_layers * st["decode_dispatches"],
            "flash_attention": n_layers * st["prefill_chunks"]}
    check(all(launches[k] == v and v > 0 for k, v in want.items()),
          f"{name}: launches {launches} vs {want}")
    # at these heads every n_kv bucket and every chunk splits the keys
    check(launches["paged_combines"] == launches["paged_attention"]
          and launches["flash_combines"] == launches["flash_attention"],
          f"{name}: combines {launches}")
    check(st["pool_unreclaimed"] == 0, f"{name}: pages left unreclaimed")
    out = {"phase": "families_engine", "ok": True, "arch": name,
           "family": cfg.family, "params": model.n_params(),
           "init_s": init_s, "init_peak_mem_gb": init_peak / 1e9,
           "layer_parity": errs, "requests": len(reqs),
           "wall_s": wall, "decode_tokens_per_s": st["tokens_emitted"] / wall,
           "median_step_ms": statistics.median(step_ms),
           "steps": st["steps"], "decode_dispatches": st["decode_dispatches"],
           "prefill_chunks": st["prefill_chunks"],
           "launches": launches, "expected_launches": want,
           "host_us_per_step": st["host_us_per_step"],
           "pool": {k: st[k] for k in ("free_pages", "pool_unreclaimed",
                                       "pool_freed", "scan_steps",
                                       "prefix_hits", "prefix_misses")},
           "repeat_tokens_identical": ([r.generated for r in reqs]
                                       == [r.generated for r in wreqs])}
    check(out["repeat_tokens_identical"],
          f"{name}: the counted run's tokens differ from the warm-up's")
    if moe:
        per_chunk, per_layer, decode_drops = moe_chunk_drops(routes, cfg,
                                                             n_layers)
        check(decode_drops == 0, f"{name}: decode dropped {decode_drops}")
        check(len(per_chunk) == st["prefill_chunks"],
              f"{name}: {len(per_chunk)} routed chunks")
        pairs = 128 * cfg.experts_per_token * n_layers
        out["moe"] = {
            "capacity_per_expert_chunk": min(max(int(
                cfg.moe_capacity_factor * 128 * cfg.experts_per_token
                / cfg.num_experts), cfg.experts_per_token),
                128 * cfg.experts_per_token),
            "dropped_pairs_per_chunk": per_chunk,
            "dropped_pairs_per_layer": per_layer,
            "pairs_per_chunk": pairs,
            "dropped_share": sum(per_chunk) / (pairs * len(per_chunk)),
            "decode_dropped": decode_drops}
        x = torch.randn((1, 128, cfg.d_model), device=model.device).to(
            torch.bfloat16)
        lp = T._layer(params["layers"], 0)
        prof = _profile_window(torch, lambda: L.apply_moe(lp["moe"], x, cfg))
        out["moe"]["apply_moe_chunk"] = {
            k: prof[k] for k in ("wall_s", "device_busy_s",
                                 "kernel_launches")}
    del routes, wreqs
    if profile:
        out["profile"] = profile_engine_steps(torch, model, params, ps)
    rows = family_table_rows(torch, cfg, n_pool, launches, errs)
    del eng, params, model
    torch.cuda.empty_cache()

    # f32 over the first 4 layers: kernels against plain, token for token
    model32 = Model(cfg.scaled(num_layers=FAM_F32_LAYERS, dtype="float32"))
    params32 = conditioned(model32, model32.init_params(seed=0))
    # the MoE runs the kernels twice: flips between two runs of the same
    # code show what is not a function of the inputs (idle slots' rows)
    toks, rts = {}, {}
    for run, impl in (("kernels", None), ("plain", "plain"),
                      ("kernels_again", None))[:3 if moe else 2]:
        (_, r32, _, _), rts[run] = record_kept_routes(
            torch, model32,
            lambda impl=impl: run_engine(torch, model32, params32,
                                         impl=impl, prompt_list=ps))
        toks[run] = [r.generated for r in r32]
    f32 = {"layers": FAM_F32_LAYERS,
           "tokens": sum(map(len, toks["kernels"])),
           "identical": toks["kernels"] == toks["plain"],
           "first_diffs": {i: next(j for j, (x, y) in enumerate(zip(a, b))
                                   if x != y)
                           for i, (a, b) in enumerate(zip(toks["kernels"],
                                                          toks["plain"]))
                           if a != b}}
    if moe and f32["identical"]:  # the same calls in the same order
        f32["routing_flips"] = kept_route_flips(rts["kernels"], rts["plain"])
        f32["routing_flips_kernels_twice"] = kept_route_flips(
            rts["kernels"], rts["kernels_again"])
        f32["routed_rows_kept"] = sum(int(k.sum()) for _, k in rts["plain"])
        check(toks["kernels_again"] == toks["kernels"],
              f"{name}: two f32 runs on the kernels differ")
    out["f32"] = f32
    del model32, params32, rts
    torch.cuda.empty_cache()
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    check(f32["identical"], f"{name}: f32 tokens differ, kernels against "
                            f"plain: {f32['first_diffs']}")
    return rows


def profile_engine_steps(torch, model, params, prompt_list, skip=8,
                         steps=8):
    """Device time by kernel over ``steps`` engine steps in one
    torch.profiler window, after ``skip`` unprofiled steps, of the greedy
    cell's requests (``run_engine``'s engine): at step 9 of about 64 the
    window holds prefill chunks and decode dispatches both.  The engine
    then runs to its end unprofiled."""
    from repro_torch.serving import ServingEngine

    eng = ServingEngine(model, max_slots=8, max_seq=1024,
                        prefix_cache_entries=16, params=params,
                        device=model.device, policy="stamp-it")
    for p in prompt_list:
        eng.submit(p, max_new_tokens=32)
    for _ in range(skip):
        eng.step()
    before = eng.stats()
    out = _profile_window(torch, lambda: [eng.step() for _ in range(steps)])
    after = eng.stats()
    out.update({"steps": steps, "after_steps": skip,
                **{k: after[k] - before[k]
                   for k in ("prefill_chunks", "decode_dispatches")}})
    eng.run_until_done()
    eng.drain()
    return out


def _profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _device_rows(prof):
    """(device µs, kernel name, calls) of each device-side event, largest
    first.  Operator events are left out: they would count their kernels
    twice."""
    from torch.autograd import DeviceType

    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        rows.append((dev_us, ev.key, ev.count))
    rows.sort(reverse=True)
    return rows


def _profile_window(torch, fn) -> dict:
    """Device time by kernel over one call of ``fn`` (torch.profiler),
    against the call's wall time."""
    torch.cuda.synchronize()
    with _profiler() as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = _device_rows(prof)
    busy_s = sum(r[0] for r in rows) / 1e6
    return {"wall_s": wall, "device_busy_s": busy_s,
            "busy_share_profiled": busy_s / wall,
            "kernel_launches": sum(r[2] for r in rows),
            **_split_attention_ms(rows),
            "top": [{"kernel": k[:80], "device_ms": us / 1e3, "calls": n}
                    for us, k, n in rows[:10]]}


def _split_attention_ms(rows) -> dict:
    """Device ms of the decode body by address rule (the paged kernel's
    split kernel, the contiguous one's) and of the split combine, which
    the paged, decode and flash kernels share.  The combine is launched to
    overlap the split kernel before it, so its span includes its wait."""
    out = {"paged_split_ms": 0.0, "decode_split_ms": 0.0, "combine_ms": 0.0}
    for us, key, _ in rows:
        for name, part in (("paged_split_ms", "PagedRows"),
                           ("decode_split_ms", "ContiguousRows"),
                           ("combine_ms", "combine_splits_kernel")):
            if part in key:
                out[name] += us / 1e3
    return out


def _profile_decode(torch, model, params, logits, cache, batch, steps):
    """``steps`` greedy decode steps from ``logits`` in one profiled
    window; ``batch`` holds any inputs besides the tokens (lengths
    advance by one a step when present)."""
    out = _profile_window(torch, lambda: greedy_decode(
        torch, model, params, logits, cache, batch, steps))
    out["steps"] = steps
    return out


def phase_ssm_profile(torch, model, params, tokens, steps: int = 8):
    """Device time by kernel over one SSM prefill and over ``steps``
    greedy decode steps (torch.profiler), each against its wall time."""
    batch = {"tokens": tokens}
    out = {"prefill": _profile_window(
        torch, lambda: model.prefill(params, batch))}
    logits, pc = model.prefill(params, batch)
    cache = load_decode_cache(torch, model, pc, SSM_BATCH)
    del pc
    out["decode"] = _profile_decode(torch, model, params, logits, cache, {},
                                    steps)
    emit({"phase": "ssm_profile", "ok": True, **out})


def phase_encdec_profile(torch, model, params, enc, toks, table,
                         steps: int = 8):
    """Device time by kernel over one encoder-decoder prefill and over
    ``steps`` greedy decode steps (torch.profiler)."""
    batch = {"enc_embeds": enc, "tokens": toks}
    out = {"prefill": _profile_window(
        torch, lambda: model.prefill(params, batch))}
    logits, pc = model.prefill(params, batch)
    cache = load_encdec_cache(torch, model, pc, table)
    del pc
    lengths = torch.full((ED_BATCH,), ED_PROMPT, dtype=torch.int32,
                         device=model.device)
    out["decode"] = _profile_decode(
        torch, model, params, logits, cache,
        {"lengths": lengths, "block_table": table}, steps)
    emit({"phase": "encdec_profile", "ok": True, **out})


def phase_profile(torch, model, params, wall_unprofiled: float):
    """Device time by kernel over one whole engine run (torch.profiler).
    Only device-side events count (operator events would count their
    kernels twice); the busy share is given against the profiled wall
    time and against the unprofiled run's."""
    with _profiler() as prof:
        t0 = time.perf_counter()
        eng, _, _, _ = run_engine(torch, model, params)
        wall = time.perf_counter() - t0
    rows = _device_rows(prof)
    busy_s = sum(r[0] for r in rows) / 1e6
    emit({"phase": "profile", "ok": True, "wall_s": wall,
          "wall_unprofiled_s": wall_unprofiled, "device_busy_s": busy_s,
          "busy_share_profiled": busy_s / wall,
          "busy_share_vs_unprofiled_wall": busy_s / wall_unprofiled,
          "kernel_launches": sum(r[2] for r in rows),
          "engine_steps": eng.steps, **_split_attention_ms(rows),
          "top": [{"kernel": k[:80], "device_ms": us / 1e3, "calls": n}
                  for us, k, n in rows[:12]]})


# ---------------------------------------------------------------------------
# the vlm path: llava-next-34b
# ---------------------------------------------------------------------------
# llava-next-34b at full width over 16 of its 60 layers (9.8 B parameters:
# the f32 seed tree, 39 GB, and its bf16 copy, 20 GB, fit the card
# together; its 60 layers are 67 GB in bf16 alone): 4 requests of 1152
# frontend embeddings (the vision stub: 2 tiles x 576 patches) followed by
# 896 text tokens, then 32 greedy steps on per-slot pages.  The f32 checks
# run its first 4 layers.
VL_LAYERS, VL_BATCH, VL_TOKENS, VL_STEPS, VL_F32_LAYERS = 16, 4, 896, 32, 4
VL_FRONT = 1152  # llava-next-34b's frontend_positions
VL_SEQ = VL_FRONT + VL_TOKENS
VL_MAX_SEQ = VL_SEQ + VL_STEPS
# f32 compute, kernels vs plain and prefill+decode vs prefill: held to
# 1e-3 of the largest magnitude through 4 layers
VL_F32_REL_TOL = 1e-3


def vlm_inputs(torch, cfg, batch=VL_BATCH, seed=6):
    """Seeded frontend embeddings (normal x 0.02, as the synthetic
    pipeline makes them) and text tokens, on the card."""
    import numpy as np

    g = torch.Generator(device="cuda").manual_seed(seed)
    fe = torch.randn((batch, cfg.frontend_positions, cfg.d_model),
                     generator=g, device="cuda") * 0.02
    toks = np.random.RandomState(seed).randint(1, cfg.vocab_size,
                                               (batch, VL_TOKENS))
    return fe, torch.from_numpy(toks.astype(np.int32)).cuda()


def vlm_table(torch, model, batch=VL_BATCH):
    """Per-slot page ids of the decode cache: a different permutation of
    each slot's pool in each row."""
    from repro_torch.configs import ShapeConfig

    pool = model.cache_specs(ShapeConfig("serve", "decode", VL_MAX_SEQ,
                                         batch))
    n_pool = pool["layers"]["k_pool"].shape[2]
    return local_table(torch, batch, n_pool, -(-VL_MAX_SEQ // 128) + 1,
                       seed=6)


def load_vlm_cache(torch, model, pcache, table):
    """The prefill K/V (L, B, S, Hkv, D) in the paged decode cache, page
    by page into the per-slot pages each block-table row names (the last
    page zero-padded)."""
    from repro_torch.configs import ShapeConfig

    B = table.shape[0]
    cache = model.init_cache(ShapeConfig("serve", "decode", VL_MAX_SEQ, B))
    pages = table.tolist()
    S = pcache["k"].shape[2]
    for j in range(-(-S // 128)):
        for name, pool in (("k", "k_pool"), ("v", "v_pool")):
            seg = pcache[name][:, :, j * 128:(j + 1) * 128]
            for b in range(B):
                cache["layers"][pool][:, b, pages[b][j], :seg.shape[2]] = \
                    seg[:, b]
    return cache


def phase_vlm_kernel_parity(torch):
    """The flash kernel at llava's prefill shape (4 x 2048 positions, 56
    query heads over 8 kv heads of 128, causal) and the paged kernel with
    per-slot pages at its decode shape (G 7, D 128, 17 pages of a 32-page
    pool), f32 and bf16, against the plain versions."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_kernel

    S = VL_SEQ
    rows, errs = [], {}
    for dname in ("float32", "bfloat16"):
        q, k, v = flash_inputs(torch, getattr(torch, dname), S, S_q=S, H=56,
                               Hkv=8, D=128, B=VL_BATCH)
        got = flash_attention_kernel(q, k, v, causal=True)
        want = ref.flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        case = attention_errs(got, want, dname, "flash llava prefill")
        rows.append({"kernel": "flash_attention", "dtype": dname,
                     "case": f"B={VL_BATCH} S_q=S_kv={S} causal H=56 Hkv=8 "
                             f"D=128", **case})
        errs["flash_attention_llava", dname] = case["max_abs_err"]
        del q, k, v, got, want
        shape = dict(n_pool=32, mb=18, H=56, Hkv=8, D=128)
        lengths = [VL_MAX_SEQ, S + 1, VL_FRONT + 1, 2000]
        rows.append(per_slot_case(torch, dname, shape, 18, lengths))
        errs["paged_attention_llava", dname] = rows[-1]["max_abs_err"]
    emit({"phase": "vlm_kernel_parity", "ok": True, "cases": rows})
    return errs


def phase_vlm_init(torch):
    """llava over VL_LAYERS layers: the seeded f32 tree with conditioned
    attention (the f32 checks run before the bf16 copy is cast from it),
    the inputs and the block table."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import Model

    t0 = time.perf_counter()
    cfg = ARCHS["llava-next-34b"]
    check(cfg.frontend_positions == VL_FRONT, "llava's frontend positions")
    model = Model(cfg.scaled(num_layers=VL_LAYERS))
    params32 = conditioned(model, model.init_params(seed=0))
    fe, toks = vlm_inputs(torch, model.cfg)
    table = vlm_table(torch, model)
    torch.cuda.synchronize()
    emit({"phase": "vlm_init", "ok": True, "arch": cfg.name,
          "layers": f"{VL_LAYERS} of {cfg.num_layers}",
          "params": model.n_params(), "seconds": time.perf_counter() - t0,
          "block_table": table.tolist(),
          "mem_gb": torch.cuda.memory_allocated() / 1e9})
    return model, params32, fe, toks, table


def phase_vlm_layers(torch, model, params, fe, toks, table):
    """Layer by layer at full width, bf16, each layer's kernels and plain
    versions on the SAME input (the plain path's hidden state): the
    causal attention over the 2048 positions (flash) and, on the loaded
    cache, one decode step's attention over each slot's pages (paged,
    per-slot ids).  Held to 4 bf16 ulps of the largest magnitude and row
    by row to ROW_REL_TOL."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    cfg = model.cfg
    worst = {}

    def hold(kind, i, got, want):
        e, scale = max_err(got, want), float(want.float().abs().max())
        check(e <= 4 * bf16_ulp(scale),
              f"{kind} {i}: err {e} at scale {scale}")
        r = row_rel_err(got, want)
        check(r <= ROW_REL_TOL, f"{kind} {i}: row-relative err {r}")
        w = worst.get(kind, {"rel": -1.0})
        if e / scale > w["rel"]:
            worst[kind] = {"max_abs_err": e, "max_abs": scale,
                           "rel": e / scale, "row_rel": r, "layer": i}

    h = T._embed_inputs(params, {"tokens": toks, "frontend_embeds": fe}, cfg)
    ks, vs = [], []
    for i in range(cfg.num_layers):
        lp = T._layer(params["layers"], i)
        a_in = L.apply_norm(lp["norm1"], h, cfg)
        res = [L.attention_full(lp["attn"], a_in, cfg, causal=True,
                                impl=impl) for impl in (None, "plain")]
        hold("attention_prefill", i, res[0][0], res[1][0])
        h = T._mlp_or_moe(lp, h + res[1][0], cfg)
        ks.append(res[1][1][0])
        vs.append(res[1][1][1])
        del res
    S = h.shape[1]
    cache = load_vlm_cache(torch, model, {"k": torch.stack(ks),
                                          "v": torch.stack(vs)}, table)
    del ks, vs
    lens = torch.full((VL_BATCH,), S, dtype=torch.int32, device="cuda")
    h = L.embed_tokens(params["embed"], toks[:, -1:], cfg)
    for i in range(cfg.num_layers):
        lp = T._layer(params["layers"], i)
        a_in = L.apply_norm(lp["norm1"], h, cfg)
        # both write the same new K/V row before attending
        outs = [L.attention_decode(lp["attn"], a_in, cfg,
                                   T._layer(cache["layers"], i), lens,
                                   block_table=table, impl=impl)[0]
                for impl in (None, "plain")]
        hold("attention_decode_paged", i, outs[0], outs[1])
        h = T._mlp_or_moe(lp, h + outs[1], cfg)
    torch.cuda.synchronize()
    emit({"phase": "vlm_layers", "ok": True, "arch": cfg.name,
          "batch": VL_BATCH, "positions": S,
          "tol": f"4 bf16 ulps of max|out|, row by row {ROW_REL_TOL}",
          "worst": worst})


def _vlm_prefill_pair(torch, model, params, batch):
    logits_k, cache_k = model.prefill(params, batch)
    logits_p, cache_p = model.prefill(params, batch, impl="plain")
    torch.cuda.synchronize()
    check(bool(torch.isfinite(logits_k).all()), "non-finite prefill logits")
    caches = {k: rel_err(cache_k[k], cache_p[k]) for k in ("k", "v")}
    return _logit_err(logits_k, logits_p), caches, logits_p, cache_p


def phase_vlm_model(torch, params32, fe, toks):
    """llava's first VL_F32_LAYERS layers in f32 compute: prefill logits
    and K/V through the kernels against the plain versions, teacher
    forcing (prefill of 2047 positions + one decode step against the
    prefill of 2048), and VL_STEPS greedy tokens through the kernels
    identical to those through the plain versions."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import Model
    from repro_torch.models.param import tree_map

    model = Model(ARCHS["llava-next-34b"].scaled(num_layers=VL_F32_LAYERS,
                                                 dtype="float32"))
    params = dict(params32, layers=tree_map(lambda t: t[:VL_F32_LAYERS],
                                            params32["layers"]))
    table = vlm_table(torch, model)
    batch = {"frontend_embeds": fe, "tokens": toks}
    logits, caches, plain, pcache = _vlm_prefill_pair(torch, model, params,
                                                      batch)
    check(logits["rel"] <= VL_F32_REL_TOL, f"f32 logits {logits}")
    for k, e in caches.items():
        check(e["rel"] <= VL_F32_REL_TOL, f"f32 cache {k} {e}")
    S = VL_SEQ
    # teacher forcing: the last text token by one decode step
    _, pc = model.prefill(params, dict(batch, tokens=toks[:, :-1]))
    cache = load_vlm_cache(torch, model, pc, table)
    del pc
    got, _ = model.decode_step(params, cache, _decode_batch(
        torch, toks[:, -1:], table, S - 1))
    tf = _logit_err(got, plain)
    check(tf["rel"] <= VL_F32_REL_TOL, f"f32 teacher forcing {tf}")
    runs = {}
    for impl in (None, "plain"):
        cache = load_vlm_cache(torch, model, pcache, table)
        runs[impl], _, _ = greedy_decode(
            torch, model, params, plain, cache,
            _decode_batch(torch, None, table, S), VL_STEPS, impl=impl)
    same = bool(torch.equal(runs[None], runs["plain"]))
    check(same, f"f32 greedy tokens differ: {runs[None][:, :8].tolist()} vs "
                f"{runs['plain'][:, :8].tolist()}")
    emit({"phase": "vlm_model", "ok": True, "layers": VL_F32_LAYERS,
          "batch": VL_BATCH, "positions": S, "tol_rel_f32": VL_F32_REL_TOL,
          "f32": {"prefill_logits": logits, "caches": caches,
                  "teacher_forcing_2047_plus_1": tf,
                  "greedy_tokens_identical": same, "steps": VL_STEPS},
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})


def phase_vlm_generate(torch, model, params, fe, toks, table):
    """The main vlm path with the launch counts set to 0: one prefill of
    the 4 requests (frontend embeddings + text; VL_LAYERS flash calls),
    the K/V loaded into per-slot pages, VL_STEPS greedy decode steps
    (VL_LAYERS paged calls each)."""
    from repro_torch.kernels.decode_attention import decode_attention_kernel
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.paged_attention import paged_attention_kernel

    kernels = {"flash_attention": flash_attention_kernel,
               "paged_attention": paged_attention_kernel,
               "decode_attention": decode_attention_kernel}
    L = model.cfg.num_layers
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset(kernels.values())
    t0 = time.perf_counter()
    logits, pc = model.prefill(params, {"frontend_embeds": fe,
                                        "tokens": toks})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    S = pc["k"].shape[2]
    check(S == VL_SEQ, f"cache positions {S}")
    at_prefill = {n: k.launches for n, k in kernels.items()}
    check(at_prefill == {"flash_attention": L, "paged_attention": 0,
                         "decode_attention": 0},
          f"prefill launches {at_prefill}: want {L} flash calls")
    cache = load_vlm_cache(torch, model, pc, table)
    del pc
    toks_out, step_ms, decode_s = greedy_decode(
        torch, model, params, logits, cache,
        _decode_batch(torch, None, table, S), VL_STEPS)
    launches = {n: k.launches for n, k in kernels.items()}
    want = dict(at_prefill, paged_attention=L * VL_STEPS)
    check(launches == want, f"launches {launches}, want {want}")
    combines = {"flash_attention": flash_attention_kernel.combine_launches,
                "paged_attention": paged_attention_kernel.combine_launches}
    emit({"phase": "vlm_generate", "ok": True, "arch": model.cfg.name,
          "batch": VL_BATCH, "frontend_positions": fe.shape[1],
          "text_tokens": toks.shape[1], "decode_steps": VL_STEPS,
          "launches": launches, "combine_launches": combines,
          "prefill_ms": prefill_ms,
          "median_decode_step_ms": statistics.median(step_ms),
          "decode_tokens_per_s": VL_BATCH * VL_STEPS / decode_s,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "first_tokens": toks_out[:, :4].tolist()})
    return launches


def vlm_table_rows(torch, launches, errs):
    """llava's two kernels at its shapes, bf16: the causal prefill flash
    (4 x 2048 positions, 56 heads over 8 of 128) and the per-slot paged
    decode at the last step (2080 positions a slot, G 7, D 128)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.flash_attention import plan_splits as flash_plan
    from repro_torch.kernels.paged_attention import paged_attention_kernel

    saved = (flash_attention_kernel.launches, paged_attention_kernel.launches)
    bf, elt = torch.bfloat16, 2
    B, S, H, Hkv, D = VL_BATCH, VL_SEQ, 56, 8, 128
    rows = []
    q, k, v = flash_inputs(torch, bf, S, S_q=S, H=H, Hkv=Hkv, D=D, B=B)

    def kfn():
        return flash_attention_kernel(q, k, v, causal=True)

    k_ms = time_ms(kfn, iters=20)
    p_ms = time_ms(lambda: ref.flash_attention(q, k, v, causal=True),
                   iters=3, warmup=1)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def lfn():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    l_ms = time_ms(lfn, iters=20)
    plan = flash_plan(B, S, H, S, causal=True, head_dim=D)
    n_bytes = (2 * q.numel() + 2 * k.numel()) * elt
    flops = 4 * B * H * D * (S * (S + 1) // 2)
    b_ms, b_by = bound_ms(n_bytes, flops, "bfloat16")
    rows.append({"name": "flash_attention_llava", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
                 "replaces": "src/repro/kernels/flash_attention.py:85",
                 "launches": launches["flash_attention"],
                 "max_abs_err": errs["flash_attention_llava", "bfloat16"],
                 "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                 "bound_by": b_by, "library_ms": l_ms,
                 **device_timings(torch, kfn, lfn, n=10),
                 "library_note": "scaled_dot_product_attention, "
                                 "is_causal=True, enable_gqa=True (timed "
                                 "only)",
                 "shape": f"B={B} S_q=S_kv={S} causal H={H} Hkv={Hkv} D={D} "
                          f"warpgroups={plan.consumers} key_tile={plan.keys} "
                          f"splits={plan.splits}",
                 "flops": flops, "bytes": n_bytes})
    del q, k, v, qt, kt, vt

    n_pool, mb = 32, 18
    lengths = [VL_MAX_SEQ] * B
    q, kp, vp, _, lens = paged_inputs(torch, bf, lengths, n_pool=n_pool,
                                      mb=mb, H=H, Hkv=Hkv, D=D)
    table = local_table(torch, B, n_pool, mb)

    def pfn():
        return paged_attention_kernel(q, kp, vp, table, lens)

    k_ms = time_ms(pfn)
    p_ms = time_ms(lambda: ref.paged_attention(q, kp, vp, table, lens))
    n_rows = sum(lengths)
    n_bytes = (2 * q.numel() * elt + n_rows * Hkv * D * 2 * elt
               + table.numel() * 4 + lens.numel() * 4)
    b_ms, b_by = bound_ms(n_bytes, 4 * H * D * n_rows, "bfloat16")
    rows.append({"name": "paged_attention_per_slot_llava", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
                 "replaces": "src/repro/kernels/paged_attention.py:128 "
                             "(global_pages=False, :171-177)",
                 "launches": launches["paged_attention"],
                 "max_abs_err": errs["paged_attention_llava", "bfloat16"],
                 "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                 "bound_by": b_by, "library_ms": None,
                 **device_timings(torch, pfn),
                 "plan": paged_plan_fields(B, Hkv, mb, lengths),
                 "library_note": "no single PyTorch call attends over pages "
                                 "named by a block table",
                 "shape": f"B={B} n_pool={n_pool} lengths={lengths[0]} "
                          f"H={H} Hkv={Hkv} D={D} per-slot ids",
                 "bytes": n_bytes})
    flash_attention_kernel.launches, paged_attention_kernel.launches = saved
    return rows


# ---------------------------------------------------------------------------
# the training plane: flash attention's backward kernel and the Trainer
# ---------------------------------------------------------------------------
# the backward kernel against autograd of the plain version: (name, B,
# S_q, S_kv, H, Hkv, D, causal, window) — qwen2's train shape, D 128 at
# G 4, phi3's D 96 and zamba2's D 112 (the run-time-D range; also at its
# train shape, B 2 x 4096), the encoder's non-causal shape, a 4096-key
# window whose edges cut key tiles mid-tile, and examples/train_lm_torch.py's
# shape (B 8 x 128, 12 heads on 2 KV heads, so G 6)
BWD_SHAPES = (
    ("qwen2_train", 2, 4096, 4096, 14, 2, 64, True, 0),
    ("d128_g4", 1, 2048, 2048, 32, 8, 128, True, 0),
    ("phi3_d96", 1, 1024, 1024, 32, 32, 96, True, 0),
    ("zamba2_d112", 1, 1024, 1024, 32, 32, 112, True, 0),
    ("zamba2_train", 2, 4096, 4096, 32, 32, 112, True, 0),
    ("encoder_noncausal", 2, 1024, 1024, 16, 16, 64, False, 0),
    ("window_4096", 1, 4672, 4672, 8, 2, 128, True, 4096),
    ("train_lm_g6", 8, 128, 128, 12, 2, 64, True, 0),
)
# each gradient's largest error over its largest magnitude: f32 sums in
# another order than the plain autograd; bf16 rounds the gradients (an ulp
# is 2**-8 of a value) and the plain forward rounds its softmax weights to
# bf16 before P.V, which its autograd differentiates through
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# qwen2-0.5b's train cell train_4k: sequences of 4096; the batch is cut
# from 256 to 2 (one card, no accumulation).  8 steps, a checkpoint every
# 4, a failure injected before step 6 (restored from step 3's checkpoint,
# steps 4 and 5 replayed).
TR_SEQ, TR_BATCH, TR_STEPS, TR_CKPT_EVERY, TR_FAIL_AT = 4096, 2, 8, 4, 6
# f32 over 4 layers, one step through the kernels against one through the
# plain versions: loss and grad norm to 1e-5 relative, every gradient
# leaf to 1e-4 of its largest magnitude (f32 sums in other orders through
# 4 layers and the 151936-way log-sum-exp)
TR_F32_LAYERS, TR_F32_LOSS_TOL, TR_F32_GRAD_TOL = 4, 1e-5, 1e-4


def bwd_inputs(torch, dtype, B, S_q, S_kv, H, Hkv, D, seed=11):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, device="cuda").to(dtype)
                 for shape in ((B, S_q, H, D), (B, S_kv, Hkv, D),
                               (B, S_kv, Hkv, D), (B, S_q, H, D)))


def plain_grads(torch, q, k, v, do, **kw):
    """(out, dq, dk, dv) by autograd of the plain version."""
    from repro_torch.kernels import ref

    q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))
    with torch.enable_grad():
        out = ref.flash_attention(q, k, v, **kw)
        grads = torch.autograd.grad(out, (q, k, v), do)
    return (out.detach(),) + grads


def grad_errs(got, want, dname):
    """Per gradient: the largest error, it over the largest magnitude
    (held to BWD_TOL), and the row-relative error over the rows whose
    largest magnitude is at least 1% of the gradient's (reported; a
    causal dQ's first row is 0 in exact arithmetic)."""
    out = {}
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        e, scale = max_err(a, b), float(b.float().abs().max())
        rows = b.float().abs().amax(-1) >= 0.01 * scale
        out[name] = {"max_abs_err": e, "max_abs": scale, "rel": e / scale,
                     "row_rel_err": row_rel_err(a[rows], b[rows])}
    out["ok"] = all(out[n]["rel"] <= BWD_TOL[dname] for n in ("dq", "dk",
                                                              "dv"))
    return out


def phase_flash_bwd_parity(torch):
    """The backward kernels, fed by the forward kernel's row statistics,
    against autograd of the plain version at BWD_SHAPES, f32 and bf16;
    two bf16 runs at each shape bit for bit equal; and three planted
    faults that the check must catch: a kernel that drops the last member
    of each GQA group (its dK and dV: the kernel's on an output gradient
    with those heads zeroed), one whose window mask keeps one key too
    many (the kernel run with window 64 against the plain gradient at
    63), and one that reads each row's statistics one row off (the
    statistics rolled by one row).  Each bf16 case also carries its dK/dV
    plan (``plan_bwd``, from shapes only): its blocks and its heaviest
    block's work over the mean."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd_kernel
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.flash_attention import plan_bwd

    rows, errs = [], {}
    for name, B, S_q, S_kv, H, Hkv, D, causal, window in BWD_SHAPES:
        for dname in ("float32", "bfloat16"):
            q, k, v, do = bwd_inputs(torch, getattr(torch, dname), B, S_q,
                                     S_kv, H, Hkv, D)
            kw = dict(causal=causal, window=window)
            out, stats = flash_attention_kernel(q, k, v, with_stats=True,
                                                **kw)
            got = flash_attention_bwd_kernel(q, k, v, out, do, stats, **kw)
            again = flash_attention_bwd_kernel(q, k, v, out, do, stats, **kw)
            want = plain_grads(torch, q, k, v, do, **kw)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            check(same, f"flash backward {name} {dname}: two runs differ")
            fwd = attention_errs(out, want[0], dname, f"flash {name}")
            case = grad_errs(got, want[1:], dname)
            check(case["ok"], f"flash backward {name} {dname}: {case}")
            rows.append({"case": name, "dtype": dname,
                         "shape": f"B={B} S_q={S_q} S_kv={S_kv} H={H} "
                                  f"Hkv={Hkv} D={D} causal={causal} "
                                  f"window={window}", "forward": fwd,
                         "two_runs_identical": same, **case})
            if dname == "bfloat16":
                work = plan_bwd(B, S_q, S_kv, H, Hkv, causal=causal,
                                window=window, head_dim=D).work
                rows[-1]["plan"] = {
                    "blocks": len(work),
                    "heaviest_over_mean": max(work) * len(work) / sum(work)}
            if name == "qwen2_train":
                errs["flash_attention_train", dname] = fwd["max_abs_err"]
            errs["flash_bwd_" + name, dname] = max(
                case[n]["max_abs_err"] for n in ("dq", "dk", "dv"))
            del q, k, v, do, out, stats, got, again, want
    faults = {}
    # a dropped group member: the last query head of each kv head's group
    q, k, v, do = bwd_inputs(torch, torch.bfloat16, 1, 1024, 1024, 14, 2, 64)
    want = plain_grads(torch, q, k, v, do, causal=True)
    out, stats = flash_attention_kernel(q, k, v, causal=True, with_stats=True)
    dropped = do.clone()
    dropped[:, :, 6::7] = 0
    got = flash_attention_bwd_kernel(q, k, v, out, dropped, stats,
                                     causal=True)
    faults["dropped_group_member"] = grad_errs(got, want[1:], "bfloat16")
    # each row's statistics read one row off
    got = flash_attention_bwd_kernel(q, k, v, out, do,
                                     stats.roll(1, dims=1).contiguous(),
                                     causal=True)
    faults["stats_one_row_off"] = grad_errs(got, want[1:], "bfloat16")
    # the window's edge one key late
    q, k, v, do = bwd_inputs(torch, torch.bfloat16, 1, 1024, 1024, 8, 2, 128)
    want = plain_grads(torch, q, k, v, do, causal=True, window=63)
    out, stats = flash_attention_kernel(q, k, v, causal=True, window=64,
                                        with_stats=True)
    got = flash_attention_bwd_kernel(q, k, v, out, do, stats, causal=True,
                                     window=64)
    faults["window_edge_shifted"] = grad_errs(got, want[1:], "bfloat16")
    for name, f in faults.items():
        check(not f["ok"], f"planted fault {name} passed the check: {f}")
    emit({"phase": "flash_bwd_parity", "ok": True, "tol": BWD_TOL,
          "cases": rows, "planted_faults_caught": faults})
    return errs


def flat_grads(torch, model, params, batch, impl=None, remat="full"):
    """The train step's loss and the gradient of every f32 master leaf
    (``launch.loss_and_grads``), the gradients by leaf path."""
    from repro_torch.launch import loss_and_grads

    loss, _, grads = loss_and_grads(model, params, batch, remat=remat,
                                    impl=impl)
    flat = {}

    def walk(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}/{k}")
            else:
                flat[f"{prefix}/{k}"] = v

    walk(grads)
    return loss, flat


def train_batch(torch, cfg, step=0, batch=TR_BATCH, seq=TR_SEQ):
    """The synthetic pipeline's batch of ``step`` (seed 0): ``batch``
    sequences of ``seq``, on the card."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.data import SyntheticDataPipeline

    pipe = SyntheticDataPipeline(cfg, ShapeConfig("train", "train", seq,
                                                  batch),
                                 start_step=step)
    try:
        return {k: torch.from_numpy(v.copy()).cuda()
                for k, v in pipe.next().items()}
    finally:
        pipe.stop()


def phase_train_grads(torch, model):
    """At full width, bf16, one step's loss and gradients through the
    kernels (remat "full"): every parameter leaf gets a finite, nonzero
    gradient, and the flash launches of a step are 24 forward calls, 24
    more where remat recomputes the layers, and 24 backward calls.  Each
    remat's step (loss and gradients, no optimizer) is timed once on the
    host clock, to its synchronise: the first call at its remat."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd_kernel
    from repro_torch.kernels.flash_attention import flash_attention_kernel

    params = model.init_params(seed=0)
    batch = train_batch(torch, model.cfg)
    L = model.cfg.num_layers
    counts, step_s = {}, {}
    for remat in ("none", "full"):
        _reset((flash_attention_kernel, flash_attention_bwd_kernel))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = flat_grads(torch, model, params, batch, remat=remat)
        torch.cuda.synchronize()
        step_s[remat] = time.perf_counter() - t0
        counts[remat] = {
            "flash_forward": flash_attention_kernel.launches,
            "flash_backward": flash_attention_bwd_kernel.launches}
        check(bool(torch.isfinite(loss)), f"loss {loss}")
        bad = [k for k, g in grads.items()
               if not bool(torch.isfinite(g).all()) or float(
                   g.abs().max()) == 0.0]
        check(not bad, f"leaves without a gradient: {bad}")
    check(counts == {"none": {"flash_forward": L, "flash_backward": L},
                     "full": {"flash_forward": 2 * L, "flash_backward": L}},
          f"flash launches per step {counts}")
    emit({"phase": "train_grads", "ok": True, "arch": model.cfg.name,
          "batch": TR_BATCH, "seq": TR_SEQ, "loss": float(loss),
          "leaves_with_gradient": len(grads),
          "flash_launches_per_step": counts, "grad_step_s": step_s,
          "tokens_per_s": {r: TR_BATCH * TR_SEQ / t
                           for r, t in step_s.items()},
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})


def phase_train_f32(torch):
    """qwen2's first 4 layers in f32: ``train_f32_check``."""
    from repro_torch.configs import ARCHS

    train_f32_check(torch, "train_f32", ARCHS["qwen2-0.5b"], TR_F32_LAYERS)


def train_f32_check(torch, phase, arch, layers, batch_size=TR_BATCH,
                    seq=TR_SEQ):
    """``arch``'s first ``layers`` layers in f32: one train step's loss,
    grad norm and every gradient leaf through the kernels (the f32 bodies
    and the backward kernels) against the plain versions, on conditioned
    weights, and one ``build_train_step`` step of each, on
    ``batch_size`` sequences of ``seq``."""
    import gc

    from repro_torch.launch import build_train_step
    from repro_torch.models import Model, init_params
    from repro_torch.models.param import tree_map
    from repro_torch.training import opt_state_specs

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = Model(arch.scaled(num_layers=layers, dtype="float32"))
    params = conditioned(model, model.init_params(seed=0))
    batch = train_batch(torch, model.cfg, batch=batch_size, seq=seq)
    runs = {impl: flat_grads(torch, model, params, batch, impl=impl)
            for impl in (None, "plain")}
    (lk, gk), (lp, gp) = runs[None], runs["plain"]
    loss_rel = abs(float(lk) - float(lp)) / abs(float(lp))
    check(loss_rel <= TR_F32_LOSS_TOL, f"f32 loss {float(lk)} vs {float(lp)}")
    worst = {"rel": -1.0}
    for k in gp:
        e, scale = max_err(gk[k], gp[k]), float(gp[k].abs().max())
        check(e <= TR_F32_GRAD_TOL * scale, f"f32 gradient {k}: err {e} "
                                            f"at scale {scale}")
        if e / scale > worst["rel"]:
            worst = {"leaf": k, "max_abs_err": e, "max_abs": scale,
                     "rel": e / scale}
    n_leaves = len(gp)
    del runs, gk, gp
    steps = {}
    for impl in (None, "plain"):
        p = tree_map(lambda t: t.clone(), params)
        o = init_params(opt_state_specs(model.param_specs), 0, "cuda")
        _, _, m = build_train_step(model, impl=impl)(p, o, batch)
        steps[impl] = {k: float(v) for k, v in m.items()}
        del p, o
    for key in ("loss", "grad_norm"):
        a, b = steps[None][key], steps["plain"][key]
        check(abs(a - b) <= TR_F32_LOSS_TOL * abs(b), f"f32 step {key} "
                                                      f"{a} vs {b}")
    emit({"phase": phase, "ok": True, "arch": arch.name, "layers": layers,
          "batch": batch_size, "seq": seq,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "loss_rel_err": loss_rel, "worst_grad_leaf": worst,
          "tol": {"loss_and_grad_norm": TR_F32_LOSS_TOL,
                  "grad_leaf": f"{TR_F32_GRAD_TOL} of max|grad|"},
          "step": steps, "leaves": n_leaves})


def phase_train_steps(torch, model):
    """The main training path with the launch counts set to 0: a
    ``Trainer`` over TR_STEPS steps (the synthetic pipeline's pinned
    buffers, remat "full"); then a second one that checkpoints every
    TR_CKPT_EVERY steps and fails before step TR_FAIL_AT, restores and
    replays: its losses identical to the first run's, step for step."""
    import shutil

    from repro_torch.configs import ShapeConfig
    from repro_torch.kernels.flash_attention import flash_attention_bwd_kernel
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.training import Trainer, inject_failure_at

    shape = ShapeConfig("train_4k", "train", TR_SEQ, TR_BATCH)
    kernels = (flash_attention_kernel, flash_attention_bwd_kernel)
    L = model.cfg.num_layers
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset(kernels)
    t0 = time.perf_counter()
    base = Trainer(model, shape).run(TR_STEPS)
    wall = time.perf_counter() - t0
    launches = {"flash_attention": flash_attention_kernel.launches,
                "flash_attention_bwd": flash_attention_bwd_kernel.launches}
    want = {"flash_attention": 2 * L * TR_STEPS,
            "flash_attention_bwd": L * TR_STEPS}
    check(launches == want, f"launches {launches}, want {want}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = [h["loss"] for h in base["history"]]
    check(all(abs(x) < float("inf") for x in losses), f"losses {losses}")
    ckpt_dir = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    try:
        crashy = Trainer(model, shape, ckpt_dir=str(ckpt_dir),
                         ckpt_every=TR_CKPT_EVERY,
                         failure_hook=inject_failure_at({TR_FAIL_AT}))
        out = crashy.run(TR_STEPS)
        saved = crashy.ckpt.available_steps()
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    check(out["restarts"] == 1 and out["final_step"] == TR_STEPS,
          f"restarts {out['restarts']} final step {out['final_step']}")
    steps = [h["step"] for h in out["history"]]
    replayed = [h for h in out["history"][TR_FAIL_AT:]]
    check(steps == list(range(TR_FAIL_AT))
          + list(range(TR_CKPT_EVERY, TR_STEPS)), f"steps {steps}")
    diffs = {h["step"]: h["loss"] - losses[h["step"]]
             for h in out["history"] if h["loss"] != losses[h["step"]]}
    check(not diffs, f"replayed losses differ from the first run's: "
                     f"{diffs}")
    times = [h["time_s"] for h in base["history"]]
    emit({"phase": "train_steps", "ok": True, "arch": model.cfg.name,
          "batch": TR_BATCH, "seq": TR_SEQ, "steps": TR_STEPS,
          "launches": launches,
          "flash_launches_per_step": {
              "forward": launches["flash_attention"] // TR_STEPS,
              "backward": launches["flash_attention_bwd"] // TR_STEPS},
          "losses": losses,
          "replay": {"history_steps": steps, "checkpoints": saved,
                     "replayed_losses": [h["loss"] for h in replayed],
                     "identical": True},
          "step_s": times, "median_step_s": statistics.median(times[1:]),
          "tokens_per_s": TR_BATCH * TR_SEQ / statistics.median(times[1:]),
          "wall_s": wall, "peak_mem_gb": peak})
    return launches


def train_table_rows(torch, launches, errs):
    """The flash forward and backward kernels at qwen2's train shape
    (B 2, S 4096, 14 heads over 2 of 64, causal), bf16: kernel, plain
    (autograd of the plain version for the backward) and SDPA times
    beside the bound."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_bwd_kernel
    from repro_torch.kernels.flash_attention import flash_attention_kernel

    saved = (flash_attention_kernel.launches,
             flash_attention_bwd_kernel.launches)
    B, S, H, Hkv, D = TR_BATCH, TR_SEQ, 14, 2, 64
    elt = 2
    q, k, v, _ = bwd_inputs(torch, torch.bfloat16, B, S, S, H, Hkv, D)
    pairs = B * H * (S * (S + 1) // 2)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    rows = []

    def kfn():
        return flash_attention_kernel(q, k, v, causal=True)

    def lfn():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    k_ms = time_ms(kfn, iters=20)
    p_ms = time_ms(lambda: ref.flash_attention(q, k, v, causal=True),
                   iters=3, warmup=1)
    l_ms = time_ms(lfn, iters=20)
    n_bytes = (2 * q.numel() + 2 * k.numel()) * elt
    b_ms, b_by = bound_ms(n_bytes, 4 * D * pairs, "bfloat16")
    rows.append({"name": "flash_attention_train", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
                 "replaces": "src/repro/kernels/flash_attention.py:85",
                 "launches": launches["flash_attention"],
                 "max_abs_err": errs["flash_attention_train", "bfloat16"],
                 "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                 "bound_by": b_by, "library_ms": l_ms,
                 "library_note": "scaled_dot_product_attention, "
                                 "is_causal=True, enable_gqa=True (timed "
                                 "only)",
                 "shape": f"B={B} S_q=S_kv={S} causal H={H} Hkv={Hkv} D={D}"})
    del q, k, v, qt, kt, vt
    rows.append(flash_bwd_row(
        torch, "flash_bwd", (B, S, H, Hkv, D),
        launches["flash_attention_bwd"],
        errs["flash_bwd_qwen2_train", "bfloat16"]))
    flash_attention_kernel.launches, flash_attention_bwd_kernel.launches = \
        saved
    return rows


def flash_bwd_row(torch, name, shape, launches, err):
    """The flash backward kernels at a causal train shape (B, S, H, Hkv,
    D), bf16: kernel, autograd of the plain version and the SDPA
    backward's times beside the bound, and each kernel's device time."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_bwd_kernel
    from repro_torch.kernels.flash_attention import BWD_KERNELS
    from repro_torch.kernels.flash_attention import flash_attention_kernel

    saved = (flash_attention_kernel.launches,
             flash_attention_bwd_kernel.launches)
    B, S, H, Hkv, D = shape
    elt = 2
    q, k, v, do = bwd_inputs(torch, torch.bfloat16, B, S, S, H, Hkv, D)
    pairs = B * H * (S * (S + 1) // 2)
    out, stats = flash_attention_kernel(q, k, v, causal=True,
                                        with_stats=True)

    def bfn():
        return flash_attention_bwd_kernel(q, k, v, out, do, stats,
                                          causal=True)

    bk_ms = time_ms(bfn, iters=20, warmup=3)
    # each kernel of a call on the device: CUDA events the entry records
    # around each launch, which also counts the kernels it launched; the
    # median of 9 calls
    times = torch.zeros(BWD_KERNELS + 1, dtype=torch.float32)
    calls = []
    for _ in range(9):
        flash_attention_bwd_kernel(q, k, v, out, do, stats, causal=True,
                                   timing=times)
        calls.append(times.tolist())
    counts = {int(c[0]) for c in calls}
    names = ("rows_kernel", "dkdv_kernel", "dq_kernel")
    check(counts == {len(names)}, f"backward kernels a call: {counts}, "
                                  f"want {len(names)} ({names})")
    split = {n: statistics.median(c[1 + i] for c in calls)
             for i, n in enumerate(names)}
    qp, kp, vp = (x.detach().requires_grad_(True) for x in (q, k, v))
    with torch.enable_grad():
        outp = ref.flash_attention(qp, kp, vp, causal=True)
        bp_ms = time_ms(lambda: torch.autograd.grad(
            outp, (qp, kp, vp), do, retain_graph=True), iters=3, warmup=1)
        del outp
        ql, kl, vl = (x.transpose(1, 2).detach().requires_grad_(True)
                      for x in (q, k, v))
        outl = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True,
                                              enable_gqa=True)
        dol = do.transpose(1, 2)
        bl_ms = time_ms(lambda: torch.autograd.grad(
            outl, (ql, kl, vl), dol, retain_graph=True), iters=20)
        del outl
    # reads q, k, v, out and dout once, writes dq, dk, dv once; the
    # products of each visible pair: S again, dP, dV, dQ, dK (10 D)
    n_bytes = (4 * q.numel() + 4 * k.numel()) * elt
    flops = 10 * D * pairs
    b_ms, b_by = bound_ms(n_bytes, flops, "bfloat16")
    flash_attention_kernel.launches, flash_attention_bwd_kernel.launches = \
        saved
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "replaces": "none: the gradient of "
                        "src/repro/kernels/flash_attention.py:85 (the JAX "
                        "package trains through ref, "
                        "src/repro/kernels/ref.py)",
            "launches": launches, "max_abs_err": err,
            "ms": bk_ms, "plain_ms": bp_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": bl_ms,
            "library_note": "the backward of scaled_dot_product_attention "
                            "(is_causal, enable_gqa) by autograd.grad "
                            "(timed only)",
            "shape": f"B={B} S_q=S_kv={S} causal H={H} Hkv={Hkv} D={D}",
            "kernels_per_call": counts.pop(), "kernel_device_ms": split,
            "flops": flops, "bytes": n_bytes}


# ---------------------------------------------------------------------------
# SSM and hybrid training: the SSD backward kernel
# ---------------------------------------------------------------------------
#: the SSD scan at the train cells' shapes (TR_BATCH x TR_SEQ): mamba2's
#: 80 heads of 64 with state 128, zamba2's 112 with state 64
SSD_TRAIN = {"mamba2": dict(B=TR_BATCH, S=TR_SEQ, H=80, P=64, N=128,
                            chunk=128),
             "zamba2": dict(B=TR_BATCH, S=TR_SEQ, H=112, P=64, N=64,
                            chunk=128)}
#: the backward's parity cases: both train shapes, one short chunk (S =
#: 127), chunks of 127 over two sequences, steep decay and the smoke form
#: (P 32, N 16, 6 heads)
SSD_BWD_CASES = (
    ("mamba2_train", SSD_TRAIN["mamba2"]),
    ("zamba2_train", SSD_TRAIN["zamba2"]),
    ("short_chunk", dict(B=2, S=127, H=80, P=64, N=128, chunk=127)),
    ("ragged_chunks", dict(B=2, S=254, H=112, P=64, N=64, chunk=127)),
    ("steep", dict(B=2, S=512, H=80, P=64, N=128, chunk=128, steep=True)),
    ("smoke_form", dict(B=2, S=256, H=6, P=32, N=16, chunk=128)),
)
SSD_GRADS = ("dx", "ddt", "da", "db", "dc", "dd")
# each gradient's largest error over its largest magnitude, against the
# plain backward: f32 sums in other orders; bf16 stores dx, dB and dC in
# bf16 (half an ulp is 2**-9 of a value).  Against autograd of the plain
# scan the same, but for da: autograd sums dt * dda in f32, where the row
# and column terms cancel to rounding (a few percent at steep decay), so
# its da is reported, not held
SSD_BWD_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# a planted fault must miss by at least this many tolerances
FAULT_MARGIN = 10.0
# mamba2-2.7b and zamba2-7b at the train cell train_4k (TR_SEQ x
# TR_BATCH), remat "full", SSM_TRAIN_STEPS steps a run.  zamba2-7b (6.75 B
# parameters, 108 GB at 16 bytes a parameter in f32 weights, gradients
# and AdamW moments) is cut by layers to HY_TRAIN_LAYERS, keeping its form:
# groups of 6 Mamba2 layers each followed by the shared block, and 3
# trailing layers, the deepest 6k + 3 whose peak reserved memory leaves
# TRAIN_SPARE_GB of the card free (39 layers reserve 70.6 GB of an H100
# 80GB HBM3's 85.0 with the allocator's expandable segments, which
# ``main`` asks for; 45 would need ~8.5 GB more).  The f32 checks run mamba2's first 4 layers and
# zamba2's first 7 (one group, the shared block, one trailing layer).
SSM_TRAIN_STEPS = 4
HY_TRAIN_LAYERS = 39
SSM_F32_LAYERS, HY_F32_LAYERS = 4, 7
TRAIN_SPARE_GB = 8.0


def ssd_bwd_inputs(torch, dtype, B, S, H, P, N, steep=False, seed=2):
    """``ssd_inputs`` and the cotangents of y (in its dtype) and of the
    final state (f32)."""
    x, dt, a, b, c, d = ssd_inputs(torch, dtype, B, S, H, P, N, seed=seed,
                                   steep=steep)
    g = torch.Generator(device="cuda").manual_seed(seed + 100)
    dy = torch.randn(x.shape, generator=g, device="cuda").to(dtype)
    ds = torch.randn((B, H, P, N), generator=g, device="cuda")
    return x, dt, a, b, c, d, dy, ds


def ssd_grad_errs(got, want, tol, held=SSD_GRADS):
    """Per gradient the largest error, it over the largest magnitude, and
    whether it is finite; ``ok`` when every gradient in ``held`` is finite
    and within ``tol`` of its largest magnitude."""
    import torch

    out = {}
    for name, g, w in zip(SSD_GRADS, got, want):
        if g is None or w is None:
            continue
        e, scale = max_err(g, w), float(w.float().abs().max())
        out[name] = {"max_abs_err": e, "max_abs": scale,
                     "rel": e / scale if scale else e,
                     "finite": bool(torch.isfinite(g).all())}
    out["ok"] = all(out[n]["finite"] and out[n]["rel"] <= tol
                    for n in held if n in out)
    out["worst_rel"] = max(out[n]["rel"] for n in held if n in out)
    return out


def ssd_plain_autograd(torch, x, dt, a, b, c, d, dy, ds, chunk):
    """The six gradients by autograd of the plain scan."""
    from repro_torch.kernels import ref

    leaves = [t.detach().requires_grad_(True) for t in (x, dt, a, b, c, d)]
    with torch.enable_grad():
        y, state = ref.ssd_chunk_scan(*leaves[:5], chunk=chunk,
                                      d_skip=leaves[5])
        return torch.autograd.grad((y, state), leaves, (dy, ds))


def phase_ssd_bwd_parity(torch):
    """The SSD backward kernels against the plain backward
    (``ref.ssd_chunk_scan_bwd``, all six gradients) and against autograd
    of the plain scan (five; da reported) at SSD_BWD_CASES in f32 and bf16,
    with a final-state cotangent, and once without one; two runs bit for
    bit; and three planted faults: the chunks run as separate sequences
    (no state and no state gradient carried across chunks) and the skip
    term dropped (each must miss by FAULT_MARGIN tolerances), and the
    heads summed in reverse order, in f32 and in bf16 (the bf16 route's
    head groups: dB's and dC's bits must differ, which the two-run
    comparison would catch, and each head's dx and ddt must not)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import plan_bwd_groups
    from repro_torch.kernels.ssd_scan import ssd_chunk_scan_bwd_kernel

    rows, errs = [], {}
    for name, case in SSD_BWD_CASES:
        for dname in ("float32", "bfloat16"):
            tol = SSD_BWD_TOL[dname]
            chunk = case["chunk"]
            shape = {k: v for k, v in case.items() if k != "chunk"}
            x, dt, a, b, c, d, dy, ds = ssd_bwd_inputs(
                torch, getattr(torch, dname), **shape)
            kw = dict(chunk=chunk, d_skip=d, dstate=ds)
            got = ssd_chunk_scan_bwd_kernel(x, dt, a, b, c, dy, **kw)
            again = ssd_chunk_scan_bwd_kernel(x, dt, a, b, c, dy, **kw)
            want = ref.ssd_chunk_scan_bwd(x, dt, a, b, c, dy, **kw)
            auto = ssd_plain_autograd(torch, x, dt, a, b, c, d, dy, ds,
                                      chunk)
            torch.cuda.synchronize()
            same = all(torch.equal(p, q) for p, q in zip(got, again))
            check(same, f"SSD backward {name} {dname}: two runs differ")
            vs_plain = ssd_grad_errs(got, want, tol)
            check(vs_plain["ok"], f"SSD backward {name} {dname} against "
                                  f"the plain backward: {vs_plain}")
            vs_auto = ssd_grad_errs(got, auto, tol, held=SSD_GRADS[:2]
                                    + SSD_GRADS[3:])
            check(vs_auto["ok"], f"SSD backward {name} {dname} against "
                                 f"autograd of the plain scan: {vs_auto}")
            rows.append({"case": name, "dtype": dname, "tol_rel": tol,
                         "shape": " ".join(f"{k}={v}"
                                           for k, v in case.items()),
                         "two_runs_identical": same,
                         "vs_plain_backward": vs_plain,
                         "vs_plain_autograd": vs_auto})
            if name.endswith("_train"):
                errs["ssd_bwd_" + name, dname] = max(
                    vs_plain[n]["max_abs_err"] for n in SSD_GRADS)
            del x, dt, a, b, c, d, dy, ds, got, again, want, auto
    # no final-state cotangent (the training path's case)
    sh = dict(SSD_BWD_CASES[2][1])
    chunk = sh.pop("chunk")
    x, dt, a, b, c, d, dy, _ = ssd_bwd_inputs(torch, torch.bfloat16, **sh)
    got = ssd_chunk_scan_bwd_kernel(x, dt, a, b, c, dy, chunk=chunk,
                                    d_skip=d)
    want = ref.ssd_chunk_scan_bwd(x, dt, a, b, c, dy, chunk=chunk, d_skip=d)
    no_state = ssd_grad_errs(got, want, SSD_BWD_TOL["bfloat16"])
    check(no_state["ok"], f"SSD backward without dstate: {no_state}")

    faults = {}
    B, S, H, P, N, L = 2, 1024, 80, 64, 128, 128
    tol = SSD_BWD_TOL["bfloat16"]
    x, dt, a, b, c, d, dy, ds = ssd_bwd_inputs(torch, torch.bfloat16, B, S,
                                               H, P, N)
    want = ref.ssd_chunk_scan_bwd(x, dt, a, b, c, dy, chunk=L, d_skip=d,
                                  dstate=ds)

    def apart(t):  # each chunk a sequence of its own
        return t.reshape(B * (S // L), L, *t.shape[2:])

    got = ssd_chunk_scan_bwd_kernel(apart(x), apart(dt), a, apart(b),
                                    apart(c), apart(dy), chunk=L, d_skip=d)
    got = tuple(g.reshape(w.shape) for g, w in zip(got, want))
    faults["no_carry_across_chunks"] = ssd_grad_errs(got, want, tol)
    got = ssd_chunk_scan_bwd_kernel(x, dt, a, b, c, dy, chunk=L, dstate=ds)
    faults["skip_term_dropped"] = ssd_grad_errs(got, want, tol)
    for fname, f in faults.items():
        check(not f["ok"] and f["worst_rel"] >= FAULT_MARGIN * tol,
              f"planted fault {fname} passed the check: {f}")
    # the heads in reverse order: each head's gradients are the same
    # numbers, dB and dC sum the heads the other way round (f32: the
    # per-head partials; bf16: each head group's heads in f32 registers,
    # then the groups)
    rev = torch.arange(H - 1, -1, -1, device="cuda")
    for dname in ("float32", "bfloat16"):
        x, dt, a, b, c, d, dy, ds = ssd_bwd_inputs(
            torch, getattr(torch, dname), B, S, H, P, N)
        base = ssd_chunk_scan_bwd_kernel(x, dt, a, b, c, dy, chunk=L,
                                         d_skip=d, dstate=ds)
        flipped = ssd_chunk_scan_bwd_kernel(
            x[:, :, rev], dt[:, :, rev], a[rev], b, c, dy[:, :, rev],
            chunk=L, d_skip=d[rev], dstate=ds[:, rev])
        differ = {n: int((base[i] != flipped[i]).sum()) for i, n in
                  ((3, "db"), (4, "dc"))}
        same_heads = (torch.equal(base[0], flipped[0][:, :, rev])
                      and torch.equal(base[1], flipped[1][:, :, rev]))
        fault = {"elements_differing": differ,
                 "dx_ddt_identical": same_heads,
                 "db_rel": max_err(flipped[3], base[3])
                 / float(base[3].abs().max())}
        faults["heads_reversed_" + dname] = fault
        check(all(v > 0 for v in differ.values()) and same_heads,
              f"planted fault heads_reversed {dname}: {fault}")
    # the bf16 route's head groups at the train shapes (planned from shapes)
    groups = {k: plan_bwd_groups(sh["B"], sh["S"], sh["H"],
                                 sh["chunk"])._asdict()
              for k, sh in SSD_TRAIN.items()}
    emit({"phase": "ssd_bwd_parity", "ok": True, "tol": SSD_BWD_TOL,
          "cases": rows, "no_final_state_cotangent": no_state,
          "planted_faults_caught": faults, "fault_margin": FAULT_MARGIN,
          "head_groups": groups})
    return errs


def _train_kernels():
    from repro_torch.kernels.flash_attention import flash_attention_bwd_kernel
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.ssd_scan import ssd_chunk_scan_bwd_kernel
    from repro_torch.kernels.ssd_scan import ssd_chunk_scan_kernel

    return {"ssd_scan": ssd_chunk_scan_kernel,
            "ssd_scan_bwd": ssd_chunk_scan_bwd_kernel,
            "flash_attention": flash_attention_kernel,
            "flash_attention_bwd": flash_attention_bwd_kernel}


def train_launches_per_step(cfg) -> dict:
    """A remat "full" step's launches: each Mamba2 layer's scan forward
    twice (the recompute) and backward once; each application of the
    hybrid's shared block's attention the same."""
    from repro_torch.models.transformer import n_shared_attn

    L = cfg.num_layers
    A = n_shared_attn(cfg) if cfg.family == "hybrid" else 0
    return {"ssd_scan": 2 * L, "ssd_scan_bwd": L,
            "flash_attention": 2 * A, "flash_attention_bwd": A}


def phase_family_train_grads(torch, phase, model):
    """At full width (zamba2 at its cut), bf16, one ``loss_and_grads``
    step through the kernels, remat "full": every parameter leaf gets a
    finite, nonzero gradient and the step's launches are
    ``train_launches_per_step``; its time on the host clock, to its
    synchronise, and the peak memory."""
    import gc

    kernels = _train_kernels()
    gc.collect()
    torch.cuda.empty_cache()
    params = conditioned(model, model.init_params(seed=0))
    batch = train_batch(torch, model.cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset(kernels.values())
    t0 = time.perf_counter()
    loss, grads = flat_grads(torch, model, params, batch, remat="full")
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    counts = _launches(kernels)
    check(bool(torch.isfinite(loss)), f"loss {loss}")
    bad = [k for k, g in grads.items()
           if not bool(torch.isfinite(g).all()) or float(
               g.abs().max()) == 0.0]
    check(not bad, f"leaves without a finite, nonzero gradient: {bad}")
    want = train_launches_per_step(model.cfg)
    check(counts == want, f"launches per step {counts}, want {want}")
    emit({"phase": phase, "ok": True, "arch": model.cfg.name,
          "layers": model.cfg.num_layers, "params": model.n_params(),
          "batch": TR_BATCH, "seq": TR_SEQ, "loss": float(loss),
          "leaves_with_gradient": len(grads), "launches_per_step": counts,
          "grad_step_s": step_s, "tokens_per_s": TR_BATCH * TR_SEQ / step_s,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})


def phase_family_train_steps(torch, phase, model):
    """The training path with the launch counts set to 0: a ``Trainer``
    over SSM_TRAIN_STEPS steps (remat "full", the synthetic pipeline's
    pinned buffers), its median step, tokens/s and peak memory beside the
    card's; then a second ``Trainer`` from the same seed, whose losses
    must equal the first's bit for bit, step for step (the SSD backward
    sums in a fixed order)."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.training import Trainer

    import gc

    shape = ShapeConfig("train_4k", "train", TR_SEQ, TR_BATCH)
    kernels = _train_kernels()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    start_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    _reset(kernels.values())
    t0 = time.perf_counter()
    base = Trainer(model, shape).run(SSM_TRAIN_STEPS)
    wall = time.perf_counter() - t0
    launches = _launches(kernels)
    peak = torch.cuda.max_memory_allocated() / 1e9
    reserved = torch.cuda.max_memory_reserved() / 1e9
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    total = torch.cuda.get_device_properties(0).total_memory / 1e9
    per_step = train_launches_per_step(model.cfg)
    want = {k: v * SSM_TRAIN_STEPS for k, v in per_step.items()}
    check(launches == want, f"launches {launches}, want {want}")
    check(reserved + TRAIN_SPARE_GB <= total,
          f"peak reserved {reserved:.1f} GB leaves under {TRAIN_SPARE_GB} "
          f"GB of {total:.1f}")
    losses = [h["loss"] for h in base["history"]]
    check(all(abs(x) < float("inf") for x in losses), f"losses {losses}")
    torch.cuda.empty_cache()
    again = Trainer(model, shape).run(SSM_TRAIN_STEPS)
    repeat = [h["loss"] for h in again["history"]]
    check(repeat == losses, f"a second run's losses {repeat} differ from "
                            f"the first's {losses}")
    times = [h["time_s"] for h in base["history"]]
    emit({"phase": phase, "ok": True, "arch": model.cfg.name,
          "layers": model.cfg.num_layers, "params": model.n_params(),
          "batch": TR_BATCH, "seq": TR_SEQ, "steps": SSM_TRAIN_STEPS,
          "launches": launches, "launches_per_step": per_step,
          "losses": losses, "repeat_losses_identical": True,
          "step_s": times, "median_step_s": statistics.median(times[1:]),
          "tokens_per_s": TR_BATCH * TR_SEQ / statistics.median(times[1:]),
          "wall_s": wall, "mem_gb_at_start": start_gb, "peak_mem_gb": peak,
          "peak_reserved_gb": reserved, "alloc_retries": retries,
          "card_gb": total})
    return launches


def ssd_bwd_table_row(torch, name, shape, launches, err):
    """The SSD backward kernels at a train shape, bf16: kernel, plain
    backward and autograd-of-the-plain-scan times beside the bound, and
    each kernel's device time."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import BWD_KERNEL_NAMES, BWD_KERNELS
    from repro_torch.kernels.ssd_scan import ssd_chunk_scan_bwd_kernel

    saved = ssd_chunk_scan_bwd_kernel.launches
    B, S, H, P, N, L = (shape[k] for k in ("B", "S", "H", "P", "N",
                                           "chunk"))
    x, dt, a, b, c, d, dy, _ = ssd_bwd_inputs(torch, torch.bfloat16, B, S,
                                              H, P, N)

    def kfn():
        return ssd_chunk_scan_bwd_kernel(x, dt, a, b, c, dy, chunk=L,
                                         d_skip=d)

    k_ms = time_ms(kfn, iters=10, warmup=2)
    times = torch.zeros(BWD_KERNELS + 1, dtype=torch.float32)
    calls = []
    for _ in range(5):
        ssd_chunk_scan_bwd_kernel(x, dt, a, b, c, dy, chunk=L, d_skip=d,
                                  timing=times)
        calls.append(times.tolist())
    counts = {int(ct[0]) for ct in calls}
    names = BWD_KERNEL_NAMES[torch.bfloat16]
    check(counts == {len(names)}, f"SSD backward kernels a call: {counts}")
    split = {n: statistics.median(ct[1 + i] for ct in calls)
             for i, n in enumerate(names)}
    p_ms = time_ms(lambda: ref.ssd_chunk_scan_bwd(x, dt, a, b, c, dy,
                                                  chunk=L, d_skip=d),
                   iters=3, warmup=1)
    leaves = [t.detach().requires_grad_(True) for t in (x, dt, a, b, c, d)]
    with torch.enable_grad():
        y, _ = ref.ssd_chunk_scan(*leaves[:5], chunk=L, d_skip=leaves[5])
        a_ms = time_ms(lambda: torch.autograd.grad(y, leaves, dy,
                                                   retain_graph=True),
                       iters=3, warmup=1)
        del y
    ssd_chunk_scan_bwd_kernel.launches = saved
    # each input read once (x, dy, B, C in bf16; dt, a, d in f32), each
    # output written once (dx, dB, dC in bf16; ddt, da, dd in f32)
    n_bytes = (3 * x.numel() * 2 + 4 * b.numel() * 2 + 2 * dt.numel() * 4
               + 4 * H * 4)
    # a chunk's products: C.B over its causal pairs once (shared by the
    # heads); each head's Q, dx's and dB's and dC's intra products over the
    # pairs, and five (L, P, N) products: the chunk's state, its state
    # gradient, the inter term of dC, X G (dB, V) and B G (dx)
    nc, pairs = S // L, L * (L + 1) // 2
    flops = 2 * B * nc * (pairs * N + H * (pairs * (2 * P + 2 * N)
                                            + 5 * L * P * N))
    b_ms, b_by = bound_ms(n_bytes, flops, "bfloat16")
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
            "replaces": "none: the gradient of "
                        "src/repro/kernels/ssd_scan.py:83 (the JAX package "
                        "trains through ref, src/repro/kernels/ref.py)",
            "launches": launches, "max_abs_err": err,
            "ms": k_ms, "plain_ms": p_ms, "plain_autograd_ms": a_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "library_note": "no PyTorch call computes the SSD scan or its "
                            "gradient",
            "shape": " ".join(f"{k}={v}" for k, v in shape.items()),
            "kernels_per_call": counts.pop(), "kernel_device_ms": split,
            "flops": flops, "bytes": n_bytes}


#: the trained configurations: (phase prefix, arch name, layers or None
#: for all, layers and sequences of the f32 check).  zamba2's f32 check
#: takes one sequence of 4096: at two, the plain path's autograd (the
#: shared block's f32 attention scores and six plain SSD layers under one
#: remat group) ran out of the card's memory
SSM_TRAIN_RUNS = (
    ("ssm", "mamba2-2.7b", None, SSM_F32_LAYERS, TR_BATCH),
    ("hybrid", "zamba2-7b", HY_TRAIN_LAYERS, HY_F32_LAYERS, 1))


def ssm_train_table_rows(torch, launches, errs):
    """The SSD backward kernels at mamba2's and zamba2's train shapes and
    the flash backward at zamba2's (D 112, 32/32 heads), bf16, with the
    launches of the ``Trainer`` runs."""
    rows = [ssd_bwd_table_row(torch, "ssd_scan_bwd", SSD_TRAIN["mamba2"],
                              launches["ssm"]["ssd_scan_bwd"],
                              errs["ssd_bwd_mamba2_train", "bfloat16"]),
            ssd_bwd_table_row(torch, "ssd_scan_bwd_zamba2",
                              SSD_TRAIN["zamba2"],
                              launches["hybrid"]["ssd_scan_bwd"],
                              errs["ssd_bwd_zamba2_train", "bfloat16"])]
    torch.cuda.empty_cache()
    rows.append(flash_bwd_row(
        torch, "flash_bwd_zamba2", (TR_BATCH, TR_SEQ, 32, 32, 112),
        launches["hybrid"]["flash_attention_bwd"],
        errs["flash_bwd_zamba2_train", "bfloat16"]))
    return rows


# ---------------------------------------------------------------------------
# the examples: examples/*_torch.py through their own entry points
# ---------------------------------------------------------------------------
#: serve_paged's runs: (arguments, requests finished); the greedy runs
#: are held to the CPU run's tokens
EX_PAGED_RUNS = {
    "defaults": ([], 12),
    "best_of_4_speculate_2": (["--best-of", "4", "--speculate", "2"], 48),
    "hazard_whole_prompt": (["--policy", "hazard", "--chunk-tokens", "0"],
                            12),
    "sampled": (["--temperature", "0.8", "--top-p", "0.9"], 12),
}
EX_PAGED_SAMPLED = "sampled"
#: serve_cluster's runs (the first also writes a trace with --trace-out)
EX_CLUSTER_RUNS = {
    "defaults_trace": [],
    "kill_replica": ["--kill-replica"],
    "tiered": ["--prefill-replicas", "1", "--decode-replicas", "2",
               "--prefill-chunk-tokens", "256"],
}
#: train_lm: the example's default 200 steps, and a failure before step
#: 120, restored from step 99's checkpoint
EX_TRAIN_STEPS, EX_TRAIN_FAIL_AT = 200, 120
#: the quickstart's defaults take about a second a scheme
EX_JOIN_TIMEOUT_S = 120
#: the stats entry that times the host
EX_HOST_TIME = "host_us_per_step"


def load_example(name: str):
    """``examples/<name>.py`` as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def quiet(fn, *a, **k):
    """``fn(*a, **k)`` and the lines it printed."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*a, **k)
    return out, buf.getvalue().splitlines()


def masked(lines) -> list:
    """An example's printed lines without its wall time, its rate and
    the trace's path."""
    import re

    out = []
    for ln in lines:
        ln = re.sub(r"in [0-9.]+s \([0-9.]+ tok/s on [^)]*\)", "in Ts", ln)
        ln = re.sub(r"tokens in [0-9.]+s", "tokens in Ts", ln)
        out.append(re.sub(r"metrics\) -> .*", "metrics) -> PATH", ln))
    return out


def card_and_cpu(torch, main, argv, cpu_argv=None):
    """An example's ``main`` on the card with the launch counts of the
    serving path's kernels set to 0, then with ``--device cpu`` on the
    same weights: the CPU run's ``Model.init_params`` returns the tree
    the card run made, copied to the CPU (the two devices' generators
    draw different numbers from one seed).  Both results with their
    printed lines and seconds, and the card run's launches."""
    from repro_torch.models import Model
    from repro_torch.models.param import tree_map

    kernels = _group_kernels()
    made = []
    init = Model.init_params

    def keep(self, seed=0):
        made.append(init(self, seed))
        return made[-1]

    try:
        Model.init_params = keep
        _reset(kernels.values())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card, card_lines = quiet(main, argv)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        launches = _launches(kernels)
        check(len(made) == 1, f"{argv}: {len(made)} weight trees made")
        host = tree_map(lambda t: t.cpu(), made[0])
        Model.init_params = lambda self, seed=0: host
        t0 = time.perf_counter()
        cpu, cpu_lines = quiet(main, (cpu_argv or argv) + ["--device", "cpu"])
        cpu_s = time.perf_counter() - t0
    finally:
        Model.init_params = init
    return (dict(out=card, lines=card_lines, seconds=card_s,
                 launches=launches),
            dict(out=cpu, lines=cpu_lines, seconds=cpu_s))


def _differing(a, b) -> dict:
    """The keys of two dicts whose values differ, with both values."""
    return {k: (a.get(k), b.get(k)) for k in sorted(set(a) | set(b), key=str)
            if a.get(k) != b.get(k)}


def phase_examples_quickstart(torch):
    """``examples/quickstart_torch.py`` at its defaults (4 threads x 3000
    operations on a Michael & Scott queue and a Harris list) under each
    of the eight schemes, each in a daemon thread joined with a timeout;
    every allocated node is reclaimed or counted unreclaimed."""
    import contextlib
    import io
    import threading

    from repro_torch.core import SCHEMES

    main = load_example("quickstart_torch").main
    runs = {}
    for scheme in sorted(SCHEMES):
        out = {}

        def target():
            try:
                out["stats"] = main(["--scheme", scheme])
            except Exception as exc:  # reported below
                out["error"] = f"{type(exc).__name__}: {exc}"

        # the workers inherit the daemon flag, so a livelock cannot hold
        # the process; stdout comes back whether or not the thread ends
        t = threading.Thread(target=target, daemon=True)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            t.start()
            t.join(EX_JOIN_TIMEOUT_S)
        seconds = time.perf_counter() - t0
        check(not t.is_alive(),
              f"quickstart {scheme}: not done in {EX_JOIN_TIMEOUT_S} s")
        check("stats" in out, f"quickstart {scheme}: {out.get('error')}")
        s = out["stats"]
        check(s["allocated"] == s["reclaimed"] + s["unreclaimed"]
              and s["reclaimed"] > 0, f"quickstart {scheme}: {s}")
        runs[scheme] = {"seconds": seconds,
                        **{k: s[k] for k in ("allocated", "reclaimed",
                                             "unreclaimed")},
                        "printed": buf.getvalue().splitlines()}
    emit({"phase": "examples_quickstart", "ok": True,
          "seconds": sum(r["seconds"] for r in runs.values()),
          "runs": runs})


def phase_examples_serve_paged(torch):
    """``examples/serve_paged_torch.py`` (granite-3-8b at smoke width, f32)
    through its ``main``: the defaults, best-of 4 with the speculative
    lane, hazard pointers with whole-prompt prefill, and sampling.  Each
    runs on the card and then on the CPU on the same weights.  The greedy
    runs give every request the CPU run's tokens, every stats entry but
    the host's own step time equals the CPU run's, and so do the printed
    lines.  The sampled run finishes every request, reclaims every page
    and recycles as many pages as its CPU run."""
    main = load_example("serve_paged_torch").main
    runs = {}
    for name, (argv, n_req) in EX_PAGED_RUNS.items():
        card, cpu = card_and_cpu(torch, main, argv)
        eng, ceng = card["out"], cpu["out"]
        toks = {r.rid: list(r.generated) for r in eng.sched.finished}
        ctoks = {r.rid: list(r.generated) for r in ceng.sched.finished}
        st, cst = eng.stats(), ceng.stats()
        check(len(toks) == n_req and all(len(t) == 8
                                         for t in toks.values()),
              f"serve_paged {name}: {len(toks)} requests, "
              f"{[len(t) for t in toks.values()]} tokens")
        check(st["pool_unreclaimed"] == 0,
              f"serve_paged {name}: {st['pool_unreclaimed']} unreclaimed")
        launches = card["launches"]
        check(launches["paged_attention"] > 0
              and launches["flash_attention"] > 0,
              f"serve_paged {name}: launches {launches}")
        diff = _differing({k: v for k, v in st.items() if k != EX_HOST_TIME},
                          {k: v for k, v in cst.items()
                           if k != EX_HOST_TIME})
        same_lines = masked(card["lines"]) == masked(cpu["lines"])
        if name == EX_PAGED_SAMPLED:
            check(st["pool_freed"] == cst["pool_freed"],
                  f"serve_paged {name}: {st['pool_freed']} pages recycled, "
                  f"{cst['pool_freed']} on the CPU")
        else:
            check(toks == ctoks, f"serve_paged {name}: tokens differ from "
                                 f"the CPU run's: {_differing(toks, ctoks)}")
            check(not diff, f"serve_paged {name}: stats differ: {diff}")
            check(same_lines, f"serve_paged {name}: printed lines differ: "
                              f"{card['lines']} vs {cpu['lines']}")
        runs[name] = {
            "argv": argv, "seconds": card["seconds"],
            "cpu_seconds": cpu["seconds"], "requests": len(toks),
            "tokens": sum(len(t) for t in toks.values()),
            "launches": launches,
            "stats": {k: st[k] for k in (
                "steps", "dispatches_per_step", "prefill_chunks",
                "prefix_hits", "prefix_misses", "pool_freed",
                "pool_unreclaimed", "cow_copies", "spec_acceptance",
                "tokens_per_dispatch", EX_HOST_TIME)},
            "tokens_equal_cpu": toks == ctoks,
            "stats_differing_cpu": list(diff),
            "printed_equal_cpu": same_lines, "printed": card["lines"]}
    emit({"phase": "examples_serve_paged", "ok": True,
          "seconds": sum(r["seconds"] for r in runs.values()),
          "cpu_seconds": sum(r["cpu_seconds"] for r in runs.values()),
          "runs": runs})


def _cluster_requests(group) -> list:
    return [(r.rid, r.replica, list(r.generated), bool(r.done))
            for r in group.requests]


def _cluster_stats(group) -> dict:
    st = dict(group.stats())
    st["per_replica"] = [{k: v for k, v in r.items() if k != EX_HOST_TIME}
                         for r in st["per_replica"]]
    return st


def phase_examples_serve_cluster(torch):
    """``examples/serve_cluster_torch.py`` (qwen2-0.5b at smoke width,
    f32) through its ``main``: the defaults writing a trace, a replica
    killed mid-traffic, and 1 prefill and 2 decode replicas with
    256-token prefill chunks.  The example's own asserts hold in each
    run (full reclamation after drain, the handoffs, the death detected
    and its hold force-expired, every replay finished).  Each runs on the
    card and then on the CPU on the same weights: every request's
    replica and tokens, the group's stats but the host's step times,
    the lifecycle counts and the printed lines equal the CPU run's, and
    the trace validates."""
    import tempfile

    from repro_torch.obs import validate_chrome_trace

    main = load_example("serve_cluster_torch").main
    runs = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as d:
        for name, argv in EX_CLUSTER_RUNS.items():
            card_argv, cpu_argv = argv, argv
            if name == "defaults_trace":
                card_argv = argv + ["--trace-out", f"{d}/card.json"]
                cpu_argv = argv + ["--trace-out", f"{d}/cpu.json"]
            card, cpu = card_and_cpu(torch, main, card_argv, cpu_argv)
            (group, life), (cgroup, clife) = card["out"], cpu["out"]
            reqs, creqs = _cluster_requests(group), _cluster_requests(cgroup)
            st = group.stats()
            check(reqs == creqs, f"serve_cluster {name}: requests differ "
                                 f"from the CPU run's: "
                                 f"{[(a, b) for a, b in zip(reqs, creqs) if a != b]}")
            diff = _differing(_cluster_stats(group), _cluster_stats(cgroup))
            check(not diff, f"serve_cluster {name}: stats differ: {diff}")
            ldiff = _differing(life.stats(), clife.stats())
            check(not ldiff, f"serve_cluster {name}: lifecycle differs: "
                             f"{ldiff}")
            same_lines = masked(card["lines"]) == masked(cpu["lines"])
            check(same_lines, f"serve_cluster {name}: printed lines differ: "
                              f"{card['lines']} vs {cpu['lines']}")
            launches = card["launches"]
            check(launches["paged_attention"] > 0
                  and launches["flash_attention"] > 0,
                  f"serve_cluster {name}: launches {launches}")
            _check_group_launches(group, launches,
                                  group.model.cfg.num_layers)
            rec = {"argv": argv, "seconds": card["seconds"],
                   "cpu_seconds": cpu["seconds"], "requests": len(reqs),
                   "tokens": sum(len(r[2]) for r in reqs),
                   "launches": launches,
                   "stats": {k: st[k] for k in (
                       "cluster_steps", "engine_steps", "checkpoints",
                       "holds_issued", "unreclaimed")},
                   "lifecycle": life.stats(),
                   "requests_equal_cpu": True, "stats_equal_cpu": True,
                   "printed_equal_cpu": True, "printed": card["lines"]}
            if name == "defaults_trace":
                with open(f"{d}/card.json") as f:
                    rec["trace_events"] = validate_chrome_trace(json.load(f))
                check(rec["trace_events"] > 0, "empty trace")
            runs[name] = rec
    emit({"phase": "examples_serve_cluster", "ok": True,
          "seconds": sum(r["seconds"] for r in runs.values()),
          "cpu_seconds": sum(r["cpu_seconds"] for r in runs.values()),
          "runs": runs})


def phase_examples_train_lm(torch):
    """``examples/train_lm_torch.py``'s default model (qwen2-100m, f32,
    batches of 8 x 128) on the card through its ``main``: 200 steps with
    a checkpoint every 50, then 200 steps with a failure before step 120.
    The example's own assert holds in both (the loss falls), the failure
    run restarts once from step 99's checkpoint, and every loss of it,
    the 20 replayed steps included, equals the clean run's bit for bit.
    Each run's wall time less its steps' own (``time_s``, which ends
    before the step's checkpoint is taken) is what the checkpoints, the
    pipeline and, after the failure, the restore cost: measured inside
    one run, since two runs' step times differ by more than the writes
    take.  The checkpoints live in a temporary directory, removed
    afterwards.  Then one step of the example's own model at its batch
    of 8 x 128 (the flash forward and backward at 12 heads on 2, G 6)
    through the kernels against the plain versions: ``train_f32_check``,
    the loss, the grad norm and every gradient leaf, on the example's
    seed-0 weights with the attention projections conditioned."""
    import tempfile

    from repro_torch.kernels.flash_attention import flash_attention_bwd_kernel
    from repro_torch.kernels.flash_attention import flash_attention_kernel

    mod = load_example("train_lm_torch")
    seen = {}
    run = mod.run

    def recording(cfg, shape, steps, **kw):
        seen.update(cfg=cfg, shape=shape)
        return run(cfg, shape, steps, **kw)

    mod.run = recording
    kernels = (flash_attention_kernel, flash_attention_bwd_kernel)
    runs = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_lm_") as d:
        for name, extra in (
                ("clean", []),
                ("failure", ["--inject-failure", str(EX_TRAIN_FAIL_AT)])):
            _reset(kernels)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, lines = quiet(mod.main, [
                "--steps", str(EX_TRAIN_STEPS), "--ckpt-dir", f"{d}/{name}",
                *extra])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            times = [h["time_s"] for h in out["history"]]
            runs[name] = {
                "seconds": seconds, "outside_steps_s": seconds - sum(times),
                "restarts": out["restarts"],
                "final_step": out["final_step"],
                "checkpoints": out["checkpoints"],
                "launches": {"flash_attention": flash_attention_kernel.launches,
                             "flash_attention_bwd":
                                 flash_attention_bwd_kernel.launches},
                "steps_run": len(times), "step_s_sum": sum(times),
                "median_step_s": statistics.median(times[1:]),
                "losses": [h["loss"] for h in out["history"]],
                "history_steps": [h["step"] for h in out["history"]],
                "printed": lines}
    mod.run = run
    clean, fail = runs["clean"], runs["failure"]
    L = seen["cfg"].num_layers
    want = {"flash_attention": 2 * L * EX_TRAIN_STEPS,
            "flash_attention_bwd": L * EX_TRAIN_STEPS}
    check(clean["launches"] == want,
          f"train_lm launches {clean['launches']}, want {want}")
    check(clean["restarts"] == 0 and fail["restarts"] == 1
          and fail["final_step"] == EX_TRAIN_STEPS,
          f"train_lm restarts {clean['restarts']} / {fail['restarts']}, "
          f"final step {fail['final_step']}")
    restored = (EX_TRAIN_FAIL_AT // 50) * 50  # the example saves every 50
    check(fail["history_steps"] == list(range(EX_TRAIN_FAIL_AT))
          + list(range(restored, EX_TRAIN_STEPS)),
          f"train_lm failure run's steps {fail['history_steps']}")
    want_loss = clean["losses"]
    diffs = {s: (x, want_loss[s]) for s, x in zip(fail["history_steps"],
                                                   fail["losses"])
             if x != want_loss[s]}
    check(not diffs, f"train_lm: losses differ from the clean run's "
                     f"(step: failure run, clean run): {diffs}")
    emit({"phase": "examples_train_lm", "ok": True,
          "arch": seen["cfg"].name, "params": clean["printed"][0],
          "batch": seen["shape"].global_batch, "seq": seen["shape"].seq_len,
          "steps": EX_TRAIN_STEPS, "fail_at": EX_TRAIN_FAIL_AT,
          "replayed_from": restored, "replay_identical": True,
          "loss_first_last": [want_loss[0], want_loss[-1]],
          "tokens_per_s": (seen["shape"].global_batch
                           * seen["shape"].seq_len
                           / clean["median_step_s"]),
          "runs": {k: {kk: vv for kk, vv in v.items()
                       if kk not in ("losses", "history_steps")}
                   for k, v in runs.items()},
          "losses": want_loss})
    train_f32_check(torch, "examples_train_lm_f32", seen["cfg"],
                    seen["cfg"].num_layers, seen["shape"].global_batch,
                    seen["shape"].seq_len)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="add torch.profiler windows over an engine run, "
                         "over a prefill and decode steps of the SSM, "
                         "encoder-decoder, hybrid and MoE models, and over "
                         "8 engine steps of each family")
    args = ap.parse_args()
    t_start = time.perf_counter()

    # the caching allocator grows segments in place rather than keeping
    # fixed ones: zamba2's training step over HY_TRAIN_LAYERS then reserves
    # what it allocates (70.6 GB against 69.7 on an H100 80GB HBM3), not
    # 79–81 GB; it must be set before the first allocation
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase = "device"
    try:
        phase_device(torch)
        phase = "build"
        phase_build()
        phase = "kernel_parity"
        errs = phase_parity(torch)
        phase = "block_gather_parity"
        errs.update(phase_block_gather_parity(torch))
        phase = "sampler_parity"
        phase_sampler_parity(torch)
        phase = "small_reference"
        phase_small_reference(torch)
        # the examples, as a user runs them (no torch.no_grad around them),
        # early: late in this process the same training steps take twice
        # as long
        phase = "examples_quickstart"
        phase_examples_quickstart(torch)
        phase = "examples_serve_paged"
        phase_examples_serve_paged(torch)
        phase = "examples_serve_cluster"
        phase_examples_serve_cluster(torch)
        phase = "examples_train_lm"
        phase_examples_train_lm(torch)
        torch.cuda.empty_cache()

        phase = "init"
        from repro_torch.configs import ARCHS, ShapeConfig
        from repro_torch.models import Model

        t0 = time.perf_counter()
        model = Model(ARCHS["qwen2-0.5b"])
        seeded = model.init_params(seed=0)
        p_own = model.compute_params(seeded)
        params = model.compute_params(conditioned(model, seeded))
        del seeded
        torch.cuda.synchronize()
        emit({"phase": "init", "ok": True, "params": model.n_params(),
              "seconds": time.perf_counter() - t0,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
        with torch.no_grad():
            phase = "layers"
            phase_layers(torch, model, p_own)
            phase = "model"
            phase_model(torch, model, params, p_own)
            del p_own
            phase = "engine"
            launches, wall, base = phase_engine(torch, model, params)
            phase = "kernel_table"
            table = phase_kernel_table(torch, launches, errs)
            phase = "fork_engine"
            fork_launches = phase_fork_engine(torch, model, params)
            phase = "block_gather_table"
            gather_rows = block_gather_table_rows(torch, fork_launches)
            table += gather_rows
            phase = "flash_prefill_parity"
            errs.update(phase_flash_prefill_parity(torch))
            phase = "unchunked_engine"
            whole_launches, admissions = phase_unchunked_engine(
                torch, model, params, base)
            phase = "whole_prompt_flash_table"
            table.append(whole_prompt_flash_row(torch, whole_launches,
                                                admissions, errs))
            phase = "spec_engine"
            phase_spec_engine(torch, model, params, base)
            phase = "spec_fork_engine"
            phase_spec_fork_engine(torch, model, params)
            phase = "policy_sweep"
            phase_policy_sweep(torch, model, params)
            gathers = {"fork_engine": fork_launches["block_gather"]}
            phase = "cluster_f32_baseline"
            f32 = cluster_f32_baseline(torch)
            phase = "cluster_engine"
            gathers[phase] = phase_cluster_engine(torch, model, params, base,
                                                  f32)
            phase = "disagg_engine"
            gathers[phase] = phase_disagg_engine(torch, model, params, base,
                                                 f32)
            phase = "lifecycle_engine"
            gathers[phase] = phase_lifecycle_engine(torch, model, params,
                                                    base, f32)
            del f32
            torch.cuda.empty_cache()
            for row in gather_rows:
                # the gather's launches on every path that runs it: the
                # fork plane's page copies and the cluster plane's reads
                row["launches"] = sum(gathers.values())
                row["launches_by_phase"] = dict(gathers)
            if args.profile:
                phase = "profile"
                phase_profile(torch, model, params, wall)
            del model, params
            torch.cuda.empty_cache()

            phase = "ssd_parity"
            errs.update(phase_ssd_parity(torch))
            phase = "ssm_init"
            t0 = time.perf_counter()
            cfg = ARCHS["mamba2-2.7b"]
            model = Model(cfg)
            model32 = Model(cfg.scaled(dtype="float32"))
            params32 = model.init_params(seed=0)
            params = model.compute_params(params32)
            tokens = torch.from_numpy(
                ssm_prompts(model.cfg.vocab_size)).to(model.device)
            torch.cuda.synchronize()
            emit({"phase": "ssm_init", "ok": True, "arch": model.cfg.name,
                  "params": model.n_params(),
                  "seconds": time.perf_counter() - t0,
                  "mem_gb": torch.cuda.memory_allocated() / 1e9})
            phase = "ssm_layers"
            phase_ssm_layers(torch, model, params, tokens)
            phase = "ssm_model"
            phase_ssm_model(torch, model, params, model32, params32, tokens)
            del model32, params32
            torch.cuda.empty_cache()
            phase = "ssm_generate"
            ssm_launches = phase_ssm_generate(torch, model, params, tokens)
            phase = "ssd_table"
            table.append(ssd_table_row(torch, ssm_launches, errs))
            if args.profile:
                phase = "ssm_profile"
                phase_ssm_profile(torch, model, params, tokens)
            del model, params, tokens
            torch.cuda.empty_cache()

            phase = "decode_parity"
            errs.update(phase_decode_parity(torch))
            phase = "per_slot_parity"
            errs.update(phase_per_slot_parity(torch))
            phase = "flash_noncausal_parity"
            errs.update(phase_flash_noncausal_parity(torch))
            phase = "encdec_init"
            t0 = time.perf_counter()
            cfg = ARCHS["seamless-m4t-medium"]
            model = Model(cfg)
            model32 = Model(cfg.scaled(dtype="float32"))
            params32 = conditioned(model, model.init_params(seed=0))
            params = model.compute_params(params32)
            enc, toks = encdec_inputs(torch, model)
            pool = model.cache_specs(ShapeConfig(
                "serve", "decode", ED_MAX_SEQ, ED_BATCH))["self"]["k_pool"]
            ed_table = local_table(torch, ED_BATCH, pool.shape[2],
                                   -(-ED_MAX_SEQ // 128) + 1)
            torch.cuda.synchronize()
            emit({"phase": "encdec_init", "ok": True, "arch": cfg.name,
                  "params": model.n_params(),
                  "seconds": time.perf_counter() - t0,
                  "block_table": ed_table.tolist(),
                  "mem_gb": torch.cuda.memory_allocated() / 1e9})
            phase = "encdec_layers"
            phase_encdec_layers(torch, model, params, enc, toks, ed_table)
            phase = "encdec_model"
            phase_encdec_model(torch, model, params, model32, params32, enc,
                               toks, ed_table)
            del model32, params32
            torch.cuda.empty_cache()
            phase = "encdec_generate"
            ed_launches = phase_encdec_generate(torch, model, params, enc,
                                                toks, ed_table)
            phase = "encdec_table"
            table += encdec_table_rows(torch, ed_launches, errs)
            if args.profile:
                phase = "encdec_profile"
                phase_encdec_profile(torch, model, params, enc, toks,
                                     ed_table)
            del model, params, enc, toks
            torch.cuda.empty_cache()

            phase = "flash_anyd_parity"
            errs.update(phase_flash_anyd_parity(torch))
            phase = "hybrid_kernel_parity"
            errs.update(phase_hybrid_kernel_parity(torch))
            phase = "hybrid_init"
            t0 = time.perf_counter()
            cfg = ARCHS["zamba2-7b"]
            model = Model(cfg)
            model32 = Model(cfg.scaled(dtype="float32"))
            params32 = conditioned(model, model.init_params(seed=0))
            params = model.compute_params(params32)
            tokens = torch.from_numpy(
                hybrid_prompts(cfg.vocab_size)).to(model.device)
            hy_table = local_table(torch, HY_BATCH, HY_POOL, HY_POOL)
            torch.cuda.synchronize()
            emit({"phase": "hybrid_init", "ok": True, "arch": cfg.name,
                  "params": model.n_params(),
                  "seconds": time.perf_counter() - t0,
                  "block_table": hy_table.tolist(),
                  "mem_gb": torch.cuda.memory_allocated() / 1e9})
            phase = "hybrid_layers"
            phase_hybrid_layers(torch, model, params, tokens, hy_table)
            del params
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            phase = "hybrid_model"
            params = phase_hybrid_model(torch, model, model32, params32,
                                        tokens, hy_table)
            del model32, params32
            torch.cuda.empty_cache()
            phase = "hybrid_generate"
            hy_launches = phase_hybrid_generate(torch, model, params, tokens,
                                                hy_table)
            phase = "hybrid_table"
            table += hybrid_table_rows(torch, hy_launches, errs)
            if args.profile:
                phase = "hybrid_profile"
                phase_hybrid_profile(torch, model, params, tokens, hy_table)
            del model, params, tokens, hy_table
            torch.cuda.empty_cache()

            phase = "flash_window_parity"
            errs.update(phase_flash_window_parity(torch))
            phase = "ring_decode_parity"
            errs.update(phase_ring_decode_parity(torch))
            phase = "moe_init"
            t0 = time.perf_counter()
            cfg = ARCHS["mixtral-8x7b"].scaled(num_layers=MX_LAYERS)
            model = Model(cfg)
            params = model.compute_params(
                conditioned(model, model.init_params(seed=0)))
            tokens = torch.from_numpy(
                mixtral_prompts(cfg.vocab_size)).to(model.device)
            torch.cuda.synchronize()
            emit({"phase": "moe_init", "ok": True, "arch": cfg.name,
                  "layers": f"{MX_LAYERS} of "
                            f"{ARCHS['mixtral-8x7b'].num_layers}",
                  "params": model.n_params(),
                  "seconds": time.perf_counter() - t0,
                  "mem_gb": torch.cuda.memory_allocated() / 1e9})
            phase = "moe_layers"
            phase_moe_layers(torch, model, params, tokens)
            # the f32 checks need the card: the bf16 tree is cast again
            # from the same seed's f32 tree after them
            del params
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            phase = "moe_model"
            params32 = conditioned(model, model.init_params(seed=0))
            params = phase_moe_model(torch, model, params32, tokens)
            del params32
            torch.cuda.empty_cache()
            phase = "moe_generate"
            mx_launches = phase_moe_generate(torch, model, params, tokens)
            phase = "moe_table"
            table += moe_table_rows(torch, mx_launches, errs)
            if args.profile:
                phase = "moe_profile"
                phase_moe_profile(torch, model, params, tokens)
            del model, params, tokens
            torch.cuda.empty_cache()

            for name in FAMILIES:
                phase = f"families_engine {name}"
                table += phase_family_engine(torch, name, args.profile)

            phase = "vlm_kernel_parity"
            errs.update(phase_vlm_kernel_parity(torch))
            phase = "vlm_init"
            model, params32, fe, toks, vl_table = phase_vlm_init(torch)
            phase = "vlm_model"
            phase_vlm_model(torch, params32, fe, toks)
            params = model.compute_params(params32)
            del params32
            torch.cuda.empty_cache()
            phase = "vlm_layers"
            phase_vlm_layers(torch, model, params, fe, toks, vl_table)
            phase = "vlm_generate"
            vl_launches = phase_vlm_generate(torch, model, params, fe, toks,
                                             vl_table)
            del model, params, fe, toks, vl_table
            torch.cuda.empty_cache()
            phase = "vlm_table"
            table += vlm_table_rows(torch, vl_launches, errs)

            phase = "flash_bwd_parity"
            errs.update(phase_flash_bwd_parity(torch))
            torch.cuda.empty_cache()
            phase = "train_f32"
            phase_train_f32(torch)
            torch.cuda.empty_cache()
            model = Model(ARCHS["qwen2-0.5b"])
            phase = "train_grads"
            phase_train_grads(torch, model)
            torch.cuda.empty_cache()
            phase = "train_steps"
            tr_launches = phase_train_steps(torch, model)
            del model
            torch.cuda.empty_cache()
            phase = "train_table"
            table += train_table_rows(torch, tr_launches, errs)

            phase = "ssd_bwd_parity"
            errs.update(phase_ssd_bwd_parity(torch))
            torch.cuda.empty_cache()
            tr_launches = {}
            for fam, name, layers, f32_layers, f32_batch in SSM_TRAIN_RUNS:
                phase = f"{fam}_train_f32"
                train_f32_check(torch, phase, ARCHS[name], f32_layers,
                                f32_batch)
                torch.cuda.empty_cache()
                cfg = ARCHS[name]
                model = Model(cfg if layers is None
                              else cfg.scaled(num_layers=layers))
                phase = f"{fam}_train_grads"
                phase_family_train_grads(torch, phase, model)
                torch.cuda.empty_cache()
                phase = f"{fam}_train_steps"
                tr_launches[fam] = phase_family_train_steps(torch, phase,
                                                            model)
                del model
                torch.cuda.empty_cache()
            phase = "ssm_train_table"
            table += ssm_train_table_rows(torch, tr_launches, errs)
    except Exception as exc:  # report which phase failed, then fail
        emit({"phase": phase, "ok": False,
              "error": f"{type(exc).__name__}: {exc}"})
        return 1
    emit({"phase": "wall", "seconds": time.perf_counter() - t_start})
    emit({"kernels": table})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
