#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--profile]

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc,
holds each kernel against its plain PyTorch version at the full-width
shapes of its path, and drives four paths at published width with
random weights from a seed:

  * qwen2-0.5b through ``Model`` and a ``ServingEngine`` that serves 8
    requests (paged decode and flash prefill kernels, global page ids),
    then a sampled ``ServingEngine`` (temperature 0.8, top_p 0.9) with
    two best-of-4 fork groups, ``select_winner`` and a prefix-cache
    replay, every page copy through the block-gather kernel;
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
    attention over the shared block's pools).

It checks that each path went through its kernels (launch counts, and
the split combines beside them), and times each kernel beside its plain
version, its bound and a library call.  The page gather is held bit for bit, and the sampling uniforms
and the sampler against their host versions.  Every phase prints one
JSON line; the card's name and power limit
print as ``nvidia-smi`` gives them; the line before the last is the
``{"kernels": [...]}`` table and the last line is ``{"ok": true,
"device": {...}}``.  Any failed check exits nonzero.
``--profile`` adds torch.profiler windows over engine steps, and over a
prefill and decode steps of the SSM, encoder-decoder and hybrid models.

Needs a CUDA device and the repository's ``src/``; imports neither JAX
nor the JAX package.
"""

from __future__ import annotations

import argparse
import itertools
import json
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
    emit({"phase": "build", "ok": True, "seconds": seconds,
          "wall_s": time.perf_counter() - t0, "ptxas": report})


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
    ``shared_attn.attn``."""
    import math

    cfg = model.cfg
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
    mb = 9
    row = torch.zeros((mb,), dtype=torch.int32, device=dev)
    row[:2] = torch.tensor([1, 2], dtype=torch.int32)  # slot 0's pages
    table = torch.zeros((8, mb), dtype=torch.int32, device=dev)
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


def prompts():
    import numpy as np

    rs = np.random.RandomState(0)
    shared = list(rs.randint(1, 150_000, 128))
    out = []
    for i, n in enumerate(PROMPT_LENS):
        if i < 4:
            out.append(shared + list(rs.randint(1, 150_000, n - 128)))
        else:
            out.append(list(rs.randint(1, 150_000, n)))
    return out


def run_engine(torch, model, params, impl=None):
    from repro_torch.serving import ServingEngine

    eng = ServingEngine(model, max_slots=8, max_seq=1024, policy="stamp-it",
                        prefix_cache_entries=16, params=params, impl=impl,
                        device=model.device)
    reqs = [eng.submit(p, max_new_tokens=32) for p in prompts()]
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
        check(eng.steps < 2000, "engine did not converge")
    eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    step_ms = [s.elapsed_time(e) for s, e in events]
    return eng, reqs, wall, step_ms


def phase_engine(torch, model, params):
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.paged_attention import paged_attention_kernel

    # warm-up pass (allocator, cuBLAS handles, kernel loads), not counted
    run_engine(torch, model, params)
    for k in (paged_attention_kernel, flash_attention_kernel):
        k.launches = 0
        k.combine_launches = 0
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
    agree = sum(a == b for r, p in zip(reqs, preqs)
                for a, b in zip(r.generated, p.generated))
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
              agree / (32 * len(reqs)),
          "plain_first_token_agreement": first_agree / len(reqs)})
    return launches, wall


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


def phase_kernel_table(torch, launches, errs):
    """Each kernel at the engine's shapes: kernel, plain and library time
    beside the bound, all in bf16 (the compute dtype)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.flash_attention import plan_splits as flash_plan
    from repro_torch.kernels.paged_attention import paged_attention_kernel

    saved = (paged_attention_kernel.launches, flash_attention_kernel.launches)
    bf = torch.bfloat16
    elt = 2
    H, Hkv, D = 14, 2, 64
    # paged: the 8 slots mid-decode (prompt + 16 generated + the new token)
    lengths = [n + 17 for n in PROMPT_LENS]
    n_kv = 8  # pow2 bucket of ceil(max len / 128), capped at mb = 9
    q, kp, vp, table, lens = paged_inputs(torch, bf, lengths)
    def pfn():
        return paged_attention_kernel(q, kp, vp, table, lens, n_kv=n_kv,
                                      global_pages=True)

    k_ms = time_ms(pfn)
    p_ms = time_ms(lambda: ref.paged_attention(q, kp, vp, table, lens,
                                               n_kv=n_kv,
                                               global_pages=True))

    tok = sum(lengths)
    n_bytes = (2 * q.numel() * elt + tok * Hkv * D * 2 * elt
               + table.numel() * 4 + lens.numel() * 4)
    flops = 4 * H * D * tok
    b_ms, b_by = bound_ms(n_bytes, flops, "bfloat16")
    paged = {"name": "paged_attention", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
             "replaces": "src/repro/kernels/paged_attention.py:128",
             "launches": launches["paged_attention"],
             "max_abs_err": errs["paged_attention", "bfloat16"],
             "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
             "bound_by": b_by, "library_ms": None,
             **device_timings(torch, pfn),
             "plan": paged_plan_fields(8, Hkv, n_kv, lengths),
             "library_note": "no single PyTorch call attends over pages "
                             "named by a block table",
             "shape": f"B=8 lengths={lengths} n_kv={n_kv} H={H} Hkv={Hkv} "
                      f"D={D} global ids"}
    # flash: the last chunk of the 900-token prompt (start 768, 8 pages),
    # and the first chunk of every prompt (start 0, one page)
    rows = [paged]
    for name, off, S_kv in (("flash_attention", 768, 1024),
                            ("flash_attention_first_chunk", 0, 128)):
        S_q = 128
        q, k, v = flash_inputs(torch, bf, S_kv)
        kfn = (lambda q=q, k=k, v=v, off=off: flash_attention_kernel(
            q, k, v, causal=True, q_offset=off))
        k_ms = time_ms(kfn)
        p_ms = time_ms(lambda: ref.flash_attention(q, k, v, causal=True,
                                                   q_offset=off))
        qpos = torch.arange(S_q, device=q.device)[:, None] + off
        mask = torch.arange(S_kv, device=q.device)[None, :] <= qpos
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lfn = (lambda qt=qt, kt=kt, vt=vt, mask=mask:
               F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              enable_gqa=True))
        l_ms = time_ms(lfn)
        keys = sum(min(off + i + 1, S_kv) for i in range(S_q))
        kv_rows = min(off + S_q, S_kv)
        n_bytes = (2 * q.numel() * elt + 2 * kv_rows * Hkv * D * elt)
        flops = 4 * H * D * keys
        b_ms, b_by = bound_ms(n_bytes, flops, "bfloat16")
        plan = flash_plan(1, S_q, H, S_kv, q_offset=off, causal=True,
                          head_dim=D)
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:85",
            "launches": launches["flash_attention"],
            "max_abs_err": errs["flash_attention", "bfloat16"],
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": l_ms,
            **device_timings(torch, kfn, lfn),
            "library_note": "scaled_dot_product_attention, boolean causal "
                            "mask, enable_gqa=True (timed only)",
            "shape": f"S_q={S_q} S_kv={S_kv} q_offset={off} H={H} "
                     f"Hkv={Hkv} D={D} warpgroups={plan.consumers} "
                     f"key_tile={plan.keys} splits={plan.splits}"})
    paged_attention_kernel.launches, flash_attention_kernel.launches = saved
    return rows


# ---------------------------------------------------------------------------
# page copies, the sampler and the copy-on-write fork plane (qwen2-0.5b)
# ---------------------------------------------------------------------------
# qwen2's engine pool, both layers' K (or V) viewed as one page array:
# L 24 x B 8 x N_pool 16 pages of (128, 2, 64) bf16 (32 KiB each)
QWEN_POOL_PAGES, QWEN_PAGE = 24 * 8 * 16, (128, 2, 64)
# one CoW copy gathers 1 page x 24 layers; the fork_engine replay 6 x 24
GATHER_M = (24, 144)
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


def phase_block_gather_parity(torch):
    """The gather kernel against ``pool[idx]``: a copy, so bit-exact.
    qwen2's and seamless's pages and a 30-byte bf16 page (the kernel's
    narrow-word path)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.block_gather import block_gather_kernel

    saved = block_gather_kernel.launches
    rows = []
    cases = [(d, p, m) for d in ("float32", "bfloat16")
             for p in (QWEN_PAGE, (128, 16, 64)) for m in (1, 24, 144)]
    cases.append(("bfloat16", (3, 1, 5), 24))
    for dname, page, m in cases:
        pool, idx = gather_inputs(torch, getattr(torch, dname), 512, page, m)
        got = block_gather_kernel(pool, idx)
        want = ref.block_gather(pool, idx)
        torch.cuda.synchronize()
        same = bool(torch.equal(got, want))
        rows.append({"dtype": dname, "page": list(page), "M": m,
                     "page_bytes": pool[0].numel() * pool.element_size(),
                     "bit_exact": same})
        check(same, f"block_gather {dname} {page} M={m} differs")
    block_gather_kernel.launches = saved
    emit({"phase": "block_gather_parity", "ok": True, "tol": 0,
          "cases": rows})
    return {("block_gather", "bfloat16"): 0.0}


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
    for k in kernels:
        k.launches = 0
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


def block_gather_table_rows(torch, launches, errs):
    """The gather at the fork run's two sizes over qwen2's pool, bf16:
    kernel, ``pool[idx]`` and ``index_select`` time beside the bound (each
    gathered byte read once and written once, plus the index)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.block_gather import block_gather_kernel

    saved = block_gather_kernel.launches
    rows = []
    for m, what in zip(GATHER_M, ("one CoW copy (1 page x 24 layers)",
                                  "the replay (6 pages x 24 layers)")):
        pool, idx = gather_inputs(torch, torch.bfloat16, QWEN_POOL_PAGES,
                                  QWEN_PAGE, m, seed=5)
        fns = {"kernel": lambda: block_gather_kernel(pool, idx),
               "plain": lambda: ref.block_gather(pool, idx),
               "library": lambda: torch.index_select(pool, 0, idx)}
        k_ms, p_ms, l_ms = (time_ms(f) for f in fns.values())
        # at these sizes a call's host enqueue outlasts its device work,
        # so the event times above read the host; the profiler gives the
        # device time of each call's kernels
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
                     "max_abs_err": errs["block_gather", "bfloat16"],
                     "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": l_ms,
                     "host_us": host["kernel"],
                     "library_host_us": host["library"],
                     "library_note": "torch.index_select on the same "
                                     "flattened pool (timed only)",
                     "shape": f"pool ({QWEN_POOL_PAGES}, 128, 2, 64) M={m}: "
                              f"{what}",
                     "bytes": n_bytes, "device_ms": dev_ms})
    block_gather_kernel.launches = saved
    return rows


# ---------------------------------------------------------------------------
# the SSM path: mamba2-2.7b prefill (SSD scan kernel) and greedy decode
# ---------------------------------------------------------------------------
def ssd_inputs(torch, dtype, B, S, H, P, N, seed=2):
    """Scan operands as ``mamba_full`` makes them: x, B and C in the
    activation dtype, dt = softplus(...) and a = -exp(...) in f32."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((B, S, H, P), generator=g, device=dev) * 0.3
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=g, device=dev) - 1.0)
    a = -torch.exp(torch.randn((H,), generator=g, device=dev) * 0.3)
    b = torch.randn((B, S, 1, N), generator=g, device=dev) * 0.3
    c = torch.randn((B, S, 1, N), generator=g, device=dev) * 0.3
    d = torch.randn((H,), generator=g, device=dev)
    return x.to(dtype), dt, a, b.to(dtype), c.to(dtype), d


def phase_ssd_parity(torch):
    """The SSD kernel against the plain scan, y and the final state, each
    held to the dtype's tolerance times its largest magnitude: the
    prefill shape in f32 and bf16, one short chunk (S = 127), and a
    smoke shape whose head count is not a multiple of 8."""
    full = SSD_SHAPE
    cases = [dict(full), dict(full, S=127, chunk=127),
             dict(B=2, S=256, H=6, P=32, N=16, chunk=128)]
    rows, errs = ssd_cases(torch, cases, full, "ssd_scan")
    emit({"phase": "ssd_parity", "ok": True, "cases": rows})
    return errs


def ssd_cases(torch, cases, full, err_name):
    """Each case in f32 and bf16, y and the final state held to the
    dtype's tolerance times each one's largest magnitude; the errors of
    case ``full`` are returned under ``err_name``."""
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
            for name, g_, w_ in (("y", got[0], want[0]),
                                 ("state", got[1], want[1])):
                check(bool(torch.isfinite(g_).all()), f"ssd {name} not finite")
                e, scale = max_err(g_, w_), float(w_.float().abs().max())
                row[f"{name}_max_abs_err"], row[f"{name}_max_abs"] = e, scale
                check(e <= KERNEL_TOL[dname] * scale,
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


def greedy_decode(torch, model, params, logits, cache, batch, steps):
    """``steps`` greedy decode steps from ``logits``; ``batch`` holds the
    inputs besides the tokens ("lengths" advance by one a step).  Checks
    that the last logits are finite and every token lies in the
    vocabulary; returns the tokens (B, steps + 1), each step's CUDA-event
    ms and the loop's wall seconds."""
    batch = dict(batch)
    nxt = logits.argmax(-1).to(torch.int32)
    generated, events = [nxt], []
    t0 = time.perf_counter()
    for _ in range(steps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        logits, cache = model.decode_step(params, cache,
                                          dict(batch, tokens=nxt[:, None]))
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
    for k in kernels.values():
        k.launches = 0
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


def ssd_table_row(torch, launches, errs, name="ssd_scan", sh=SSD_SHAPE):
    """The SSD kernel at a prefill shape, bf16: kernel and plain time
    beside the bound, and the kernel's device and cold-L2 times."""
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
            "bytes": n_bytes, "flops": flops}


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
    for k in kernels.values():
        k.launches = 0
    for k in (flash_attention_kernel, decode_attention_kernel,
              paged_attention_kernel):
        k.combine_launches = 0
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
    64) and the per-slot paged kernel at its shared block's decode shape
    (G 1, head dim 112, 10 pages of 128 per slot; also at a tile's split
    edges and the full sweep, with q scaled up), in f32 and bf16."""
    rows, errs = ssd_cases(torch, [dict(HY_SSD_SHAPE)], HY_SSD_SHAPE,
                           "ssd_scan_zamba2")
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
    for k in kernels.values():
        k.launches = 0
    for k in (flash_attention_kernel, paged_attention_kernel):
        k.combine_launches = 0
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="add torch.profiler windows over an engine run, "
                         "and over a prefill and decode steps of the SSM, "
                         "encoder-decoder and hybrid models")
    args = ap.parse_args()

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
            launches, wall = phase_engine(torch, model, params)
            phase = "kernel_table"
            table = phase_kernel_table(torch, launches, errs)
            phase = "fork_engine"
            fork_launches = phase_fork_engine(torch, model, params)
            phase = "block_gather_table"
            table += block_gather_table_rows(torch, fork_launches, errs)
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
    except Exception as exc:  # report which phase failed, then fail
        emit({"phase": phase, "ok": False,
              "error": f"{type(exc).__name__}: {exc}"})
        return 1
    emit({"kernels": table})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
