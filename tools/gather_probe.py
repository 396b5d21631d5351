#!/usr/bin/env python3
"""Where a block-gather call's time goes on a cold L2, and which launch
plan the gather should take.

    python3 tools/gather_probe.py [--rounds 7] [--old OLD/src] [--out PATH]

Rows: the serving path's gather sizes, bf16 pages of qwen2-0.5b ((128,
2, 64) = 32 KB; M 24 and 144 from the engine's 3,072-page pool, M 192
from a cluster replica's 1,536-page pool with the index ``read_pages``
builds for a handoff of 8 pages); M 24 of seamless-m4t-medium's 256 KB
pages from a 512-page pool; and M 1536 of the 32 KB pages (50 MB, a
copy long enough to be bound by bandwidth).  In each row it times every
variant below with a cold L2 (one call after 256 MB were written,
``chip_smoke.cold_ms``), all variants in turns, then in the reverse
order, ``--rounds`` times:

  * ``empty``: an empty kernel from the gather's own library with as
    many blocks as the default plan (the launch floor and its cold code
    fetch);
  * ``index``: a kernel that only reads the index, one entry a block;
  * ``kernel`` / ``kernel_contig``: the gather under its default plan
    over the row's index and over a contiguous run of M pages (no TLB
    spread);
  * ``piece_<n>K``: the gather under the plan of n KB pieces, 16-byte
    words, one block of 256 threads a piece (16 KB: 4 words in flight a
    thread);
  * ``old``: with ``--old``, the gather of an older tree (its ``src/``
    directory, e.g. an unpacked ``git archive``), built here;
  * ``index_select`` / ``index_select_contig``: ``torch.index_select``
    on the same pool and indices.

Every variant is first held bit for bit against ``pool[idx]``.  The
kernel, ``piece_16K``, the old kernel and ``index_select``
also get their warm device time (``chip_smoke.queued_ms``) and their
host time per call (``chip_smoke.host_us``), in turns; so do the parts
of the wrapper's host path: the output's allocation, ``plan_gather``
and the C entry alone.  Last, the kernel and ``index_select`` on a cold
L2 again, in turns, after a ``torch.profiler`` window over 20 kernel
calls (``chip_smoke._profile_window``).  Prints one JSON line per row with the median of
each variant, then the card's name and power limit; every reading goes
to ``--out`` (default ``build/gather_probe/readings.json``).  Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import struct
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

#: seamless-m4t-medium's self-attention page: 128 rows of 16 heads of 64
SEAMLESS_PAGE = (128, 16, 64)
#: the row bound by bandwidth: half the engine's pool
LARGE_M = 1536


def build_old(old_src: Path) -> ctypes.CDLL:
    """The older tree's gather, compiled with this tree's nvcc flags."""
    from repro_torch.kernels import _build

    csrc = old_src / "repro_torch" / "kernels" / "csrc"
    out = ROOT / "build" / "gather_probe" / "old_block_gather.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc),
                    "-o", str(out), str(csrc / "block_gather.cu")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    lib.repro_block_gather.argtypes = [ctypes.c_char_p]
    lib.repro_block_gather.restype = ctypes.c_int
    return lib


def row_inputs(torch, chip_smoke, m, page):
    if page == "seamless":
        return chip_smoke.gather_inputs(torch, torch.bfloat16, 512,
                                        SEAMLESS_PAGE, m, seed=5)
    if m == chip_smoke.GATHER_M[-1]:
        pool = chip_smoke.replica_pool(torch, torch.bfloat16, seed=5)
        return pool, chip_smoke.handoff_index(
            torch, m // chip_smoke.N_LAYERS).to("cuda")
    return chip_smoke.gather_inputs(torch, torch.bfloat16,
                                    chip_smoke.QWEN_POOL_PAGES,
                                    chip_smoke.QWEN_PAGE, m, seed=5)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--old", type=Path, default=None,
                    help="an older tree's src/ directory")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "gather_probe" / "readings.json",
                    help="where every reading is written (JSON)")
    args = ap.parse_args()

    import torch

    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels import block_gather as bg
    from repro_torch.kernels import ref

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    old = build_old(args.old) if args.old else None
    planner = bg.plan_gather
    rows = [(m, "qwen2") for m in chip_smoke.GATHER_M]
    rows += [(24, "seamless"), (LARGE_M, "qwen2")]
    summary, readings = [], []
    try:
        for m, page in rows:
            pool, idx = row_inputs(torch, chip_smoke, m, page)
            start = (pool.shape[0] - m) // 2
            contig = torch.arange(start, start + m, dtype=torch.int32,
                                  device="cuda")
            page_bytes = pool[0].numel() * pool.element_size()
            out = pool.new_empty((m, *pool.shape[1:]))
            plan = planner(page_bytes, m, pool.data_ptr(), out.data_ptr())
            blocks = m * plan.pieces
            plans = {"kernel": plan, "kernel_contig": plan}
            for kb in (4, 8, 16):
                piece = min(kb << 10, page_bytes)
                plans[f"piece_{kb}K"] = bg.GatherPlan(
                    piece, -(-page_bytes // piece), 16)

            def gather(p, ix):
                # the default plan through the planner itself, so that its
                # host time counts
                bg.plan_gather = planner if p is plan else (
                    lambda *_, p=p: p)
                return bg.block_gather_kernel(pool, ix)

            fns = {"empty": lambda: bg.block_gather_probe(idx, blocks),
                   "index": lambda: bg.block_gather_probe(idx, blocks,
                                                          "index")}
            for name, p in plans.items():
                ix = contig if name.endswith("_contig") else idx
                fns[name] = lambda p=p, ix=ix: gather(p, ix)
            if old is not None:
                def old_gather():
                    got = pool.new_empty((m, *pool.shape[1:]))
                    packed = struct.pack(
                        "<8q", 0, pool.data_ptr(), idx.data_ptr(),
                        got.data_ptr(), m, pool.shape[0], page_bytes,
                        torch.cuda.current_stream().cuda_stream)
                    if old.repro_block_gather(packed):
                        raise RuntimeError("old gather refused")
                    return got
                fns["old"] = old_gather
            fns["index_select"] = lambda: torch.index_select(pool, 0, idx)
            fns["index_select_contig"] = lambda: torch.index_select(
                pool, 0, contig)
            for name, fn in fns.items():
                if name in ("empty", "index"):
                    continue
                ix = contig if name.endswith("_contig") else idx
                got = fn()
                torch.cuda.synchronize()
                if not torch.equal(got, ref.block_gather(pool, ix)):
                    raise SystemExit(f"M {m} {name}: differs from pool[idx]")
            cold = {k: [] for k in fns}
            order = list(fns)
            for _ in range(args.rounds):
                for name in order + order[::-1]:
                    cold[name].append(chip_smoke.cold_ms(fns[name]))
            timed = [k for k in ("kernel", "piece_16K", "old",
                                 "index_select") if k in fns]
            warm = {k: [] for k in timed}
            for _ in range(args.rounds):
                for k in timed:
                    warm[k].append(chip_smoke.queued_ms(fns[k]))
            # the host path and its parts, on the default plan
            bg.plan_gather = planner
            _, stream = _build.device_stream(pool)
            args_c = (0, pool.data_ptr(), idx.data_ptr(), out.data_ptr(), m,
                      pool.shape[0], page_bytes, stream, *plan)
            parts = {"alloc": lambda: pool.new_empty((m, *pool.shape[1:])),
                     "plan": lambda: planner(page_bytes, m, pool.data_ptr(),
                                             out.data_ptr()),
                     "entry": lambda: bg._launch(*args_c)}
            host = {k: [] for k in timed + list(parts)}
            for _ in range(args.rounds):
                for k in host:
                    host[k].append(chip_smoke.host_us(
                        parts[k] if k in parts else fns[k]))
            # the same pair on a cold L2 once a profiler window has run
            # (the gather rows of earlier smoke runs timed it there)
            chip_smoke._profile_window(torch, lambda: [
                fns["kernel"]() for _ in range(20)])
            after = {k: [] for k in ("kernel", "index_select")}
            for _ in range(args.rounds):
                for k in list(after) + list(after)[::-1]:
                    after[k].append(chip_smoke.cold_ms(fns[k]))
            summary.append({
                "M": m, "page": page, "page_bytes": page_bytes,
                "pool_pages": pool.shape[0], "plan": plan._asdict(),
                "cold_ms": {k: statistics.median(v) for k, v in cold.items()},
                "dev_ms": {k: statistics.median(v) for k, v in warm.items()},
                "host_us": {k: statistics.median(v) for k, v in host.items()},
                "cold_after_profiler_ms": {
                    k: statistics.median(v) for k, v in after.items()},
                "bound_ms": chip_smoke.bound_ms(
                    2 * m * page_bytes + 4 * m, 0, "bfloat16")[0]})
            readings.append({"M": m, "page": page, "cold_ms": cold,
                             "dev_ms": warm, "host_us": host,
                             "cold_after_profiler_ms": after})
            print(json.dumps(summary[-1]), flush=True)
            del pool, out
    finally:
        bg.plan_gather = planner
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": smi, "rounds": args.rounds,
                                "summary": summary, "readings": readings}))
    print(json.dumps({"card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
