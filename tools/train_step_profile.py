#!/usr/bin/env python3
"""Where a steady-state training step's time goes on one card.

    python3 tools/train_step_profile.py [--arch NAME] [--layers L]
        [--warm 4] [--timed 6]

Runs ``chip_smoke.py``'s training cell (``--arch``, qwen2-0.5b by
default, at full width or over its first ``--layers``, bf16, remat
"full", 2 sequences of 4096 from the synthetic pipeline, no
checkpoints) through a ``Trainer``: ``--warm`` steps to warm up,
``--timed`` steps timed on the host clock (the ``Trainer``'s own
``time_s``: from the batch's copy to the loss read back), then one more
step under ``torch.profiler`` (CPU and CUDA activities).  Prints one
JSON line: the step times and their median, tokens/s, peak memory, the
profiled step's wall and device-busy time, the device time by group
(the SSD backward's kernels and the forward's, the flash backward's and
the forward's, GEMMs, the rest) and the kernels that take the most.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

#: device-time groups by kernel name, first match wins
GROUPS = (("ssd_backward", ("states_kernel", "pass_kernel", "col_kernel",
                            "row_kernel", "sums_kernel", "carry_kernel",
                            "chunk_kernel", "reduce_bc_kernel",
                            "reduce_heads_kernel")),
          ("ssd_forward", ("ssd_wgmma_kernel", "ssd_scan_kernel")),
          ("flash_backward", ("rows_kernel", "dkdv_kernel", "dq_kernel")),
          ("flash_forward", ("flash_wgmma_kernel", "combine_splits_kernel",
                             "flash_fwd_kernel")),
          ("gemm", ("gemm", "nvjet", "xmma", "cutlass")))


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--layers", type=int, default=0,
                    help="the first L layers (0: all)")
    ap.add_argument("--warm", type=int, default=4)
    ap.add_argument("--timed", type=int, default=6)
    args = ap.parse_args()
    WARM, TIMED = args.warm, args.timed
    # as chip_smoke.py: segments grow in place (zamba2 over 39 layers
    # reserves what it allocates); before the first allocation
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch

    if not torch.cuda.is_available():
        print("train_step_profile: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.configs import ARCHS, ShapeConfig
    from repro_torch.kernels import _build
    from repro_torch.models import Model
    from repro_torch.training import Trainer

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build(["flash_attention", "flash_attention_bwd", "ssd_scan",
                  "ssd_scan_bwd"])
    cfg = ARCHS[args.arch]
    model = Model(cfg.scaled(num_layers=args.layers) if args.layers
                  else cfg)
    shape = ShapeConfig("train_4k", "train", cs.TR_SEQ, cs.TR_BATCH)
    tr = Trainer(model, shape)
    tr.run(WARM)
    tr.run(WARM + TIMED)
    times = [h["time_s"] for h in tr.history[WARM:]]
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    reserved = torch.cuda.max_memory_reserved() / 1e9
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    with cs._profiler() as prof:
        t0 = time.perf_counter()
        tr.run(WARM + TIMED + 1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = cs._device_rows(prof)
    groups = {name: 0.0 for name, _ in GROUPS}
    groups["other"] = 0.0
    for us, key, _ in rows:
        name = next((g for g, parts in GROUPS
                     if any(p in key.lower() for p in parts)), "other")
        groups[name] += us / 1e3
    busy_ms = sum(groups.values())
    out = {"card": card, "arch": model.cfg.name,
           "layers": model.cfg.num_layers, "batch": cs.TR_BATCH,
           "seq": cs.TR_SEQ, "peak_mem_gb": peak,
           "peak_reserved_gb": reserved, "alloc_retries": retries,
           "step_s": times,
           "median_step_s": statistics.median(times),
           "tokens_per_s": cs.TR_BATCH * cs.TR_SEQ / statistics.median(
               times),
           "profiled": {"wall_ms": wall * 1e3, "device_busy_ms": busy_ms,
                        "busy_share": busy_ms / (wall * 1e3),
                        "device_ms_by_group": groups,
                        "loss": tr.history[-1]["loss"],
                        "top": [{"kernel": k[:100], "device_ms": us / 1e3,
                                 "calls": n} for us, k, n in rows[:15]]}}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
