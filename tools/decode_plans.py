#!/usr/bin/env python3
"""Time the contiguous decode kernel under launch plans its planner does
not pick.

    python3 tools/decode_plans.py

At mixtral's ring (B 4, 4096 rows all valid, 32/8 heads of 128) and
seamless's cross cache (B 8, 1024 of 4096 rows, 16/16 heads of 64), bf16,
the kernel runs with tiles of 64 or 128 rows and 1 to 16 tiles a split,
``decode_attention.plan_splits`` replaced for the call.  Prints one JSON
line per shape: for each plan the device time per call (20 calls queued
behind a sleep kernel, ``chip_smoke.queued_ms``; the median of 5 runs)
and the largest error against the plain version, with the plan the
planner picks marked.
Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from chip_smoke import queued_ms  # noqa: E402
from repro_torch.kernels import decode_attention as dm  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

# name: (B, H, Hkv, D, valid rows, S_max)
SHAPES = {"mixtral_ring": (4, 32, 8, 128, 4096, 4096),
          "seamless_cross": (8, 16, 16, 64, 1024, 4096)}


def main() -> int:
    smi = torch.cuda.get_device_name(0)
    g = torch.Generator(device="cuda").manual_seed(0)
    planner = dm.plan_splits
    for name, (B, H, Hkv, D, n, S_max) in SHAPES.items():
        q, k, v = ((torch.randn(shape, generator=g, device="cuda") * 0.3)
                   .bfloat16() for shape in ((B, H, D), (B, S_max, Hkv, D),
                                             (B, S_max, Hkv, D)))
        lens = torch.full((B,), n, dtype=torch.int32, device="cuda")
        want = ref.decode_attention(q, k, v, lens)
        picked = planner(B, Hkv, S_max)
        rows = {}
        try:
            for block in (64, 128):
                for per in (1, 2, 4, 8, 16):
                    plan = dm.DecodePlan(block, -(-(S_max // block) // per),
                                         per)
                    dm.plan_splits = lambda *a, plan=plan: plan
                    got = dm.decode_attention_kernel(q, k, v, lens)
                    err = float((got.float() - want.float()).abs().max())
                    ms = statistics.median(
                        queued_ms(lambda: dm.decode_attention_kernel(
                            q, k, v, lens)) for _ in range(5))
                    rows[f"block{block}_per{per}"] = {
                        "dev_ms": ms, "max_abs_err": err,
                        "planner": plan == picked}
        finally:
            dm.plan_splits = planner
        print(json.dumps({"card": smi, "shape": name, "plans": rows}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
