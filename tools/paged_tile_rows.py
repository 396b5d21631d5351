#!/usr/bin/env python3
"""Device time of the paged decode kernel under tiles of 64 and 32 rows at
the qwen2-0.5b serving engine's decode shapes.

    python3 tools/paged_tile_rows.py [--rounds 5]

The engine's decode step attends 8 rows (14 query heads, 2 kv heads, D 64,
bf16, global page ids into 16 pages of 128 rows a slot) over the first
``n_kv`` columns of the block table, ``n_kv`` the power-of-two bucket of
its longest row's pages: 1, 2 and 4 in its first steps, 8 at the smoke
run's timed step.  For each ``n_kv`` the rows' lengths fill the upper half
of the swept pages (seeded).  Each plan is one tile a split (no split
larger than a tile), with the kernel's own combine.  The planner is
replaced for the timing only; each plan's output is held against the
plain version.  Times are ``chip_smoke.queued_ms`` (20 calls queued behind
a sleep kernel), in the order 64, 32, 32, 64 in each round; the line
gives every reading and the median of each plan.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

N_KV = (1, 2, 4, 8)
TILE_ROWS = (64, 32)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke
    from repro_torch.kernels import paged_attention as pmod
    from repro_torch.kernels import ref

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    B, H, Hkv, D = 8, 14, 2, 64
    planner = pmod.plan_splits
    rows = []
    try:
        for n_kv in N_KV:
            rs = np.random.RandomState(n_kv)
            lengths = [int(n) for n in rs.randint(n_kv * 64 + 1,
                                                  n_kv * 128 + 1, B)]
            q, kp, vp, table, lens = chip_smoke.paged_inputs(
                torch, torch.bfloat16, lengths)
            want = ref.paged_attention(q, kp, vp, table, lens, n_kv=n_kv,
                                       global_pages=True)
            fns = {}
            for tile in TILE_ROWS:
                n_tiles = n_kv * 128 // tile
                plan = pmod.PagedPlan(tile, n_tiles, 1)
                pmod.plan_splits = lambda *_, plan=plan: plan

                def fn():
                    return pmod.paged_attention_kernel(
                        q, kp, vp, table, lens, n_kv=n_kv, global_pages=True)

                err = chip_smoke.max_err(fn(), want)
                if err > 2e-2:
                    raise SystemExit(f"n_kv {n_kv} tile {tile}: error {err}")
                fns[tile] = (plan, fn)
            ms = {tile: [] for tile in TILE_ROWS}
            for _ in range(args.rounds):
                for tile in TILE_ROWS + TILE_ROWS[::-1]:
                    plan, fn = fns[tile]
                    pmod.plan_splits = lambda *_, plan=plan: plan
                    ms[tile].append(chip_smoke.queued_ms(fn))
            rows.append({"n_kv": n_kv, "lengths": lengths,
                         "planned": list(planner(B, Hkv, n_kv, 128)),
                         **{f"ms_{t}": v for t, v in ms.items()},
                         **{f"median_{t}": statistics.median(v)
                            for t, v in ms.items()}})
    finally:
        pmod.plan_splits = planner
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi, "shape": f"B={B} H={H} Hkv={Hkv} D={D} "
                      "bf16 global ids", "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
