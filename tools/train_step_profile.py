#!/usr/bin/env python3
"""Where a steady-state training step's time goes on one card.

    python3 tools/train_step_profile.py

Runs ``chip_smoke.py``'s training cell (qwen2-0.5b at full width, bf16,
remat "full", 2 sequences of 4096 from the synthetic pipeline, no
checkpoints) through a ``Trainer``: 4 steps to warm up, 6 steps timed on
the host clock (the ``Trainer``'s own ``time_s``: from the batch's copy
to the loss read back), then one more step under ``torch.profiler``
(CPU and CUDA activities).  Prints one JSON line: the step times
and their median, tokens/s, the profiled step's wall and device-busy
time, the device time by group (the flash backward's kernels, the flash
forward's, GEMMs, the rest) and the kernels that take the most.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

WARM, TIMED = 4, 6
#: device-time groups by kernel name, first match wins
GROUPS = (("flash_backward", ("rows_kernel", "dkdv_kernel", "dq_kernel")),
          ("flash_forward", ("flash_wgmma_kernel", "combine_splits_kernel",
                             "flash_fwd_kernel")),
          ("gemm", ("gemm", "nvjet", "xmma", "cutlass")))


def main() -> int:
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
    _build.build(["flash_attention", "flash_attention_bwd"])
    model = Model(ARCHS["qwen2-0.5b"])
    shape = ShapeConfig("train_4k", "train", cs.TR_SEQ, cs.TR_BATCH)
    tr = Trainer(model, shape)
    tr.run(WARM)
    tr.run(WARM + TIMED)
    times = [h["time_s"] for h in tr.history[WARM:]]
    torch.cuda.synchronize()
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
    out = {"card": card, "arch": model.cfg.name, "batch": cs.TR_BATCH,
           "seq": cs.TR_SEQ, "step_s": times,
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
