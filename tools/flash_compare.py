#!/usr/bin/env python3
"""Time the bf16 flash kernel of two or more source trees on one card.

    python3 tools/flash_compare.py SRC [SRC ...]

Each SRC is a ``src/`` directory holding ``repro_torch`` (this checkout's
``src``, or an unpacked older commit's).  For each tree a fresh process
builds its flash kernel (into that tree's own build directory) and times
it at the paths' shapes: device time per call, 20 calls queued behind a
sleep kernel (``chip_smoke.queued_ms`` of this checkout), the median of 5
such runs.  The trees run in turns, A B B A (and so on), so that the
card's drift between them shows.  A tree whose
kernel takes no ``window`` gets null for the windowed shapes.  Prints one
JSON line per run and a summary line of the medians by tree and shape.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# name: (B, S_q, S_kv, H, Hkv, D, causal, q_offset, window)
SHAPES = {
    "encoder_d64": (8, 1024, 1024, 16, 16, 64, False, 0, 0),
    "qwen2_chunk": (1, 128, 1024, 14, 2, 64, True, 768, 0),
    "zamba2_d112": (8, 1024, 1024, 32, 32, 112, True, 0, 0),
    "mixtral_prefill_w0": (4, 6144, 6144, 32, 8, 128, True, 0, 0),
    "mixtral_prefill_w4096": (4, 6144, 6144, 32, 8, 128, True, 0, 4096),
    "mixtral_chunk_w4096": (1, 128, 6144, 32, 8, 128, True, 6016, 4096),
}

BODY = r"""
import json, statistics, sys, torch
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import flash_attention_kernel as fk
shapes = json.loads(sys.argv[1])
from chip_smoke import queued_ms
_build.build(["flash_attention"])
out = {}
g = torch.Generator(device="cuda").manual_seed(0)
for name, (B, S_q, S_kv, H, Hkv, D, causal, off, w) in shapes.items():
    q = (torch.randn((B, S_q, H, D), generator=g, device="cuda") * 0.3).bfloat16()
    k = (torch.randn((B, S_kv, Hkv, D), generator=g, device="cuda") * 0.3).bfloat16()
    v = (torch.randn((B, S_kv, Hkv, D), generator=g, device="cuda") * 0.3).bfloat16()
    kw = dict(causal=causal, q_offset=off)
    if w:
        kw["window"] = w
    try:
        fk(q, k, v, **kw)
    except NotImplementedError:
        out[name] = None
        continue
    out[name] = statistics.median(queued_ms(lambda: fk(q, k, v, **kw))
                                  for _ in range(5))
print(json.dumps(out))
"""


def run(src: str) -> dict:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(Path(src).resolve()), str(ROOT)]))
    proc = subprocess.run([sys.executable, "-c", BODY, json.dumps(SHAPES)],
                          env=env, capture_output=True, text=True,
                          check=False)
    if proc.returncode:
        raise SystemExit(f"{src}: exit {proc.returncode}\n{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    trees = sys.argv[1:]
    if not trees:
        raise SystemExit(__doc__)
    order = trees + trees[::-1]
    runs = {t: [] for t in trees}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    for t in order:
        res = run(t)
        runs[t].append(res)
        print(json.dumps({"tree": t, "dev_ms": res}), flush=True)
    summary = {t: {name: (None if any(r[name] is None for r in rs) else
                          statistics.median(r[name] for r in rs))
                   for name in SHAPES} for t, rs in runs.items()}
    print(json.dumps({"card": smi, "median_dev_ms": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
