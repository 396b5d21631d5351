#!/usr/bin/env python3
"""Device time of the SSD backward's bf16 kernels against variants of
their source, at mamba2's and zamba2's train shapes.

    python3 tools/ssd_bwd_probe.py [--rounds 5]

Each variant is ``csrc/ssd_scan_bwd.cu`` built with one more macro
(``VARIANTS``), on its own under ``build/ssd_bwd_probe/``, and called
through the same wrapper (its C entry swapped in for the timing only);
the line says whether its gradients equal the base build's bit for bit
(each variant here keeps the arithmetic).  Each call reports each
kernel's device time (the entry's CUDA events, ``timing=``); in each
round the libraries run in the order base, variants, variants reversed,
base, three calls each, and the line gives every kernel's median and the
call's total for each library.  Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

OUT_DIR = ROOT / "build" / "ssd_bwd_probe"


#: name -> (what it changes, the macro it is built with)
VARIANTS = {"cb_per_head": ("C . B^T formed in every head's pass (as a "
                            "kernel without the head group's sharing "
                            "would) instead of once a block",
                            "-DREPRO_SSD_BWD_CB_PER_HEAD=1")}


def build_variants(names):
    """The base build and each variant as its own library; returns
    {name: ctypes library}."""
    from repro_torch.kernels import _build

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    cu = _build.CSRC / "ssd_scan_bwd.cu"
    nvcc = _build.find_nvcc()
    procs = {}
    for name in names:
        flags = [] if name == "base" else [VARIANTS[name][1]]
        lib = OUT_DIR / f"{name}.so"
        procs[name] = (subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, *flags, "-I", str(_build.CSRC),
             "-o", str(lib), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True), lib)
    libs = {}
    for name, (p, lib) in procs.items():
        _, err = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{err}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


class _Entry:
    """A variant library's C entry with the wrapper's packing."""

    def __init__(self, lib, pack):
        self.fn = lib.repro_ssd_chunk_scan_bwd
        self.fn.argtypes = [ctypes.c_char_p]
        self.fn.restype = ctypes.c_int
        self.pack = pack

    def __call__(self, *args):
        err = self.fn(self.pack(*args))
        if err:
            raise RuntimeError(f"the variant's entry: CUDA error {err}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()

    import torch

    import chip_smoke
    from repro_torch.kernels import ssd_scan as smod

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    names = ["base", *VARIANTS]
    libs = build_variants(names)
    built = smod._launch_bwd
    entries = {n: _Entry(lib, built._pack) for n, lib in libs.items()}
    kernels = smod.BWD_KERNEL_NAMES[torch.bfloat16]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()[0]
    out = {"card": card, "variants": {n: VARIANTS[n][0] for n in VARIANTS},
           "shapes": {}}
    try:
        for key, shape in chip_smoke.SSD_TRAIN.items():
            B, S, H, P, N, L = (shape[k] for k in ("B", "S", "H", "P", "N",
                                                   "chunk"))
            x, dt, a, b, c, d, dy, _ = chip_smoke.ssd_bwd_inputs(
                torch, torch.bfloat16, B, S, H, P, N)

            def call(name, timing=None):
                smod._launch_bwd = entries[name]
                return smod.ssd_chunk_scan_bwd_kernel(
                    x, dt, a, b, c, dy, chunk=L, d_skip=d, timing=timing)

            ref = call("base")
            same = {}
            for n in VARIANTS:
                got = call(n)
                same[n] = all(torch.equal(p, q) for p, q in zip(got, ref)
                              if p is not None)
            readings = {n: [] for n in names}
            order = names + names[::-1]
            times = torch.zeros(smod.BWD_KERNELS + 1)
            for _ in range(args.rounds):
                for n in order:
                    for _ in range(3):
                        call(n, times)
                        readings[n].append(times[1:len(kernels) + 1]
                                           .tolist())
            med = {n: {k: statistics.median(r[i] for r in readings[n])
                       for i, k in enumerate(kernels)}
                   for n in names}
            for n in names:
                med[n]["call"] = statistics.median(sum(r)
                                                   for r in readings[n])
            out["shapes"][key] = {"shape": shape, "bits_identical": same,
                                  "median_ms": med}
    finally:
        smod._launch_bwd = built
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
