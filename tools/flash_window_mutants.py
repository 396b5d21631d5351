#!/usr/bin/env python3
"""Plant faults in the flash kernel's sliding window and check that the
card tests catch each one.

    python3 tools/flash_window_mutants.py

Copies ``src/`` three times under ``build/mutants/``, plants one fault in
each copy's ``csrc/flash_attention.cu`` and runs the window cases of
``tests/test_torch_cuda.py`` against that copy (its kernel built there,
the three runs at once):

  * ``edge``: the window keeps ``kv_pos >= q_pos - window`` (window + 1
    keys) in place of ``kv_pos > q_pos - window``, in the f32 body and
    the bf16 kernel;
  * ``split``: the bf16 kernel's last split computes nothing where the
    key range is split (its keys are dropped from the combine);
  * ``kv_begin``: every block starts one key tile after its first
    visible key (f32 and bf16).

Prints one JSON line per mutant (tests run, failed) and exits nonzero if
a mutant passes every test, or if the unmutated tree fails one.  Needs a
CUDA card and nvcc; the repository's sources are not touched.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KERNEL = Path("repro_torch/kernels/csrc/flash_attention.cu")
TESTS = "window"

# (old, new, count): each old text must occur exactly count times
MUTANTS = {
    "edge": [("const int lo0 = kWindow ? q_pos0 - window + 1 : -kNone;",
              "const int lo0 = kWindow ? q_pos0 - window : -kNone;", 1),
             ("ok = ok && kv_pos > q_pos - window;",
              "ok = ok && kv_pos >= q_pos - window;", 1)],
    "split": [("const int t_end = min(n_tiles, t_base + (split + 1) * "
               "tiles_per_split);",
               "const int t_end = splits > 1 && split == splits - 1 ? "
               "t_begin : min(n_tiles, t_base + (split + 1) * "
               "tiles_per_split);", 1)],
    "kv_begin": [("const int t_begin = max(first_key(q_offset + q0, q_hi, "
                  "window, S_kv) / KN,",
                  "const int t_begin = max(first_key(q_offset + q0, q_hi, "
                  "window, S_kv) / KN + (window > 0),", 1),
                 ("wg_begin = first_key(q_offset + qw0, q_hi, window, S_kv) "
                  "/ KN;",
                  "wg_begin = first_key(q_offset + qw0, q_hi, window, S_kv) "
                  "/ KN + (window > 0);", 1),
                 ("const int t_first = first_key(q_offset + q0, q_hi, window, "
                  "S_kv) / kBlockK;",
                  "const int t_first = first_key(q_offset + q0, q_hi, window, "
                  "S_kv) / kBlockK + (window > 0);", 1)],
}


def plant(src: Path, edits) -> None:
    """Apply ``edits`` to the kernel source of the copy at ``src``; any
    run of whitespace in an old text matches any run in the source (its
    line breaks)."""
    path = src / KERNEL
    text = path.read_text()
    for old, new, count in edits:
        pattern = re.compile(r"\s+".join(map(re.escape, old.split())))
        found = len(pattern.findall(text))
        if found != count:
            raise SystemExit(f"{path}: {old!r} found {found} times, "
                             f"expected {count}")
        text = pattern.sub(lambda _: new, text)
    path.write_text(text)


def run_tests(src: Path) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=str(src))
    return subprocess.Popen(
        [sys.executable, "-m", "pytest", "-q", "-m", "cuda", "-k", TESTS,
         "-p", "no:cacheprovider", str(ROOT / "tests" / "test_torch_cuda.py")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def summary(out: str) -> dict:
    counts = {}
    for n, what in re.findall(r"(\d+) (passed|failed|error)", out):
        counts[what] = int(n)
    return counts


def main() -> int:
    base = ROOT / "build" / "mutants"
    shutil.rmtree(base, ignore_errors=True)
    trees = {}
    for name, edits in {"none": [], **MUTANTS}.items():
        trees[name] = base / name / "src"
        shutil.copytree(ROOT / "src" / "repro_torch",
                        trees[name] / "repro_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        plant(trees[name], edits)
    procs = {name: run_tests(src) for name, src in trees.items()}
    ok = True
    for name, proc in procs.items():
        out, _ = proc.communicate()
        counts = summary(out.splitlines()[-1] if out.strip() else "")
        caught = counts.get("failed", 0) + counts.get("error", 0)
        if name == "none":
            good = proc.returncode == 0 and caught == 0
        else:
            good = caught > 0
        ok &= good
        print(json.dumps({"mutant": name, "rc": proc.returncode, **counts,
                          "as_expected": good}), flush=True)
        if not good:
            print(out[-4000:], file=sys.stderr)
    shutil.rmtree(base, ignore_errors=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
