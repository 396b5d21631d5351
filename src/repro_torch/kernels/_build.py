"""Build the CUDA kernels of this package with nvcc and load them.

Each ``csrc/<name>.cu`` is compiled on its own, for ``sm_90a``, into a
shared library with a plain C interface, and loaded with :mod:`ctypes`
(no PyTorch headers, so a build takes seconds).  Libraries go under
``build/repro_torch/`` at the root of the checkout, named by a hash of
the sources and flags, so an edited source rebuilds and an unchanged one
is reused.  :func:`build` starts one ``nvcc`` per source, all at once.

Nothing is built when this module is imported: the first kernel launch
builds what it needs, and ``chip_smoke.py`` calls :func:`build` up front.
A failed build raises with the compiler's stderr.  Wrappers launch through
an :class:`Entry` (one packed argument block per call) on the stream
:func:`device_stream` reads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

import torch

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("paged_attention", "decode_attention", "flash_attention",
           "ssd_scan", "block_gather")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the toolkit's
    default install location."""
    candidates = []
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        candidates.append(Path(home) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, on PATH and in "
        "/usr/local/cuda/bin); the CUDA kernels are compiled from "
        "src/repro_torch/kernels/csrc on first use"
    )


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives for these sources."""
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every named source whose library is missing, one ``nvcc``
    per source, all started together.  Returns the seconds each build
    took (0.0 for one already built).  The compiler's report (registers,
    shared memory, spills from ``-Xptxas -v``) is kept beside each
    library as ``<lib>.log``."""
    names = list(names)
    seconds = {n: 0.0 for n in names}
    todo = [n for n in names if not library_path(n).is_file()]
    if not todo:
        return seconds
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs: Dict[str, Tuple[subprocess.Popen, Path, float]] = {}
    try:
        for n in todo:
            out = library_path(n)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   str(CSRC / f"{n}.cu")]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.PIPE, text=True),
                        tmp, time.perf_counter())
        failures = []
        for n, (proc, tmp, t0) in procs.items():
            stdout, stderr = proc.communicate()
            seconds[n] = time.perf_counter() - t0
            if proc.returncode != 0:
                failures.append(f"nvcc failed on csrc/{n}.cu "
                                f"(exit {proc.returncode}):\n{stderr}")
                continue
            out = library_path(n)
            out.with_name(out.name + ".log").write_text(stdout + stderr)
            os.replace(tmp, out)  # atomic: concurrent builders agree
    finally:
        for proc, tmp, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


class Entry:
    """A C entry point of a kernel library, called with its arguments
    packed into one block: 8 bytes each, little-endian, ``q`` in ``fmt``
    for an integer (a size, a flag, a data pointer, the stream) and ``d``
    for a float, in the order the entry reads them (``repro::Args`` in
    ``csrc/common.cuh``).  ctypes then converts one argument, the bytes of
    the block, where it would convert each of 8 to 23 one by one; the
    block is a new ``bytes`` object each call, so calls from several
    threads do not share it.  The library is loaded, and built if need
    be, at the first call.  A nonzero return (a refused shape or a failed
    launch) raises with CUDA's message."""

    def __init__(self, lib: str, fn: str, fmt: str):
        self.lib, self.fn = lib, fn
        self._pack = struct.Struct("<" + fmt).pack
        self._call = None

    def __call__(self, *args) -> None:
        call = self._call
        if call is None:
            call = getattr(load(self.lib), self.fn)
            call.argtypes = [ctypes.c_char_p]
            call.restype = ctypes.c_int
            self._call = call
        err = call(self._pack(*args))
        if err:
            msg = load(self.lib).repro_error_string(err).decode()
            raise RuntimeError(f"{self.fn}: CUDA error {err} ({msg})")


def device_stream(t: torch.Tensor) -> Tuple[int, int]:
    """The index of ``t``'s device and the raw handle of that device's
    current stream, read without building a ``torch.cuda.Stream``."""
    device = t.get_device()
    return device, torch._C._cuda_getCurrentRawStream(device)
