"""Asynchronous checkpointing with stamp-guarded staging slots.

Save path: snapshot the tensors to the host, hand the host arrays to a
writer thread, and hold a ``ckpt-writer`` stamp in the StampLedger for
as long as the write runs — reclamation of anything retired meanwhile
(the data pipeline's buffers) waits for it.  At most ``n_staging``
saves are in flight (a semaphore).  The snapshot is a synchronous copy
on the current stream, so it is ordered after the optimizer step that
produced the tensors.  It is a copy on every device, the CPU included
(where ``Tensor.cpu()`` would return the live storage): the optimizer
updates params and moments in place, and the next step must not reach
arrays that the writer thread is still writing.

Restore path: reads the manifest and the per-leaf ``.npy`` files and
puts every leaf on ``device``.

On-disk format, the JAX package's (``repro/training/checkpoint.py``), so
each package reads the other's checkpoints: ``step_<8 digits>/`` holding
``manifest.json`` ({"step", "leaves": {path: {"file", "shape",
"dtype"}}}) and one ``.npy`` per leaf, its path with ``/`` written as
``__``.  Saves are atomic (a temporary directory, then a rename); the
newest ``keep`` complete saves are kept.  bf16 has no numpy dtype: the
JAX package's ``np.save`` of an ml_dtypes bfloat16 array writes the raw
2-byte values with the descriptor ``<V2`` and the manifest says
"bfloat16"; a bf16 leaf is written the same way here (its bits as
``V2``) and read back by its manifest dtype.  The trainer's masters and
moments are f32, so this touches only what a caller passes in.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..memory.stamp_ledger import StampLedger


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    else:
        out[prefix] = tree
    return out


def _unflatten(flat: Dict[str, Any]):
    root: Dict[str, Any] = {}
    for path, v in flat.items():
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return root


def _to_host(t) -> np.ndarray:
    """A leaf on the host; a bf16 leaf as its raw 2-byte values (V2)."""
    if not isinstance(t, torch.Tensor):
        return np.array(t)  # a copy
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _save(path: Path, arr: np.ndarray, dtype: str) -> None:
    """``np.save``, but a bf16 leaf under the descriptor ``<V2`` that the
    JAX package's ml_dtypes array gets (numpy's own V2 says ``|V2``), so
    the two packages write the same bytes."""
    if dtype != "bfloat16":
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(f, {
            "descr": "<V2", "fortran_order": False, "shape": arr.shape})
        f.write(np.ascontiguousarray(arr).tobytes())


def _from_host(arr: np.ndarray, dtype: str, dev: torch.device):
    arr = np.array(arr, copy=True, order="C")  # keeps a 0-d leaf 0-d
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(dev)
    return torch.from_numpy(arr).to(dev)


class CheckpointManager:
    def __init__(
        self,
        directory: str,
        *,
        ledger: Optional[StampLedger] = None,
        keep: int = 3,
        n_staging: int = 2,
    ) -> None:
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.ledger = ledger or StampLedger()
        self.keep = keep
        self._staging_free = threading.Semaphore(n_staging)
        self._writer_threads: list[threading.Thread] = []
        self._errors: list[str] = []

    # ------------------------------------------------------------------
    # save
    # ------------------------------------------------------------------
    def save(self, step: int, state: Dict[str, Any],
             blocking: bool = False) -> None:
        """Async checkpoint of a tree of tensors ``state``."""
        self._staging_free.acquire()  # bounded staging slots
        flat = _flatten(state)
        # snapshot to host (ordered after all queued work on the stream)
        host = {k: _to_host(v) for k, v in flat.items()}
        dtypes = {k: ("bfloat16" if isinstance(v, torch.Tensor)
                      and v.dtype == torch.bfloat16 else str(host[k].dtype))
                  for k, v in flat.items()}
        stamp_hold = self.ledger.hold("ckpt-writer")
        stamp_hold.__enter__()

        def write():
            try:
                tmp = self.dir / f".tmp-{step}-{os.getpid()}"
                tmp.mkdir(parents=True, exist_ok=True)
                manifest = {}
                for k, v in host.items():
                    fn = k.replace("/", "__") + ".npy"
                    _save(tmp / fn, v, dtypes[k])
                    manifest[k] = {
                        "file": fn,
                        "shape": list(v.shape),
                        "dtype": dtypes[k],
                    }
                (tmp / "manifest.json").write_text(json.dumps(
                    {"step": step, "leaves": manifest}))
                final = self.dir / f"step_{step:08d}"
                if final.exists():
                    shutil.rmtree(final)
                tmp.rename(final)
                self._gc()
            except Exception as e:  # noqa: BLE001 — surfaced by wait()
                self._errors.append(f"{type(e).__name__}: {e}")
            finally:
                stamp_hold.__exit__(None, None, None)
                self._staging_free.release()

        t = threading.Thread(target=write, name="ckpt-writer", daemon=True)
        t.start()
        self._writer_threads.append(t)
        if blocking:
            t.join()

    def wait(self) -> None:
        for t in self._writer_threads:
            t.join(timeout=60)
        self._writer_threads.clear()
        if self._errors:
            raise RuntimeError(f"checkpoint writer failed: {self._errors}")

    def _gc(self) -> None:
        steps = sorted(self.available_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # ------------------------------------------------------------------
    # restore
    # ------------------------------------------------------------------
    def available_steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            if (p / "manifest.json").exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def restore(self, step: Optional[int] = None,
                device: DeviceLike = "cuda"):
        """Load (state, step), every leaf on ``device``; (None, -1) when
        there is no complete save."""
        steps = self.available_steps()
        if not steps:
            return None, -1
        step = step if step is not None else steps[-1]
        dev = resolve_device(device)
        d = self.dir / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        flat = {k: _from_host(np.load(d / meta["file"]), meta["dtype"], dev)
                for k, meta in manifest["leaves"].items()}
        return _unflatten(flat), manifest["step"]
