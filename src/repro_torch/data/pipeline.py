"""Synthetic token pipeline with stamp-guarded prefetch buffers.

A background producer thread fills a bounded ring of host batches ahead
of the training loop.  Each buffer is a reclaimable resource: the
producer may only REUSE a buffer once every step that could read it has
completed — under asynchronous dispatch that is exactly the
safe-memory-reclamation problem, so buffers retire through the
StampLedger (the paper's technique on the host plane of the training
stack).

Batches are pure numpy and bit for bit the JAX package's
(``repro/data/pipeline.py``): deterministic in (seed, step) so restarts
resume identically, with the schema of ``Model.input_specs`` (train).

Unlike the JAX package's, whose buffers carry a new array per batch,
each buffer here owns its arrays and the producer overwrites them in
place; with ``pin_memory`` they live in page-locked memory, so a
``non_blocking`` copy to the card reads them after :meth:`next` has
returned.  A consumer therefore issues its step's stamp BEFORE
:meth:`next` (which retires the buffer under the highest stamp) and
completes it only once the step's device work — the host-to-device copy
included — has finished (``Trainer`` reads the loss first).  A batch
read after its step's stamp completed may already hold a later batch.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..memory.stamp_ledger import StampLedger


class _Buffer:
    __slots__ = ("arrays", "step")

    def __init__(self):
        self.arrays: Dict[str, np.ndarray] = {}
        self.step = -1


class SyntheticDataPipeline:
    def __init__(
        self,
        cfg: ModelConfig,
        shape: ShapeConfig,
        *,
        seed: int = 0,
        prefetch: int = 2,
        ledger: Optional[StampLedger] = None,
        start_step: int = 0,
        pin_memory: bool = False,
    ) -> None:
        self.cfg = cfg
        self.shape = shape
        self.seed = seed
        self.pin_memory = pin_memory
        self.ledger = ledger or StampLedger()
        self._free: "queue.Queue[_Buffer]" = queue.Queue()
        self._ready: "queue.Queue[_Buffer]" = queue.Queue()
        for _ in range(prefetch + 1):
            self._free.put(_Buffer())
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------
    def _make_batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg, shape = self.cfg, self.shape
        B, S = shape.global_batch, shape.seq_len
        rng = np.random.RandomState((self.seed * 1_000_003 + step) % 2**31)
        # learnable synthetic language: affine recurrence with noise —
        # t_{i+1} = (a * t_i + b) mod V for per-sequence (a, b), so the
        # next-token distribution is predictable and loss curves are
        # meaningful (uniform-random tokens have no learnable signal).
        # Sequences live in a small sub-vocabulary so the (fixed per seed)
        # affine next-token map is learnable within a few hundred steps.
        V = min(cfg.vocab_size, 1024)
        srng = np.random.RandomState(self.seed)
        a = np.full((B, 1), srng.choice([3, 5, 7, 11]), np.int64)
        b = np.full((B, 1), srng.randint(0, V), np.int64)
        t0 = rng.randint(0, V, (B, 1)).astype(np.int64)
        seq = np.empty((B, S + 1), np.int64)
        seq[:, 0:1] = t0
        for i in range(S):
            seq[:, i + 1: i + 2] = (a * seq[:, i: i + 1] + b) % V
        noise = rng.random((B, S + 1)) < 0.05
        seq = np.where(noise, rng.randint(0, V, (B, S + 1)), seq)
        seq = seq.astype(np.int32)
        batch = {"tokens": seq[:, :S], "labels": seq[:, 1:]}
        if cfg.is_encdec:
            batch["enc_embeds"] = rng.randn(
                B, S, cfg.d_model).astype(np.float32) * 0.02
        elif cfg.family == "vlm":
            P = cfg.frontend_positions
            batch["frontend_embeds"] = rng.randn(
                B, P, cfg.d_model).astype(np.float32) * 0.02
            batch["tokens"] = batch["tokens"][:, : S - P]
            batch["labels"] = batch["labels"][:, : S - P]
        return batch

    def _fill(self, buf: _Buffer, step: int) -> None:
        """Write batch ``step`` into the buffer's own arrays (allocated at
        its first batch, page-locked with ``pin_memory``)."""
        for k, v in self._make_batch(step).items():
            dst = buf.arrays.get(k)
            if dst is None:
                t = torch.empty(v.shape, dtype=torch.from_numpy(v).dtype,
                                pin_memory=self.pin_memory)
                dst = buf.arrays[k] = t.numpy()
            np.copyto(dst, v)
        buf.step = step

    def _produce(self) -> None:
        while not self._stop.is_set():
            try:
                buf = self._free.get(timeout=0.2)
            except queue.Empty:
                continue
            self._fill(buf, self._step)
            self._step += 1
            self._ready.put(buf)

    # ------------------------------------------------------------------
    def next(self) -> Dict[str, np.ndarray]:
        """Returns the next batch (views of its buffer); the buffer is
        retired with the CURRENT highest stamp and refilled only after
        every step active at that moment completes — issue the step's
        stamp before this call and complete it after the step."""
        buf = self._ready.get()
        self.ledger.retire(lambda b=buf: self._free.put(b))
        self.ledger.reclaim()
        return buf.arrays

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2)
