"""Trainer: checkpointed, fault-tolerant training loop on one device.

Wires together the train step (:func:`repro_torch.launch.steps.
build_train_step`), the stamp-guarded data pipeline, async checkpointing
and the fault-tolerance hooks of the JAX package's ``Trainer``:

  * **checkpoint/restart** — periodic async saves; ``resume()`` waits for
    the writes in flight and restores the newest complete checkpoint;
  * **failure injection** — ``failure_hook(step)`` may raise; the loop
    restores and replays from the last checkpoint (the data pipeline is
    deterministic in step, and the step's sums run in a fixed order, so
    replays are bit-identical);
  * **straggler flags** — steps over ``step_deadline_s`` are recorded.

It takes a ``device`` where the JAX package's takes a mesh.  Each step
issues its stamp before it takes its batch and completes it after
reading the loss, which waits for the step's device work: the batch's
page-locked buffer, retired under that stamp, is not refilled while a
copy from it may be in flight.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

import torch

from ..configs.base import ShapeConfig
from ..data.pipeline import SyntheticDataPipeline
from ..device import DeviceLike, resolve_device
from ..memory.stamp_ledger import StampLedger
from ..models import Model, init_params
from ..models.param import tree_map
from .checkpoint import CheckpointManager
from .optimizer import AdamWConfig, opt_state_specs


class Trainer:
    def __init__(
        self,
        model: Model,
        shape: ShapeConfig,
        device: Optional[DeviceLike] = None,
        *,
        ckpt_dir: Optional[str] = None,
        ckpt_every: int = 50,
        remat: Optional[str] = "full",
        adamw: Optional[AdamWConfig] = None,
        seed: int = 0,
        step_deadline_s: float = 0.0,
        failure_hook: Optional[Callable[[int], None]] = None,
    ) -> None:
        self.model = model
        self.shape = shape
        self.device = (model.device if device is None
                       else resolve_device(device))
        self.ledger = StampLedger()
        self.ckpt = (
            CheckpointManager(ckpt_dir, ledger=self.ledger)
            if ckpt_dir else None
        )
        self.ckpt_every = ckpt_every
        self.step_deadline_s = step_deadline_s
        self.failure_hook = failure_hook
        self.stragglers: list[int] = []
        from ..launch.steps import build_train_step  # lazy: avoids a cycle

        self.fn = build_train_step(model, remat=remat, adamw=adamw)
        self.seed = seed
        self._init_state()
        self.history: list[Dict[str, float]] = []

    def _init_state(self) -> None:
        self.params = tree_map(lambda t: t.to(self.device),
                               self.model.init_params(self.seed))
        self.opt_state = init_params(opt_state_specs(self.model.param_specs),
                                     0, self.device)
        self.step = 0

    # ------------------------------------------------------------------
    def resume(self) -> bool:
        if not self.ckpt:
            return False
        self.ckpt.wait()
        state, step = self.ckpt.restore(device=self.device)
        if state is None:
            return False
        self.params = state["params"]
        self.opt_state = state["opt"]
        self.step = step + 1
        return True

    # ------------------------------------------------------------------
    def run(self, n_steps: int, *, max_restarts: int = 2) -> Dict[str, Any]:
        restarts = 0
        while True:
            try:
                self._run_inner(n_steps)
                break
            except _InjectedFailure:
                restarts += 1
                if restarts > max_restarts:
                    raise
                if not self.resume():  # no checkpoint yet: from scratch
                    self._init_state()
        if self.ckpt:
            self.ckpt.wait()
        return {
            "final_step": self.step,
            "restarts": restarts,
            "stragglers": list(self.stragglers),
            "history": self.history,
        }

    def _run_inner(self, n_steps: int) -> None:
        pipeline = SyntheticDataPipeline(
            self.model.cfg, self.shape, seed=self.seed,
            ledger=self.ledger, start_step=self.step,
            pin_memory=self.device.type == "cuda",
        )
        try:
            while self.step < n_steps:
                if self.failure_hook:
                    self.failure_hook(self.step)
                stamp = self.ledger.issue("train-step")
                batch_np = pipeline.next()
                t0 = time.time()
                batch = {k: torch.from_numpy(v).to(self.device,
                                                   non_blocking=True)
                         for k, v in batch_np.items()}
                self.params, self.opt_state, metrics = self.fn(
                    self.params, self.opt_state, batch)
                loss = float(metrics["loss"])  # sync point
                dt = time.time() - t0
                self.ledger.complete(stamp)
                if self.step_deadline_s and dt > self.step_deadline_s:
                    self.stragglers.append(self.step)
                self.history.append(
                    {"step": self.step, "loss": loss, "time_s": dt}
                )
                if self.ckpt and (self.step + 1) % self.ckpt_every == 0:
                    self.ckpt.save(self.step, {
                        "params": self.params, "opt": self.opt_state,
                    })
                self.step += 1
        finally:
            pipeline.stop()


class _InjectedFailure(RuntimeError):
    """Raised by failure hooks to simulate a node crash."""


def inject_failure_at(steps) -> Callable[[int], None]:
    fired = set()

    def hook(step: int) -> None:
        if step in steps and step not in fired:
            fired.add(step)
            raise _InjectedFailure(f"simulated node failure at step {step}")

    return hook
