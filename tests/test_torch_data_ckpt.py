"""The port's data pipeline and checkpoints against the JAX package:
``SyntheticDataPipeline`` batches bit for bit (dense, vlm and
encoder-decoder configs, from step 0 and from a ``start_step``), its
buffers refilled only after the stamp of the step that read them
completes; ``CheckpointManager`` round trips, ``keep`` and its garbage
collection, the ``ckpt-writer`` stamp hold, a save untouched by the
next in-place optimizer step, and checkpoints written by
one package restored by the other (the same files, bf16 leaves stored
as the JAX package's ``np.save`` stores them)."""

import json
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import ShapeConfig as JaxShape
from repro.configs import smoke_config as jax_smoke
from repro.data.pipeline import SyntheticDataPipeline as JaxPipeline
from repro.training import CheckpointManager as JaxCheckpointManager
from repro_torch.configs import ARCHS, ShapeConfig, smoke_config
from repro_torch.data import SyntheticDataPipeline
from repro_torch.memory.stamp_ledger import StampLedger
from repro_torch.training import CheckpointManager

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

SHAPE = (48, 2)  # seq_len, global batch


def _port_batches(cfg, n, **kw):
    """``n`` batches, each copied while its step's stamp is active."""
    ledger = StampLedger()
    pipe = SyntheticDataPipeline(cfg, ShapeConfig("t", "train", *SHAPE),
                                 ledger=ledger, **kw)
    out = []
    try:
        for _ in range(n):
            stamp = ledger.issue("train-step")
            out.append({k: v.copy() for k, v in pipe.next().items()})
            ledger.complete(stamp)
    finally:
        pipe.stop()
    return out


def _jax_batches(name, n, **kw):
    pipe = JaxPipeline(jax_smoke(JAX_ARCHS[name]),
                       JaxShape("t", "train", *SHAPE), **kw)
    try:
        return [pipe.next() for _ in range(n)]
    finally:
        pipe.stop()


@pytest.mark.parametrize("name", ["qwen2-0.5b", "llava-next-34b",
                                  "seamless-m4t-medium"])
@pytest.mark.parametrize("start_step", [0, 3])
def test_pipeline_batches_match_jax_bit_for_bit(name, start_step):
    kw = dict(seed=5, start_step=start_step)
    got = _port_batches(smoke_config(ARCHS[name]), 3, **kw)
    want = _jax_batches(name, 3, **kw)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape
            np.testing.assert_array_equal(g[k], w[k])
    if name == "llava-next-34b":
        P = smoke_config(ARCHS[name]).frontend_positions
        assert got[0]["tokens"].shape == (SHAPE[1], SHAPE[0] - P)
        assert got[0]["frontend_embeds"].shape == (SHAPE[1], P, 128)


def test_pipeline_refills_a_buffer_only_after_its_step_completes():
    """Two buffers (prefetch 1): the batch of step 0 stays in its buffer
    while step 0's stamp is active, however long the producer waits;
    once it completes, the producer refills that buffer, in place, with
    step 2's batch."""
    cfg = smoke_config(ARCHS["qwen2-0.5b"])
    ledger = StampLedger()
    pipe = SyntheticDataPipeline(cfg, ShapeConfig("t", "train", *SHAPE),
                                 seed=1, prefetch=1, ledger=ledger)
    want = _jax_batches("qwen2-0.5b", 3, seed=1)
    try:
        s0 = ledger.issue("train-step")
        b0 = pipe.next()
        time.sleep(0.5)  # the producer has one free buffer, then waits
        np.testing.assert_array_equal(b0["tokens"], want[0]["tokens"])
        assert ledger.unreclaimed() == 1
        s1 = ledger.issue("train-step")
        b1 = pipe.next()
        np.testing.assert_array_equal(b1["tokens"], want[1]["tokens"])
        assert b1["tokens"] is not b0["tokens"]
        time.sleep(0.3)
        np.testing.assert_array_equal(b0["tokens"], want[0]["tokens"])
        ledger.complete(s0)  # step 0 done: its buffer goes back
        deadline = time.time() + 10
        while (not np.array_equal(b0["tokens"], want[2]["tokens"])
               and time.time() < deadline):
            time.sleep(0.01)
        np.testing.assert_array_equal(b0["tokens"], want[2]["tokens"])
        np.testing.assert_array_equal(b1["tokens"], want[1]["tokens"])
        ledger.complete(s1)
        b2 = pipe.next()
        assert b2["tokens"] is b0["tokens"]  # the same buffer, refilled
    finally:
        pipe.stop()


def _state():
    return {
        "params": {"w": torch.arange(12.0).reshape(3, 4),
                   "b": torch.ones((4,)),
                   "h": torch.linspace(-2, 2, 6).to(torch.bfloat16)},
        "opt": {"mu": {"w": torch.zeros((3, 4))},
                "step": torch.tensor(7, dtype=torch.int32)},
    }


def _assert_state(got, want):
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], dict):
            _assert_state(got[k], want[k])
        else:
            assert got[k].dtype == want[k].dtype and got[k].device.type \
                == "cpu"
            assert torch.equal(got[k], want[k]), k


def test_checkpoint_roundtrip_keep_and_hold(tmp_path):
    ledger = StampLedger()
    mgr = CheckpointManager(str(tmp_path), ledger=ledger, keep=2)
    state = _state()
    mgr.save(5, state)
    mgr.save(9, state)
    mgr.wait()
    assert mgr.available_steps() == [5, 9]
    restored, step = mgr.restore(device="cpu")
    assert step == 9
    _assert_state(restored, state)
    restored5, step5 = mgr.restore(5, device="cpu")
    assert step5 == 5
    _assert_state(restored5, state)
    mgr.save(11, state)
    mgr.wait()
    assert mgr.available_steps() == [9, 11]  # gc keeps the `keep` newest
    # the writer holds a stamp: a buffer retired during a save waits for it
    freed = []
    mgr.save(12, state)
    ledger.retire(lambda: freed.append(1))
    mgr.wait()
    ledger.reclaim()
    assert freed == [1] and ledger.unreclaimed() == 0
    assert CheckpointManager(str(tmp_path / "none")).restore(
        device="cpu") == (None, -1)


def test_checkpoint_is_the_state_at_save_after_an_inplace_step(
        tmp_path, monkeypatch):
    """A save is the state when ``save`` returned, though the next AdamW
    step updates params and moments in place while the writer runs: on
    the CPU too, where ``.cpu()`` would hand the writer the live arrays.
    The writer is held until the step is done, so a torn snapshot shows
    every time."""
    from repro_torch.training import checkpoint as ckpt_mod
    from repro_torch.training.optimizer import AdamWConfig, adamw_update

    stepped = threading.Event()
    real_save = ckpt_mod._save

    def held_save(path, arr, dtype):
        assert stepped.wait(10)
        real_save(path, arr, dtype)

    monkeypatch.setattr(ckpt_mod, "_save", held_save)
    g = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(3, 4, generator=g),
              "b": torch.randn(4, generator=g)}
    opt = {"mu": {k: torch.randn(v.shape, generator=g).abs()
                  for k, v in params.items()},
           "nu": {k: torch.rand(v.shape, generator=g)
                  for k, v in params.items()},
           "step": torch.tensor(3, dtype=torch.int32)}
    state = {"params": params, "opt": opt}
    want = {"params": {k: v.clone() for k, v in params.items()},
            "opt": {"mu": {k: v.clone() for k, v in opt["mu"].items()},
                    "nu": {k: v.clone() for k, v in opt["nu"].items()},
                    "step": opt["step"].clone()}}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, state)
    grads = {k: torch.randn(v.shape, generator=g) for k, v in params.items()}
    adamw_update(AdamWConfig(warmup_steps=1), grads, opt, params)
    assert not torch.equal(params["w"], want["params"]["w"])
    assert not torch.equal(opt["mu"]["w"], want["opt"]["mu"]["w"])
    stepped.set()
    mgr.wait()
    got, step = mgr.restore(device="cpu")
    assert step == 3
    _assert_state(got, want)


def test_jax_checkpoint_restored_by_the_port(tmp_path):
    state = {
        "params": {"w": jnp.arange(12.0).reshape(3, 4),
                   "h": jnp.linspace(-2, 2, 6).astype(jnp.bfloat16)},
        "opt": {"mu": {"w": jnp.zeros((3, 4))}, "step": jnp.int32(7)},
    }
    jmgr = JaxCheckpointManager(str(tmp_path / "jax"))
    jmgr.save(3, state)
    jmgr.wait()
    got, step = CheckpointManager(str(tmp_path / "jax")).restore(
        device="cpu")
    assert step == 3
    _assert_state(got, {
        "params": {"w": torch.arange(12.0).reshape(3, 4),
                   "h": torch.linspace(-2, 2, 6).to(torch.bfloat16)},
        "opt": {"mu": {"w": torch.zeros((3, 4))},
                "step": torch.tensor(7, dtype=torch.int32)}})
    # the port writes the same files: manifests equal, .npy bytes equal
    pmgr = CheckpointManager(str(tmp_path / "port"))
    pmgr.save(3, got)
    pmgr.wait()
    jd, pd = tmp_path / "jax" / "step_00000003", tmp_path / "port" / \
        "step_00000003"
    jman = json.loads((jd / "manifest.json").read_text())
    pman = json.loads((pd / "manifest.json").read_text())
    assert jman == pman
    for meta in jman["leaves"].values():
        assert (jd / meta["file"]).read_bytes() == \
            (pd / meta["file"]).read_bytes(), meta


def test_port_checkpoint_restored_by_jax(tmp_path):
    state = _state()
    # the JAX package restores no bf16 leaf, its own neither: its
    # ``device_put`` refuses the ``V2`` array ``np.load`` gives back
    del state["params"]["h"]
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(4, state)
    mgr.wait()
    got, step = JaxCheckpointManager(str(tmp_path)).restore()
    assert step == 4
    np.testing.assert_array_equal(np.asarray(got["params"]["w"]),
                                  np.arange(12.0).reshape(3, 4))
    np.testing.assert_array_equal(np.asarray(got["params"]["b"]),
                                  np.ones(4, np.float32))
    assert np.asarray(got["opt"]["step"]).dtype == np.int32
    assert int(got["opt"]["step"]) == 7
