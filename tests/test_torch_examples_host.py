"""``examples/quickstart_torch.py`` and ``examples/train_lm_torch.py``
against their JAX counterparts.

The quickstart: under each of the eight schemes at one thread and 300
operations (a deterministic interleaving), the JAX example run through
its own ``main()`` (``runpy`` with ``sys.argv`` set) and the port's print
the same lines, so the same allocated / reclaimed / unreclaimed counts
and scan work.  At the defaults (4 threads x 3000 operations) the port's
example alone runs under a join timeout for every scheme — its Stamp Pool
is the repaired copy, and the JAX package's is never run with threads
here — and every node is accounted for.

``train_lm``: the port's ``run`` at smoke width (qwen2 smoke, f32, the
example's 8 x 128 batch) over 8 steps with a checkpoint every 4, clean
and with a failure before step 6: one restart, and every loss of the
failure run, the replayed steps included, equal to the clean run's bit
for bit.  Both packages' ``Model.init_params`` return one weight tree
(the JAX model's, its attention projections conditioned, through
``params_from_numpy``), and a JAX ``Trainer``
built with the JAX example's arguments (AdamW lr 3e-3 with 20 warmup
steps, seed 0) runs beside it through the same failure: the losses of
every step, the replayed ones included, agree to 1e-5, and the
checkpoint steps and final step are equal.  Without ``--device`` and
without a card the example raises ``resolve_device``'s error before it
makes a directory."""

import runpy
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_examples import ROOT, load_port_example, run_quietly
from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import ShapeConfig as JaxShape
from repro.configs import smoke_config as jax_smoke
from repro.core import SCHEMES as JAX_SCHEMES
from repro.launch.mesh import make_debug_mesh
from repro.models import Model as JaxModel
from repro.training import AdamWConfig as JaxAdamW
from repro.training import Trainer as JaxTrainer
from repro.training import inject_failure_at as jax_inject_failure_at
from repro_torch.configs import ARCHS, ShapeConfig, smoke_config
from repro_torch.core import SCHEMES
from repro_torch.models import Model, params_from_numpy

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

#: the defaults take about a second a scheme
JOIN_TIMEOUT_S = 120
STEPS, CKPT_EVERY, FAIL_AT = 8, 4, 6
SHAPE = ("train_tiny", "train", 128, 8)  # the example's batch


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------
def test_the_port_has_the_jax_examples_schemes():
    assert sorted(SCHEMES) == sorted(JAX_SCHEMES)
    assert len(SCHEMES) == 8


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_quickstart_prints_the_jax_examples_counts(scheme, monkeypatch):
    args = ["--scheme", scheme, "--threads", "1", "--ops", "300"]
    monkeypatch.setattr(sys, "argv", ["quickstart.py", *args])
    _, want = run_quietly(runpy.run_path,
                          str(ROOT / "examples" / "quickstart.py"),
                          run_name="__main__")
    stats, got = run_quietly(load_port_example("quickstart_torch").main,
                             args)
    assert got == want
    assert got.startswith(f"scheme={scheme} allocated={stats['allocated']} ")
    assert stats["allocated"] == stats["reclaimed"] + stats["unreclaimed"]
    assert stats["reclaimed"] > 0


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_quickstart_defaults_finish_under_a_join_timeout(scheme):
    main = load_port_example("quickstart_torch").main
    out = {}

    def target():
        out["stats"], out["text"] = run_quietly(main, ["--scheme", scheme])

    # a daemon thread: the example's workers inherit it, so a livelock
    # fails this test without holding the process
    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(JOIN_TIMEOUT_S)
    assert not t.is_alive(), f"{scheme} did not finish in {JOIN_TIMEOUT_S}s"
    s = out["stats"]
    assert s["allocated"] == s["reclaimed"] + s["unreclaimed"]
    assert s["allocated"] > 4 * 3000 * 0.3 * 0.9  # ~30% of ops enqueue
    assert out["text"].startswith(f"scheme={scheme} ")


# ---------------------------------------------------------------------------
# train_lm
# ---------------------------------------------------------------------------
def condition(tree):
    """Attention projections rescaled to unit variance over their
    contraction, in place (every dict holding ``wq``)."""
    if not isinstance(tree, dict):
        return tree
    if "wq" in tree:
        M, H = tree["wq"].shape[-3], tree["wq"].shape[-2]
        Hkv = tree["wk"].shape[-2]
        for k, f in (("wq", np.sqrt(H / M)), ("wk", np.sqrt(Hkv / M)),
                     ("wv", np.sqrt(Hkv / M)), ("wo", 1 / np.sqrt(H))):
            tree[k] = (tree[k] * f).astype(np.float32)
    for v in tree.values():
        condition(v)
    return tree


@pytest.fixture(scope="module")
def weights():
    """The JAX smoke model and its seed-0 tree as numpy arrays, the
    attention projections conditioned, which both packages'
    ``init_params`` return.  The reference's init makes every head a
    hard argmax, on which two correct packages' losses part ways within
    a few steps (ROADMAP, "Full-width random init is chaotic")."""
    jm = JaxModel(jax_smoke(JAX_ARCHS["qwen2-0.5b"]))
    return jm, condition(jax.tree.map(np.asarray, jm.init_params(0)))


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory, weights):
    _, np_params = weights
    run = load_port_example("train_lm_torch").run
    cfg = smoke_config(ARCHS["qwen2-0.5b"])
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Model, "init_params",
                   lambda self, seed=0: params_from_numpy(np_params, "cpu"))
        for name, fail in (("clean", -1), ("failure", FAIL_AT)):
            d = tmp_path_factory.mktemp(name)
            out[name], out[name + "_text"] = run_quietly(
                run, cfg, ShapeConfig(*SHAPE), STEPS, device="cpu",
                ckpt_dir=str(d), ckpt_every=CKPT_EVERY, inject_failure=fail)
    return out


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory, weights):
    """A JAX ``Trainer`` with the JAX example's arguments on the bridged
    weights, through a failure before step FAIL_AT: its report and its
    checkpoint steps."""
    jm, np_params = weights
    jm.init_params = lambda seed=0: jax.tree.map(jnp.asarray, np_params)
    fail = jax_inject_failure_at({FAIL_AT})
    trainer = JaxTrainer(
        jm, JaxShape(*SHAPE), make_debug_mesh(),
        ckpt_dir=str(tmp_path_factory.mktemp("jax")),
        ckpt_every=CKPT_EVERY, adamw=JaxAdamW(lr=3e-3, warmup_steps=20),
        seed=0)

    def hook(step):
        # the JAX resume does not wait for the writer thread: wait here,
        # so that it restores the newest checkpoint as the port's does
        trainer.ckpt.wait()
        fail(step)

    trainer.failure_hook = hook
    return trainer.run(STEPS), trainer.ckpt.available_steps()


def test_train_lm_replay_is_bit_identical(train_runs):
    clean, failed = train_runs["clean"], train_runs["failure"]
    assert clean["restarts"] == 0 and failed["restarts"] == 1
    assert clean["final_step"] == failed["final_step"] == STEPS
    want = [h["loss"] for h in clean["history"]]
    assert len(want) == STEPS
    steps = [h["step"] for h in failed["history"]]
    # steps 0..5, the failure before 6, then 4.. replayed from step 3's
    # checkpoint
    assert steps == list(range(FAIL_AT)) + list(range(CKPT_EVERY, STEPS))
    assert [h["loss"] for h in failed["history"]] == [want[s] for s in steps]
    assert "restarts: 1" in train_runs["failure_text"]


def test_train_lm_checkpoints_equal_the_jax_trainers(train_runs, jax_run):
    jout, jax_checkpoints = jax_run
    got = train_runs["failure"]
    assert got["final_step"] == jout["final_step"] == STEPS
    assert got["restarts"] == jout["restarts"] == 1
    assert got["checkpoints"] == jax_checkpoints
    assert ([h["step"] for h in got["history"]]
            == [h["step"] for h in jout["history"]])


def test_train_lm_losses_equal_the_jax_trainers(train_runs, jax_run):
    jout, _ = jax_run
    got = train_runs["failure"]["history"]
    assert [h["step"] for h in got] == [h["step"] for h in jout["history"]]
    np.testing.assert_allclose([h["loss"] for h in got],
                               [h["loss"] for h in jout["history"]],
                               rtol=1e-5)


def test_train_lm_prints_the_examples_lines(train_runs):
    lines = train_runs["clean_text"].splitlines()
    assert lines[0].startswith("model: ") and lines[0].endswith("M params")
    assert lines[1] == f"steps: {STEPS}  restarts: 0"
    assert lines[2].startswith("loss: first~")
    assert lines[3].startswith(
        f"checkpoints: {train_runs['clean']['checkpoints']} in ")


# ---------------------------------------------------------------------------
# no card
# ---------------------------------------------------------------------------
def test_train_lm_without_a_card_raises_before_any_directory(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    made = []
    import tempfile

    monkeypatch.setattr(tempfile, "mkdtemp",
                        lambda *a, **k: made.append(a) or "/nonexistent")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        load_port_example("train_lm_torch").main(["--steps", "1"])
    assert made == []
