"""The port's training plane against the JAX package on the same numpy
inputs, at smoke width (2 layers, d_model 128, f32): ``Model.loss_fn``
(the loss, ``ntokens`` and the gradient of every param leaf against
``jax.value_and_grad(model.loss_fn)``) for each family — dense, MoE
dropless and at capacity 0.5 (each expert takes 8 slots a row of the
~16 pairs routed to it, so pairs drop), SSM, hybrid, encoder-decoder
and the vlm with its text-only loss —; the four remat policies giving
the same numbers; ``adamw_update`` over 3 steps in warm-up with the
clip active; ``build_train_step`` against the JAX step on
``make_debug_mesh()`` over 3 steps; the ``Trainer``'s losses against the
JAX ``Trainer``'s through a failure and its replay, the replay bit for
bit against an uninterrupted run, and the straggler flags; and
``Model.synthetic_batch`` the same in two processes.

Tolerances.  The attention projections are *conditioned* (rescaled to
unit variance over their contraction, as tests/test_torch_hybrid.py
does): the seeded init makes each head a near-hard argmax that amplifies
the two frameworks' summation orders ~20-fold (measured: gradients then
differ by up to 1.6e-3 of a leaf's largest magnitude, conditioned by up
to 3.2e-6).  Losses are held to rtol 1e-6, every gradient leaf to 1e-5 of
its largest magnitude, AdamW to 1e-6, the train step's loss and grad norm
to rtol 1e-6 and its params to 1e-6 absolute."""

import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import ShapeConfig as JaxShape
from repro.configs import smoke_config as jax_smoke
from repro.launch.mesh import make_debug_mesh
from repro.launch.steps import build_train_step as jax_build_train_step
from repro.models import Model as JaxModel
from repro.models.param import init_params as jax_init_params
from repro.training import AdamWConfig as JaxAdamW
from repro.training import Trainer as JaxTrainer
from repro.training import adamw_update as jax_adamw_update
from repro.training import inject_failure_at as jax_inject_failure_at
from repro.training import opt_state_specs as jax_opt_state_specs
from repro_torch.configs import ARCHS, ShapeConfig, smoke_config
from repro_torch.launch import build_train_step, loss_and_grads
from repro_torch.models import Model, init_params, params_from_numpy
from repro_torch.training import (AdamWConfig, Trainer, adamw_update,
                                  inject_failure_at, opt_state_specs)

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
B, S = 2, 32
GRAD_TOL = 1e-5
#: (arch, overrides of its smoke config)
FAMILIES = [
    ("qwen2-0.5b", {}),
    ("granite-moe-3b-a800m", {}),
    ("granite-moe-3b-a800m", {"moe_capacity_factor": 0.5}),
    ("mamba2-2.7b", {}),
    ("zamba2-7b", {}),
    ("seamless-m4t-medium", {}),
    ("llava-next-34b", {}),
]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _condition(tree):
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
        _condition(v)
    return tree


def _models(name, over):
    jm = JaxModel(jax_smoke(JAX_ARCHS[name]).scaled(**over))
    np_params = _condition(jax.tree.map(np.asarray, jm.init_params(0)))
    tm = Model(smoke_config(ARCHS[name]).scaled(**over), device="cpu")
    return jm, np_params, tm


def _batch(cfg, seed=0, mask=True):
    rs = np.random.RandomState(seed)
    P = cfg.frontend_positions if cfg.family == "vlm" else 0
    batch = {"tokens": rs.randint(0, cfg.vocab_size, (B, S - P)),
             "labels": rs.randint(0, cfg.vocab_size, (B, S - P))}
    batch = {k: v.astype(np.int32) for k, v in batch.items()}
    if mask:
        batch["loss_mask"] = (rs.rand(B, S - P) < 0.8).astype(np.float32)
    if cfg.is_encdec:
        batch["enc_embeds"] = (rs.randn(B, S, cfg.d_model)
                               * 0.02).astype(np.float32)
    if P:
        batch["frontend_embeds"] = (rs.randn(B, P, cfg.d_model)
                                    * 0.02).astype(np.float32)
    return batch


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _port_loss_and_grads(tm, np_params, batch, remat):
    loss, metrics, grads = loss_and_grads(
        tm, params_from_numpy(np_params, "cpu"), _tb(batch), remat=remat)
    return loss, metrics, _flat(grads)


# ---------------------------------------------------------------------------
# the loss and every gradient leaf, each family
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,over", FAMILIES, ids=lambda x: (
    x if isinstance(x, str) else "drops" if x else "default"))
def test_loss_and_grads_match_jax(name, over):
    jm, np_params, tm = _models(name, over)
    batch = _batch(jm.cfg)
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss_fn(p, b, remat=None), has_aux=True))
    (jloss, jmet), jgrads = fn(np_params, batch)
    loss, metrics, grads = _port_loss_and_grads(tm, np_params, batch, "full")
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    assert float(metrics["ntokens"]) == float(jmet["ntokens"])
    assert float(metrics["loss"]) == float(loss)
    jg = _flat(jax.tree.map(np.asarray, jgrads))
    assert set(grads) == set(jg)
    for k, g in grads.items():
        want = jg[k]
        err = np.abs(g.numpy() - want).max() / max(np.abs(want).max(), 1e-30)
        assert err <= GRAD_TOL, (k, err)


def test_vlm_loss_is_on_text_positions_only():
    """The frontend positions carry no loss: the loss equals the mean
    next-token loss over the text logits alone."""
    _, np_params, tm = _models("llava-next-34b", {})
    batch = _batch(tm.cfg, mask=False)
    params = params_from_numpy(np_params, "cpu")
    loss, metrics = tm.loss_fn(params, _tb(batch), remat=None)
    assert float(metrics["ntokens"]) == B * (S - tm.cfg.frontend_positions)
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    tb = _tb(batch)
    x, _ = T.run_decoder_stack(params, T._embed_inputs(params, tb, tm.cfg),
                               tm.cfg)
    x = L.apply_norm(params["final_norm"], x, tm.cfg)
    logits = L.unembed(params["embed"], x, tm.cfg)[
        :, tm.cfg.frontend_positions:]
    want = torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), tb["labels"].long().reshape(-1))
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-6)


@pytest.mark.parametrize("name", ["qwen2-0.5b", "zamba2-7b",
                                  "seamless-m4t-medium"])
def test_remat_policies_give_the_same_numbers(name):
    _, np_params, tm = _models(name, {})
    batch = _batch(tm.cfg)
    runs = {r: _port_loss_and_grads(tm, np_params, batch, r)
            for r in (None, "none", "full", "dots")}
    loss0, _, grads0 = runs[None]
    for r, (loss, _, grads) in runs.items():
        assert torch.equal(loss, loss0), r
        for k in grads0:
            assert torch.equal(grads[k], grads0[k]), (r, k)
    with pytest.raises(ValueError, match="remat"):
        tm.loss_fn(params_from_numpy(np_params, "cpu"), _tb(batch),
                   remat="some")


# ---------------------------------------------------------------------------
# AdamW and the train step
# ---------------------------------------------------------------------------
def test_adamw_update_matches_jax():
    rs = np.random.RandomState(3)
    shapes = {"w": (6, 5), "norm": {"scale": (5,)}, "b": (5,)}
    params = jax.tree.map(lambda s: rs.randn(*s).astype(np.float32), shapes,
                          is_leaf=lambda x: isinstance(x, tuple))
    jcfg = JaxAdamW(warmup_steps=10, grad_clip=0.5)
    cfg = AdamWConfig(warmup_steps=10, grad_clip=0.5)
    zeros = jax.tree.map(np.zeros_like, params)
    jstate = {"mu": zeros, "nu": zeros, "step": jnp.int32(0)}
    tparams = params_from_numpy(params, "cpu")
    tstate = {"mu": params_from_numpy(zeros, "cpu"),
              "nu": params_from_numpy(zeros, "cpu"),
              "step": torch.zeros((), dtype=torch.int32)}
    jparams = params
    for step in range(3):
        grads = jax.tree.map(
            lambda p: (rs.randn(*p.shape) * 2).astype(np.float32), params)
        jparams, jstate, jnorm = jax_adamw_update(jcfg, grads, jstate,
                                                  jparams)
        tparams, tstate, tnorm = adamw_update(
            cfg, params_from_numpy(grads, "cpu"), tstate, tparams)
        assert float(jnorm) > 0.5  # the clip is active
        np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=1e-6)
        assert int(tstate["step"]) == int(jstate["step"]) == step + 1
        for tree, jtree in ((tparams, jparams), (tstate["mu"], jstate["mu"]),
                            (tstate["nu"], jstate["nu"])):
            jf = _flat(jax.tree.map(np.asarray, jtree))
            for k, v in _flat(tree).items():
                np.testing.assert_allclose(v.numpy(), jf[k], rtol=1e-6,
                                           atol=1e-7)


def test_adamw_update_in_pieces_is_bit_identical(monkeypatch):
    """A leaf of more than ``PIECE`` elements is updated in pieces (here
    pieces of 7 elements): the same bits as the whole leaf at once, over 3
    steps with the clip active, and within 1e-6 of the JAX update."""
    from repro_torch.training import optimizer

    monkeypatch.setattr(optimizer, "PIECE", 7)
    rs = np.random.RandomState(4)
    shapes = {"layers": {"w": (3, 6, 5), "a": (3, 4)}, "b": (5,)}
    params = jax.tree.map(lambda s: rs.randn(*s).astype(np.float32), shapes,
                          is_leaf=lambda x: isinstance(x, tuple))
    cfg = AdamWConfig(warmup_steps=10, grad_clip=0.5)
    zeros = jax.tree.map(np.zeros_like, params)
    tparams = params_from_numpy(params, "cpu")
    tstate = {"mu": params_from_numpy(zeros, "cpu"),
              "nu": params_from_numpy(zeros, "cpu"),
              "step": torch.zeros((), dtype=torch.int32)}
    # the whole-leaf update, as the step wrote it before the pieces
    ref = {k: v.clone() for k, v in _flat(tparams).items()}
    mu = {k: torch.zeros_like(v) for k, v in ref.items()}
    nu = {k: torch.zeros_like(v) for k, v in ref.items()}
    jstate = {"mu": zeros, "nu": zeros, "step": jnp.int32(0)}
    jparams = params
    for step in range(3):
        grads = jax.tree.map(
            lambda p: (rs.randn(*p.shape) * 2).astype(np.float32), params)
        tgrads = params_from_numpy(grads, "cpu")
        tparams, tstate, tnorm = adamw_update(cfg, tgrads, tstate, tparams)
        jparams, jstate, _ = jax_adamw_update(
            JaxAdamW(warmup_steps=10, grad_clip=0.5), grads, jstate, jparams)
        stepf = torch.tensor(step + 1, dtype=torch.int32).float()
        lr = cfg.lr * torch.clamp(stepf / cfg.warmup_steps, max=1.0)
        flat_g = _flat(tgrads)
        sq = sum(torch.sum(torch.square(flat_g[k].float()))
                 for k in sorted(flat_g))
        scale = torch.clamp(cfg.grad_clip / torch.clamp(torch.sqrt(sq),
                                                        min=1e-9), max=1.0)
        bc1 = 1 - torch.tensor(cfg.b1) ** stepf
        bc2 = 1 - torch.tensor(cfg.b2) ** stepf
        for k in ref:
            gf = flat_g[k].float() * scale
            mu[k].mul_(cfg.b1).add_((1 - cfg.b1) * gf)
            nu[k].mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(gf))
            ref[k] = ref[k] - lr * ((mu[k] / bc1) / (
                torch.sqrt(nu[k] / bc2) + cfg.eps) + cfg.weight_decay * ref[k])
        got = _flat(tparams)
        jf = _flat(jax.tree.map(np.asarray, jparams))
        for k in ref:
            assert torch.equal(got[k], ref[k]), k
            assert torch.equal(_flat(tstate["mu"])[k], mu[k]), k
            assert torch.equal(_flat(tstate["nu"])[k], nu[k]), k
            np.testing.assert_allclose(got[k].numpy(), jf[k], rtol=1e-6,
                                       atol=1e-7)


def test_train_step_matches_jax_on_debug_mesh():
    jm, np_params, tm = _models("qwen2-0.5b", {})
    fn, _, _ = jax_build_train_step(jm, JaxShape("t", "train", S, B),
                                    make_debug_mesh(), remat="full")
    jp = jax.tree.map(jnp.asarray, np_params)
    jo = jax_init_params(jax_opt_state_specs(jm.param_specs))
    step = build_train_step(tm, remat="full")
    tp = params_from_numpy(np_params, "cpu")
    to = init_params(opt_state_specs(tm.param_specs), 0, "cpu")
    for i in range(3):
        batch = _batch(tm.cfg, seed=10 + i, mask=False)
        jp, jo, jmet = fn(jp, jo, batch)
        tp, to, tmet = step(tp, to, _tb(batch))
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(tmet["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-6)
    jf = _flat(jax.tree.map(np.asarray, jp))
    for k, v in _flat(tp).items():
        np.testing.assert_allclose(v.numpy(), jf[k], rtol=0, atol=1e-6)
    assert int(to["step"]) == 3


# ---------------------------------------------------------------------------
# the Trainer
# ---------------------------------------------------------------------------
TRAIN_SHAPE = ShapeConfig("t", "train", S, B)


def _trainers(tmp_path, **kw):
    jm, np_params, tm = _models("qwen2-0.5b", {})
    jm.init_params = lambda seed=0: jax.tree.map(jnp.asarray, np_params)
    tm.init_params = lambda seed=0: params_from_numpy(np_params, "cpu")
    jt = JaxTrainer(jm, JaxShape("t", "train", S, B), make_debug_mesh(),
                    ckpt_dir=str(tmp_path / "jax"), **kw)
    return jt, tm


def test_trainer_matches_jax_trainer_through_a_failure(tmp_path):
    jt, tm = _trainers(tmp_path, ckpt_every=2)
    fail = jax_inject_failure_at({3})

    def jax_hook(step):
        # the JAX resume does not wait for the writer thread: wait here,
        # so that it restores step 1's checkpoint as the port's does
        jt.ckpt.wait()
        fail(step)

    jt.failure_hook = jax_hook
    tt = Trainer(tm, TRAIN_SHAPE, "cpu", ckpt_dir=str(tmp_path / "port"),
                 ckpt_every=2, failure_hook=inject_failure_at({3}))
    jout, tout = jt.run(5), tt.run(5)
    assert tout["restarts"] == jout["restarts"] == 1
    assert tout["final_step"] == jout["final_step"] == 5
    assert ([h["step"] for h in tout["history"]]
            == [h["step"] for h in jout["history"]])
    np.testing.assert_allclose([h["loss"] for h in tout["history"]],
                               [h["loss"] for h in jout["history"]],
                               rtol=1e-5)
    assert tt.ckpt.available_steps() == jt.ckpt.available_steps()


def test_trainer_replay_is_bit_identical(tmp_path):
    _, np_params, tm = _models("qwen2-0.5b", {})
    tm.init_params = lambda seed=0: params_from_numpy(np_params, "cpu")
    base = Trainer(tm, TRAIN_SHAPE, "cpu", ckpt_dir=str(tmp_path / "a"),
                   ckpt_every=2, seed=1).run(6)
    crashy = Trainer(tm, TRAIN_SHAPE, "cpu", ckpt_dir=str(tmp_path / "b"),
                     ckpt_every=2, seed=1,
                     failure_hook=inject_failure_at({4}))
    out = crashy.run(6)
    assert out["restarts"] == 1
    want = {h["step"]: h["loss"] for h in base["history"]}
    got = {h["step"]: h["loss"] for h in out["history"]}
    assert got == want
    for k, v in _flat(crashy.params).items():
        assert torch.isfinite(v).all(), k


def test_trainer_straggler_flags():
    tm = Model(smoke_config(ARCHS["qwen2-0.5b"]), device="cpu")
    out = Trainer(tm, TRAIN_SHAPE, "cpu", step_deadline_s=1e-9).run(2)
    assert out["stragglers"] == [0, 1]  # every step exceeds 1 ns
    assert Trainer(tm, TRAIN_SHAPE, "cpu").run(1)["stragglers"] == []


# ---------------------------------------------------------------------------
# synthetic batches: the same in every process
# ---------------------------------------------------------------------------
_CHILD = r"""
import hashlib
import torch
from repro_torch.configs import ARCHS, ShapeConfig, smoke_config
from repro_torch.models import Model

h = hashlib.sha256()
for name in ("qwen2-0.5b", "llava-next-34b", "seamless-m4t-medium"):
    m = Model(smoke_config(ARCHS[name]), device="cpu")
    for kind in ("train", "prefill", "decode"):
        b = m.synthetic_batch(ShapeConfig("t", kind, 32, 2), seed=3)
        for k in sorted(b):
            h.update(k.encode())
            h.update(b[k].view(torch.uint8).numpy().tobytes()
                     if b[k].dim() else b[k].numpy().tobytes())
print(h.hexdigest())
"""


def test_synthetic_batch_is_the_same_in_two_processes():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1] for o in outs]
    assert outs[0][0] == outs[1][0] and len(outs[0][0].strip()) == 64


def test_synthetic_batch_follows_input_specs():
    for name in ("qwen2-0.5b", "llava-next-34b", "seamless-m4t-medium",
                 "zamba2-7b"):
        m = Model(smoke_config(ARCHS[name]), device="cpu")
        for kind in ("train", "prefill", "decode"):
            shape = ShapeConfig("t", kind, 32, 2)
            specs = m.input_specs(shape)
            b = m.synthetic_batch(shape, seed=1)
            assert set(b) == set(specs)
            for k, s in specs.items():
                assert tuple(b[k].shape) == s.shape and b[k].dtype == s.dtype
            if kind == "decode":
                assert (b["lengths"] == 16).all()
            else:
                assert 0 <= int(b["tokens"].min()) and int(
                    b["tokens"].max()) < m.cfg.vocab_size
            other = m.synthetic_batch(shape, seed=2)
            assert not torch.equal(b["tokens"], other["tokens"]) or (
                kind == "decode")
