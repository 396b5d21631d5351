"""The PyTorch package stands alone: importing it, running an engine
step, a sampled engine with a copy-on-write fork, a whole-prompt
speculative engine under a core scheme, the paper's benchmark data
structures, engines over the granite, minitron, phi3 and granite-moe
configs, a disaggregated replica group
with the lifecycle plane and the trace exporters, a prefix migration
between replicas, an SSM, an encoder-decoder and a hybrid prefill and
decode, a vlm prefill, and the training plane (a ``Trainer`` with its
stamp-guarded data pipeline and checkpoints) pulls in neither JAX nor
the JAX package, and its entry points run on the card unless told
otherwise.  So do the four examples of the port (``examples/*_torch.py``):
their sources import neither, and the quickstart and ``serve_paged``
with ``--device cpu`` run in a process that ends with neither loaded."""

import pathlib
import re
import subprocess
import sys

import pytest
import torch

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]

_CHILD = r"""
import sys
import numpy as np
import repro_torch
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.models import Model
from repro_torch.serving import ServingEngine

eng = ServingEngine(Model(smoke_config(ARCHS["qwen2-0.5b"]), device="cpu"),
                    max_slots=2, max_seq=256, device="cpu")
eng.submit(list(np.arange(1, 40)), max_new_tokens=2)
eng.step()
eng.run_until_done()

# sampled decoding and a copy-on-write fork (the block gather's plain
# version copies the partial prompt page)
eng = ServingEngine(Model(smoke_config(ARCHS["qwen2-0.5b"]), device="cpu"),
                    max_slots=2, max_seq=256, device="cpu", temperature=0.8,
                    top_p=0.9, sample_seed=7)
eng.fork_submit(list(np.arange(1, 140)), 2, max_new_tokens=2)
eng.run_until_done()
assert eng.cow_copies == 1
import repro_torch.kernels.block_gather
import repro_torch.serving.rng
import repro_torch.serving.sampling

# whole-prompt prefill with the speculative lane under a core scheme
eng = ServingEngine(Model(smoke_config(ARCHS["qwen2-0.5b"]), device="cpu"),
                    max_slots=2, max_seq=256, device="cpu", chunk_tokens=0,
                    speculate_k=2, policy="hazard")
eng.submit(list(np.arange(1, 40)), max_new_tokens=3)
eng.run_until_done()
import repro_torch.core
import repro_torch.memory.stall

# the paper's benchmark data structures over a core scheme
import repro_torch.core.ds
from repro_torch.core import BoundedHashMap, make_reclaimer
hm = BoundedHashMap(make_reclaimer("stamp-it"), n_buckets=4, max_entries=3)
for key in range(6):
    hm.get_or_compute(key)
assert hm.count.load() == 3

# the four configs of the dense and MoE families on the paged engine
import repro_torch.configs.granite_3_8b
import repro_torch.configs.granite_moe_3b_a800m
import repro_torch.configs.minitron_4b
import repro_torch.configs.phi3_mini_3_8b
from repro_torch.configs import get_arch
for name in ("granite-moe-3b-a800m", "granite-3-8b", "minitron-4b",
             "phi3-mini-3.8b"):
    eng = ServingEngine(Model(smoke_config(get_arch(name)), device="cpu"),
                        max_slots=2, max_seq=256, device="cpu")
    eng.submit(list(np.arange(1, 140)), max_new_tokens=2)
    eng.run_until_done()

# the cluster plane: a disaggregated group with the lifecycle plane, a
# prefix migration, and the trace exporters
from repro_torch.cluster import (LifecycleManager, ReplicaGroup,
                                 migrate_prefix)
from repro_torch.obs.export import chrome_trace, validate_chrome_trace

model = Model(smoke_config(ARCHS["qwen2-0.5b"]), device="cpu")
group = ReplicaGroup(model, prefill_replicas=1, decode_replicas=1,
                     max_slots=2, max_seq=256)
LifecycleManager(group, heartbeat_timeout=2)
group.submit(list(np.arange(1, 40)), max_new_tokens=3)
group.run_until_done()
assert group.tiers.handoffs_completed == 1
assert validate_chrome_trace(chrome_trace(group.spans)) > 0
group = ReplicaGroup(model, 2, max_slots=2, max_seq=256,
                     router="prefix-affinity", prefix_cache_entries=4)
prompt = list(np.arange(1, 140))
group.submit(prompt, max_new_tokens=2)
group.run_until_done()
src = group.route_trace[0][1]
assert migrate_prefix(group, prompt, src, 1 - src)["imported"] == 1
group.checkpoint()
group.drain()

import torch
from repro_torch.configs import ShapeConfig

ssm = Model(smoke_config(ARCHS["mamba2-2.7b"]), device="cpu")
params = ssm.init_params(0)
tokens = torch.arange(1, 65, dtype=torch.int32).reshape(2, 32)
logits, pcache = ssm.prefill(params, {"tokens": tokens})
cache = ssm.init_cache(ShapeConfig("serve", "decode", 64, 2))
for k, dst in cache["layers"].items():
    dst.copy_(pcache[k])
ssm.decode_step(params, cache, {"tokens": logits.argmax(-1)[:, None]})

ed = Model(smoke_config(ARCHS["seamless-m4t-medium"]), device="cpu")
params = ed.init_params(0)
logits, pcache = ed.prefill(params, {
    "enc_embeds": torch.zeros((1, 16, 128)),
    "tokens": torch.arange(1, 9, dtype=torch.int32)[None]})
cache = ed.init_cache(ShapeConfig("serve", "decode", 64, 1))
cache["self"]["k_pool"][:, 0, 1, :8] = pcache["self_k"][:, 0]
cache["self"]["v_pool"][:, 0, 1, :8] = pcache["self_v"][:, 0]
cache["cross_k"][:, :, :16] = pcache["cross_k"]
cache["cross_v"][:, :, :16] = pcache["cross_v"]
cache["enc_len"][:] = 16
ed.decode_step(params, cache, {
    "tokens": logits.argmax(-1).to(torch.int32)[:, None],
    "lengths": torch.full((1,), 8, dtype=torch.int32),
    "block_table": torch.ones((1, 2), dtype=torch.int32)})
hy = Model(smoke_config(ARCHS["zamba2-7b"]), device="cpu")
params = hy.init_params(0)
logits, pcache = hy.prefill(params, {
    "tokens": torch.arange(1, 17, dtype=torch.int32)[None]})
cache = hy.init_cache(ShapeConfig("serve", "decode", 64, 1))
for k, dst in cache["layers"].items():
    dst.copy_(pcache["mamba"][k])
cache["attn"]["k_pool"][:, 0, 1, :16] = pcache["attn_k"][:, 0]
cache["attn"]["v_pool"][:, 0, 1, :16] = pcache["attn_v"][:, 0]
hy.decode_step(params, cache, {
    "tokens": logits.argmax(-1).to(torch.int32)[:, None],
    "lengths": torch.full((1,), 16, dtype=torch.int32),
    "block_table": torch.ones((1, 2), dtype=torch.int32)})

# the vlm's prefill, and the training plane: a Trainer over its data
# pipeline, the train step and the checkpoint manager
import tempfile
import repro_torch.data
import repro_torch.launch
from repro_torch.training import Trainer
vlm = Model(smoke_config(ARCHS["llava-next-34b"]), device="cpu")
params = vlm.init_params(0)
vlm.prefill(params, vlm.synthetic_batch(ShapeConfig("t", "prefill", 24, 1)))
with tempfile.TemporaryDirectory() as d:
    out = Trainer(vlm, ShapeConfig("t", "train", 24, 1), "cpu", ckpt_dir=d,
                  ckpt_every=1).run(2)
assert out["final_step"] == 2
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
print("BAD", bad)
"""


def test_port_imports_no_jax_and_no_jax_package():
    out = subprocess.run(
        [sys.executable, "-c", _CHILD], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "1",
             "JAX_PLATFORMS": "cpu"},
    )
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_sources_name_no_jax_import():
    pat = re.compile(r"^\s*(import jax|from jax|from repro\b|import repro\b)",
                     re.M)
    files = list((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    examples = sorted((ROOT / "examples").glob("*_torch.py"))
    assert [f.name for f in examples] == [
        "quickstart_torch.py", "serve_cluster_torch.py",
        "serve_paged_torch.py", "train_lm_torch.py"]
    files += examples
    assert len(files) > 10
    hits = [f for f in files if pat.search(f.read_text())]
    assert hits == []


_EXAMPLES_CHILD = r"""
import runpy
import sys

sys.argv = ["quickstart_torch.py"]
runpy.run_path("examples/quickstart_torch.py", run_name="__main__")
sys.argv = ["serve_paged_torch.py", "--device", "cpu"]
runpy.run_path("examples/serve_paged_torch.py", run_name="__main__")
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
print("BAD", bad)
"""


def test_examples_run_without_jax_and_the_jax_package():
    out = subprocess.run(
        [sys.executable, "-c", _EXAMPLES_CHILD], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"},
    )
    assert out.returncode == 0, out.stderr
    assert "scheme=stamp-it allocated=" in out.stdout, out.stdout
    assert "tok/s on CPU" in out.stdout, out.stdout
    assert "BAD []" in out.stdout, out.stdout


def test_group_replicas_live_on_the_models_device():
    """A group takes no device of its own: every replica's engine, pools
    and the shared weights live on the model's device (the card unless
    the model was built for the CPU)."""
    from repro_torch.cluster import ReplicaGroup
    from repro_torch.cluster.group import _leaves
    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.models import Model

    model = Model(smoke_config(ARCHS["qwen2-0.5b"]), device="cpu")
    group = ReplicaGroup(model, 2, max_slots=1, max_seq=256)
    for eng in group.engines:
        assert eng.device == model.device
        assert eng.dev.cache["layers"]["k_pool"].device == model.device
        assert all(t.device == model.device
                   for t in _leaves(eng.dev.params))


def test_engine_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.models import Model
    from repro_torch.serving import ServingEngine

    model = Model(smoke_config(ARCHS["qwen2-0.5b"]), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(model, max_slots=1, max_seq=256)
