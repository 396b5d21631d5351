"""``examples/serve_paged_torch.py`` against ``examples/serve_paged.py``.

Each JAX run goes through the example's own ``main()`` (``runpy`` with
``sys.argv`` set); its engine is recorded by wrapping
``ServingEngine.run_until_done``, so every request is compared, not only
the four the example prints.  The port's example runs with ``--device
cpu`` on the same weights: ``Model.init_params`` returns the JAX
engine's tree through ``params_from_numpy``.  For the defaults, best-of
2 with the speculative lane, and sampling under whole-prompt prefill and
hazard pointers, the tokens of every request, every stats entry the two
engines share (all but the host's own step time) and the printed lines
(the wall time and rate masked) are equal.  Without ``--device`` and
without a card the example raises ``resolve_device``'s error."""

import runpy
import sys

import jax
import numpy as np
import pytest
import torch

from _torch_examples import ROOT, load_port_example, mask, run_quietly
import repro.serving
from repro_torch.models import Model, params_from_numpy

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

RUNS = {
    "defaults": [],
    "best_of_spec": ["--best-of", "2", "--speculate", "2"],
    "sampled_whole_hazard": ["--temperature", "0.8", "--top-p", "0.9",
                             "--chunk-tokens", "0", "--policy", "hazard"],
}
#: stats only one package's engine keeps, and the host's own step time
UNSHARED = {"fused_step_compiles", "decode_dispatches", "host_us_per_step"}


@pytest.fixture(scope="module", params=sorted(RUNS))
def pair(request):
    args = RUNS[request.param]
    mp = pytest.MonkeyPatch()
    engines = []
    run = repro.serving.ServingEngine.run_until_done

    def recorded(self, *a, **k):
        engines.append(self)
        return run(self, *a, **k)

    mp.setattr(repro.serving.ServingEngine, "run_until_done", recorded)
    mp.setattr(sys, "argv", ["serve_paged.py", *args])
    _, jax_out = run_quietly(runpy.run_path,
                             str(ROOT / "examples" / "serve_paged.py"),
                             None, "__main__")
    (jeng,) = engines
    np_params = jax.tree.map(np.asarray, jeng.model.init_params(0))
    mp.setattr(Model, "init_params",
               lambda self, seed=0: params_from_numpy(np_params,
                                                      self.device))
    teng, port_out = run_quietly(load_port_example("serve_paged_torch").main,
                                 [*args, "--device", "cpu"])
    mp.undo()
    return jeng, teng, jax_out, port_out


def test_every_request_gets_the_jax_examples_tokens(pair):
    jeng, teng, _, _ = pair
    want = {r.rid: list(r.generated) for r in jeng.sched.finished}
    got = {r.rid: list(r.generated) for r in teng.sched.finished}
    assert len(want) >= 12
    assert got == want


def test_stats_equal_the_jax_examples(pair):
    jeng, teng, _, _ = pair
    js, ts = jeng.stats(), teng.stats()
    shared = (set(js) | set(ts)) - UNSHARED
    assert shared <= set(js) & set(ts)
    assert {k: ts[k] for k in shared} == {k: js[k] for k in shared}
    assert ts["pool_unreclaimed"] == 0


def test_printed_lines_equal_the_jax_examples(pair):
    _, _, jax_out, port_out = pair
    assert "tok/s on CPU" in port_out
    assert mask(port_out) == mask(jax_out)
    assert len(port_out.splitlines()) >= 6


def test_without_a_card_the_example_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        load_port_example("serve_paged_torch").main([])
