"""``examples/serve_cluster_torch.py`` against ``examples/serve_cluster.py``.

Each JAX run goes through the example's own ``main()`` (``runpy`` with
``sys.argv`` set); its ``ReplicaGroup`` and ``LifecycleManager`` are
recorded by wrapping their constructors, so every request is compared,
not only the three the example prints.  The port's example runs with
``--device cpu`` on the same weights: ``Model.init_params`` returns the
JAX group's tree through ``params_from_numpy``.  For the defaults with
``--trace-out``, ``--kill-replica`` and the tiered run (1 prefill and 2
decode replicas, 256-token prefill chunks), every request's replica and
tokens, the group's stats (all but the host's own step time and the
counters only one package's engine keeps), the lifecycle counts, the
printed lines (the wall time, the trace's path and its metric count
masked) and the trace's events (names, phases and rows; times differ)
equal the JAX example's; the trace's metrics are the JAX example's and
one more gauge a replica (``cow_copies``, which only the port's engine
publishes); and the example's own asserts hold.  Without ``--device``
and without a card the example raises ``resolve_device``'s error."""

import json
import runpy
import sys

import jax
import numpy as np
import pytest
import torch

from _torch_examples import ROOT, load_port_example, mask, run_quietly
import repro.cluster
from repro_torch.models import Model, params_from_numpy
from repro_torch.obs import validate_chrome_trace

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

RUNS = {
    "defaults_trace": ["--trace-out"],
    "kill_replica": ["--kill-replica"],
    "tiered": ["--prefill-replicas", "1", "--decode-replicas", "2",
               "--prefill-chunk-tokens", "256"],
}
#: per-replica stats only one package's engine keeps, and the host's own
#: step time
UNSHARED = {"fused_step_compiles", "decode_dispatches", "host_us_per_step"}


def shared_stats(stats):
    """The group's stats without what only one package keeps."""
    out = dict(stats)
    out["per_replica"] = [{k: v for k, v in r.items() if k not in UNSHARED}
                          for r in stats["per_replica"]]
    return out


def read_trace(path):
    """The trace's events without their times, and its metrics' names
    and labels."""
    with open(path) as f:
        trace = json.load(f)
    validate_chrome_trace(trace)
    events = [(e.get("name"), e.get("ph"), e.get("pid"), e.get("tid"))
              for e in trace["traceEvents"]]
    metrics = {(m["name"], tuple(sorted(m.get("labels", {}).items())))
               for m in trace["metadata"]["metrics"]}
    return events, metrics


@pytest.fixture(scope="module", params=sorted(RUNS))
def pair(request, tmp_path_factory):
    args = list(RUNS[request.param])
    traces = {}
    if args[:1] == ["--trace-out"]:
        d = tmp_path_factory.mktemp("traces")
        traces = {"jax": str(d / "jax.json"), "port": str(d / "port.json")}
        args = args[1:]
    mp = pytest.MonkeyPatch()
    made = {}
    for cls in (repro.cluster.ReplicaGroup, repro.cluster.LifecycleManager):
        def recorded(self, *a, _init=cls.__init__, _name=cls.__name__,
                     **k):
            made[_name] = self
            _init(self, *a, **k)
        mp.setattr(cls, "__init__", recorded)
    jargs = args + (["--trace-out", traces["jax"]] if traces else [])
    mp.setattr(sys, "argv", ["serve_cluster.py", *jargs])
    _, jax_out = run_quietly(runpy.run_path,
                             str(ROOT / "examples" / "serve_cluster.py"),
                             None, "__main__")
    jgroup, jlife = made["ReplicaGroup"], made["LifecycleManager"]
    np_params = jax.tree.map(np.asarray, jgroup.model.init_params(0))
    mp.setattr(Model, "init_params",
               lambda self, seed=0: params_from_numpy(np_params,
                                                      self.device))
    targs = args + (["--trace-out", traces["port"]] if traces else [])
    (tgroup, tlife), port_out = run_quietly(
        load_port_example("serve_cluster_torch").main,
        [*targs, "--device", "cpu"])
    mp.undo()
    return dict(jax=(jgroup, jlife, jax_out), port=(tgroup, tlife, port_out),
                traces=traces, run=request.param)


def _requests(group):
    return [(r.rid, r.replica, [int(t) for t in r.prompt],
             list(r.generated), r.done) for r in group.requests]


def test_every_request_gets_the_jax_examples_replica_and_tokens(pair):
    jgroup, tgroup = pair["jax"][0], pair["port"][0]
    want = _requests(jgroup)
    assert len(want) >= 12 and all(r[4] for r in want)
    assert _requests(tgroup) == want


def test_stats_and_lifecycle_equal_the_jax_examples(pair):
    jgroup, jlife, _ = pair["jax"]
    tgroup, tlife, _ = pair["port"]
    ts = tgroup.stats()
    assert shared_stats(ts) == shared_stats(jgroup.stats())
    assert tlife.stats() == jlife.stats()
    assert ts["unreclaimed"] == 0
    if pair["run"] == "kill_replica":
        assert tlife.stats()["dead"] == [0]
    if pair["run"] == "tiered":
        assert ts["tiers"]["handoffs_completed"] > 0


def test_printed_lines_equal_the_jax_examples(pair):
    jax_out, port_out = pair["jax"][2], pair["port"][2]
    assert mask(port_out) == mask(jax_out)
    assert "routing spread" in port_out


@pytest.mark.parametrize("pair", ["defaults_trace"], indirect=True)
def test_trace_validates_and_has_the_jax_examples_events(pair):
    traces = pair["traces"]
    got, got_metrics = read_trace(traces["port"])
    want, want_metrics = read_trace(traces["jax"])
    assert len(got) > 0
    assert got == want
    # the port's engine also publishes its cow_copies counter as a gauge
    extra = {m for m in got_metrics - want_metrics if m[0] == "cow_copies"}
    assert len(extra) == len(pair["port"][0].engines)
    assert got_metrics == want_metrics | extra


def test_without_a_card_the_example_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        load_port_example("serve_cluster_torch").main([])
