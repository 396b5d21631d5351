"""Helpers shared by the ``tests/test_torch_examples_*.py`` files: the
port's example files loaded as modules, their printed lines captured,
and the lines' run-dependent parts masked."""

import contextlib
import importlib.util
import io
import pathlib
import re

ROOT = pathlib.Path(__file__).resolve().parents[1]


def load_port_example(name):
    """``examples/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_quietly(fn, *a, **k):
    """``fn(*a, **k)`` and what it printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*a, **k)
    return out, buf.getvalue()


def mask(text):
    """The printed lines without the wall time, the rate, the trace's
    metric count (held in the trace test) and its path."""
    text = re.sub(r"in [0-9.]+s \([0-9.]+ tok/s on [^)]*\)", "in Ts", text)
    text = re.sub(r"tokens in [0-9.]+s", "tokens in Ts", text)
    return re.sub(r"[0-9]+ metrics\) -> .*", "N metrics) -> PATH", text)
