"""The port's plain attention versions against the JAX package's Pallas
kernels in interpret mode (and its jnp oracles), on the same numpy
inputs: the GQA groups of full qwen2-0.5b (G = 7) and of the smoke
config (G = 2), block-table rows that name other slots' pages, a sweep
bound below the table width, lengths off page boundaries, and chunk
offsets past the first page.  Plus the device dispatch and the kernel
build's error paths, which need no card."""

import os
import stat

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.paged_attention import paged_attention_pallas
from repro_torch.kernels import _build, ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import flash_attention_kernel
from repro_torch.kernels.paged_attention import paged_attention_kernel

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

# f32, as tests/test_kernels.py holds the Pallas bodies to the oracles
TOL = dict(rtol=2e-5, atol=2e-5)


def _rand(rs, shape):
    return (rs.standard_normal(shape) * 0.3).astype(np.float32)


def _paged_case(seed, B, n_pool, mb, H, Hkv, D, n_kv, block=128):
    rs = np.random.RandomState(seed)
    q = _rand(rs, (B, H, D))
    kp = _rand(rs, (B, n_pool, block, Hkv, D))
    vp = _rand(rs, (B, n_pool, block, Hkv, D))
    # global ids drawn across ALL slots' pages: rows read other slots'
    table = rs.randint(0, B * n_pool, (B, mb)).astype(np.int32)
    # lengths off page boundaries, within the swept columns
    lengths = rs.randint(1, n_kv * block, (B,)).astype(np.int32)
    lengths[0] = n_kv * block - 37
    return q, kp, vp, table, lengths


@pytest.mark.parametrize(
    "B,n_pool,mb,H,Hkv,D,n_kv",
    [
        (3, 4, 5, 14, 2, 64, 3),  # qwen2-0.5b: G = 7, n_kv < table width
        (2, 3, 4, 4, 2, 32, 4),   # smoke config: G = 2, full table sweep
        (2, 2, 3, 14, 2, 64, 2),  # G = 7, every row crosses slots
    ],
)
def test_paged_plain_matches_pallas_interpret(B, n_pool, mb, H, Hkv, D,
                                              n_kv):
    q, kp, vp, table, lengths = _paged_case(7 + B + H, B, n_pool, mb, H,
                                            Hkv, D, n_kv)
    want = paged_attention_pallas(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(table), jnp.asarray(lengths), n_kv=n_kv,
        global_pages=True, interpret=True)
    got = tref.paged_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(table), torch.from_numpy(lengths), n_kv=n_kv,
        global_pages=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_paged_plain_local_pages_matches_oracle():
    """The per-slot (local page id) mode of the plain version, against
    the JAX oracle (tests/test_torch_encdec.py holds it against the
    Pallas body, and tests/test_torch_cuda.py the kernel against it)."""
    rs = np.random.RandomState(3)
    B, n_pool, mb, H, Hkv, D = 2, 4, 3, 14, 2, 64
    q = _rand(rs, (B, H, D))
    kp = _rand(rs, (B, n_pool, 128, Hkv, D))
    vp = _rand(rs, (B, n_pool, 128, Hkv, D))
    table = np.stack([rs.permutation(n_pool)[:mb] for _ in range(B)])
    table = table.astype(np.int32)
    lengths = np.array([200, 301], np.int32)
    want = jref.paged_attention(jnp.asarray(q), jnp.asarray(kp),
                                jnp.asarray(vp), jnp.asarray(table),
                                jnp.asarray(lengths))
    got = tref.paged_attention(torch.from_numpy(q), torch.from_numpy(kp),
                               torch.from_numpy(vp), torch.from_numpy(table),
                               torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize(
    "H,Hkv,D,S_kv,q_offset",
    [
        (14, 2, 64, 256, 128),  # qwen2-0.5b group, second chunk
        (14, 2, 64, 384, 256),  # third chunk
        (4, 2, 32, 256, 128),   # smoke config group
        (4, 4, 112, 256, 128),  # zamba2's shared-attention head dim
        (6, 2, 96, 256, 128),   # phi3's head dim
    ],
)
def test_flash_plain_matches_pallas_interpret(H, Hkv, D, S_kv, q_offset):
    rs = np.random.RandomState(11 + q_offset + H)
    q = _rand(rs, (1, 128, H, D))
    k = _rand(rs, (1, S_kv, Hkv, D))
    v = _rand(rs, (1, S_kv, Hkv, D))
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=True,
                                  q_offset=q_offset, interpret=True)
    got = tref.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=True,
                               q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("causal,window,chunk", [(False, 0, 64),
                                                 (True, 96, 100)])
def test_flash_plain_matches_oracle_masks(causal, window, chunk):
    """Bidirectional and sliding-window masks and a ragged last KV chunk
    of the plain version, against the JAX oracle."""
    rs = np.random.RandomState(5)
    q = _rand(rs, (2, 64, 4, 32))
    k = _rand(rs, (2, 250, 2, 32))
    v = _rand(rs, (2, 250, 2, 32))
    want = jref.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal,
                                window=window, q_offset=186, chunk=chunk)
    got = tref.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=causal,
                               window=window, q_offset=186, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_bf16_plain_rounds_weights_like_oracle():
    """bf16 operands: the weights are cast to the value dtype before the
    PV product in both packages."""
    q, kp, vp, table, lengths = _paged_case(9, 2, 3, 3, 14, 2, 64, 3)
    want = jref.paged_attention(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(kp, jnp.bfloat16),
        jnp.asarray(vp, jnp.bfloat16), jnp.asarray(table),
        jnp.asarray(lengths), global_pages=True)
    got = tref.paged_attention(
        torch.from_numpy(q).bfloat16(), torch.from_numpy(kp).bfloat16(),
        torch.from_numpy(vp).bfloat16(), torch.from_numpy(table),
        torch.from_numpy(lengths), global_pages=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


# ---------------------------------------------------------------------------
# dispatch and build (no card needed)
# ---------------------------------------------------------------------------
def test_ops_sends_cpu_tensors_to_plain_versions():
    q, kp, vp, table, lengths = _paged_case(1, 2, 2, 3, 4, 2, 32, 2)
    args = [torch.from_numpy(a) for a in (q, kp, vp, table, lengths)]
    before = paged_attention_kernel.launches
    got = ops.paged_attention(*args, n_kv=2, global_pages=True)
    want = tref.paged_attention(*args, n_kv=2, global_pages=True)
    assert torch.equal(got, want)
    assert paged_attention_kernel.launches == before
    with pytest.raises(ValueError):
        ops.paged_attention(*args, global_pages=True, impl="pallas")


def test_kernel_wrappers_refuse_cpu_tensors():
    x = torch.zeros((1, 128, 2, 32))
    with pytest.raises(ValueError):
        flash_attention_kernel(x, x, x, q_offset=0)
    q, kp, vp, table, lengths = _paged_case(1, 2, 2, 3, 4, 2, 32, 2)
    with pytest.raises(ValueError):
        paged_attention_kernel(*[torch.from_numpy(a) for a in
                                 (q, kp, vp, table, lengths)])


def _fake_nvcc(tmp_path, body):
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text("#!/bin/sh\n" + body)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    return home


def test_build_raises_with_compiler_stderr(tmp_path, monkeypatch):
    home = _fake_nvcc(tmp_path, 'echo "error: no sm_90a here" >&2\nexit 2\n')
    monkeypatch.setenv("CUDA_HOME", str(home))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="no sm_90a here"):
        _build.build(["paged_attention"])
    assert not list((tmp_path / "build").glob("*.so"))


def test_build_writes_hash_named_libraries_once(tmp_path, monkeypatch):
    home = _fake_nvcc(tmp_path, (
        'while [ $# -gt 0 ]; do [ "$1" = "-o" ] && out="$2"; shift; done\n'
        'echo "ptxas info: 40 registers" >&2\necho lib > "$out"\n'))
    monkeypatch.setenv("CUDA_HOME", str(home))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    secs = _build.build()
    assert set(secs) == set(_build.SOURCES)
    for name in _build.SOURCES:
        lib = _build.library_path(name)
        assert lib.is_file() and lib.parent == tmp_path / "build"
        assert "40 registers" in lib.with_name(lib.name + ".log").read_text()
    # unchanged sources: nothing rebuilds
    assert _build.build() == {n: 0.0 for n in _build.SOURCES}
    assert os.path.basename(str(_build.library_path("flash_attention"))
                            ).startswith("flash_attention-")
