"""The port's sampling lane against the JAX package's.

  * ``counter_uniform`` (torch, on the CPU here) and its numpy twin give
    the SAME float32 bit patterns as the JAX package's
    ``counter_uniform`` (threefry2x32, ``jax_threefry_partitionable``
    on) over a grid of seeds and positions: tolerance 0, compared as
    uint32.
  * ``sample_tokens`` (torch) equals the JAX ``sample_tokens`` and the
    port's host reference ``sample_ref`` token for token at the four
    ``(temperature, top_p)`` pairs of ``tests/test_sampling.py``.  The
    only legal divergence is float associativity (the packages sum the
    softmax and the cumulative sums in different orders), so a case whose
    ``u`` lies within 1e-5 of a ``kcum`` boundary is filtered, as that
    file does, and more than 100 cases must remain.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import sample_tokens as jax_sample_tokens
from repro.serving.device_state import counter_uniform as jax_uniform
from repro.serving.sampling import sample as jax_sample
from repro.serving.sampling import sample_ref as jax_sample_ref
from repro_torch.serving.device_state import sample_tokens
from repro_torch.serving.rng import counter_uniform, counter_uniform_np
from repro_torch.serving.sampling import nucleus_cdf, sample, sample_ref

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

PAIRS = [(0.7, 0.9), (1.0, 1.0), (1.3, 0.5), (0.4, 0.95)]
BOUNDARY = 1e-5  # |u - kcum| below this is a float-associativity tie


def _seed_pos_grid():
    rs = np.random.RandomState(0)
    seeds = [0, 1, 7, 12345, 0x7FFFFFFF] + list(rs.randint(0, 2**31 - 1, 6))
    pos = [0, 1, 127, 128, 1023] + list(rs.randint(0, 1 << 20, 6))
    s, p = np.meshgrid(np.asarray(seeds, np.int64),
                       np.asarray(pos, np.int64), indexing="ij")
    return s.ravel(), p.ravel()


@pytest.fixture(scope="module")
def jax_bits():
    s, p = _seed_pos_grid()
    u = jax.vmap(jax_uniform)(jnp.asarray(s, jnp.int32),
                              jnp.asarray(p, jnp.int32))
    return np.asarray(u).view(np.uint32)


@pytest.mark.parametrize("impl", ["torch", "numpy"])
def test_counter_uniform_bits_match_jax(jax_bits, impl):
    s, p = _seed_pos_grid()
    if impl == "torch":
        u = counter_uniform(torch.from_numpy(s).to(torch.int32),
                            torch.from_numpy(p).to(torch.int32)).numpy()
    else:
        u = counter_uniform_np(s, p)
    assert u.dtype == np.float32
    np.testing.assert_array_equal(u.view(np.uint32), jax_bits)
    assert (u >= 0).all() and (u < 1).all()


@pytest.mark.parametrize("temperature,top_p", PAIRS)
def test_sample_tokens_match_jax_and_host(temperature, top_p):
    rs = np.random.RandomState(0)
    V, n_rows = 257, 25
    logits = np.stack([(rs.randn(V) * rs.uniform(0.5, 3.0))
                       for _ in range(n_rows)]).astype(np.float32)
    kcums = [nucleus_cdf(row, temperature, top_p)[1] for row in logits]
    checked = filtered = 0
    for u in (0.013, 0.2, 0.37, 0.55, 0.71, 0.9, 0.987):
        uu = np.full((n_rows,), u, np.float32)
        got = sample_tokens(torch.from_numpy(logits), torch.from_numpy(uu),
                            temperature, top_p).numpy()
        want = np.asarray(jax_sample_tokens(jnp.asarray(logits),
                                            jnp.asarray(uu), temperature,
                                            top_p))
        for i in range(n_rows):
            if np.min(np.abs(kcums[i] - np.float32(u))) < BOUNDARY:
                filtered += 1
                continue
            host = sample_ref(logits[i], u, temperature=temperature,
                              top_p=top_p)
            assert host == jax_sample_ref(logits[i], u,
                                          temperature=temperature,
                                          top_p=top_p)
            assert int(got[i]) == int(want[i]) == host, (i, u)
            checked += 1
    assert checked > 100, (checked, filtered)


def test_sampler_respects_top_p():
    """A spiked distribution under top_p 0.6: only the spike set is ever
    drawn, by the torch sampler, the JAX sampler and the host alike."""
    logits = np.full((64,), -10.0, np.float32)
    logits[7] = 5.0
    logits[11] = 4.5
    us = np.linspace(0.001, 0.999, 23).astype(np.float32)
    batch = np.repeat(logits[None], len(us), axis=0)
    got = sample_tokens(torch.from_numpy(batch), torch.from_numpy(us),
                        1.0, 0.6).numpy()
    want = np.asarray(jax_sample_tokens(jnp.asarray(batch),
                                        jnp.asarray(us), 1.0, 0.6))
    host = [sample_ref(logits, float(u), temperature=1.0, top_p=0.6)
            for u in us]
    assert set(got.tolist()) <= {7, 11}
    assert got.tolist() == want.tolist() == host


def test_sample_convenience_api_matches_jax():
    rs = np.random.RandomState(1)
    logits = rs.randn(100).astype(np.float32)
    assert sample(logits) == int(np.argmax(logits))  # greedy default
    for kw, seed in ((dict(temperature=0.8, top_p=0.9), 2),
                     (dict(temperature=0.8, top_k=5), 3),
                     (dict(temperature=1.1), 4)):
        got = sample(logits, rng=np.random.RandomState(seed), **kw)
        want = jax_sample(logits, rng=np.random.RandomState(seed), **kw)
        assert got == want and 0 <= got < 100
