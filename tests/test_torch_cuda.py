"""The CUDA kernels against their plain versions on the card, the engine
through the kernels against the engine through the plain versions, and a
full-width Mamba2 layer with the SSD kernel against the plain scan.
Marked ``cuda``: each test skips where there is no card.  On a machine
with one, run ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_cuda.py`` (the first test builds the kernels with nvcc).

Tolerances: f32 1e-4 (the kernels sum in another order than the plain
matmuls, over up to ~1k keys); bf16 2e-2 (the kernels round unnormalized
softmax weights to bf16, the plain versions normalized ones — the same
gap tests/test_kernels.py allows between the Pallas bodies and their
oracles)."""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention_kernel
from repro_torch.kernels.paged_attention import paged_attention_kernel
from repro_torch.kernels.ssd_scan import ssd_chunk_scan_kernel

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,n_pool,mb,H,Hkv,D,n_kv",
    [(8, 16, 9, 14, 2, 64, 8), (3, 4, 5, 4, 2, 32, 5),
     (2, 3, 4, 14, 2, 128, 2)],
)
def test_paged_kernel_matches_plain(card, dtype, B, n_pool, mb, H, Hkv, D,
                                    n_kv):
    g = torch.Generator(device=card).manual_seed(B * H + D)
    q = torch.randn((B, H, D), generator=g, device=card).to(dtype) * 0.3
    kp = torch.randn((B, n_pool, 128, Hkv, D), generator=g,
                     device=card).to(dtype) * 0.3
    vp = torch.randn((B, n_pool, 128, Hkv, D), generator=g,
                     device=card).to(dtype) * 0.3
    table = torch.randint(0, B * n_pool, (B, mb), generator=g, device=card,
                          dtype=torch.int32)
    lengths = torch.randint(1, n_kv * 128, (B,), generator=g, device=card,
                            dtype=torch.int32)
    lengths[-1] = 0  # an idle row: uniform weights over the masked sweep
    before = paged_attention_kernel.launches
    got = ops.paged_attention(q, kp, vp, table, lengths, n_kv=n_kv,
                              global_pages=True)
    torch.cuda.synchronize()
    assert paged_attention_kernel.launches == before + 1
    want = ref.paged_attention(q, kp, vp, table, lengths, n_kv=n_kv,
                               global_pages=True)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "S_q,S_kv,H,Hkv,D,q_offset",
    [(128, 1024, 14, 2, 64, 768), (128, 128, 14, 2, 64, 0),
     (100, 250, 4, 2, 32, 150), (64, 384, 8, 8, 128, 256)],
)
def test_flash_kernel_matches_plain(card, dtype, S_q, S_kv, H, Hkv, D,
                                    q_offset):
    g = torch.Generator(device=card).manual_seed(S_q + S_kv + D)
    q = torch.randn((1, S_q, H, D), generator=g, device=card) * 0.3
    k = torch.randn((1, S_kv, Hkv, D), generator=g, device=card) * 0.3
    v = torch.randn((1, S_kv, Hkv, D), generator=g, device=card) * 0.3
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    before = flash_attention_kernel.launches
    got = ops.flash_attention(q, k, v, causal=True, q_offset=q_offset)
    torch.cuda.synchronize()
    assert flash_attention_kernel.launches == before + 1
    want = ref.flash_attention(q, k, v, causal=True, q_offset=q_offset)
    _close(got, want, dtype)


def test_engine_kernels_match_plain_tokens(card):
    """Smoke width, f32: the engine through the kernels emits the same
    greedy tokens as the engine through the plain versions."""
    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.models import Model
    from repro_torch.serving import ServingEngine

    model = Model(smoke_config(ARCHS["qwen2-0.5b"]), device=card)
    params = model.init_params(0)
    rs = np.random.RandomState(0)
    prompts = [list(rs.randint(1, 500, n)) for n in (20, 300, 130, 513)]
    out = {}
    for impl in (None, "plain"):
        eng = ServingEngine(model, max_slots=2, max_seq=768, params=params,
                            device=card, impl=impl)
        reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
        eng.run_until_done()
        eng.drain()
        assert eng.stats()["dispatches_per_step"] == 1
        out[impl] = [r.generated for r in reqs]
    assert out[None] == out["plain"]


def _ssd_inputs(card, dtype, B, S, H, P, N, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    x = (torch.randn((B, S, H, P), generator=g, device=card) * 0.3)
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=g, device=card) - 1.0)
    a = -torch.exp(torch.randn((H,), generator=g, device=card) * 0.3)
    b = torch.randn((B, S, 1, N), generator=g, device=card) * 0.3
    c = torch.randn((B, S, 1, N), generator=g, device=card) * 0.3
    d = torch.randn((H,), generator=g, device=card)
    return x.to(dtype), dt, a, b.to(dtype), c.to(dtype), d


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,S,H,P,N,chunk",
    [(1, 128, 4, 32, 16, 64), (2, 256, 8, 64, 32, 128),
     (1, 256, 16, 32, 64, 64), (2, 127, 80, 64, 128, 127),
     (2, 512, 80, 64, 128, 128), (1, 96, 6, 32, 16, 128)],
)
def test_ssd_kernel_matches_plain(card, dtype, B, S, H, P, N, chunk):
    """y and the final state, held to the tolerance of the dtype times
    the largest magnitude of each (the state sums up to 128 rows)."""
    x, dt, a, b, c, d = _ssd_inputs(card, dtype, B, S, H, P, N,
                                    B * S + H + N)
    before = ssd_chunk_scan_kernel.launches
    got_y, got_s = ops.ssd_chunk_scan(x, dt, a, b, c, chunk=chunk, d_skip=d)
    torch.cuda.synchronize()
    assert ssd_chunk_scan_kernel.launches == before + 1
    want_y, want_s = ref.ssd_chunk_scan(x, dt, a, b, c, chunk=min(chunk, S),
                                        d_skip=d)
    assert got_y.dtype == dtype and got_s.dtype == torch.float32
    tol = TOL[dtype]["atol"]
    for got, want in ((got_y, want_y), (got_s, want_s)):
        scale = float(want.float().abs().max())
        err = float((got.float() - want.float()).abs().max())
        assert err <= tol * scale, (err, scale)


def test_full_width_mamba_layer_kernel_matches_plain(card):
    """One full-width mamba2-2.7b layer (bf16, seeded init), 2 sequences
    of 256 tokens: the block output and its cache through the kernel
    against the plain scan, within 2e-2 of each one's largest magnitude
    (bf16 activations round the scan's output once either way)."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import Model
    from repro_torch.models import ssm as S
    from repro_torch.models import transformer as T

    cfg = ARCHS["mamba2-2.7b"].scaled(num_layers=1)
    model = Model(cfg, device=card)
    params = model.compute_params(model.init_params(0))
    lp = T._layer(params["layers"], 0)["mamba"]
    g = torch.Generator(device=card).manual_seed(5)
    xin = torch.randn((2, 256, cfg.d_model), generator=g,
                      device=card).to(torch.bfloat16)
    before = ssd_chunk_scan_kernel.launches
    got, got_c = S.mamba_full(lp, xin, cfg)
    want, want_c = S.mamba_full(lp, xin, cfg, impl="plain")
    torch.cuda.synchronize()
    assert ssd_chunk_scan_kernel.launches == before + 1
    pairs = [(got, want)] + [(got_c[k], want_c[k]) for k in want_c]
    for a, b in pairs:
        assert a.dtype == b.dtype and a.shape == b.shape
        scale = float(b.float().abs().max())
        assert float((a.float() - b.float()).abs().max()) <= 2e-2 * scale
