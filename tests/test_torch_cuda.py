"""The CUDA kernels against their plain versions on the card (the paged
kernel at each path's decode shape, at a tile's split edges and under
launch plans its planner does not pick), the engine
through the kernels against the engine through the plain versions, a
full-width Mamba2 layer with the SSD kernel against the plain scan, and
a full-width seamless-m4t-medium decoder layer through the flash, paged
(per-slot) and contiguous decode kernels against the plain versions, a
full-width zamba2-7b Mamba2 layer and shared-attention application (the
SSD kernel, flash at head dim 112, per-slot paged) against them, the
block-gather kernel against ``pool[idx]`` (bit-exact), the sampling
uniforms on the card against their numpy twin (bit-exact), and a sampled
fork engine on the card against the same engine on the CPU.
Marked ``cuda``: each test skips where there is no card.  On a machine
with one, run ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_cuda.py`` (the first test builds the kernels with nvcc).

Tolerances: f32 1e-4 (the kernels sum in another order than the plain
matmuls, over up to ~1k keys); bf16 2e-2 (the kernels round unnormalized
softmax weights to bf16, the plain versions normalized ones — the same
gap tests/test_kernels.py allows between the Pallas bodies and their
oracles).  bf16 attention is also held row by row, each output row's
largest error within 2e-2 of that row's largest magnitude: a near-uniform
softmax over ~1k keys gives outputs of ~1e-2, under the absolute 2e-2,
and a split that the combine drops or weighs wrongly moves a row by 4e-2
to 1 of its magnitude (one bf16 ulp is under 8e-3).  Cases with q scaled
up make the softmax peaked, so that the splits' maxima differ."""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import decode_attention_kernel
from repro_torch.kernels.decode_attention import plan_splits as decode_plan
from repro_torch.kernels.flash_attention import flash_attention_kernel
from repro_torch.kernels.flash_attention import plan_splits
from repro_torch.kernels import paged_attention as paged_module
from repro_torch.kernels.paged_attention import PagedPlan
from repro_torch.kernels.paged_attention import paged_attention_kernel
from repro_torch.kernels.paged_attention import plan_splits as paged_plan
from repro_torch.kernels.ssd_scan import ssd_chunk_scan_kernel

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
ROW_REL_TOL = 2e-2
PEAKED_Q = 10.0  # scores spread ~0.9 instead of ~0.09


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


def _close_rows(got, want, dtype):
    """Attention outputs: ``_close``, and for bf16 each row (the last axis)
    within ROW_REL_TOL of the row's largest magnitude."""
    _close(got, want, dtype)
    if dtype == torch.bfloat16:
        got, want = got.float(), want.float()
        rel = ((got - want).abs().amax(-1)
               / want.abs().amax(-1).clamp_min(1e-30)).max().item()
        assert rel <= ROW_REL_TOL, f"row-relative error {rel}"


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
    combines = paged_attention_kernel.combine_launches
    got = ops.paged_attention(q, kp, vp, table, lengths, n_kv=n_kv,
                              global_pages=True)
    torch.cuda.synchronize()
    assert paged_attention_kernel.launches == before + 1
    split = paged_plan(B, Hkv, n_kv, 128).splits > 1
    assert paged_attention_kernel.combine_launches == combines + split
    want = ref.paged_attention(q, kp, vp, table, lengths, n_kv=n_kv,
                               global_pages=True)
    _close_rows(got, want, dtype)


# the split edges of a 64-row tile (block - 1, block, block + 1; a page's
# end), an idle row, a fresh one, and the full n_kv sweep, at each path's
# decode shape
PAGED_SHAPES = {
    # qwen2's engine: G 7, global ids across slots, n_kv 8 of 9 columns
    "qwen2": dict(B=8, n_pool=16, mb=9, H=14, Hkv=2, D=64, n_kv=8,
                  global_pages=True,
                  lengths=[0, 1, 63, 64, 65, 129, 1024, 901]),
    # seamless's self-attention: G 1, per-slot ids, 3 pages a slot
    "seamless": dict(B=8, n_pool=3, mb=3, H=16, Hkv=16, D=64, n_kv=3,
                     global_pages=False,
                     lengths=[0, 1, 63, 64, 65, 129, 384, 160]),
    # zamba2's shared block: G 1, D 112 (compiled, 14 chunks on 16 lanes)
    "zamba2": dict(B=8, n_pool=10, mb=10, H=32, Hkv=32, D=112, n_kv=10,
                   global_pages=False,
                   lengths=[0, 1, 63, 64, 65, 129, 1280, 1056]),
    "d32": dict(B=6, n_pool=4, mb=5, H=8, Hkv=2, D=32, n_kv=4,
                global_pages=True, lengths=[0, 1, 31, 33, 65, 512]),
    "d128": dict(B=6, n_pool=4, mb=4, H=16, Hkv=16, D=128, n_kv=3,
                 global_pages=False, lengths=[0, 1, 63, 65, 129, 384]),
    # the run-time-D form: rows of whole 16-byte chunks (D 80), and rows
    # that are not (D 36 in bf16: element by element)
    "d80": dict(B=6, n_pool=4, mb=4, H=8, Hkv=8, D=80, n_kv=3,
                global_pages=True, lengths=[0, 1, 63, 65, 129, 384]),
    "d36": dict(B=6, n_pool=3, mb=3, H=4, Hkv=2, D=36, n_kv=3,
                global_pages=False, lengths=[0, 1, 127, 128, 129, 384]),
}


def _paged_split_case(card, dtype, shape, seed, q_scale=1.0):
    """The paged kernel against the plain version at one of PAGED_SHAPES:
    global ids drawn from every slot's pages, or per-slot ids, each row
    its own permutation of its pool.  Returns the plan it ran (the
    module's ``plan_splits``, which a test may replace)."""
    s = PAGED_SHAPES[shape]
    B, n_pool, mb, H, Hkv, D, n_kv = (s[k] for k in (
        "B", "n_pool", "mb", "H", "Hkv", "D", "n_kv"))
    g = torch.Generator(device=card).manual_seed(seed)
    q = torch.randn((B, H, D), generator=g,
                    device=card).to(dtype) * (0.3 * q_scale)
    kp = torch.randn((B, n_pool, 128, Hkv, D), generator=g,
                     device=card).to(dtype) * 0.3
    vp = torch.randn((B, n_pool, 128, Hkv, D), generator=g,
                     device=card).to(dtype) * 0.3
    rs = np.random.RandomState(seed)
    if s["global_pages"]:
        table = rs.randint(0, B * n_pool, (B, mb))
    else:
        table = np.stack([rs.permutation(n_pool)[:mb] for _ in range(B)])
    table = torch.tensor(table, dtype=torch.int32, device=card)
    lengths = torch.tensor(s["lengths"], dtype=torch.int32, device=card)
    plan = paged_module.plan_splits(B, Hkv, n_kv, 128)
    before = paged_attention_kernel.launches
    combines = paged_attention_kernel.combine_launches
    got = paged_attention_kernel(q, kp, vp, table, lengths, n_kv=n_kv,
                                 global_pages=s["global_pages"])
    torch.cuda.synchronize()
    assert paged_attention_kernel.launches == before + 1
    assert (paged_attention_kernel.combine_launches
            == combines + (plan.splits > 1))
    want = ref.paged_attention(q, kp, vp, table, lengths, n_kv=n_kv,
                               global_pages=s["global_pages"])
    _close_rows(got, want, dtype)
    return plan


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", list(PAGED_SHAPES))
@pytest.mark.parametrize("q_scale", [1.0, PEAKED_Q])
def test_paged_kernel_split_edges(card, dtype, shape, q_scale):
    """The planner's split at each path's decode shape, the split edges,
    and q scaled up so that the splits' maxima differ."""
    plan = _paged_split_case(card, dtype, shape, len(shape) + 7,
                             q_scale=q_scale)
    assert plan.splits > 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,plan", [
    ("qwen2", PagedPlan(128, 1, 8)),    # one split: no combine
    ("qwen2", PagedPlan(128, 8, 1)),    # a page a split
    ("qwen2", PagedPlan(32, 32, 1)),    # a quarter page a split
    ("qwen2", PagedPlan(64, 6, 3)),     # three half pages a split
    ("zamba2", PagedPlan(128, 1, 10)),
    ("zamba2", PagedPlan(128, 4, 3)),   # the last split one tile
    ("zamba2", PagedPlan(64, 20, 1)),
    ("seamless", PagedPlan(32, 12, 1)),
])
def test_paged_kernel_other_plans(card, monkeypatch, dtype, shape, plan):
    """Launch shapes the planner does not pick at these shapes: one split,
    several tiles a split (pages crossed inside a split), tiles of 32 and
    64 rows (a page cut in tiles)."""
    monkeypatch.setattr(paged_module, "plan_splits", lambda *_: plan)
    assert _paged_split_case(card, dtype, shape, 11,
                             q_scale=PEAKED_Q) == plan


def test_paged_kernel_refuses_a_plan_that_misses_tiles(card, monkeypatch):
    """A plan that covers fewer than n_kv pages, or tiles that do not
    divide the page, launches nothing and raises."""
    q = torch.zeros((2, 4, 64), dtype=torch.bfloat16, device=card)
    kp = torch.zeros((2, 3, 128, 2, 64), dtype=torch.bfloat16, device=card)
    table = torch.zeros((2, 3), dtype=torch.int32, device=card)
    lengths = torch.ones((2,), dtype=torch.int32, device=card)
    before = paged_attention_kernel.launches
    for plan in (PagedPlan(128, 2, 1), PagedPlan(96, 4, 1)):
        monkeypatch.setattr(paged_module, "plan_splits",
                            lambda *_, plan=plan: plan)
        with pytest.raises(RuntimeError, match="CUDA error"):
            paged_attention_kernel(q, kp, kp, table, lengths, n_kv=3)
    assert paged_attention_kernel.launches == before


def _flash_case(card, dtype, B, S_q, S_kv, H, Hkv, D, causal, q_offset,
                q_scale=1.0):
    """The kernel against the plain version; the bf16 kernel's plan
    (warpgroups, key tile, splits) is returned for the caller to check."""
    g = torch.Generator(device=card).manual_seed(B + S_q + S_kv + D)
    q = torch.randn((B, S_q, H, D), generator=g, device=card) * 0.3 * q_scale
    k = torch.randn((B, S_kv, Hkv, D), generator=g, device=card) * 0.3
    v = torch.randn((B, S_kv, Hkv, D), generator=g, device=card) * 0.3
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    before = flash_attention_kernel.launches
    combines = flash_attention_kernel.combine_launches
    got = ops.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    torch.cuda.synchronize()
    assert flash_attention_kernel.launches == before + 1
    plan = plan_splits(B, S_q, H, S_kv, q_offset=q_offset, causal=causal,
                       head_dim=D)
    split = dtype == torch.bfloat16 and plan.splits > 1
    assert flash_attention_kernel.combine_launches == combines + split
    want = ref.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    _close_rows(got, want, dtype)
    return plan


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,S_q,S_kv,H,Hkv,D,q_offset",
    [(1, 128, 1024, 14, 2, 64, 768), (1, 128, 128, 14, 2, 64, 0),
     (1, 100, 250, 4, 2, 32, 150), (1, 64, 384, 8, 8, 128, 256),
     # S_q 1 / 63 / 65 / 200 over S_kv 1 / 65 / 1000 / 1024, q_offset at
     # 0, in the middle and at S_kv - S_q, D 32 / 64 / 128, G 7 and 1
     (2, 1, 1, 14, 2, 64, 0), (2, 63, 65, 7, 1, 32, 2),
     (2, 65, 1000, 16, 16, 128, 935), (2, 200, 1000, 14, 2, 64, 400),
     (2, 128, 1024, 14, 2, 64, 0), (2, 200, 1024, 16, 16, 64, 0),
     (2, 65, 65, 7, 1, 128, 0), (2, 63, 1024, 16, 16, 32, 961),
     # no split (256 blocks of 64 rows), and 128-row tiles (two
     # warpgroups) over the causal diagonal
     (8, 128, 1024, 16, 16, 64, 896), (4, 1000, 1000, 16, 16, 64, 0)],
)
def test_flash_kernel_matches_plain(card, dtype, B, S_q, S_kv, H, Hkv, D,
                                    q_offset):
    _flash_case(card, dtype, B, S_q, S_kv, H, Hkv, D, True, q_offset)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,S_q,S_kv,H,Hkv,D,causal,q_offset,splits",
    [(1, 128, 1024, 14, 2, 64, True, 768, 5),
     (1, 128, 512, 14, 2, 64, True, 300, 4),
     (2, 128, 1024, 16, 16, 64, False, 0, 3),
     (2, 65, 1000, 14, 2, 128, False, 0, 3),
     (8, 128, 1024, 16, 16, 64, True, 896, 1),
     (2, 1024, 1024, 16, 16, 64, False, 0, 1)],
)
def test_flash_kernel_peaked_softmax_matches_plain(card, dtype, B, S_q, S_kv,
                                                   H, Hkv, D, causal,
                                                   q_offset, splits):
    """q scaled up: the splits' maxima differ, and a combine that drops a
    split or skips its 2^(m_s - M) weight shows in every row."""
    plan = _flash_case(card, dtype, B, S_q, S_kv, H, Hkv, D, causal,
                       q_offset, q_scale=PEAKED_Q)
    assert plan.splits == splits


# head dims outside the compiled 32 / 64 / 128: zamba2's 112, phi3's 96,
# 80, and 48 (laid out for 64 columns)
ANY_D = [112, 96, 80, 48]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", ANY_D)
@pytest.mark.parametrize(
    "B,S_q,S_kv,H,Hkv,causal,q_offset,splits",
    [(1, 128, 1024, 14, 2, True, 768, 5),     # a chunk at a q_offset
     (2, 200, 1000, 14, 2, True, 400, 2),
     (2, 63, 65, 7, 1, True, 2, 2),
     (2, 128, 1024, 16, 16, False, 0, 3),     # non-causal, split
     (2, 65, 1000, 14, 2, False, 0, 3),
     (8, 128, 1024, 16, 16, True, 896, 1),    # no split
     (8, 1024, 1024, 32, 32, True, 0, 1)],    # zamba2's prefill shape
)
def test_flash_kernel_any_head_dim_matches_plain(card, dtype, D, B, S_q,
                                                 S_kv, H, Hkv, causal,
                                                 q_offset, splits):
    """The run-time-D form (one consumer warpgroup, tiles laid out for 64
    or 128 columns and zero past D), split and unsplit."""
    plan = _flash_case(card, dtype, B, S_q, S_kv, H, Hkv, D, causal,
                       q_offset)
    assert plan.consumers == 1 and plan.splits == splits


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [112, 96, 80])
@pytest.mark.parametrize("B,S_q,S_kv,H,Hkv,causal,q_offset",
                         [(1, 128, 1024, 14, 2, True, 768),
                          (2, 128, 1024, 16, 16, False, 0),
                          (8, 1024, 1024, 32, 32, True, 0)])
def test_flash_kernel_any_head_dim_peaked_softmax(card, dtype, D, B, S_q,
                                                  S_kv, H, Hkv, causal,
                                                  q_offset):
    _flash_case(card, dtype, B, S_q, S_kv, H, Hkv, D, causal, q_offset,
                q_scale=PEAKED_Q)


@pytest.mark.parametrize("D", [100, 136, 4])
def test_flash_kernel_refuses_other_head_dims(card, D):
    """D % 8 != 0 (a TMA row must be whole 16-byte units) or D > 128: the
    wrapper raises, launching nothing."""
    q = torch.zeros((1, 64, 2, D), dtype=torch.bfloat16, device=card)
    before = flash_attention_kernel.launches
    with pytest.raises(ValueError, match="D % 8"):
        flash_attention_kernel(q, q, q, causal=True)
    assert flash_attention_kernel.launches == before


DECODE_LENGTHS = [0, 1, 127, 128, 1000, 1024, 4095, 4096]
# tile edges: block - 1, block, block + 1
SPLIT_LENGTHS = [0, 1, 127, 128, 129, 1024, 4095, 4096]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "H,Hkv,D,S_max,lengths",
    [(16, 16, 64, 4096, DECODE_LENGTHS), (14, 2, 64, 4096, DECODE_LENGTHS),
     (16, 16, 32, 4096, DECODE_LENGTHS), (16, 16, 128, 4096, DECODE_LENGTHS),
     (16, 16, 64, 4096, SPLIT_LENGTHS), (14, 2, 64, 4096, SPLIT_LENGTHS),
     # S_max 128: one split, no combine; B 1
     (14, 2, 64, 128, [0, 1, 127, 128]), (16, 16, 64, 128, [0, 1, 127, 128]),
     (14, 2, 64, 4096, [1024]), (16, 16, 128, 4096, [129]),
     # D 112 (zamba2's, compiled with 16 lanes a key for 14 chunks) and
     # D 80 (the run-time-D form)
     (16, 16, 112, 4096, SPLIT_LENGTHS), (14, 2, 80, 4096, DECODE_LENGTHS),
     (7, 1, 112, 128, [0, 1, 127, 128])],
)
def test_decode_kernel_matches_plain(card, dtype, H, Hkv, D, S_max, lengths):
    """The contiguous decode kernel at seamless's cross cache (B 8, S_max
    4096), lengths from 0 (uniform weights over all rows) to S_max, and
    the split edges."""
    _decode_case(card, dtype, H, Hkv, D, S_max, lengths, H + Hkv + D)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,Hkv,D", [(16, 16, 64), (14, 2, 64),
                                     (16, 16, 112)])
def test_decode_kernel_peaked_softmax_matches_plain(card, dtype, H, Hkv, D):
    """q scaled up over seamless's cross cache: the splits' maxima differ."""
    _decode_case(card, dtype, H, Hkv, D, 4096, SPLIT_LENGTHS, H + Hkv + D + 1,
                 q_scale=PEAKED_Q)


def _decode_case(card, dtype, H, Hkv, D, S_max, lengths, seed, q_scale=1.0):
    g = torch.Generator(device=card).manual_seed(seed)
    B = len(lengths)
    q = torch.randn((B, H, D), generator=g,
                    device=card).to(dtype) * (0.3 * q_scale)
    k = torch.randn((B, S_max, Hkv, D), generator=g,
                    device=card).to(dtype) * 0.3
    v = torch.randn((B, S_max, Hkv, D), generator=g,
                    device=card).to(dtype) * 0.3
    lengths = torch.tensor(lengths, dtype=torch.int32, device=card)
    before = decode_attention_kernel.launches
    combines = decode_attention_kernel.combine_launches
    got = ops.decode_attention(q, k, v, lengths)
    torch.cuda.synchronize()
    assert decode_attention_kernel.launches == before + 1
    split = decode_plan(B, Hkv, S_max).splits > 1
    assert decode_attention_kernel.combine_launches == combines + split
    _close_rows(got, ref.decode_attention(q, k, v, lengths), dtype)


def _misaligned(t):
    """A copy of ``t`` whose storage starts one element past a 16-byte
    boundary: contiguous, but its base takes no 16-byte load."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 16
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["decode", "paged"])
@pytest.mark.parametrize("H,Hkv,D", [(14, 2, 64), (16, 16, 112)])
def test_split_kernels_take_a_misaligned_cache(card, dtype, kernel, H, Hkv,
                                               D):
    """K and V views one element past a 16-byte boundary, at compiled D:
    the tiles load element by element and the outputs still match the
    plain version, the split edges included."""
    g = torch.Generator(device=card).manual_seed(D + H)
    lengths = torch.tensor(SPLIT_LENGTHS[:6], dtype=torch.int32, device=card)
    B = lengths.numel()
    shape = (B, 1024, Hkv, D) if kernel == "decode" else (B, 8, 128, Hkv, D)
    q = torch.randn((B, H, D), generator=g,
                    device=card).to(dtype) * (0.3 * PEAKED_Q)
    k = torch.randn(shape, generator=g, device=card).to(dtype) * 0.3
    v = torch.randn(shape, generator=g, device=card).to(dtype) * 0.3
    mk, mv = _misaligned(k), _misaligned(v)
    if kernel == "decode":
        before = decode_attention_kernel.launches
        got = ops.decode_attention(q, mk, mv, lengths)
        torch.cuda.synchronize()
        assert decode_attention_kernel.launches == before + 1
        want = ref.decode_attention(q, k, v, lengths)
    else:  # global ids drawn from every slot's pages
        table = torch.tensor(np.random.RandomState(D).randint(0, B * 8,
                                                              (B, 8)),
                             dtype=torch.int32, device=card)
        before = paged_attention_kernel.launches
        got = ops.paged_attention(q, mk, mv, table, lengths,
                                  global_pages=True)
        torch.cuda.synchronize()
        assert paged_attention_kernel.launches == before + 1
        want = ref.paged_attention(q, k, v, table, lengths,
                                   global_pages=True)
    _close_rows(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,n_pool,mb,H,Hkv,D,n_kv",
                         [(8, 16, 9, 14, 2, 64, 8), (8, 3, 3, 16, 16, 64, 3),
                          # zamba2's shared attention: G 1, D 112
                          (8, 10, 10, 32, 32, 112, 9)])
def test_per_slot_paged_kernel_matches_plain(card, dtype, B, n_pool, mb, H,
                                             Hkv, D, n_kv):
    """Per-slot page ids, each row its own permutation of its pool's
    pages: reading another slot's pool would show."""
    g = torch.Generator(device=card).manual_seed(B * H + D + n_pool)
    q = torch.randn((B, H, D), generator=g, device=card).to(dtype) * 0.3
    kp = torch.randn((B, n_pool, 128, Hkv, D), generator=g,
                     device=card).to(dtype) * 0.3
    vp = torch.randn((B, n_pool, 128, Hkv, D), generator=g,
                     device=card).to(dtype) * 0.3
    rs = np.random.RandomState(n_pool)
    table = torch.tensor(np.stack([rs.permutation(n_pool)[:mb]
                                   for _ in range(B)]), dtype=torch.int32,
                         device=card)
    lengths = torch.randint(1, n_kv * 128, (B,), generator=g, device=card,
                            dtype=torch.int32)
    lengths[-1] = 0
    before = paged_attention_kernel.launches
    combines = paged_attention_kernel.combine_launches
    got = ops.paged_attention(q, kp, vp, table, lengths, n_kv=n_kv)
    torch.cuda.synchronize()
    assert paged_attention_kernel.launches == before + 1
    split = paged_plan(B, Hkv, n_kv, 128).splits > 1
    assert paged_attention_kernel.combine_launches == combines + split
    _close_rows(got, ref.paged_attention(q, kp, vp, table, lengths,
                                         n_kv=n_kv), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "S_q,S_kv,H,Hkv,D",
    [(1024, 1024, 16, 16, 64), (128, 1024, 16, 16, 64),
     (20, 300, 16, 16, 64),
     # ragged S_q and S_kv, D 32 / 128, G 7, a split (B 2 x H 14 x 1 q
     # tile) and two warpgroups (B 2 x H 16 x 8 tiles of 128 rows)
     (1, 1, 16, 16, 64), (63, 65, 14, 2, 32), (65, 1000, 14, 2, 128),
     (200, 1024, 16, 16, 32), (1000, 1000, 16, 16, 128),
     (128, 65, 7, 1, 64)],
)
def test_noncausal_flash_kernel_matches_plain(card, dtype, S_q, S_kv, H, Hkv,
                                              D):
    """The encoder's self-attention, the decoder prefill's cross-
    attention, a query tile shorter than a warpgroup's 64 rows over a
    ragged key count, and the shapes above."""
    _flash_case(card, dtype, 2, S_q, S_kv, H, Hkv, D, False, 0)


def test_full_width_seamless_decoder_layer_kernels_match_plain(card):
    """One full-width seamless-m4t-medium decoder layer (bf16, seeded
    init), 2 sequences: the prefill's causal self-attention and cross-
    attention over 256 encoder frames (flash kernel), then one decode
    step's per-slot paged self-attention and cross-attention over the
    (2, 4096, 16, 64) cross cache (decode kernel), each against the plain
    version on the same input, within 2e-2 of the largest magnitude."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.models.param import init_params

    cfg = ARCHS["seamless-m4t-medium"].scaled(num_layers=1,
                                              encoder_layers=1)
    bf = torch.bfloat16
    lp = T._layer(init_params(T.build_specs(cfg)["dec_layers"], 0, card), 0)
    lp = {k: {n: t.to(bf) for n, t in v.items()} for k, v in lp.items()}
    g = torch.Generator(device=card).manual_seed(9)
    x = torch.randn((2, 128, cfg.d_model), generator=g, device=card).to(bf)
    enc_out = torch.randn((2, 256, cfg.d_model), generator=g,
                          device=card).to(bf)
    counts = (flash_attention_kernel.launches, paged_attention_kernel.launches,
              decode_attention_kernel.launches)
    outs = {}
    for impl in (None, "plain"):
        a, (sk, sv) = L.attention_full(lp["self_attn"], x, cfg, causal=True,
                                       impl=impl)
        xa, (ck, cv) = L.attention_full(lp["cross_attn"], x, cfg,
                                        causal=False, kv_x=enc_out, impl=impl)
        # the decode cache: the prompt on page 2 of each slot, the encoder
        # output in the first 256 rows of the cross cache
        pool = torch.zeros((2, 3, 128, 16, 64), dtype=bf, device=card)
        vpool = torch.zeros_like(pool)
        pool[:, 2], vpool[:, 2] = sk, sv
        cross_k = torch.zeros((2, 4096, 16, 64), dtype=bf, device=card)
        cross_v = torch.zeros_like(cross_k)
        cross_k[:, :256], cross_v[:, :256] = ck, cv
        table = torch.tensor([[2, 0, 1], [2, 1, 0]], dtype=torch.int32,
                             device=card)
        lengths = torch.full((2,), 128, dtype=torch.int32, device=card)
        x1 = x[:, -1:]
        d, _ = L.attention_decode(lp["self_attn"], x1, cfg,
                                  {"k_pool": pool, "v_pool": vpool}, lengths,
                                  block_table=table, impl=impl)
        dx, _ = L.attention_decode(
            lp["cross_attn"], x1, cfg,
            {"k": cross_k, "v": cross_v,
             "len": torch.full((2,), 256, dtype=torch.int32, device=card)},
            lengths, cross=True, impl=impl)
        outs[impl] = (a, xa, d, dx)
    torch.cuda.synchronize()
    assert (flash_attention_kernel.launches, paged_attention_kernel.launches,
            decode_attention_kernel.launches) == (counts[0] + 2,
                                                  counts[1] + 1,
                                                  counts[2] + 1)
    for got, want in zip(outs[None], outs["plain"]):
        assert got.dtype == want.dtype and got.shape == want.shape
        scale = float(want.float().abs().max())
        assert float((got.float() - want.float()).abs().max()) <= 2e-2 * scale


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
     (2, 512, 80, 64, 128, 128), (1, 96, 6, 32, 16, 128),
     (2, 256, 112, 64, 64, 128)],  # zamba2: 112 heads of 64, state 64
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


@pytest.mark.parametrize("case", ["groups", "init_state"])
def test_ssd_kernel_refuses_what_the_tpu_kernel_refuses(card, case):
    """The kernel keeps the TPU kernel's limits: one B/C group and a zero
    initial state (the plain version takes both)."""
    x, dt, a, b, c, d = _ssd_inputs(card, torch.float32, 1, 128, 4, 32, 16,
                                    1)
    init = None
    if case == "groups":
        b, c = b.repeat(1, 1, 2, 1), c.repeat(1, 1, 2, 1)
    else:
        init = torch.zeros((1, 4, 32, 16), device=card)
    before = ssd_chunk_scan_kernel.launches
    with pytest.raises(ValueError):
        ops.ssd_chunk_scan(x, dt, a, b, c, d_skip=d, init_state=init)
    assert ssd_chunk_scan_kernel.launches == before
    y, _ = ops.ssd_chunk_scan(x, dt, a, b, c, d_skip=d, init_state=init,
                              impl="plain")
    assert bool(torch.isfinite(y).all())


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("page", [(128, 2, 64), (128, 16, 64), (3, 1, 5)])
@pytest.mark.parametrize("M", [1, 24, 144])
def test_block_gather_kernel_matches_plain(card, dtype, page, M):
    """A copy, so bit-exact: repeated and unordered indices; qwen2's and
    seamless's pages and a 30-byte bf16 page (not a multiple of 16)."""
    from repro_torch.kernels.block_gather import block_gather_kernel

    g = torch.Generator(device=card).manual_seed(M)
    pool = torch.randn((200, *page), generator=g, device=card).to(dtype)
    idx = torch.randint(0, 200, (M,), generator=g, device=card,
                        dtype=torch.int32)
    before = block_gather_kernel.launches
    got = ops.block_gather(pool, idx)
    torch.cuda.synchronize()
    assert block_gather_kernel.launches == before + 1
    assert torch.equal(got, ref.block_gather(pool, idx))
    # host indices are range-checked and uploaded
    assert torch.equal(ops.block_gather(pool, idx.cpu()), got)
    with pytest.raises(IndexError):
        ops.block_gather(pool, torch.tensor([200], dtype=torch.int32))
    with pytest.raises(ValueError):
        ops.block_gather(pool[::2], idx)  # never gathers from a copy


def test_counter_uniform_on_card_matches_numpy(card):
    from repro_torch.serving.rng import counter_uniform, counter_uniform_np

    rs = np.random.RandomState(0)
    seeds = np.concatenate([[0, 0x7FFFFFFF, 1, 7],
                            rs.randint(0, 2**31 - 1, 9996)])
    pos = rs.randint(0, 1 << 20, 10_000)
    got = counter_uniform(torch.from_numpy(seeds).to(card),
                          torch.from_numpy(pos).to(card)).cpu().numpy()
    want = counter_uniform_np(seeds, pos)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def test_sampled_fork_engine_card_matches_cpu(card):
    """Smoke width, f32, the same weights: a sampled engine (temperature
    0.8, top_p 0.9) with a best-of-3 group whose secondaries copy their
    partial prompt page through the block-gather kernel emits the same
    tokens on the card as on the CPU.  The uniforms are bit-identical;
    the logits differ by the matmuls' summation order (~1e-6), which can
    flip a token only where u lies that close to a kcum boundary."""
    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.kernels.block_gather import block_gather_kernel
    from repro_torch.models import Model
    from repro_torch.serving import ServingEngine

    cfg = smoke_config(ARCHS["qwen2-0.5b"])
    params = Model(cfg, device="cpu").init_params(0)
    rs = np.random.RandomState(0)
    prompts = [list(rs.randint(1, 500, n)) for n in (40, 290)]
    fork = list(rs.randint(1, 500, 160))
    out = {}
    for dev in ("cpu", card):
        eng = ServingEngine(Model(cfg, device=dev), max_slots=4,
                            max_seq=512, params=_to(params, dev), device=dev,
                            temperature=0.8, top_p=0.9, sample_seed=7)
        before = block_gather_kernel.launches
        reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
        grp = eng.fork_submit(fork, 3, max_new_tokens=6)
        eng.run_until_done()
        eng.drain()
        st = eng.stats()
        assert st["cow_copies"] == 2 and st["pool_unreclaimed"] == 0
        launched = block_gather_kernel.launches - before
        assert launched == (2 * st["admission_dispatches"]
                            if dev != "cpu" else 0)
        out[str(dev)] = [r.generated for r in reqs + grp.branches]
    assert out["cpu"] == out[str(card)]


def test_full_width_zamba2_layers_kernels_match_plain(card):
    """One full-width zamba2-7b Mamba2 layer and one application of the
    shared attention block (bf16, seeded init, the attention projections
    conditioned as ``chip_smoke.conditioned`` does), 2 sequences of 256
    tokens: the Mamba2 block (SSD kernel: 112 heads of 64, state 64), the
    shared block's causal attention (flash, head dim 112) and one decode
    step over its per-slot pool (paged, G 1), each against the plain
    version on the same input, within 2e-2 of the largest magnitude, and
    the attention outputs also row by row."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import Model
    from repro_torch.models import layers as L
    from repro_torch.models import ssm as S
    from repro_torch.models import transformer as T

    cfg = ARCHS["zamba2-7b"].scaled(num_layers=1, attn_period=1)
    model = Model(cfg, device=card)
    params = model.init_params(0)
    M, H = cfg.d_model, cfg.num_heads
    attn = params["shared_attn"]["attn"]
    for name in ("wq", "wk", "wv"):
        attn[name] = attn[name] * (H / M) ** 0.5
    attn["wo"] = attn["wo"] / H ** 0.5
    params = model.compute_params(params)
    mp = T._layer(params["layers"], 0)["mamba"]
    shared = params["shared_attn"]
    g = torch.Generator(device=card).manual_seed(6)
    xin = torch.randn((2, 256, M), generator=g, device=card).to(
        torch.bfloat16)
    counts = (ssd_chunk_scan_kernel.launches, flash_attention_kernel.launches,
              paged_attention_kernel.launches)
    outs = {}
    for impl in (None, "plain"):
        m, mc = S.mamba_full(mp, xin, cfg, impl=impl)
        a, (k, v) = L.attention_full(shared["attn"], xin, cfg, causal=True,
                                     impl=impl)
        # the prompt on pages 3 and 1 of each slot's 4-page pool
        pools = {n: torch.zeros((2, 4, 128, 32, 112), dtype=torch.bfloat16,
                                device=card) for n in ("k_pool", "v_pool")}
        for n, kv in (("k_pool", k), ("v_pool", v)):
            pools[n][:, 3], pools[n][:, 1] = kv[:, :128], kv[:, 128:]
        table = torch.tensor([[3, 1, 2, 0], [3, 1, 0, 2]], dtype=torch.int32,
                             device=card)
        lengths = torch.full((2,), 256, dtype=torch.int32, device=card)
        d, _ = L.attention_decode(shared["attn"], xin[:, -1:], cfg, pools,
                                  lengths, block_table=table, impl=impl)
        outs[impl] = (m, mc["state"], a, d)
    torch.cuda.synchronize()
    assert (ssd_chunk_scan_kernel.launches, flash_attention_kernel.launches,
            paged_attention_kernel.launches) == (counts[0] + 1,
                                                 counts[1] + 1,
                                                 counts[2] + 1)
    for i, (got, want) in enumerate(zip(outs[None], outs["plain"])):
        assert got.dtype == want.dtype and got.shape == want.shape
        scale = float(want.float().abs().max())
        assert float((got.float() - want.float()).abs().max()) <= 2e-2 * scale
        if i >= 2:  # the attention outputs, row by row
            _close_rows(got, want, torch.bfloat16)
