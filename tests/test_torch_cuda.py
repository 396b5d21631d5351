"""The CUDA kernels against their plain versions on the card (the paged
kernel at each path's decode shape, at a tile's split edges and under
launch plans its planner does not pick), the engine
through the kernels against the engine through the plain versions, a
full-width Mamba2 layer with the SSD kernel against the plain scan (the
scan itself at both prefill shapes, B 1, chunks of 127 over two
sequences, steep decay and other head and state dims; its f32 route bit
for bit against the first version's digest), and
a full-width seamless-m4t-medium decoder layer through the flash, paged
(per-slot) and contiguous decode kernels against the plain versions, a
full-width zamba2-7b Mamba2 layer and shared-attention application (the
SSD kernel, flash at head dim 112, per-slot paged) against them, the flash
kernel with a sliding window (small windows that cut tiles mid-tile,
mixtral's 4096, a window past the keys bit for bit against none), a
full-width mixtral-8x7b layer's attention (windowed flash, one decode
step on a wrapped ring through the decode kernel) against the plain
path, the paged and flash kernels at the engine's shapes of
granite-3-8b, minitron-4b, phi3-mini-3.8b and granite-moe-3b-a800m, the
block-gather kernel against ``pool[idx]`` (bit-exact: a pool at an odd
base, a zero page for an id out of range, plans its planner does not
pick and plans it refuses), the sampling
uniforms on the card against their numpy twin (bit-exact), a sampled
fork engine on the card against the same engine on the CPU, and
granite-moe-3b-a800m's MoE block (top-8 of 40) bit-identical from run to
run on the card, its combine bit for bit the CPU's.
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
from repro_torch.kernels.block_gather import block_gather_kernel
from repro_torch.kernels.decode_attention import decode_attention_kernel
from repro_torch.kernels.decode_attention import plan_splits as decode_plan
from repro_torch.kernels import flash_attention as fa_module
from repro_torch.kernels.flash_attention import flash_attention_bwd_kernel
from repro_torch.kernels.flash_attention import flash_attention_kernel
from repro_torch.kernels.flash_attention import plan_splits
from repro_torch.kernels import paged_attention as paged_module
from repro_torch.kernels.paged_attention import PagedPlan
from repro_torch.kernels.paged_attention import paged_attention_kernel
from repro_torch.kernels.paged_attention import plan_splits as paged_plan
from repro_torch.kernels import ssd_scan as ssd_module
from repro_torch.kernels.ssd_scan import bf16_plan
from repro_torch.kernels.ssd_scan import ssd_chunk_scan_bwd_kernel
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
    # the engine's decode shapes of the dense and MoE families at
    # published width (8 slots, max_seq 1024, global ids, n_kv 8): G 4 /
    # D 128 (granite-3-8b), G 3 / D 128 (minitron-4b), G 1 / D 96
    # through the run-time-D form (phi3-mini-3.8b), G 3 / D 64
    # (granite-moe-3b-a800m); pools of 16 pages where 8 kv heads do not
    # divide the JAX package's 16-wide mesh, else 9
    "granite": dict(B=8, n_pool=16, mb=9, H=32, Hkv=8, D=128, n_kv=8,
                    global_pages=True,
                    lengths=[0, 1, 63, 64, 65, 129, 1024, 917]),
    "minitron": dict(B=8, n_pool=16, mb=9, H=24, Hkv=8, D=128, n_kv=8,
                     global_pages=True,
                     lengths=[0, 1, 63, 64, 65, 129, 1024, 917]),
    "phi3": dict(B=8, n_pool=9, mb=9, H=32, Hkv=32, D=96, n_kv=8,
                 global_pages=True,
                 lengths=[0, 1, 63, 64, 65, 129, 1024, 917]),
    "granite_moe": dict(B=8, n_pool=16, mb=9, H=24, Hkv=8, D=64, n_kv=8,
                        global_pages=True,
                        lengths=[0, 1, 63, 64, 65, 129, 1024, 917]),
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


# the families' chunk attention at published width: (H, Hkv, D) of
# granite-3-8b, minitron-4b, phi3-mini-3.8b (the run-time-D form) and
# granite-moe-3b-a800m
FAMILY_HEADS = {"granite": (32, 8, 128), "minitron": (24, 8, 128),
                "phi3": (32, 32, 96), "granite_moe": (24, 8, 64)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("family", list(FAMILY_HEADS))
@pytest.mark.parametrize("S_kv,q_offset,q_scale",
                         [(1024, 768, 1.0), (1024, 768, PEAKED_Q),
                          (128, 0, 1.0), (1024, 0, 1.0)])
def test_flash_kernel_family_chunks_match_plain(card, dtype, family, S_kv,
                                                q_offset, q_scale):
    """The engine's 128-token chunk at each family's heads: the last
    chunk of a 900-token prompt's sweep (split over the keys), also
    with a peaked softmax, the first chunk, and a first chunk over a
    1024-key sweep (the keys past the chunk masked).  phi3's D 96 runs
    the run-time-D form, whose key tiles are 64 wide."""
    H, Hkv, D = FAMILY_HEADS[family]
    plan = _flash_case(card, dtype, 1, 128, S_kv, H, Hkv, D, True,
                       q_offset, q_scale=q_scale)
    assert plan.keys == 64


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


def _window_case(card, dtype, B, S_q, S_kv, H, Hkv, D, causal, q_offset,
                 window):
    """The kernel with a sliding window against the plain version, on q
    scaled up (a peaked softmax) and V rows that mark their position in
    column 0, so that the weight of a window's edge key shows; the plan
    is returned."""
    g = torch.Generator(device=card).manual_seed(S_q + S_kv + D + window)
    q = torch.randn((B, S_q, H, D), generator=g, device=card) * 3.0
    k = torch.randn((B, S_kv, Hkv, D), generator=g, device=card)
    v = torch.randn((B, S_kv, Hkv, D), generator=g, device=card)
    v[..., 0] = (torch.arange(S_kv, device=card) / S_kv)[None, :, None]
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    before = flash_attention_kernel.launches
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              q_offset=q_offset)
    torch.cuda.synchronize()
    assert flash_attention_kernel.launches == before + 1
    want = ref.flash_attention(q, k, v, causal=causal, window=window,
                               q_offset=q_offset)
    _close_rows(got, want, dtype)
    return plan_splits(B, S_q, H, S_kv, q_offset=q_offset, causal=causal,
                       window=window, head_dim=D)


# (B, S_q, S_kv, H, Hkv, D, causal, q_offset, plan kind): plan kinds are
# "split" (64-key tiles across blocks), "one" (one warpgroup, unsplit)
# and "two" (two warpgroups over 128-key tiles)
WINDOW_SHAPES = [
    (1, 128, 512, 4, 2, 32, True, 384, "split"),     # a chunk, D 32
    (1, 128, 6144, 32, 8, 128, True, 6016, "split"),  # mixtral's last chunk
    (8, 1024, 1024, 32, 8, 128, True, 0, "two"),     # D 128, unsplit
    (1, 1024, 1024, 16, 16, 64, True, 0, "one"),
    (2, 200, 1000, 14, 2, 64, True, 800, "split"),   # ragged S_q, S_kv
    (2, 128, 1024, 16, 16, 64, False, 0, "split"),   # without causal mask
    (2, 96, 100, 4, 2, 64, True, 40, "split"),       # rows that see no key
    (4, 1024, 1024, 32, 8, 128, True, 100, "two"),   # the same, unsplit
    (1, 128, 1024, 14, 2, 112, True, 768, "split"),  # run-time D
    (2, 1024, 1024, 16, 16, 112, True, 0, "one"),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [1, 40, 63, 100, 129])
@pytest.mark.parametrize("B,S_q,S_kv,H,Hkv,D,causal,q_offset,kind",
                         WINDOW_SHAPES)
def test_flash_kernel_window_matches_plain(card, dtype, window, B, S_q, S_kv,
                                           H, Hkv, D, causal, q_offset,
                                           kind):
    """Windows that cut key tiles mid-tile (1, 63, 100, 129 keys; 40 moves
    the second warpgroup's first tile one past the first's), in every
    form: f32, bf16 compiled (D 32/64/128) and run-time D (112), split and
    unsplit, one and two warpgroups, with and without the causal mask,
    and rows past S_kv + window - 1, which see no key and average every
    key, as the Pallas body's do."""
    plan = _window_case(card, dtype, B, S_q, S_kv, H, Hkv, D, causal,
                        q_offset, window)
    got = {(1, False): "one", (2, False): "two"}.get(
        (plan.consumers, plan.splits > 1), "split")
    assert got == kind


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S_q,S_kv,H,Hkv,D,causal,q_offset,kind",
                         WINDOW_SHAPES[1:3])
def test_flash_kernel_mixtral_window_matches_plain(card, dtype, B, S_q, S_kv,
                                                   H, Hkv, D, causal,
                                                   q_offset, kind):
    """mixtral's window (4096) at its chunk shape and at 1024 tokens (the
    window does not cut: every row sees all its keys)."""
    _window_case(card, dtype, B, S_q, S_kv, H, Hkv, D, causal, q_offset,
                 4096)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S_q,S_kv,H,Hkv,D,causal,q_offset",
                         [(1, 128, 1024, 14, 2, 64, True, 768),
                          (8, 1024, 1024, 32, 8, 128, True, 0),
                          (2, 1024, 1024, 16, 16, 112, True, 0),
                          (2, 128, 1024, 16, 16, 64, False, 0)])
def test_flash_window_past_the_keys_is_bit_identical(card, dtype, B, S_q,
                                                     S_kv, H, Hkv, D, causal,
                                                     q_offset):
    """A window of S_kv or more keys cuts nothing: the output equals the
    window-0 call bit for bit (the same plan, tiles and mask paths)."""
    g = torch.Generator(device=card).manual_seed(S_q + D)
    q, k, v = (torch.randn((B, n, h, D), generator=g, device=card).to(dtype)
               for n, h in ((S_q, H), (S_kv, Hkv), (S_kv, Hkv)))
    want = flash_attention_kernel(q, k, v, causal=causal, q_offset=q_offset)
    for window in (S_kv, S_kv + 1000):
        got = flash_attention_kernel(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset)
        assert torch.equal(got, want)


def test_flash_kernel_refuses_a_negative_window(card):
    q = torch.zeros((1, 64, 2, 64), dtype=torch.bfloat16, device=card)
    before = flash_attention_kernel.launches
    with pytest.raises(ValueError, match="window"):
        flash_attention_kernel(q, q, q, causal=True, window=-1)
    assert flash_attention_kernel.launches == before


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


def _ssd_inputs(card, dtype, B, S, H, P, N, seed, steep=False):
    """Scan operands as mamba_full makes them; steep: dt ~ 3 and |a| ~ 7,
    so cum falls by ~20 a row and e^{cum_i - cum_j} above the diagonal
    overflows to inf (the kernel must select, not multiply by a mask)."""
    shift, a_shift = (3.0, 2.0) if steep else (-1.0, 0.0)
    g = torch.Generator(device=card).manual_seed(seed)
    x = (torch.randn((B, S, H, P), generator=g, device=card) * 0.3)
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=g, device=card) + shift)
    a = -torch.exp(torch.randn((H,), generator=g, device=card) * 0.3
                   + a_shift)
    b = torch.randn((B, S, 1, N), generator=g, device=card) * 0.3
    c = torch.randn((B, S, 1, N), generator=g, device=card) * 0.3
    d = torch.randn((H,), generator=g, device=card)
    return x.to(dtype), dt, a, b.to(dtype), c.to(dtype), d


def _hold_ssd(got_y, got_s, want_y, want_s, dtype):
    """y within the dtype's tolerance of its largest magnitude; the final
    state, f32 on both routes, within the f32 tolerance of its largest
    magnitude (the bf16 kernel carries it in f32 and takes xu as two bf16
    operands, so it keeps ~16 bits)."""
    for got, want, tol in (
            (got_y, want_y, TOL[dtype]["atol"]),
            (got_s, want_s, TOL[torch.float32]["atol"])):
        assert got.shape == want.shape
        scale = float(want.float().abs().max())
        err = float((got.float() - want.float()).abs().max())
        assert err <= tol * scale, (err, scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,S,H,P,N,chunk,steep",
    [(1, 128, 4, 32, 16, 64, False), (2, 256, 8, 64, 32, 128, False),
     (1, 256, 16, 32, 64, 64, False), (2, 127, 80, 64, 128, 127, False),
     (2, 512, 80, 64, 128, 128, False), (1, 96, 6, 32, 16, 128, False),
     (2, 256, 112, 64, 64, 128, False),  # zamba2: 112 heads, state 64
     # the two prefill paths at full width: mamba2 and zamba2
     (8, 1024, 80, 64, 128, 128, False), (8, 1024, 112, 64, 64, 128, False),
     # B 1 (few blocks)
     (1, 1024, 112, 64, 64, 128, False), (1, 1024, 80, 64, 128, 128, False),
     # chunk 127 over two sequences: a tile that read the next sequence's
     # rows would show
     (2, 254, 112, 64, 64, 127, False), (2, 254, 80, 64, 128, 127, False),
     # steep decay: inf above the diagonal must not become NaN
     (2, 256, 80, 64, 128, 128, True), (2, 256, 112, 64, 64, 128, True)],
)
def test_ssd_kernel_matches_plain(card, dtype, B, S, H, P, N, chunk, steep):
    """y held to the tolerance of the dtype times its largest magnitude,
    the final state (a sum of up to 128 rows a chunk) to the f32
    tolerance times its own."""
    x, dt, a, b, c, d = _ssd_inputs(card, dtype, B, S, H, P, N,
                                    B * S + H + N, steep)
    before = ssd_chunk_scan_kernel.launches
    got_y, got_s = ops.ssd_chunk_scan(x, dt, a, b, c, chunk=chunk, d_skip=d)
    torch.cuda.synchronize()
    assert ssd_chunk_scan_kernel.launches == before + 1
    want_y, want_s = ref.ssd_chunk_scan(x, dt, a, b, c, chunk=min(chunk, S),
                                        d_skip=d)
    assert got_y.dtype == dtype and got_s.dtype == torch.float32
    _hold_ssd(got_y, got_s, want_y, want_s, dtype)


@pytest.mark.parametrize("P,N", [(48, 96), (16, 24), (64, 80), (8, 8)])
def test_ssd_bf16_kernel_at_other_head_and_state_dims(card, P, N):
    """The bf16 kernel lays its tiles out for 64 columns of x and 64 or 128
    of B and C, zero past P and N, so it takes any P % 8 == 0 up to 64 and
    N % 8 == 0 up to 128 (chunks of 127 over two sequences here); the f32
    body takes only its compiled forms and refuses these."""
    x, dt, a, b, c, d = _ssd_inputs(card, torch.bfloat16, 2, 254, 6, P, N,
                                    P + N)
    got_y, got_s = ops.ssd_chunk_scan(x, dt, a, b, c, chunk=127, d_skip=d)
    want_y, want_s = ref.ssd_chunk_scan(x, dt, a, b, c, chunk=127, d_skip=d)
    torch.cuda.synchronize()
    _hold_ssd(got_y, got_s, want_y, want_s, torch.bfloat16)
    before = ssd_chunk_scan_kernel.launches
    with pytest.raises(ValueError):
        ops.ssd_chunk_scan(x.float(), dt, a, b.float(), c.float(), chunk=127,
                           d_skip=d)
    assert ssd_chunk_scan_kernel.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_on_operands_off_a_16_byte_boundary(card, dtype):
    """x, B and C as contiguous views one element into their storage: the
    wrapper copies them to 16-byte aligned storage for the tensor maps."""
    x, dt, a, b, c, d = _ssd_inputs(card, dtype, 2, 256, 8, 64, 32, 9)
    views = []
    for t in (x, b, c):
        flat = torch.empty(t.numel() + 1, dtype=dtype, device=card)
        view = flat[1:].view(t.shape)
        view.copy_(t)
        assert view.is_contiguous() and view.data_ptr() % 16 != 0
        views.append(view)
    got_y, got_s = ops.ssd_chunk_scan(views[0], dt, a, views[1], views[2],
                                      d_skip=d)
    want_y, want_s = ref.ssd_chunk_scan(x, dt, a, b, c, d_skip=d)
    torch.cuda.synchronize()
    _hold_ssd(got_y, got_s, want_y, want_s, dtype)


def _ssd_numpy_inputs(B, S, H, P, N, seed):
    rs = np.random.RandomState(seed)
    x = rs.standard_normal((B, S, H, P)).astype(np.float32) * 0.3
    dt = np.log1p(np.exp(rs.standard_normal((B, S, H)) - 1.0)).astype(
        np.float32)
    a = -np.exp(rs.standard_normal(H) * 0.3).astype(np.float32)
    b = rs.standard_normal((B, S, 1, N)).astype(np.float32) * 0.3
    c = rs.standard_normal((B, S, 1, N)).astype(np.float32) * 0.3
    d = rs.standard_normal(H).astype(np.float32)
    return x, dt, a, b, c, d


# sha256 (first 16 hex digits) of the f32 route's y and final state on
# these seeded inputs, from the first version of csrc/ssd_scan.cu (the
# CUDA-core body the f32 route still runs) on an H100
_F32_DIGESTS = {
    (2, 256, 8, 64, 32, 128, 11): ("f993fa7771c6de16", "97bbb0fe8c29e334"),
    (2, 127, 80, 64, 128, 127, 12): ("0a1cc3a5aa21a473", "ce6e499c65c1c5e2"),
}


@pytest.mark.parametrize("case", sorted(_F32_DIGESTS))
def test_ssd_f32_route_is_bit_identical_to_the_first_version(card, case):
    """The bf16 route was redesigned; the f32 route (which the f32
    end-to-end checks run) must give the same bits as before."""
    import hashlib

    B, S, H, P, N, chunk, seed = case
    x, dt, a, b, c, d = (torch.from_numpy(v).to(card) for v in
                         _ssd_numpy_inputs(B, S, H, P, N, seed))
    y, state = ssd_chunk_scan_kernel(x, dt, a, b, c, chunk=chunk, d_skip=d)
    torch.cuda.synchronize()
    got = tuple(hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]
                for t in (y, state))
    assert got == _F32_DIGESTS[case]


@pytest.mark.parametrize("B,H,N", [(8, 80, 128), (8, 112, 64), (1, 6, 16)])
def test_ssd_bf16_plan_is_read_from_the_built_kernel(card, B, H, N):
    """The launch plan the library reports: a block a (head, sequence),
    threads within what the compiled kernel takes, registers and shared
    memory from the build; a shape the bf16 kernel refuses raises."""
    plan = bf16_plan(B, H, 64, N, card.index or 0)
    assert plan["blocks"] == B * H
    assert 0 < plan["threads"] <= plan["max_threads"]
    assert plan["stages"] >= 2
    assert 0 < plan["registers"] <= 255
    assert 0 < plan["smem_bytes"] <= 232448
    assert plan["local_bytes"] >= 0
    with pytest.raises(RuntimeError):
        bf16_plan(B, H, 64, N + 4, card.index or 0)


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


def _handoff_index(n, L=24, B=4, N=16, slot=1, seed=0):
    """The host-built index ``DeviceState.read_pages`` hands the gather
    for ``n`` of one slot's pages in an (L * B * N)-page replica pool:
    layer-major, padded to a power of two with the slot's page 0."""
    rs = np.random.RandomState(seed + n)
    pages = rs.choice(np.arange(1, N), n, replace=False)
    nb = 1 << (n - 1).bit_length()
    pages = np.concatenate([pages, np.zeros(nb - n, np.int64)])
    idx = np.arange(L)[:, None] * (B * N) + slot * N + pages[None, :]
    return torch.from_numpy(idx.reshape(-1).astype(np.int32))


def _gather_want(pool, idx):
    """``pool[idx]`` with a zero page where ``idx`` is out of range."""
    n = pool.shape[0]
    bad = (idx < 0) | (idx >= n)
    want = ref.block_gather(pool, idx.clamp(0, n - 1))
    want[bad] = 0
    return want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["unaligned", "bad_index",
                                  "bad_index_unaligned", "m0",
                                  "handoff_m192"])
def test_block_gather_kernel_cases(card, dtype, case):
    """Beside ``test_block_gather_kernel_matches_plain``, each bit-exact: a
    pool viewed one element past a 16-byte boundary (narrow words),
    a device index with ids out of range (a zero page, on 16-byte and on
    narrower words), M 0 (no launch) and the M 192 index of a handoff
    read of 8 pages over a replica's 1,536-page pool."""
    from repro_torch.kernels.block_gather import block_gather_kernel

    g = torch.Generator(device=card).manual_seed(3)
    n_pool = 1536 if case == "handoff_m192" else 200
    pool = torch.randn((n_pool, 128, 2, 64), generator=g,
                       device=card).to(dtype)
    if "unaligned" in case:
        pool = _misaligned(pool)
    m = {"m0": 0, "handoff_m192": 192}.get(case, 24)
    idx = torch.randint(0, n_pool, (m,), generator=g, device=card,
                        dtype=torch.int32)
    if case == "handoff_m192":
        idx = _handoff_index(8)
    if "bad_index" in case:
        idx[[0, 5, 23]] = torch.tensor([-1, n_pool, 2**31 - 1],
                                       dtype=torch.int32, device=card)
    before = block_gather_kernel.launches
    got = ops.block_gather(pool, idx)
    torch.cuda.synchronize()
    assert got.shape == (m, *pool.shape[1:]) and got.dtype == dtype
    assert block_gather_kernel.launches == before + (m > 0)
    assert torch.equal(got, _gather_want(pool, idx.to(card)))
    if m:
        from repro_torch.kernels.block_gather import plan_gather

        plan = plan_gather(pool[0].numel() * pool.element_size(), m,
                           pool.data_ptr(), got.data_ptr())
        assert (plan.word_bytes < 16) == ("unaligned" in case)


# (piece KB, word bytes): 4, 2 and 1 words a thread, narrower words than
# the page allows, a piece that does not divide the page
_OTHER_PLANS = [(16, 16), (8, 16), (4, 16), (8, 8), (2, 2), (12, 16)]


@pytest.mark.parametrize("page", [(128, 2, 64), (128, 16, 64)])
@pytest.mark.parametrize("spec", _OTHER_PLANS,
                         ids=[f"{p}K-w{w}" for p, w in _OTHER_PLANS])
def test_block_gather_kernel_under_other_plans(card, monkeypatch, page,
                                               spec):
    """Plans the planner does not pick, bit-exact, with a zero page for
    an id out of range."""
    from repro_torch.kernels import block_gather as bg

    g = torch.Generator(device=card).manual_seed(spec[0])
    pool = torch.randn((64, *page), generator=g,
                       device=card).to(torch.bfloat16)
    idx = torch.randint(0, 64, (37,), generator=g, device=card,
                        dtype=torch.int32)
    idx[11] = 64
    page_bytes = pool[0].numel() * 2
    piece = min(spec[0] << 10, page_bytes)
    plan = bg.GatherPlan(piece, -(-page_bytes // piece), spec[1])
    monkeypatch.setattr(bg, "plan_gather", lambda *_: plan)
    before = bg.block_gather_kernel.launches
    got = bg.block_gather_kernel(pool, idx)
    torch.cuda.synchronize()
    assert bg.block_gather_kernel.launches == before + 1
    assert torch.equal(got, _gather_want(pool, idx))


@pytest.mark.parametrize("fault", ["word_on_odd_base", "piece_too_big",
                                   "pieces_wrong", "word_not_power_of_two",
                                   "piece_not_in_words"])
def test_block_gather_kernel_refuses_a_plan(card, monkeypatch, fault):
    """A plan the kernel cannot run raises and launches nothing."""
    from repro_torch.kernels import block_gather as bg

    pool = torch.zeros((8, 128, 2, 64), dtype=torch.bfloat16, device=card)
    if fault == "word_on_odd_base":
        pool = _misaligned(pool)
    idx = torch.arange(8, dtype=torch.int32, device=card)
    plan = {"word_on_odd_base": bg.GatherPlan(16384, 2, 16),
            "piece_too_big": bg.GatherPlan(16384, 2, 8),
            "pieces_wrong": bg.GatherPlan(8192, 3, 16),
            "word_not_power_of_two": bg.GatherPlan(6144, 6, 6),
            "piece_not_in_words": bg.GatherPlan(8200, 4, 16)}[fault]
    monkeypatch.setattr(bg, "plan_gather", lambda *_: plan)
    before = bg.block_gather_kernel.launches
    with pytest.raises(RuntimeError):
        bg.block_gather_kernel(pool, idx)
    assert bg.block_gather_kernel.launches == before


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


def test_full_width_mixtral_layer_kernels_match_plain(card):
    """One mixtral-8x7b layer's attention at full width (d_model 4096,
    32/8 heads of 128, window 4096), bf16, on 2 x 4608 tokens (the window
    cuts the last 512 rows): the windowed flash prefill, then one decode
    step on the ring loaded from the prefill's last 4096 positions
    (wrapped: position p in slot p % 4096) through the decode kernel,
    each against the plain path on the same input, within 2e-2 of the
    largest magnitude and row by row."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import Model
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    cfg = ARCHS["mixtral-8x7b"].scaled(num_layers=1)
    model = Model(cfg, device=card)
    params = model.init_params(0)
    M, H, Hkv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    attn = params["layers"]["attn"]
    attn["wq"] = attn["wq"] * (H / M) ** 0.5
    for name in ("wk", "wv"):
        attn[name] = attn[name] * (Hkv / M) ** 0.5
    attn["wo"] = attn["wo"] / H ** 0.5
    params = model.compute_params(params)
    lp = T._layer(params["layers"], 0)
    S, W = 4608, cfg.sliding_window
    g = torch.Generator(device=card).manual_seed(8)
    xin = torch.randn((2, S, M), generator=g, device=card).to(torch.bfloat16)
    counts = (flash_attention_kernel.launches,
              decode_attention_kernel.launches)
    outs = {}
    for impl in (None, "plain"):
        a, (k, v) = L.attention_full(lp["attn"], xin, cfg, causal=True,
                                     impl=impl)
        ring = {n: torch.zeros((2, W, Hkv, 128), dtype=torch.bfloat16,
                               device=card) for n in ("k", "v")}
        pos = torch.arange(S - W, S, device=card)
        ring["k"][:, pos % W], ring["v"][:, pos % W] = k[:, S - W:], v[:,
                                                                     S - W:]
        lengths = torch.full((2,), S, dtype=torch.int32, device=card)
        d, _ = L.attention_decode(lp["attn"], xin[:, -1:], cfg, ring,
                                  lengths, impl=impl)
        outs[impl] = (a, d)
    torch.cuda.synchronize()
    assert (flash_attention_kernel.launches,
            decode_attention_kernel.launches) == (counts[0] + 1,
                                                  counts[1] + 1)
    for got, want in zip(outs[None], outs["plain"]):
        assert got.dtype == want.dtype and got.shape == want.shape
        scale = float(want.float().abs().max())
        assert float((got.float() - want.float()).abs().max()) <= 2e-2 * scale
        _close_rows(got, want, torch.bfloat16)


def _granite_moe_layer(card):
    """granite-moe-3b-a800m's MoE block at full width (d_model 1536, 40
    experts of d_ff 512, top-8, capacity 1.25), seeded weights scaled to
    unit variance over their contraction, in bf16 on ``card``, and one
    128-token chunk's input."""
    from repro_torch.configs import ARCHS

    cfg = ARCHS["granite-moe-3b-a800m"]
    M, E, Fd = cfg.d_model, cfg.num_experts, cfg.d_ff
    g = torch.Generator().manual_seed(9)
    p = {"router": torch.randn((M, E), generator=g) / M ** 0.5,
         "wi_gate": torch.randn((E, M, Fd), generator=g) / M ** 0.5,
         "wi_up": torch.randn((E, M, Fd), generator=g) / M ** 0.5,
         "wo": torch.randn((E, Fd, M), generator=g) / Fd ** 0.5}
    x = torch.randn((1, 128, M), generator=g)
    return (cfg, {k: v.to(card, torch.bfloat16) for k, v in p.items()},
            x.to(card, torch.bfloat16))


def test_apply_moe_top8_is_bit_identical_on_card(card):
    """granite-moe's MoE block on one chunk, bf16, 8 times on the card:
    every output bit for bit the first's.  Each token sums its 8 expert
    outputs in a fixed order (``combine_pairs``); an atomic scatter-add
    (``index_add_``) sums them in whatever order the card's threads land
    and rounds each add to bf16, so its outputs differ between runs."""
    from repro_torch.models import layers as L

    cfg, p, x = _granite_moe_layer(card)
    outs = [L.apply_moe(p, x, cfg) for _ in range(8)]
    torch.cuda.synchronize()
    assert outs[0].dtype == torch.bfloat16
    assert bool(torch.isfinite(outs[0].float()).all())
    for out in outs[1:]:
        assert torch.equal(out.view(torch.int16), outs[0].view(torch.int16))


def test_moe_combine_on_card_matches_cpu(card):
    """``combine_pairs`` on the card, bf16, at granite-moe's chunk (128
    tokens, top-8 of 40, d_model 1536) on pair outputs spanning 2^-8 ..
    2^8: bit for bit the CPU's on the same inputs (which is the JAX
    scatter-add's order, tests/test_torch_moe.py), on each of 4 runs."""
    from repro_torch.models import layers as L

    rs = np.random.RandomState(4)
    S, k, E, M = 128, 8, 40, 1536
    ids = torch.from_numpy(np.stack([[rs.permutation(E)[:k]
                                      for _ in range(S)]]))
    order = torch.argsort(ids.reshape(1, S * k), dim=-1, stable=True)
    contrib = torch.from_numpy(rs.standard_normal((1, S * k, M)) * np.exp2(
        rs.randint(-8, 9, (1, S * k, 1)))).to(torch.bfloat16)
    want = L.combine_pairs(contrib, ids, order)
    for _ in range(4):
        got = L.combine_pairs(contrib.to(card), ids.to(card), order.to(card))
        assert torch.equal(got.cpu().view(torch.int16),
                           want.view(torch.int16))


# ---------------------------------------------------------------------------
# flash attention under autograd: the backward kernel
# ---------------------------------------------------------------------------
#: (B, S_q, S_kv, H, Hkv, D, causal, window): qwen2's heads causal; D 112
#: with a window that cuts key tiles mid-tile; D 128 at G 4; a non-causal
#: window whose last rows see no key (they average every key); S not a
#: multiple of 128 at D 64; G 1 at D 112; examples/train_lm_torch.py's
#: batch, 12 heads on 2 (G 6)
_BWD_SHAPES = [
    (2, 640, 640, 14, 2, 64, True, 0),
    (1, 300, 300, 8, 2, 112, True, 100),
    (1, 256, 256, 16, 4, 128, True, 0),
    (1, 400, 300, 6, 3, 96, False, 40),
    (2, 333, 333, 14, 2, 64, True, 0),
    (1, 200, 200, 4, 4, 112, True, 0),
    (8, 128, 128, 12, 2, 64, True, 0),
]
#: each gradient's largest error over its largest magnitude: f32 sums in
#: another order than the plain autograd; bf16 rounds the gradients
#: (one ulp is 2**-8 of a value) and the plain forward rounds its softmax
#: weights to bf16 before P.V, which its autograd differentiates through
_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _bwd_inputs(card, dtype, B, S_q, S_kv, H, Hkv, D, seed=0):
    g = torch.Generator(device=card).manual_seed(seed)
    q, k, v, do = (torch.randn(shape, generator=g, device=card).to(dtype)
                   for shape in ((B, S_q, H, D), (B, S_kv, Hkv, D),
                                 (B, S_kv, Hkv, D), (B, S_q, H, D)))
    return q, k, v, do


def _grads(fn, q, k, v, do):
    q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))
    out = fn(q, k, v)
    return (out,) + torch.autograd.grad(out, (q, k, v), do)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", _BWD_SHAPES, ids=lambda s: "x".join(
    str(int(x)) for x in s))
def test_flash_bwd_kernel_matches_plain_autograd(card, dtype, shape):
    B, S_q, S_kv, H, Hkv, D, causal, window = shape
    q, k, v, do = _bwd_inputs(card, dtype, B, S_q, S_kv, H, Hkv, D)
    kw = dict(causal=causal, window=window)
    got = _grads(lambda *a: ops.flash_attention(*a, **kw), q, k, v, do)
    want = _grads(lambda *a: ops.flash_attention(*a, impl="plain", **kw),
                  q, k, v, do)
    assert got[0].grad_fn is not None
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        a, b = a.detach(), b.detach()
        err = float((a.float() - b.float()).abs().max()
                    / b.float().abs().max())
        assert err <= _BWD_TOL[dtype], (name, err)


def test_flash_bwd_kernel_is_deterministic(card):
    B, S_q, S_kv, H, Hkv, D, causal, window = _BWD_SHAPES[0]
    q, k, v, do = _bwd_inputs(card, torch.bfloat16, B, S_q, S_kv, H, Hkv, D)
    out, stats = flash_attention_kernel(q, k, v, causal=causal,
                                        with_stats=True)
    runs = [flash_attention_bwd_kernel(q, k, v, out, do, stats,
                                       causal=causal) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_kernel_times_its_kernels(card, dtype):
    """With ``timing`` the call reports the kernels it launched, three,
    each with a positive device time, and its gradients are those of a
    call without it."""
    B, S_q, S_kv, H, Hkv, D, causal, window = _BWD_SHAPES[0]
    q, k, v, do = _bwd_inputs(card, dtype, B, S_q, S_kv, H, Hkv, D)
    out, stats = flash_attention_kernel(q, k, v, causal=causal,
                                        with_stats=True)
    times = torch.zeros(fa_module.BWD_KERNELS + 1)
    got = flash_attention_bwd_kernel(q, k, v, out, do, stats, causal=causal,
                                     timing=times)
    want = flash_attention_bwd_kernel(q, k, v, out, do, stats, causal=causal)
    assert times[0].item() == 3 and bool((times[1:] > 0).all())
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_flash_bwd_kernel_refuses_a_plan_of_other_rows(card, monkeypatch):
    """The dK/dV kernel reads the plan's query tiles in its own rows a
    stage (64 at D 64): a plan cut for 32 is refused, not run."""
    B, S_q, S_kv, H, Hkv, D, causal, window = 1, 256, 256, 4, 2, 64, True, 0
    q, k, v, do = _bwd_inputs(card, torch.bfloat16, B, S_q, S_kv, H, Hkv, D)
    out, stats = flash_attention_kernel(q, k, v, causal=causal,
                                        with_stats=True)
    real = fa_module._plan_tensor
    monkeypatch.setattr(fa_module, "_plan_tensor",
                        lambda *a: real(*a)[:2] + (32,))
    with pytest.raises(RuntimeError, match="CUDA error"):
        flash_attention_bwd_kernel(q, k, v, out, do, stats, causal=causal)


#: forward shapes for the row statistics: (B, S_q, S_kv, H, Hkv, D, causal,
#: window) — unsplit (280 blocks of 64 rows), split (32 query blocks), a
#: split non-causal window whose last rows see no key, and the run-time-D
#: form at D 112
_STATS_SHAPES = [
    (2, 640, 640, 14, 2, 64, True, 0),
    (1, 256, 256, 16, 4, 128, True, 0),
    (1, 400, 300, 6, 3, 96, False, 40),
    (1, 300, 300, 8, 2, 112, True, 100),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", _STATS_SHAPES, ids=lambda s: "x".join(
    str(int(x)) for x in s))
def test_flash_forward_stats_match_plain(card, dtype, shape):
    """The kernel's (m, l) against the plain forward's: m within 1e-4
    (the scores' products summed in another order), exactly NEG_INF in a
    row that sees no key, l within 1e-4 of itself (ex2.approx against
    exp); split and unsplit plans both."""
    B, S_q, S_kv, H, Hkv, D, causal, window = shape
    if dtype == torch.bfloat16:
        splits = plan_splits(B, S_q, H, S_kv, causal=causal, window=window,
                             head_dim=D).splits
        assert (splits > 1) == (shape != _STATS_SHAPES[0])
    q, k, v, _ = _bwd_inputs(card, dtype, B, S_q, S_kv, H, Hkv, D)
    kw = dict(causal=causal, window=window)
    _, got = flash_attention_kernel(q, k, v, with_stats=True, **kw)
    _, want = ref.flash_attention(q, k, v, with_stats=True, **kw)
    empty = want[..., 0] == ref.NEG_INF
    assert bool(empty.any()) == (window == 40)
    assert torch.equal(got[..., 0][empty], want[..., 0][empty])
    m_err = (got[..., 0] - want[..., 0])[~empty].abs().max()
    l_err = ((got[..., 1] - want[..., 1]) / want[..., 1]).abs().max()
    assert float(m_err) <= 1e-4 and float(l_err) <= 1e-4, (m_err, l_err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", _STATS_SHAPES, ids=lambda s: "x".join(
    str(int(x)) for x in s))
def test_flash_forward_output_is_the_same_with_stats(card, dtype, shape):
    B, S_q, S_kv, H, Hkv, D, causal, window = shape
    q, k, v, _ = _bwd_inputs(card, dtype, B, S_q, S_kv, H, Hkv, D)
    kw = dict(causal=causal, window=window)
    plain = flash_attention_kernel(q, k, v, **kw)
    with_stats, _ = flash_attention_kernel(q, k, v, with_stats=True, **kw)
    assert torch.equal(plain, with_stats)


def test_inference_kernels_refuse_grad(card):
    g = torch.Generator(device=card).manual_seed(0)
    q = torch.randn((2, 4, 64), generator=g, device=card).requires_grad_()
    cache = torch.randn((2, 128, 2, 64), generator=g, device=card)
    lens = torch.tensor([5, 9], dtype=torch.int32, device=card)
    with pytest.raises(RuntimeError, match="decode_attention_kernel"):
        decode_attention_kernel(q, cache, cache, lens)
    pool = cache.reshape(2, 1, 128, 2, 64)
    table = torch.zeros((2, 1), dtype=torch.int32, device=card)
    with pytest.raises(RuntimeError, match="paged_attention_kernel"):
        paged_attention_kernel(q, pool, pool, table, lens)
    pages = torch.randn((4, 128, 2, 64), device=card).requires_grad_()
    idx = torch.tensor([1, 0], dtype=torch.int32, device=card)
    with pytest.raises(RuntimeError, match="block_gather_kernel"):
        block_gather_kernel(pages, idx)
    x = torch.randn((1, 128, 2, 64), device=card).requires_grad_()
    dt = torch.rand((1, 128, 2), device=card)
    a = -torch.rand((2,), device=card)
    bc = torch.randn((1, 128, 1, 128), device=card)
    with pytest.raises(RuntimeError, match="ssd_chunk_scan_kernel"):
        ssd_chunk_scan_kernel(x, dt, a, bc, bc)
    with torch.no_grad():  # the same calls without grad run
        decode_attention_kernel(q, cache, cache, lens)
        block_gather_kernel(pages, idx)


@pytest.mark.parametrize("window", [0, 4096])
def test_flash_two_warpgroups_with_an_empty_second_match_plain(card, window):
    """S_q = 4672 = 36.5 blocks of 128 rows under the two-warpgroup plan:
    the last block's second warpgroup has no row and computes no tile.
    It must still release each of the block's 37 key tiles (more than
    the ring's 3 stages) as the first one takes its turns."""
    B, S, H, Hkv, D = 1, 4672, 8, 2, 128
    assert plan_splits(B, S, H, S, window=window, head_dim=D).consumers == 2
    q, k, v, _ = _bwd_inputs(card, torch.bfloat16, B, S, S, H, Hkv, D)
    got = flash_attention_kernel(q, k, v, causal=True, window=window)
    want = ref.flash_attention(q, k, v, causal=True, window=window)
    _close(got, want, torch.bfloat16)


# ---------------------------------------------------------------------------
# the SSD scan's backward kernels
# ---------------------------------------------------------------------------
#: each gradient's largest error over its largest magnitude against the
#: plain backward: f32 sums in other orders (measured <= 3e-6); bf16 rounds
#: the products' operands to bf16 and stores dx, dB and dC in bf16
#: (measured <= 6.7e-3 on an H100, about one bf16 ulp 2**-8 of the largest
#: gradient)
_SSD_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
#: (B, S, H, P, N, chunk, steep): the smoke form, mamba2's and zamba2's
#: widths, chunks of 127 over two sequences, one chunk of 96, steep decay;
#: 13 heads in groups of 4 (the bf16 route's last group takes one) and 6
#: heads in one group over long sequences (``plan_bwd_groups``)
_SSD_BWD_SHAPES = [
    (1, 128, 4, 32, 16, 64, False), (2, 256, 8, 64, 32, 128, False),
    (2, 512, 80, 64, 128, 128, False), (2, 256, 112, 64, 64, 128, False),
    (2, 254, 80, 64, 128, 127, False), (1, 96, 6, 32, 16, 128, False),
    (1, 128, 3, 32, 128, 32, False), (2, 256, 80, 64, 128, 128, True),
    (2, 4096, 13, 64, 128, 128, False), (2, 12288, 6, 64, 128, 128, False),
]


def _ssd_bwd_inputs(card, dtype, B, S, H, P, N, steep):
    x, dt, a, b, c, d = _ssd_inputs(card, dtype, B, S, H, P, N,
                                    B * S + H + N, steep)
    g = torch.Generator(device=card).manual_seed(S + P)
    dy = torch.randn(x.shape, generator=g, device=card).to(dtype)
    ds = torch.randn((B, H, P, N), generator=g, device=card)
    return x, dt, a, b, c, d, dy, ds


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", _SSD_BWD_SHAPES, ids=lambda s: "x".join(
    str(int(x)) for x in s))
def test_ssd_bwd_kernel_matches_plain(card, dtype, shape):
    B, S, H, P, N, chunk, steep = shape
    x, dt, a, b, c, d, dy, ds = _ssd_bwd_inputs(card, dtype, B, S, H, P, N,
                                                steep)
    kw = dict(chunk=chunk, d_skip=d, dstate=ds)
    got = ssd_chunk_scan_bwd_kernel(x, dt, a, b, c, dy, **kw)
    want = ref.ssd_chunk_scan_bwd(x, dt, a, b, c, dy, **kw)
    for name, g, w in zip(("dx", "ddt", "da", "db", "dc", "dd"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert bool(torch.isfinite(g).all()), name
        err = float((g.float() - w.float()).abs().max()
                    / w.float().abs().max())
        assert err <= _SSD_BWD_TOL[dtype], (name, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_bwd_kernel_is_deterministic(card, dtype):
    x, dt, a, b, c, d, dy, ds = _ssd_bwd_inputs(card, dtype, 2, 512, 80, 64,
                                                128, False)
    runs = [ssd_chunk_scan_bwd_kernel(x, dt, a, b, c, dy, chunk=128,
                                      d_skip=d, dstate=ds)
            for _ in range(2)]
    for a_, b_ in zip(*runs):
        assert torch.equal(a_, b_)


def test_ssd_bwd_kernel_times_its_kernels(card):
    """With ``timing`` the call reports its kernels (``BWD_KERNELS`` in
    bf16), each with a positive device time, and its gradients are those
    of a call without it; without ``d_skip`` there is no dd."""
    x, dt, a, b, c, d, dy, _ = _ssd_bwd_inputs(card, torch.bfloat16, 2, 256,
                                               8, 64, 32, False)
    times = torch.zeros(ssd_module.BWD_KERNELS + 1)
    got = ssd_chunk_scan_bwd_kernel(x, dt, a, b, c, dy, timing=times)
    want = ssd_chunk_scan_bwd_kernel(x, dt, a, b, c, dy)
    n = len(ssd_module.BWD_KERNEL_NAMES[torch.bfloat16])
    assert n == ssd_module.BWD_KERNELS
    assert times[0].item() == n and bool((times[1:] > 0).all())
    assert got[5] is None and want[5] is None
    for a_, b_ in zip(got[:5], want[:5]):
        assert torch.equal(a_, b_)


@pytest.mark.parametrize("H,N", [(80, 128), (112, 64)],
                         ids=["mamba2", "zamba2"])
def test_ssd_bwd_workspace_within_the_first_version(card, H, N):
    """At both train shapes (2 x 4096, P 64, chunks of 128) the bf16
    backward's f32 workspace is no larger than the first version's
    formula (S and G, dB's and dC's per-head partials, da's and dd's
    partials), and the call runs within it: the allocator's peak grows by
    the workspace and the outputs, no more."""
    B, S, P, chunk = 2, 4096, 64, 128
    nc = S // chunk
    first = 2 * B * nc * H * P * N + 2 * B * S * H * N + 2 * B * nc * H
    groups = ssd_module.plan_bwd_groups(B, S, H, chunk).groups
    work = ssd_module._bwd_workspace(B, S, H, P, N, chunk, torch.bfloat16,
                                     groups)
    assert work <= first
    x, dt, a, b, c, d, dy, _ = _ssd_bwd_inputs(card, torch.bfloat16, B, S,
                                               H, P, N, False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    out = ssd_chunk_scan_bwd_kernel(x, dt, a, b, c, dy, chunk=chunk,
                                    d_skip=d)
    torch.cuda.synchronize()
    outputs = sum(g.numel() * g.element_size() for g in out)
    grown = torch.cuda.max_memory_allocated() - start
    # + the f32 copies of dt, a and d the wrapper makes, and the
    # allocator's rounding
    slack = 3 * dt.numel() * 4 + (8 << 20)
    assert grown <= 4 * work + outputs + slack, (grown, work)


def test_ssd_ops_under_grad_runs_both_kernels(card):
    """``ops.ssd_chunk_scan`` on CUDA tensors that require grad: the
    forward kernel, then the backward kernel, and gradients within the
    f32 tolerance of autograd of the plain scan (which is finite: the
    plain scan selects the exponent before exp)."""
    x, dt, a, b, c, d, dy, ds = _ssd_bwd_inputs(card, torch.float32, 2, 256,
                                                8, 64, 32, False)
    fwd, bwd = (ssd_chunk_scan_kernel.launches,
                ssd_chunk_scan_bwd_kernel.launches)
    grads = {}
    for impl in (None, "plain"):
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in (x, dt, a, b, c, d)]
        y, state = ops.ssd_chunk_scan(*leaves[:5], chunk=128,
                                      d_skip=leaves[5], impl=impl)
        assert y.grad_fn is not None
        grads[impl] = torch.autograd.grad((y, state), leaves, (dy, ds))
    assert ssd_chunk_scan_kernel.launches == fwd + 1
    assert ssd_chunk_scan_bwd_kernel.launches == bwd + 1
    # da: autograd's f32 sum of dt * dda cancels; it is held to the plain
    # backward in the test above
    for name, g, w in zip(("dx", "ddt", "da", "db", "dc", "dd"),
                          grads[None], grads["plain"]):
        assert bool(torch.isfinite(w).all()), name
        if name != "da":
            err = float((g - w).abs().max() / w.abs().max())
            assert err <= _SSD_BWD_TOL[torch.float32], (name, err)


#: (arch, layers, smoke width): mamba2 and zamba2 at smoke width (f32, P
#: 32, N 16; zamba2 two shared-block applications and a trailing layer)
#: and at full width in bf16 (zamba2 one group, the shared block and a
#: trailing layer)
_REMAT_MODELS = [("mamba2-2.7b", 2, True), ("zamba2-7b", 5, True),
                 ("mamba2-2.7b", 2, False), ("zamba2-7b", 7, False)]


@pytest.mark.parametrize("arch,layers,smoke", _REMAT_MODELS,
                         ids=lambda x: str(x))
def test_ssd_backward_under_remat_policies(card, arch, layers, smoke):
    """``loss_and_grads`` through ``SSDChunkScan`` under remat "none",
    "full" and "dots": the same loss and gradients, bit for bit (the
    kernels are deterministic and each recompute reruns the forward
    kernel), and the SSD launches each policy implies: "dots" recomputes
    the scan (a ctypes launch its dispatcher-level policy cannot save)."""
    from repro_torch.configs import ARCHS, ShapeConfig, smoke_config
    from repro_torch.launch import loss_and_grads
    from repro_torch.models import Model

    cfg = ARCHS[arch]
    cfg = (smoke_config(cfg) if smoke else cfg).scaled(num_layers=layers)
    model = Model(cfg, device=card)
    params = model.init_params(seed=0)
    batch = model.synthetic_batch(ShapeConfig("t", "train", 256, 2))
    runs = {}
    for remat in ("none", "full", "dots"):
        fwd, bwd = (ssd_chunk_scan_kernel.launches,
                    ssd_chunk_scan_bwd_kernel.launches)
        loss, _, grads = loss_and_grads(model, params, batch, remat=remat)
        torch.cuda.synchronize()
        runs[remat] = (loss, grads)
        assert ssd_chunk_scan_bwd_kernel.launches - bwd == layers
        assert ssd_chunk_scan_kernel.launches - fwd == (
            layers if remat == "none" else 2 * layers)

    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}/{k}")
            else:
                yield f"{prefix}/{k}", v

    base = dict(flat(runs["none"][1]))
    assert all(bool(torch.isfinite(g).all()) for g in base.values())
    for remat in ("full", "dots"):
        assert torch.equal(runs[remat][0], runs["none"][0]), remat
        other = dict(flat(runs[remat][1]))
        for k, g in base.items():
            assert torch.equal(other[k], g), (remat, k)
