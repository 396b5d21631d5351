"""The block gather's launch plan, on the CPU.

``plan_gather`` decides how the CUDA kernel cuts M pages into pieces,
one block of an ``(M, pieces)`` grid a piece, and which word it moves;
the card runs the plan and the C entry only refuses one it cannot run.
These tests hold each plan to what the kernel needs: every byte of every
gathered page is copied by exactly one block, a piece is at most 4
words for each of a block's threads, words divide the page size and
both base addresses.  The blocks are walked as the kernel walks them on
numpy pages, against ``pool[idx]`` with a zero page for an id out of
range.  Shapes: qwen2-0.5b's 32 KB bf16 page at the serving path's M
24, 144 and 192; seamless-m4t-medium's 256 KB page; a 30-byte page and
pools at odd bases (narrow words); f32 and zamba2-sized pages; M 0.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import block_gather as bg

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

QWEN = 128 * 2 * 64 * 2  # (128, 2, 64) bf16
SEAMLESS = 128 * 16 * 64 * 2  # (128, 16, 64) bf16
ZAMBA = 128 * 32 * 112 * 2  # (128, 32, 112) bf16
BASE = 1 << 30  # a pool base on a 16-byte (indeed 2 MB) boundary
OUT = 1 << 31  # the caching allocator's outputs start 512-byte aligned


def _blocks(plan, page_bytes, m):
    """(page, first byte, bytes) of block (page, piece) of the grid."""
    out = []
    for page in range(m):
        for p in range(plan.pieces):
            begin = p * plan.piece_bytes
            out.append((page, begin, min(plan.piece_bytes, page_bytes - begin)))
    return out


def _hold(plan, page_bytes, m, pool_ptr=BASE, out_ptr=OUT):
    """What the kernel and its C entry need of a plan."""
    assert (plan.pieces - 1) * plan.piece_bytes < page_bytes \
        <= plan.pieces * plan.piece_bytes
    assert plan.pieces <= 65535  # the grid's second dimension
    word = plan.word_bytes
    assert word in (1, 2, 4, 8, 16)
    assert (pool_ptr | out_ptr | page_bytes | plan.piece_bytes) % word == 0
    assert plan.piece_bytes <= bg.THREADS * max(bg.WORDS) * word
    # every byte of every page once: the blocks tile each page
    seen = {}
    for page, begin, n in _blocks(plan, page_bytes, m):
        assert n > 0
        seen.setdefault(page, []).append((begin, n))
    assert sorted(seen) == list(range(m))
    for spans in seen.values():
        spans.sort()
        end = 0
        for begin, n in spans:
            assert begin == end
            end = begin + n
        assert end == page_bytes


def _gather(plan, pool, idx):
    """The plan's blocks applied to numpy pages, bytes as the kernel
    moves them; a page with an id out of range comes out zero."""
    page_bytes = pool.shape[1]
    out = np.full((len(idx), page_bytes), 0xAB, np.uint8)
    for page, begin, n in _blocks(plan, page_bytes, len(idx)):
        src = idx[page]
        if 0 <= src < pool.shape[0]:
            out[page, begin:begin + n] = pool[src, begin:begin + n]
        else:
            out[page, begin:begin + n] = 0
    return out


def _want(pool, idx):
    ok = (idx >= 0) & (idx < pool.shape[0])
    out = pool[np.where(ok, idx, 0)].copy()
    out[~ok] = 0
    return out


# (page bytes, M, pool base offset, word): the serving path's qwen2
# pages (a CoW copy, the replay, a handoff read), seamless's pages (cut
# into pieces), qwen2's pages in f32 and zamba2's attention pages
# (128, 32, 112), a 30-byte page, pools viewed at odd element offsets
PLAN_CASES = {
    "qwen2-m1": (QWEN, 1, 0, 16),
    "qwen2-m24": (QWEN, 24, 0, 16),
    "qwen2-m144": (QWEN, 144, 0, 16),
    "qwen2-m192": (QWEN, 192, 0, 16),
    "qwen2-m3072": (QWEN, 3072, 0, 16),
    "seamless-m1": (SEAMLESS, 1, 0, 16),
    "seamless-m24": (SEAMLESS, 24, 0, 16),
    "seamless-m144": (SEAMLESS, 144, 0, 16),
    "page30-m24": (30, 24, 0, 2),
    "qwen2-bf16-odd-base": (QWEN, 24, 2, 2),
    "qwen2-f32-odd-base": (QWEN, 24, 4, 4),
    "qwen2-8-byte-base": (QWEN, 144, 8, 8),
    "seamless-odd-base": (SEAMLESS, 24, 2, 2),
    "page30-odd-base": (30, 24, 1, 1),
    "qwen2-f32-m24": (2 * QWEN, 24, 0, 16),
    "qwen2-f32-m144": (2 * QWEN, 144, 0, 16),
    "zamba2-m1": (ZAMBA, 1, 0, 16),
    "zamba2-m13": (ZAMBA, 13, 0, 16),
    "qwen2-m0": (QWEN, 0, 0, 16),
    "page30-m0": (30, 0, 0, 2),
}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_plan_gather_covers_every_byte_once(case):
    page_bytes, m, offset, word = PLAN_CASES[case]
    plan = bg.plan_gather(page_bytes, m, BASE + offset, OUT)
    assert plan.word_bytes == word
    _hold(plan, page_bytes, m, BASE + offset)
    if m * page_bytes >= bg.SMS * bg.THREADS * word:
        # enough bytes for a piece of a full word per thread on every SM
        assert m * plan.pieces >= bg.SMS
    # planned from the page size, M and the word alone, once
    assert plan is bg.plan_gather(page_bytes, m, BASE + 16 * 7 + offset,
                                  OUT + 512)


@pytest.mark.parametrize("case", [c for c in PLAN_CASES
                                  if PLAN_CASES[c][1]])
def test_plan_gather_moves_the_pages(case):
    """The plan's blocks, applied to random pages with an id out of
    range in the index, give ``pool[idx]`` with a zero page."""
    page_bytes, m, offset, _ = PLAN_CASES[case]
    plan = bg.plan_gather(page_bytes, m, BASE + offset, OUT)
    rs = np.random.RandomState(m)
    n_pool = 40 if page_bytes <= SEAMLESS else 16
    pool = rs.randint(0, 256, (n_pool, page_bytes), dtype=np.uint8)
    idx = rs.randint(0, n_pool, m).astype(np.int64)
    idx[m // 2] = n_pool if m > 1 else -1
    np.testing.assert_array_equal(_gather(plan, pool, idx), _want(pool, idx))


def test_plan_gather_fills_the_card_at_the_serving_sizes():
    """At the path's M the pieces start every one of the 132 SMs; a
    piece is 4 words a thread where that still holds."""
    got = {m: bg.plan_gather(QWEN, m, BASE, OUT) for m in (24, 144, 192)}
    assert {m: (p.piece_bytes, m * p.pieces) for m, p in got.items()} == {
        24: (4096, 192), 144: (16384, 288), 192: (16384, 384)}


def test_plan_gather_refuses_a_bad_size():
    with pytest.raises(ValueError):
        bg.plan_gather(0, 24, BASE, OUT)
    with pytest.raises(ValueError):
        bg.plan_gather(QWEN, -1, BASE, OUT)


def test_the_wrapper_takes_only_a_card_pool():
    """On the CPU ``ops.block_gather`` runs the plain version; the kernel
    wrapper itself refuses a CPU pool before it plans or builds."""
    from repro_torch.kernels import ops

    pool = torch.arange(4 * 6, dtype=torch.float32).view(4, 2, 3)
    idx = torch.tensor([3, 0, 3], dtype=torch.int32)
    assert torch.equal(ops.block_gather(pool, idx), pool[[3, 0, 3]])
    assert ops.block_gather(pool, idx[:0]).shape == (0, 2, 3)
    with pytest.raises(ValueError):
        bg.block_gather_kernel(pool, idx)
