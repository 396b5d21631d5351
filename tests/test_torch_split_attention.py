"""The split-and-combine arithmetic of the port's attention kernels, held
against the JAX package on the CPU.

The bf16 flash kernel, the contiguous decode kernel and the paged decode
kernel split a row's key range across blocks: each split keeps its own online-softmax state (m, l,
acc), rounds its weights to the value dtype against its own running
max, and a combine merges the splits as
``sum_s e^(m_s - M) acc_s / max(sum_s e^(m_s - M) l_s, 1e-30)``.  The
kernels run only on the card, so this file emulates that arithmetic in
plain PyTorch, with the wrappers' own split planners and the kernels'
tile rules (a split wholly past a row's keys contributes ``m = -1e30,
l = 0``; a decode row with ``length <= 0`` sweeps every split), and
holds it against ``decode_attention_pallas``,
``paged_attention_pallas`` and ``flash_attention_pallas`` in interpret
mode and against the JAX package's ``ref`` oracles.  The paged kernel's
tiles are gathered by the block table (a tile is a page or a piece of
one), with global ids across slots or per-slot ids.  It also checks the
planners: every key tile falls in exactly one split, and the path's
shapes give at least one block per SM.

Tolerances: f32 at rtol = atol = 2e-5, as tests/test_kernels.py holds the
Pallas bodies to their oracles (the splits sum in another order); bf16
weights at 2e-2, the gap the card tests allow between the kernels (which
round unnormalised weights against a split's max) and the plain
versions."""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.paged_attention import decode_attention_pallas
from repro.kernels.paged_attention import paged_attention_pallas
from repro_torch.kernels import decode_attention as dmod
from repro_torch.kernels import flash_attention as fmod
from repro_torch.kernels import paged_attention as pmod

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

NEG_INF = -1e30
F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _rand(rs, shape, scale=0.3):
    return (rs.standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# the emulation: one split's online softmax, and the combine
# ---------------------------------------------------------------------------
def _split_state(q, tiles, pdtype):
    """Online softmax of the rows of ``q`` (R, D) over ``tiles``, a list
    of (keys (T, D), values (T, D), mask (R, T)) in order: f32 (m, l,
    acc), the weights rounded to ``pdtype`` against the split's running
    max, NEG_INF at masked scores, as the kernels do."""
    R, D = q.shape
    m = torch.full((R,), NEG_INF)
    l = torch.zeros(R)
    acc = torch.zeros(R, D)
    for kt, vt, mask in tiles:
        s = (q @ kt.T) / math.sqrt(D)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[:, None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[:, None] + p.to(pdtype).float() @ vt
        m = m_new
    return m, l, acc


def _combine(states):
    """The combine of common.cuh: splits with l == 0 are skipped."""
    M = torch.stack([torch.where(l > 0, m, torch.full_like(m, NEG_INF))
                     for m, l, _ in states]).amax(0)
    num = 0.
    den = 0.
    for m, l, a in states:
        w = torch.where(l > 0, torch.exp(m - M), torch.zeros_like(m))
        num = num + w[:, None] * a
        den = den + w * l
    return num / torch.clamp(den, min=1e-30)[:, None]


def split_decode(q, k, v, lengths, plan, pdtype=torch.float32):
    """The split decode kernel's arithmetic: q (B, H, D), caches (B,
    S_max, Hkv, D), lengths (B,); ``plan`` from ``dmod.plan_splits``."""
    B, H, D = q.shape
    S_max, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    blk, tps = plan.block, plan.tiles_per_split
    n_max = S_max // blk
    out = torch.zeros(B, H, D)
    for b in range(B):
        length = int(lengths[b])
        n_live = min(n_max, -(-length // blk)) if length > 0 else n_max
        for h in range(Hkv):
            qg = q[b, h * G:(h + 1) * G]
            states = []
            for s in range(plan.splits):
                t0, t1 = s * tps, min(n_live, (s + 1) * tps)
                if t0 >= t1:  # wholly past the row's keys
                    states.append((torch.full((G,), NEG_INF),
                                   torch.zeros(G), torch.zeros(G, D)))
                    continue
                tiles = []
                for t in range(t0, t1):
                    rows = slice(t * blk, (t + 1) * blk)
                    pos = torch.arange(t * blk, (t + 1) * blk)
                    tiles.append((k[b, rows, h], v[b, rows, h],
                                  (pos < length)[None, :].expand(G, blk)))
                states.append(_split_state(qg, tiles, pdtype))
            out[b, h * G:(h + 1) * G] = _combine(states)
    return out


def split_paged(q, k_pool, v_pool, table, lengths, plan, *, n_kv,
                global_pages, pdtype=torch.float32):
    """The paged kernel's arithmetic: q (B, H, D), pools (B, N_pool,
    page_rows, Hkv, D), table (B, max_blocks); ``plan`` from
    ``pmod.plan_splits``.  Tile t of row b is rows ``[(t % tpp) * block,
    (t % tpp + 1) * block)`` of page ``table[b, t // tpp]`` (of the
    slot-flattened pool for global ids, of row b's own pool otherwise),
    ``tpp = page_rows / block``; only the first ``n_kv`` columns count."""
    B, H, D = q.shape
    n_pool, page_rows, Hkv = k_pool.shape[1:4]
    G = H // Hkv
    blk, tps = plan.block, plan.tiles_per_split
    tpp = page_rows // blk
    n_tiles = n_kv * tpp
    kfl = k_pool.reshape(-1, page_rows, Hkv, D)
    vfl = v_pool.reshape(-1, page_rows, Hkv, D)
    out = torch.zeros(B, H, D)
    for b in range(B):
        length = int(lengths[b])
        n_live = min(n_tiles, -(-length // blk)) if length > 0 else n_tiles
        base = 0 if global_pages else b * n_pool
        for h in range(Hkv):
            qg = q[b, h * G:(h + 1) * G]
            states = []
            for s in range(plan.splits):
                t0, t1 = s * tps, min(n_live, (s + 1) * tps)
                if t0 >= t1:  # wholly past the row's keys
                    states.append((torch.full((G,), NEG_INF),
                                   torch.zeros(G), torch.zeros(G, D)))
                    continue
                tiles = []
                for t in range(t0, t1):
                    page = base + int(table[b, t // tpp])
                    rows = slice((t % tpp) * blk, (t % tpp + 1) * blk)
                    pos = torch.arange(t * blk, (t + 1) * blk)
                    tiles.append((kfl[page, rows, h], vfl[page, rows, h],
                                  (pos < length)[None, :].expand(G, blk)))
                states.append(_split_state(qg, tiles, pdtype))
            out[b, h * G:(h + 1) * G] = _combine(states)
    return out


def _first_key(lo, hi, window, S_kv):
    """The kernel's ``first_key``: the window's lower edge for the row at
    position ``lo``, or 0 without a window or where the row at ``hi``
    sees no key at all."""
    if window > 0 and hi - window + 1 < S_kv:
        return max(0, lo - window + 1)
    return 0


def flash_split_ranges(plan, S_q, S_kv, *, causal, q_offset, window=0):
    """The key tiles the bf16 flash kernel computes, as it picks them:
    ``{(q0, s): (t0, t1)}`` for the warpgroup of ``fmod.ROWS`` query rows
    at ``q0`` in split ``s``.  Splits count ``tiles_per_split`` tiles from
    the launch's first key tile; a block of ``consumers`` warpgroups
    starts at its first row's window edge, each warpgroup at its own
    (both 0 where the block's last row sees no key), and each ends at its
    causal horizon."""
    KN, tps, R = plan.keys, plan.tiles_per_split, fmod.ROWS
    t_base = _first_key(q_offset, q_offset + S_q - 1, window, S_kv) // KN
    ranges = {}
    for q0 in range(0, S_q, R * plan.consumers):
        q_hi = q_offset + min(q0 + R * plan.consumers, S_q) - 1
        n_tiles = -(-(min(S_kv, q_hi + 1) if causal else S_kv) // KN)
        blk_first = _first_key(q_offset + q0, q_hi, window, S_kv) // KN
        for qw0 in range(q0, min(q0 + R * plan.consumers, S_q), R):
            wq_hi = q_offset + min(qw0 + R, S_q) - 1
            wg_end = (-(-min(S_kv, wq_hi + 1) // KN) if causal
                      else n_tiles)
            wg_begin = _first_key(q_offset + qw0, q_hi, window, S_kv) // KN
            for s in range(plan.splits):
                t_begin = max(blk_first, t_base + s * tps)
                t_end = min(n_tiles, t_base + (s + 1) * tps)
                ranges[qw0, s] = (max(t_begin, wg_begin), min(t_end, wg_end))
    return ranges


def split_flash(q, k, v, plan, *, causal, q_offset, window=0,
                pdtype=torch.float32, ranges=None):
    """The bf16 flash kernel's arithmetic: q (B, S_q, H, D), k and v (B,
    S_kv, Hkv, D); ``plan`` from ``fmod.plan_splits``.  Per warpgroup of
    ``fmod.ROWS`` query rows, the key tiles of each split that
    :func:`flash_split_ranges` gives it (or ``ranges``), with the
    kernel's masks: keys past S_kv are not in a tile (the kernel scores
    them -inf)."""
    B, S_q, H, D = q.shape
    S_kv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    KN, R = plan.keys, fmod.ROWS
    if ranges is None:
        ranges = flash_split_ranges(plan, S_q, S_kv, causal=causal,
                                    q_offset=q_offset, window=window)
    out = torch.zeros(B, S_q, H, D)
    for b in range(B):
        for h in range(H):
            hk = h // G
            for q0 in range(0, S_q, R):
                rows = torch.arange(q0, min(q0 + R, S_q))
                q_pos = q_offset + rows
                states = []
                for s in range(plan.splits):
                    t0, t1 = ranges[q0, s]
                    tiles = []
                    for t in range(t0, t1):
                        pos = torch.arange(t * KN, min((t + 1) * KN, S_kv))
                        mask = torch.ones(len(rows), len(pos),
                                          dtype=torch.bool)
                        if causal:
                            mask = pos[None, :] <= q_pos[:, None]
                        if window:
                            mask = mask & (pos[None, :]
                                           > q_pos[:, None] - window)
                        tiles.append((k[b, pos, hk], v[b, pos, hk], mask))
                    states.append(_split_state(q[b, rows, h], tiles, pdtype))
                out[b, rows, h] = _combine(states)
    return out


# ---------------------------------------------------------------------------
# decode: emulation vs the Pallas body and the JAX oracle
# ---------------------------------------------------------------------------
DECODE_LENGTHS = [0, 1, 127, 128, 129, 512]  # block - 1, block, + 1, S_max


@pytest.mark.parametrize("H,Hkv,D", [(4, 2, 32), (7, 1, 64)])
def test_split_decode_matches_jax(H, Hkv, D):
    """Tiles of 128 rows, one split a tile (S_max 512: four splits), so
    the rows of length 1 and 127 leave three splits wholly past their
    keys; the row of length 0 sweeps all four."""
    rs = np.random.RandomState(H + D)
    B, S_max = len(DECODE_LENGTHS), 512
    q = _rand(rs, (B, H, D))
    k = _rand(rs, (B, S_max, Hkv, D))
    v = _rand(rs, (B, S_max, Hkv, D))
    lens = np.asarray(DECODE_LENGTHS, np.int32)
    plan = dmod.plan_splits(B, Hkv, S_max)
    assert (plan.block, plan.splits, plan.tiles_per_split) == (128, 4, 1)
    got = split_decode(*map(torch.from_numpy, (q, k, v, lens)), plan)
    for want in (jref.decode_attention(*map(jnp.asarray, (q, k, v, lens))),
                 decode_attention_pallas(*map(jnp.asarray, (q, k, v, lens)),
                                         interpret=True)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_split_decode_bf16_weights_match_pallas():
    """Weights rounded to bf16 against each split's own max, bf16 caches,
    against the Pallas body on the same bf16 inputs."""
    rs = np.random.RandomState(7)
    B, H, Hkv, D, S_max = len(DECODE_LENGTHS), 4, 4, 64, 512
    q, k, v = (_rand(rs, s) for s in ((B, H, D), (B, S_max, Hkv, D),
                                       (B, S_max, Hkv, D)))
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    lens = np.asarray(DECODE_LENGTHS, np.int32)
    got = split_decode(q.float(), k.float(), v.float(),
                       torch.from_numpy(lens),
                       dmod.plan_splits(B, Hkv, S_max), torch.bfloat16)
    want = decode_attention_pallas(
        *(jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (q, k, v)),
        jnp.asarray(lens), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               **BF16_TOL)


def test_empty_split_is_the_combines_identity():
    """Adding a split that saw no key (m = -1e30, l = 0, acc = 0) leaves
    the combine unchanged, bit for bit; giving it l = 1 instead (a wrong
    empty-split value) would not."""
    rs = np.random.RandomState(3)
    states = [(torch.from_numpy(_rand(rs, (5,), 2.0)),
               torch.from_numpy(np.abs(_rand(rs, (5,), 3.0)) + 1.0),
               torch.from_numpy(_rand(rs, (5, 8)))) for _ in range(3)]
    empty = (torch.full((5,), NEG_INF), torch.zeros(5), torch.zeros(5, 8))
    base = _combine(states)
    assert torch.equal(_combine(states + [empty]), base)
    assert torch.equal(_combine([empty] + states), base)
    wrong = (empty[0], torch.ones(5), empty[2])
    all_empty = [wrong] * 2
    assert torch.isfinite(_combine(all_empty)).all()
    assert not torch.allclose(_combine(states + [(
        torch.full((5,), 50.0), torch.ones(5), torch.zeros(5, 8))]), base)


# ---------------------------------------------------------------------------
# paged: emulation vs the Pallas body and the JAX oracle
# ---------------------------------------------------------------------------
# lengths 0 (an idle row), 1, a page - 1, a page, a page + 1, the full
# n_kv sweep; the tables have 4 columns, of which n_kv = 3 are swept
PAGED_LENGTHS = [0, 1, 127, 128, 129, 384]
PAGED_CASES = {
    # G 7 / D 64 (qwen2's group), global ids drawn from every slot's pages
    "g7_global": dict(H=7, Hkv=1, D=64, global_pages=True),
    # G 1 / D 112 (zamba2's shared block), each row a permutation of its
    # own pool's pages
    "g1_d112_local": dict(H=2, Hkv=2, D=112, global_pages=False),
}
PAGED_PLANS = [None, pmod.PagedPlan(128, 3, 1), pmod.PagedPlan(64, 3, 2),
               pmod.PagedPlan(128, 1, 3)]


def _paged_inputs(case, dtype):
    """Numpy inputs of a PAGED_CASES case (f32, or rounded to bf16)."""
    c = PAGED_CASES[case]
    rs = np.random.RandomState(c["D"] + c["H"])
    B, n_pool, mb, n_kv = len(PAGED_LENGTHS), 3, 4, 3
    q = _rand(rs, (B, c["H"], c["D"]))
    kp = _rand(rs, (B, n_pool, 128, c["Hkv"], c["D"]))
    vp = _rand(rs, (B, n_pool, 128, c["Hkv"], c["D"]))
    if dtype == "bfloat16":
        q, kp, vp = (np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
                     for x in (q, kp, vp))
    if c["global_pages"]:
        table = rs.randint(0, B * n_pool, (B, mb))
    else:
        table = np.stack([np.concatenate([rs.permutation(n_pool), [0]])
                          for _ in range(B)])
    return (q, kp, vp, table.astype(np.int32),
            np.asarray(PAGED_LENGTHS, np.int32), n_kv, c["global_pages"])


@functools.lru_cache(maxsize=None)
def _paged_want(case, dtype):
    """The Pallas body in interpret mode (in ``dtype``) and, for f32, the
    JAX oracle, on a case's inputs."""
    q, kp, vp, table, lens, n_kv, glob = _paged_inputs(case, dtype)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    pallas = paged_attention_pallas(
        *(jnp.asarray(x, jd) for x in (q, kp, vp)), jnp.asarray(table),
        jnp.asarray(lens), n_kv=n_kv, global_pages=glob, interpret=True)
    wants = [np.asarray(pallas, np.float32)]
    if dtype == "float32":
        wants.append(np.asarray(jref.paged_attention(
            *map(jnp.asarray, (q, kp, vp, table, lens)), n_kv=n_kv,
            global_pages=glob)))
    return wants


@pytest.mark.parametrize("case", list(PAGED_CASES))
@pytest.mark.parametrize("plan", PAGED_PLANS,
                         ids=["planned", "page_a_split", "two_halves",
                              "one_split"])
def test_split_paged_matches_jax(case, plan):
    """f32: the planner's split (pages cut to tiles of 32 rows at these
    small shapes), a page a split, two half pages a split (a split that
    crosses a page), and one split sweeping every page."""
    q, kp, vp, table, lens, n_kv, glob = _paged_inputs(case, "float32")
    B, H = q.shape[:2]
    Hkv = kp.shape[3]
    if plan is None:
        plan = pmod.plan_splits(B, Hkv, n_kv, 128)
        assert plan == (32, 12, 1)
    got = split_paged(*map(torch.from_numpy, (q, kp, vp, table, lens)),
                      plan, n_kv=n_kv, global_pages=glob)
    for want in _paged_want(case, "float32"):
        np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


@pytest.mark.parametrize("case", list(PAGED_CASES))
def test_split_paged_bf16_weights_match_pallas(case):
    """Weights rounded to bf16 against each split's own max, bf16 pools,
    against the Pallas body on the same bf16 inputs."""
    q, kp, vp, table, lens, n_kv, glob = _paged_inputs(case, "bfloat16")
    plan = pmod.plan_splits(q.shape[0], kp.shape[3], n_kv, 128)
    got = split_paged(*map(torch.from_numpy, (q, kp, vp, table, lens)),
                      plan, n_kv=n_kv, global_pages=glob,
                      pdtype=torch.bfloat16)
    np.testing.assert_allclose(got.numpy(), _paged_want(case, "bfloat16")[0],
                               **BF16_TOL)


# ---------------------------------------------------------------------------
# flash: emulation vs the Pallas body and the JAX oracle
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("q_offset", [192, 384])
def test_split_flash_causal_chunk_matches_pallas(q_offset):
    """A causal chunk of 128 queries over 512 keys.  At q_offset 192 the
    planner splits the 320 visible keys into three tiles of 128, and the
    first 64-row warpgroup's horizon (256) lies before the third split:
    that split gives it nothing.  The Pallas body wants whole blocks, so
    the sizes are multiples of 128."""
    rs = np.random.RandomState(q_offset)
    B, S_q, S_kv, H, Hkv, D = 1, 128, 512, 4, 2, 32
    q = _rand(rs, (B, S_q, H, D))
    k = _rand(rs, (B, S_kv, Hkv, D))
    v = _rand(rs, (B, S_kv, Hkv, D))
    plan = fmod.plan_splits(B, S_q, H, S_kv, q_offset=q_offset, causal=True,
                            head_dim=D)
    assert plan.splits > 1
    got = split_flash(*map(torch.from_numpy, (q, k, v)), plan, causal=True,
                      q_offset=q_offset)
    want = flash_attention_pallas(*map(jnp.asarray, (q, k, v)), causal=True,
                                  q_offset=q_offset, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize(
    "S_q,S_kv,q_offset,causal",
    [(100, 250, 150, True), (63, 65, 2, True), (65, 1000, 0, False),
     (1, 1, 0, True)],
)
def test_split_flash_ragged_matches_jax_ref(S_q, S_kv, q_offset, causal):
    """Ragged S_q and S_kv (a last tile cut by S_kv, a last warpgroup cut
    by S_q) against the JAX oracle."""
    rs = np.random.RandomState(S_q + S_kv)
    B, H, Hkv, D = 2, 4, 2, 32
    q = _rand(rs, (B, S_q, H, D))
    k = _rand(rs, (B, S_kv, Hkv, D))
    v = _rand(rs, (B, S_kv, Hkv, D))
    plan = fmod.plan_splits(B, S_q, H, S_kv, q_offset=q_offset,
                            causal=causal, head_dim=D)
    got = split_flash(*map(torch.from_numpy, (q, k, v)), plan,
                      causal=causal, q_offset=q_offset)
    want = jref.flash_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                                q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


# ---------------------------------------------------------------------------
# flash with a sliding window
# ---------------------------------------------------------------------------
def _window_inputs(seed, B, S_q, S_kv, H, Hkv, D):
    """q scaled up (a peaked softmax) and V rows that mark their position
    in column 0, so that the weight of a window's edge key shows."""
    rs = np.random.RandomState(seed)
    q = _rand(rs, (B, S_q, H, D), 3.0)
    k = _rand(rs, (B, S_kv, Hkv, D), 1.0)
    v = _rand(rs, (B, S_kv, Hkv, D), 1.0)
    v[..., 0] = np.arange(S_kv)[None, :, None] / S_kv
    return q, k, v


def _assert_splits_inside(plan, S_q, S_kv, q_offset, causal, window):
    """Every split of the launch holds a key tile inside the keys the
    chunk sees, ``[kv_begin, kv_end)``."""
    kv_begin, kv_end = fmod.key_range(S_q, S_kv, q_offset=q_offset,
                                      causal=causal, window=window)
    lo, hi = kv_begin // plan.keys, -(-kv_end // plan.keys)
    for s in range(plan.splits):
        t0 = lo + s * plan.tiles_per_split
        assert lo <= t0 < hi, (s, t0, lo, hi)


# (S_q, S_kv, q_offset, window): a causal chunk of 128 rows over 512 keys
# at windows that cut 64-key tiles mid-tile (1, 63, 100, 129) or hold the
# whole chunk (1000), split across blocks; multiples of 128 for the Pallas
# body's blocks
WINDOW_CHUNKS = [(128, 512, 384, 1), (128, 512, 384, 63),
                 (128, 512, 384, 100), (128, 512, 384, 129),
                 (128, 512, 384, 1000), (128, 512, 0, 100),
                 (256, 256, 0, 129)]


WINDOW_SHAPE = dict(B=1, H=4, Hkv=2, D=32)


@functools.lru_cache(maxsize=None)
def _window_chunk(S_q, S_kv, q_offset, window):
    """A WINDOW_CHUNKS case's inputs, its plan and the Pallas body's
    output on them (interpret mode), computed once for the parity test
    and the planted-fault test."""
    B, H, Hkv, D = (WINDOW_SHAPE[n] for n in ("B", "H", "Hkv", "D"))
    q, k, v = _window_inputs(window, B, S_q, S_kv, H, Hkv, D)
    plan = fmod.plan_splits(B, S_q, H, S_kv, q_offset=q_offset, causal=True,
                            window=window, head_dim=D)
    want = np.array(flash_attention_pallas(
        *map(jnp.asarray, (q, k, v)), causal=True, window=window,
        q_offset=q_offset, interpret=True))
    return (q, k, v), plan, want


@pytest.mark.parametrize("S_q,S_kv,q_offset,window", WINDOW_CHUNKS)
def test_split_flash_window_matches_pallas(S_q, S_kv, q_offset, window):
    qkv, plan, want = _window_chunk(S_q, S_kv, q_offset, window)
    assert plan.splits > 1
    _assert_splits_inside(plan, S_q, S_kv, q_offset, True, window)
    got = split_flash(*map(torch.from_numpy, qkv), plan, causal=True,
                      q_offset=q_offset, window=window)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


@pytest.mark.parametrize(
    "B,S_q,S_kv,H,q_offset,window,causal",
    [(1, 4224, 4224, 4, 0, 40, True),    # two warpgroups, 128-key tiles
     (1, 4224, 4224, 4, 0, 129, True),
     (1, 128, 6144, 32, 6016, 4096, True),  # mixtral's last chunk
     (2, 200, 1000, 4, 800, 77, True),   # ragged S_q / S_kv
     (2, 96, 300, 4, 0, 50, False),      # a window without the causal mask
     (2, 96, 100, 4, 40, 16, True)],     # rows that see no key: every key
)
def test_split_flash_window_matches_jax_ref(B, S_q, S_kv, H, q_offset,
                                           window, causal):
    """Windowed plans the Pallas body's block sizes do not reach, against
    the JAX oracle: two consumer warpgroups whose first key tiles differ,
    mixtral's split chunk, ragged sizes, a window without the causal
    mask, and rows past S_kv + window - 1, which see no key and average
    every key (so those blocks read every tile)."""
    Hkv, D = 2, 32
    q, k, v = _window_inputs(S_q + window, B, S_q, S_kv, H, Hkv, D)
    plan = fmod.plan_splits(B, S_q, H, S_kv, q_offset=q_offset,
                            causal=causal, window=window, head_dim=D)
    _assert_splits_inside(plan, S_q, S_kv, q_offset, causal, window)
    if S_q == 4224:
        assert plan.consumers == 2 and plan.splits == 1
        ranges = flash_split_ranges(plan, S_q, S_kv, causal=causal,
                                    q_offset=q_offset, window=window)
        # at window 40 the second warpgroup of every block but the first
        # starts a tile after the first warpgroup (at 129, on the same one)
        shifted = sum(ranges[q0 + 64, 0][0] == ranges[q0, 0][0] + 1
                      for q0 in range(0, S_q, 128))
        assert shifted == (S_q // 128 - 1 if window == 40 else 0)
    if S_kv == 6144:  # only the window's keys are split: 66 tiles, 3 ways
        assert (plan.splits, plan.tiles_per_split) == (3, 22)
    got = split_flash(*map(torch.from_numpy, (q, k, v)), plan,
                      causal=causal, q_offset=q_offset, window=window)
    want = jref.flash_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                                window=window, q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def _planted(fault, plan, S_q, S_kv, q_offset, window):
    """The kernel's split ranges and window with one fault planted: the
    edge kept with ``>=`` (window + 1 keys), the last split dropped, or
    each block's first key tile one tile late."""
    ranges = flash_split_ranges(plan, S_q, S_kv, causal=True,
                                q_offset=q_offset, window=window)
    if fault == "edge":
        return ranges, window + 1
    if fault == "split":
        last = plan.splits - 1
        return {key: ((0, 0) if key[1] == last else r)
                for key, r in ranges.items()}, window
    first = {}
    for (q0, s), (t0, t1) in ranges.items():
        first[q0] = min(first.get(q0, t0), t0)
    return {(q0, s): (max(t0, first[q0] + 1), t1)
            for (q0, s), (t0, t1) in ranges.items()}, window


@pytest.mark.parametrize("fault", ["edge", "split", "kv_begin"])
def test_window_parity_catches_planted_faults(fault):
    """The window cases of the card tests and the smoke (small windows
    that cut tiles mid-tile, peaked q, position-marking V) have power: the
    kernel's arithmetic with a fault planted misses the Pallas body by
    far more than the f32 tolerance, and in bf16 terms by more than the
    row-relative 2e-2, in at least one case."""
    worst = 0.0
    for S_q, S_kv, q_offset, window in WINDOW_CHUNKS[:4]:
        qkv, plan, want = _window_chunk(S_q, S_kv, q_offset, window)
        ranges, w = _planted(fault, plan, S_q, S_kv, q_offset, window)
        got = split_flash(*map(torch.from_numpy, qkv), plan, causal=True,
                          q_offset=q_offset, window=w, ranges=ranges)
        want = torch.from_numpy(want)
        rel = ((got - want).abs().amax(-1)
               / want.abs().amax(-1).clamp_min(1e-30)).max().item()
        worst = max(worst, rel)
    assert worst > 10 * 2e-2


# ---------------------------------------------------------------------------
# the planners
# ---------------------------------------------------------------------------
def _flash_live_blocks(B, S_q, H, S_kv, q_offset, causal, head_dim=64):
    """Blocks of the plan that compute at least one tile."""
    plan = fmod.plan_splits(B, S_q, H, S_kv, q_offset=q_offset,
                            causal=causal, head_dim=head_dim)
    rows = fmod.ROWS * plan.consumers
    live = 0
    for q0 in range(0, S_q, rows):
        end = min(S_kv, q_offset + min(q0 + rows, S_q)) if causal else S_kv
        n = -(-end // plan.keys)
        live += sum(s * plan.tiles_per_split < n for s in range(plan.splits))
    return plan, live * B * H


@pytest.mark.parametrize(
    "B,S_q,H,S_kv,q_offset,causal",
    [(1, 128, 14, 1024, 768, True), (1, 128, 14, 128, 0, True),
     (8, 1024, 16, 1024, 0, False), (8, 128, 16, 1024, 0, False),
     (2, 200, 14, 1000, 800, True), (1, 1, 4, 1, 0, True),
     (3, 777, 16, 300, 0, False), (1, 64, 2, 4096, 4032, True)],
)
def test_flash_planner_covers_every_tile_once(B, S_q, H, S_kv, q_offset,
                                              causal):
    plan = fmod.plan_splits(B, S_q, H, S_kv, q_offset=q_offset,
                            causal=causal, head_dim=64)
    end = min(S_kv, q_offset + S_q) if causal else S_kv
    n_tiles = -(-end // plan.keys)
    covered = [t for s in range(plan.splits)
               for t in range(s * plan.tiles_per_split,
                              min(n_tiles, (s + 1) * plan.tiles_per_split))]
    assert covered == list(range(n_tiles))
    assert (plan.splits - 1) * plan.tiles_per_split < n_tiles
    assert plan.consumers in (1, 2) and plan.keys in (64, 128)


@pytest.mark.parametrize(
    "B,S_q,H,S_kv,q_offset,causal",
    [(1, 128, 14, 1024, 768, True),     # qwen2's last prefill chunk
     (8, 1024, 16, 1024, 0, False),     # seamless's encoder
     (8, 128, 16, 1024, 0, False)],     # seamless's cross-attention prefill
)
def test_flash_planner_fills_the_card_at_path_shapes(B, S_q, H, S_kv,
                                                     q_offset, causal):
    _, live = _flash_live_blocks(B, S_q, H, S_kv, q_offset, causal)
    assert live >= fmod.SMS


@pytest.mark.parametrize("D", [112, 96, 80])
def test_flash_planner_runtime_d_form_at_zamba2_prefill(D):
    """zamba2's prefill (B 8, S 1024, H 32) at a head dim without a
    compiled form: one warpgroup over 64-key tiles, the only launch shape
    the run-time-D form has, and still enough blocks for the card.  The
    compiled D 128 form takes two warpgroups at the same shape."""
    plan, live = _flash_live_blocks(8, 1024, 32, 1024, 0, True, head_dim=D)
    assert (plan.consumers, plan.keys, plan.splits) == (1, 64, 1)
    assert live >= fmod.SMS
    assert fmod.plan_splits(8, 1024, 32, 1024, head_dim=128).consumers == 2


@pytest.mark.parametrize(
    "B,S_q,H,S_kv,q_offset,window",
    [(4, 6144, 32, 6144, 0, 4096), (1, 128, 32, 6144, 6016, 4096),
     (1, 128, 4, 512, 384, 1), (1, 128, 4, 512, 384, 129),
     (2, 200, 14, 1000, 800, 77), (1, 64, 2, 4096, 4032, 4096),
     (2, 96, 4, 100, 40, 16)],
)
def test_flash_planner_covers_the_window_once(B, S_q, H, S_kv, q_offset,
                                              window):
    """With a window the splits cover the key tiles of ``[kv_begin,
    kv_end)`` exactly once, counted from ``kv_begin``'s tile; at
    mixtral's prefill (B 4, 6144 tokens, 32 heads) two warpgroups over
    128-key tiles, one range of all 48 tiles."""
    plan = fmod.plan_splits(B, S_q, H, S_kv, q_offset=q_offset, causal=True,
                            window=window, head_dim=64)
    kv_begin, kv_end = fmod.key_range(S_q, S_kv, q_offset=q_offset,
                                      window=window)
    lo, hi = kv_begin // plan.keys, -(-kv_end // plan.keys)
    covered = [t for s in range(plan.splits)
               for t in range(lo + s * plan.tiles_per_split,
                              min(hi, lo + (s + 1) * plan.tiles_per_split))]
    assert covered == list(range(lo, hi))
    assert (plan.splits - 1) * plan.tiles_per_split < hi - lo
    if S_q == 6144:
        assert plan == fmod.FlashPlan(2, 128, 1, 48)


def test_flash_planner_reaches_every_kernel_shape():
    """The card tests' causal cases (tests/test_torch_cuda.py) reach every
    bf16 plan: split key ranges (tiles of 64), one range of 128-key tiles
    with one warpgroup, and two warpgroups."""
    kinds = set()
    for B, S_q, S_kv, H, off in ((1, 128, 1024, 14, 768),
                                 (8, 128, 1024, 16, 896),
                                 (4, 1000, 1000, 16, 0)):
        plan = fmod.plan_splits(B, S_q, H, S_kv, q_offset=off, head_dim=64)
        kinds.add((plan.consumers, plan.keys, plan.splits > 1))
    assert kinds == {(1, 64, True), (1, 128, False), (2, 128, False)}


@pytest.mark.parametrize("B,Hkv,S_max", [(8, 16, 4096), (8, 16, 128),
                                         (1, 2, 64), (64, 16, 4096),
                                         (3, 4, 384)])
def test_decode_planner_covers_every_row_once(B, Hkv, S_max):
    plan = dmod.plan_splits(B, Hkv, S_max)
    assert S_max % plan.block == 0
    n_tiles = S_max // plan.block
    assert plan.splits * plan.tiles_per_split >= n_tiles
    assert (plan.splits - 1) * plan.tiles_per_split < n_tiles


def test_decode_planner_fills_the_card_at_seamless_shape():
    """The cross cache: 4096 rows, 1024 live in each of 8 rows, 16 kv
    heads; the live blocks are those holding a row's first 1024 keys."""
    B, Hkv, S_max, length = 8, 16, 4096, 1024
    plan = dmod.plan_splits(B, Hkv, S_max)
    per = plan.block * plan.tiles_per_split
    live = B * Hkv * -(-length // per)
    assert live >= 132 and plan.splits * B * Hkv <= dmod.MAX_BLOCKS


@pytest.mark.parametrize("B,Hkv,n_kv,page_rows",
                         [(8, 2, 8, 128), (8, 16, 3, 128), (8, 32, 10, 128),
                          (1, 2, 1, 128), (64, 16, 32, 128), (3, 4, 5, 96),
                          (2, 1, 7, 200), (8, 2, 9, 16), (200, 32, 64, 128)])
def test_paged_planner_covers_every_tile_once(B, Hkv, n_kv, page_rows):
    """Every (row, kv head) sweeps n_kv pages of page_rows / block tiles;
    each tile falls in exactly one split, and a tile never crosses a
    page."""
    plan = pmod.plan_splits(B, Hkv, n_kv, page_rows)
    assert 0 < plan.block <= pmod.MAX_TILE and page_rows % plan.block == 0
    n_tiles = n_kv * (page_rows // plan.block)
    covered = [t for s in range(plan.splits)
               for t in range(s * plan.tiles_per_split,
                              min(n_tiles, (s + 1) * plan.tiles_per_split))]
    assert covered == list(range(n_tiles))
    assert (plan.splits - 1) * plan.tiles_per_split < n_tiles
    assert B * Hkv * (plan.splits - 1) <= pmod.MAX_BLOCKS


def _paged_live_blocks(plan, Hkv, lengths):
    """Blocks of the plan that see at least one key of their row."""
    per = plan.block * plan.tiles_per_split
    return Hkv * sum(min(plan.splits, -(-n // per)) for n in lengths)


# each path's decode shape at the step the smoke run times: B, Hkv, n_kv
# and the rows' lengths (qwen2: the engine's prompts + 16 tokens + the
# new one; seamless: 128-token prompts + 32 steps; zamba2: 1024 + 32)
PAGED_PATH_SHAPES = {
    "qwen2": (8, 2, 8, [277, 917, 537, 157, 117, 417, 794, 350]),
    "seamless": (8, 16, 3, [160] * 8),
    "zamba2": (8, 32, 10, [1056] * 8),
}


@pytest.mark.parametrize("path,plan,live", [
    ("qwen2", (64, 16, 1), 120), ("seamless", (64, 6, 1), 384),
    ("zamba2", (64, 10, 2), 2304)])
def test_paged_planner_live_blocks_at_path_shapes(path, plan, live):
    """The plan and its live blocks at each path's decode shape: tiles of
    half a page; at zamba2's, two tiles a split (a tile a split would
    pass MAX_BLOCKS).  zamba2 and seamless give more live blocks than the
    H100 has SMs; the engine's 8 x 2 x 8 pages give 256 blocks, 120 of
    them live (tiles of 32 rows would give 228 of 512, and measured no
    faster: PERF.md)."""
    B, Hkv, n_kv, lengths = PAGED_PATH_SHAPES[path]
    assert pmod.plan_splits(B, Hkv, n_kv, 128) == plan
    plan = pmod.PagedPlan(*plan)
    assert _paged_live_blocks(plan, Hkv, lengths) == live
    if path != "qwen2":
        assert live >= pmod.SMS
