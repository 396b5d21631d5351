// The backward pass of flash attention: dQ, dK and dV of what the forward
// kernel (flash_attention.cu) computes, for training through it.
//
// Replaces no TPU kernel: the JAX package has no backward kernel and
// trains through the plain attention (its autograd).  Its forward is
// repro/kernels/flash_attention.py:85 flash_attention_pallas, ported as
// flash_attention.cu; this is the gradient of that function, so that a
// training step on the card runs the forward kernel under autograd
// (kernels/flash_attention.py: FlashAttention) and gets every gradient
// before the attention.
//
// The function: q (B, S_q, H, D), k and v (B, S_kv, Hkv, D), query head h
// reads kv head h / G; scores s = (q . k) * scale where key j is visible
// to row i (j <= i when causal, j > i - window when window > 0), NEG_INF
// (-1e30) where it is not; P = softmax over the row's S_kv keys, O = P V.
// A row that sees no key (window > 0, i >= S_kv + window - 1) averages
// every key, as the forward does.  q_offset is 0.  With dO given and
// D_i = rowsum(dO_i * O_i):
//   dV_j = sum_i P_ij dO_i,   dP_ij = dO_i . v_j,
//   dS_ij = P_ij (dP_ij - D_i) where j is visible to i, else 0,
//   dQ_i = scale sum_j dS_ij k_j,   dK_j = scale sum_i dS_ij q_i,
// dK and dV summed over the G query heads of each kv head.
//
// The row statistics come from the forward: run with statistics asked
// for, it writes each row's (m, l) in f32, (B, S_q, H, 2), in the log2
// domain of the bf16 kernel (scores times scale * log2 e; a masked score
// is NEG_INF itself, not scaled), so that P_ij = 2^(s_ij - m_i) / l_i
// rebuilds its weights.  (m, l) and not one log-sum-exp: for a row that
// sees no key, m = NEG_INF and m + log2(l) rounds to NEG_INF in f32, which
// would give its keys the weight 1 instead of 1 / l.
//
// What bounds it on the H100: operations.  The least work is five
// products of length D a visible (row, key) pair (S, dP, dV, dK, dQ), 10 D
// flops: at qwen2's train shape (B 2, S 4096, 14/2 heads of 64, causal)
// 1.5e11 flops, 0.152 ms at the tensor cores' 989 TFLOP/s.  The bytes (q,
// k, v, o, dO read once, dq, dk, dv written once) are a few tens of MB:
// microseconds.  This design does seven products a pair, 14 D flops: S
// and dP once for dK and dV and again for dQ, so that dQ needs no
// reduction across blocks.
//
// bf16: three kernels, no atomics anywhere (each output element is
// written once by one thread after a loop of fixed order, so two runs give
// the same bits).
//   1. rows_kernel, a half-warp per row (16-byte loads): D_i =
//      rowsum(dO_i * O_i) in f32 beside the forward's (m_i, 1 / l_i), one
//      float4 a row, (B, H, S_pad) with S_pad = S_q rounded up to 64; rows
//      past S_q are zeros, so that the padded rows of a tile weigh 0.
//   2. dkdv_kernel, persistent: the plan (the host's plan_bwd) gives each
//      block a list of items, a (sequence, kv head, 64-key tile) each, so
//      that the causal work (key tile 0 is seen by every query tile, the
//      last by one) is balanced over the SMs: longest first, each onto
//      the least loaded block.  A block is a producer warpgroup and two
//      consumer warpgroups.  One producer thread loads the item's K and V
//      tiles
//      (64 keys x D) once by TMA, then walks the G query heads of the kv
//      head and, for each, the query tiles that see the item's keys
//      (QN rows: 64, or 32 at D > 64 for registers), bringing Q, dO and
//      the rows' statistics into a ring of four mbarrier-guarded stages.
//      The two warpgroups take the stages in turn (pair p goes to
//      warpgroup p % 2), each computing for the item's 64 keys
//        S^T = K Q^T and dP^T = V dO^T   (wgmma, both operands in shared
//                                         memory, K-major),
//        P^T and dS^T in registers from the statistics,
//        dV += P^T dO and dK += dS^T Q   (wgmma, A from registers: the
//                                         accumulator fragment converted
//                                         to bf16 A fragments, B N-major),
//      P^T while dP^T runs and dS^T while dV runs; at the item's end the
//      second warpgroup hands its dK and dV to the first through shared
//      memory, which adds them in a fixed order and stores them.  The sum
//      over G stays in one block.  The producer warpgroup hands its
//      registers to the consumers (setmaxnreg: 40 against 232 a thread),
//      so that dK and dV stay in registers at D 128 without spills (a
//      producer warp alone leaves the block 168 a thread).
//   3. dq_kernel, a block per (b, h, 64-row query tile), heaviest tiles
//      first, one consumer warpgroup and a producer warp, several blocks
//      an SM: Q and dO resident, K and V tiles (64 keys) through a TMA
//      ring; S = Q K^T and dP = dO V^T on wgmma, P while dP runs, dS in
//      registers, dQ += dS K with dS as the register operand and K read
//      N-major.
//   Each consumer waits for a pair's last product before the next pair's
//   first: on the H100 at qwen2's train shape that measured faster than
//   the variants tried (two dQ warpgroups sharing one K/V ring; issuing a
//   pair's first products before the last pair's have drained, with
//   deeper rings, or with the two dK/dV warpgroups taking turns).
// Masks: a key past S_kv weighs 0; a key the row does not see has P =
// 2^(NEG_INF - m) / l (0, or 1 / l in a row that sees no key: dV still
// takes those rows' uniform weights) and dS = 0.  Only pairs of tiles that
// cross the diagonal, a window's edge or S_kv take the mask arithmetic.
// Rows past S_q and columns past D load as zeros (TMA) and are not stored.
// Head dims: D 32, 64 and 128 compiled; any other D % 8 == 0 up to 128
// runs the 64- or 128-column layout with the tensor maps spanning the real
// D, as the forward's run-time-D form does.
//
// f32: the CUDA-core bodies of the first version (dK/dV per key tile, dQ
// per query tile, f32 tiles with a row stride of D + 1), chosen by dtype:
// the checks held to 1e-4 would miss what TF32 products lose.  They read
// the same row statistics (rows_kernel) as the bf16 kernels.
#include "common.cuh"
#include "flash_tiles.cuh"
#include "hopper.cuh"

namespace {

namespace hp = repro::hopper;
using bf16 = __nv_bfloat16;
using namespace repro::flash;

constexpr int kRows = 64;  // keys an item / query rows a dQ block or tile
constexpr int kMaxD = 128;

struct Shape {
  int B, S_q, S_kv, H, Hkv, D, causal, window;
  float scale;
  int S_pad;  // rows a head holds in the row statistics
};

__device__ __forceinline__ bool visible(const Shape& s, int i, int j) {
  if (s.causal && j > i) return false;
  if (s.window > 0 && j <= i - s.window) return false;
  return true;
}

// rows at or past S_kv + window - 1 see no key: they average every key
__device__ __forceinline__ bool has_empty_row(const Shape& s, int q_last) {
  return s.window > 0 && q_last >= s.S_kv + s.window - 1;
}

// the key tiles [*t0, *t1) that rows [q0, q1) read
__device__ __forceinline__ void key_tiles(const Shape& s, int q0, int q1,
                                          int* t0, int* t1) {
  int lo = 0, hi = s.S_kv;
  if (!has_empty_row(s, q1 - 1)) {
    if (s.window > 0) lo = max(0, q0 - s.window + 1);
    if (s.causal) hi = min(s.S_kv, q1);
  }
  *t0 = lo / kRows;
  *t1 = (hi + kRows - 1) / kRows;
}

// whether query rows [q0, q1) read some key of [k0, k1)
__device__ __forceinline__ bool tile_needed(const Shape& s, int q0, int q1,
                                            int k0, int k1) {
  if (has_empty_row(s, q1 - 1)) return true;
  if (s.causal && q1 - 1 < k0) return false;
  if (s.window > 0 && q0 - s.window + 1 > k1 - 1) return false;
  return true;
}

// whether the pair of key rows [k0, k0 + 64) and query rows [q0, q0 + qn)
// needs the mask arithmetic: some key is past S_kv, past the diagonal or
// at or below some row's window edge
__device__ __forceinline__ bool pair_masked(const Shape& s, int k0, int q0,
                                            int qn) {
  return k0 + kRows > s.S_kv || (s.causal && k0 + kRows - 1 > q0) ||
         (s.window > 0 && k0 <= q0 + qn - 1 - s.window);
}

// ---------------------------------------------------------------------------
// 1. the rows: (m, 1 / l, D_i, 0) of each row, zeros past S_q
// ---------------------------------------------------------------------------
// A half-warp a row, 16 bytes a lane a load (a row of D % 8 == 0
// elements is whole 16-byte units); 16 rows a block.
constexpr int kRowsPerBlock = 16;

template <typename T>
__global__ void __launch_bounds__(kRowsPerBlock * 16)
    rows_kernel(Shape s, const T* __restrict__ o, const T* __restrict__ dout,
                const float* __restrict__ stats, float4* __restrict__ rows) {
  constexpr int kVec = 16 / sizeof(T);  // elements a 16-byte load
  const int lane = threadIdx.x & 15;
  const int64_t r =
      static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 4);
  // the half-warps of a warp stay together for the shuffles below
  const bool live = r < static_cast<int64_t>(s.B) * s.H * s.S_pad;
  const int i = live ? static_cast<int>(r % s.S_pad) : s.S_q;
  const int bh = live ? static_cast<int>(r / s.S_pad) : 0;
  const int b = bh / s.H, h = bh % s.H;
  const int64_t row = (static_cast<int64_t>(b) * s.S_q + i) * s.H + h;
  float sum = 0.f;
  if (i < s.S_q)
    for (int d = lane * kVec; d < s.D; d += 16 * kVec) {
      const uint4 a = *reinterpret_cast<const uint4*>(dout + row * s.D + d);
      const uint4 c = *reinterpret_cast<const uint4*>(o + row * s.D + d);
      const T* x = reinterpret_cast<const T*>(&a);
      const T* y = reinterpret_cast<const T*>(&c);
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        sum += repro::to_float(x[j]) * repro::to_float(y[j]);
    }
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (!live || lane != 0) return;
  rows[r] = i < s.S_q ? make_float4(stats[row * 2], 1.f / stats[row * 2 + 1],
                                    sum, 0.f)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
}

// ---------------------------------------------------------------------------
// bf16 tiles: products on the tensor cores
// ---------------------------------------------------------------------------

// acc = A . B^T for a 64-row A tile and an N-row B tile, both K-major (D
// columns, D / 16 steps): S^T = K Q^T, dP^T = V dO^T, S = Q K^T, dP = dO V^T
template <int D, int N>
__device__ __forceinline__ void issue_ss(float (&acc)[N / 2], uint32_t a_tile,
                                         uint32_t b_tile) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t a = kmajor_desc<D>(a_tile, kRows, kk);
    const uint64_t b = kmajor_desc<D>(b_tile, N, kk);
    if constexpr (N == 64)
      hp::wgmma_ss_m64n64k16(acc, a, b, kk > 0);
    else
      hp::wgmma_ss_m64n32k16(acc, a, b, kk > 0);
  }
}

// The dK/dV kernel's weights, in two steps so that each overlaps a
// product: s and dp hold S^T and dP^T of 64 keys x QN query rows as
// accumulator fragments (element (key r0 + 8 i, row 8 n + 2 cq + e) in
// register 4 n + 2 i + e); stat holds the QN rows' (m, 1 / l, D_i).
// dkdv_p leaves P^T in s, dkdv_ds dS^T in dp.  kMask: key0 is the key of
// fragment row r0 (r0 + 8: 8 later), q0 the row of column 0.
template <int QN, bool kMask>
__device__ __forceinline__ void dkdv_p(float (&s)[QN / 2], const float4* stat,
                                       const Shape& sh, int key0, int q0,
                                       int cq, float sl2) {
#pragma unroll
  for (int n = 0; n < QN / 8; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * n + 2 * cq + e;
      const float4 st = stat[col];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float& x = s[4 * n + 2 * i + e];
        if constexpr (kMask) {
          const int key = key0 + 8 * i;
          const bool vis = visible(sh, q0 + col, key);
          x = key >= sh.S_kv
                  ? 0.f
                  : hp::ex2((vis ? x * sl2 : repro::kNegInf) - st.x) * st.y;
        } else {
          x = hp::ex2(fmaf(x, sl2, -st.x)) * st.y;
        }
      }
    }
}

template <int QN, bool kMask>
__device__ __forceinline__ void dkdv_ds(const float (&s)[QN / 2],
                                        float (&dp)[QN / 2],
                                        const float4* stat, const Shape& sh,
                                        int key0, int q0, int cq) {
#pragma unroll
  for (int n = 0; n < QN / 8; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * n + 2 * cq + e;
      const float di = stat[col].z;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float ds = s[4 * n + 2 * i + e] * (dp[4 * n + 2 * i + e] - di);
        if constexpr (kMask) {
          const int key = key0 + 8 * i;
          dp[4 * n + 2 * i + e] =
              key < sh.S_kv && visible(sh, q0 + col, key) ? ds : 0.f;
        } else {
          dp[4 * n + 2 * i + e] = ds;
        }
      }
    }
}

// The dQ kernel's dS, in two steps as above.  s and dp hold S and dP of
// 64 rows x 64 keys (element (row r0 + 8 i, key 8 n + 2 cq + e) in
// register 4 n + 2 i + e); st[i] is row r0 + 8 i's (m, 1 / l, D_i).
// dq_p leaves the unmasked P in s (inf in a row that sees no key, whose
// every pair is masked), dq_ds dS in s.  kMask: q_row is the row of
// fragment row r0, key0 the key of column 0.
__device__ __forceinline__ void dq_p(float (&s)[kRows / 2],
                                     const float4 (&st)[2], float sl2) {
#pragma unroll
  for (int n = 0; n < kRows / 8; ++n)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * n + 2 * i + e];
        x = hp::ex2(fmaf(x, sl2, -st[i].x)) * st[i].y;
      }
}

template <bool kMask>
__device__ __forceinline__ void dq_ds(float (&s)[kRows / 2],
                                      const float (&dp)[kRows / 2],
                                      const float4 (&st)[2], const Shape& sh,
                                      int q_row, int key0, int cq) {
#pragma unroll
  for (int n = 0; n < kRows / 8; ++n)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * n + 2 * i + e];
        const float ds = x * (dp[4 * n + 2 * i + e] - st[i].z);
        if constexpr (kMask) {
          const int key = key0 + 8 * n + 2 * cq + e;
          x = key < sh.S_kv && visible(sh, q_row + 8 * i, key) ? ds : 0.f;
        } else {
          x = ds;
        }
      }
}

// ---------------------------------------------------------------------------
// 2. dK and dV: persistent blocks over the planned items
// ---------------------------------------------------------------------------
template <int D>
struct DkdvLayout : TileSwizzle<D> {
  // query rows a stage; plan_bwd (kernels/flash_attention.py) cuts the
  // items' query tiles by the same rule and passes its rows, which
  // launch_bf16 holds to this
  static constexpr int QN = D <= 64 ? 64 : 32;
  static constexpr int kStages = 4;  // two a warpgroup
  static constexpr uint32_t kKVBytes = kRows * D * 2;
  static constexpr uint32_t kQBytes = QN * D * 2;
  static constexpr uint32_t kStatBytes = QN * 16;
  // offsets from a 1024-byte aligned base (the swizzle atom's period)
  static constexpr uint32_t kK = 0;
  static constexpr uint32_t kV = kK + kKVBytes;
  static constexpr uint32_t kQ = kV + kKVBytes;
  static constexpr uint32_t kDO = kQ + kStages * kQBytes;
  static constexpr uint32_t kStat = kDO + kStages * kQBytes;
  // the second warpgroup's dK and dV, D floats a thread, for the first
  static constexpr uint32_t kRed = kStat + kStages * kStatBytes;
  static constexpr uint32_t kBars = kRed + 128 * D * 4;
  // full and empty per stage, then kv_full and kv_empty
  static constexpr uint32_t kBytes = kBars + (2 * kStages + 2) * 8;
  // a producer warpgroup (one thread issues the loads; the four warps
  // give their registers to the consumers) and two consumer warpgroups
  static constexpr int kThreads = 3 * 128;
  static constexpr int kProducerRegs = 40;
  static constexpr int kConsumerRegs = 232;  // 128 * 40 + 256 * 232 <= 64K
  static_assert(kBytes + 1024 <= 232448, "shared memory per block");
};

// An item: (b * Hkv + kv head, key tile, lo, hi, e): its query tiles are
// [lo, hi) and [max(hi, e), n_qt) (the second: tiles holding rows that see
// no key), for each of the G query heads in turn.
constexpr int kItemInts = 5;

// the query tiles an item walks for each query head, and the j-th of them
__device__ __forceinline__ int item_tiles(const int* it, int n_qt) {
  return it[3] - it[2] + max(0, n_qt - max(it[3], it[4]));
}
__device__ __forceinline__ int item_tile(const int* it, int j) {
  const int a = it[3] - it[2];
  return j < a ? it[2] + j : max(it[3], it[4]) + j - a;
}

// D: the head dim the tiles are laid out for; with kAnyD the real one,
// sh.D <= D, spans the tensor maps (columns past it load as zeros).
template <int D, bool kAnyD>
__global__ void __launch_bounds__(DkdvLayout<D>::kThreads, 1)
    dkdv_kernel(const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ CUtensorMap do_map,
                const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map,
                const float4* __restrict__ rows, const int* __restrict__ plan,
                bf16* __restrict__ dk, bf16* __restrict__ dv, Shape sh,
                float sl2) {
  using L = DkdvLayout<D>;
  constexpr int QN = L::QN;
  const int dh = kAnyD ? sh.D : D;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hp::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* base_ptr = smem_raw + (base - raw);
  const uint32_t full = base + L::kBars;  // full[i] = full + 8 i
  const uint32_t empty = full + 8 * L::kStages;
  const uint32_t kv_full = empty + 8 * L::kStages;
  const uint32_t kv_empty = kv_full + 8;

  const int G = sh.H / sh.Hkv;
  const int n_qt = (sh.S_q + QN - 1) / QN;
  const int* items = plan + gridDim.x + 1;
  const int beg = plan[blockIdx.x], end = plan[blockIdx.x + 1];
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int i = 0; i < L::kStages; ++i) {
      hp::mbar_init(full + 8 * i, 1);
      hp::mbar_init(empty + 8 * i, 4);  // the four warps of one warpgroup
    }
    hp::mbar_init(kv_full, 1);
    hp::mbar_init(kv_empty, 8);  // every consumer warp
    hp::mbar_fence_init();
  }
  __syncthreads();

  if (tid < 128) {  // the producer warpgroup: one thread issues every load
    hp::setmaxnreg_dec<L::kProducerRegs>();
    if (tid == 0) {
      int p = 0;  // pairs this block has loaded
      for (int n = beg; n < end; ++n) {
        const int* it = items + kItemInts * n;
        const int b = it[0] / sh.Hkv, hk = it[0] % sh.Hkv;
        hp::mbar_wait(kv_empty, ((n - beg) & 1) ^ 1);  // item 0 passes
        hp::mbar_expect_tx(kv_full, 2 * L::kKVBytes);
        for (int j = 0; j < L::kChunks; ++j) {
          const uint32_t off = j * kRows * L::kSwizzle;
          hp::tma_load_4d(base + L::kK + off, &k_map, kv_full, j * L::kAtom,
                          hk, it[1] * kRows, b);
          hp::tma_load_4d(base + L::kV + off, &v_map, kv_full, j * L::kAtom,
                          hk, it[1] * kRows, b);
        }
        const int nt = item_tiles(it, n_qt);
        for (int pg = 0; pg < G * nt; ++pg, ++p) {
          const int h = hk * G + pg / nt;
          const int qt = item_tile(it, pg % nt);
          const int st = p % L::kStages;
          hp::mbar_wait(empty + 8 * st, ((p / L::kStages) & 1) ^ 1);
          const uint32_t bar = full + 8 * st;
          hp::mbar_expect_tx(bar, 2 * L::kQBytes + L::kStatBytes);
          for (int j = 0; j < L::kChunks; ++j) {
            const uint32_t off = st * L::kQBytes + j * QN * L::kSwizzle;
            hp::tma_load_4d(base + L::kQ + off, &q_map, bar, j * L::kAtom, h,
                            qt * QN, b);
            hp::tma_load_4d(base + L::kDO + off, &do_map, bar, j * L::kAtom,
                            h, qt * QN, b);
          }
          hp::bulk_load(base + L::kStat + st * L::kStatBytes,
                        rows + (static_cast<int64_t>(b) * sh.H + h) *
                                   sh.S_pad + qt * QN,
                        L::kStatBytes, bar);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroup w: the item's 64 keys, every other pair ----
  hp::setmaxnreg_inc<L::kConsumerRegs>();
  const int w = (tid >> 7) - 1;
  const int t = tid & 127;
  const int lane = t & 31;
  const int r0 = (t >> 5) * 16 + (lane >> 2);  // fragment rows r0, r0 + 8
  const int cq = lane & 3;                     // fragment column pair
  float* red = reinterpret_cast<float*>(base_ptr + L::kRed);
  float s[QN / 2], dp[QN / 2];
#pragma unroll
  for (int j = 0; j < QN / 2; ++j) s[j] = dp[j] = 0.f;
  int p = 0;
  for (int n = beg; n < end; ++n) {
    const int* it = items + kItemInts * n;
    const int b = it[0] / sh.Hkv, hk = it[0] % sh.Hkv;
    const int k0 = it[1] * kRows;
    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) dk_acc[j] = dv_acc[j] = 0.f;
    hp::mbar_wait(kv_full, (n - beg) & 1);
    const int nt = item_tiles(it, n_qt);
    for (int pg = 0; pg < G * nt; ++pg, ++p) {
      if ((p & 1) == w) {
        const int qt = item_tile(it, pg % nt);
        const int st = p % L::kStages;
        const uint32_t q_t = base + L::kQ + st * L::kQBytes;
        const uint32_t do_t = base + L::kDO + st * L::kQBytes;
        const float4* stat = reinterpret_cast<const float4*>(
            base_ptr + L::kStat + st * L::kStatBytes);
        hp::mbar_wait(full + 8 * st, (p / L::kStages) & 1);
        const bool masked = pair_masked(sh, k0, qt * QN, QN);
        // S^T = K Q^T and dP^T = V dO^T; P^T while dP^T runs, then dV +=
        // P^T dO while dS^T is formed, then dK += dS^T Q
        hp::fence_regs(s);
        hp::fence_regs(dp);
        hp::wgmma_fence();
        issue_ss<D, QN>(s, base + L::kK, q_t);
        hp::wgmma_commit();
        issue_ss<D, QN>(dp, base + L::kV, do_t);
        hp::wgmma_commit();
        hp::wgmma_wait<1>();
        hp::fence_regs(s);
        if (masked)
          dkdv_p<QN, true>(s, stat, sh, k0 + r0, qt * QN, cq, sl2);
        else
          dkdv_p<QN, false>(s, stat, sh, k0 + r0, qt * QN, cq, sl2);
        uint32_t pa[QN / 16][4], da[QN / 16][4];
        pack_weights<QN>(s, pa);
        hp::fence_regs(dv_acc);
        hp::wgmma_fence();
        issue_pv<D, QN>(dv_acc, pa, do_t);
        hp::wgmma_commit();
        hp::wgmma_wait<1>();  // dP^T is in; dV may still run
        hp::fence_regs(dp);
        if (masked)
          dkdv_ds<QN, true>(s, dp, stat, sh, k0 + r0, qt * QN, cq);
        else
          dkdv_ds<QN, false>(s, dp, stat, sh, k0 + r0, qt * QN, cq);
        pack_weights<QN>(dp, da);
        hp::fence_regs(dk_acc);
        hp::wgmma_fence();
        issue_pv<D, QN>(dk_acc, da, q_t);
        hp::wgmma_commit();
        hp::wgmma_wait<0>();
        hp::fence_regs(dv_acc);
        hp::fence_regs(dk_acc);
#pragma unroll
        for (int kk = 0; kk < QN / 16; ++kk) {
          hp::fence_regs(pa[kk]);
          hp::fence_regs(da[kk]);
        }
        __syncwarp();
        if (lane == 0) hp::mbar_arrive(empty + 8 * st);
      }
    }
    // this warpgroup no longer reads the item's K and V
    __syncwarp();
    if (lane == 0) hp::mbar_arrive(kv_empty);

    // the second warpgroup's sums go to the first, which adds them to its
    // own (the same order every run) and stores the item's rows
    if (w == 1) {
#pragma unroll
      for (int j = 0; j < D / 2; ++j) {
        red[j * 128 + t] = dk_acc[j];
        red[(D / 2 + j) * 128 + t] = dv_acc[j];
      }
      hp::named_bar_arrive(1, 256);
      hp::named_bar_sync(2, 256);
      continue;
    }
    hp::named_bar_sync(1, 256);
#pragma unroll
    for (int j = 0; j < D / 2; ++j) {
      dk_acc[j] += red[j * 128 + t];
      dv_acc[j] += red[(D / 2 + j) * 128 + t];
    }
    hp::named_bar_arrive(2, 256);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = k0 + r0 + 8 * i;
      if (key >= sh.S_kv) continue;
      const int64_t off =
          ((static_cast<int64_t>(b) * sh.S_kv + key) * sh.Hkv + hk) * dh;
      // columns 8 n + 2 cq and + 1 lie below dh together (dh % 8 == 0)
#pragma unroll
      for (int n2 = 0; n2 < D / 8; ++n2)
        if (!kAnyD || 8 * n2 < dh) {
          const int c = 4 * n2 + 2 * i;
          *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * n2 + 2 * cq) =
              __floats2bfloat162_rn(dk_acc[c] * sh.scale,
                                    dk_acc[c + 1] * sh.scale);
          *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * n2 + 2 * cq) =
              __floats2bfloat162_rn(dv_acc[c], dv_acc[c + 1]);
        }
    }
  }
}

// ---------------------------------------------------------------------------
// 3. dQ: a block per (b, h, 64-row query tile)
// ---------------------------------------------------------------------------
template <int D>
struct DqLayout : TileSwizzle<D> {
  static constexpr int kStages = D <= 64 ? 3 : 2;
  static constexpr uint32_t kTileBytes = kRows * D * 2;
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kDO = kQ + kTileBytes;
  static constexpr uint32_t kK = kDO + kTileBytes;
  static constexpr uint32_t kV = kK + kStages * kTileBytes;
  static constexpr uint32_t kBars = kV + kStages * kTileBytes;
  static constexpr uint32_t kBytes = kBars + (2 * kStages + 1) * 8;
  static constexpr int kThreads = 128 + 32;
  static_assert(kBytes + 1024 <= 232448, "shared memory per block");
};

template <int D, bool kAnyD>
__global__ void __launch_bounds__(DqLayout<D>::kThreads)
    dq_kernel(const __grid_constant__ CUtensorMap q_map,
              const __grid_constant__ CUtensorMap do_map,
              const __grid_constant__ CUtensorMap k_map,
              const __grid_constant__ CUtensorMap v_map,
              const float4* __restrict__ rows, bf16* __restrict__ dq,
              Shape sh, float sl2) {
  using L = DqLayout<D>;
  const int dh = kAnyD ? sh.D : D;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (hp::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = base + L::kBars;
  const uint32_t empty = full + 8 * L::kStages;
  const uint32_t q_bar = empty + 8 * L::kStages;

  const int bh = blockIdx.x;
  const int b = bh / sh.H, h = bh % sh.H;
  const int hk = h / (sh.H / sh.Hkv);
  // causal: the heaviest tiles (the last rows) are scheduled first
  const int qt = sh.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * kRows, q1 = min(q0 + kRows, sh.S_q);
  int t0, t1;
  key_tiles(sh, q0, q1, &t0, &t1);
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int i = 0; i < L::kStages; ++i) {
      hp::mbar_init(full + 8 * i, 1);
      hp::mbar_init(empty + 8 * i, 4);
    }
    hp::mbar_init(q_bar, 1);
    hp::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= 128) {  // the producer warp
    if (tid == 128 && t0 < t1) {
      hp::mbar_expect_tx(q_bar, 2 * L::kTileBytes);
      for (int j = 0; j < L::kChunks; ++j) {
        const uint32_t off = j * kRows * L::kSwizzle;
        hp::tma_load_4d(base + L::kQ + off, &q_map, q_bar, j * L::kAtom, h,
                        q0, b);
        hp::tma_load_4d(base + L::kDO + off, &do_map, q_bar, j * L::kAtom, h,
                        q0, b);
      }
      for (int it = t0; it < t1; ++it) {
        const int i = it - t0;
        const int st = i % L::kStages;
        hp::mbar_wait(empty + 8 * st, ((i / L::kStages) & 1) ^ 1);
        hp::mbar_expect_tx(full + 8 * st, 2 * L::kTileBytes);
        for (int j = 0; j < L::kChunks; ++j) {
          const uint32_t off = st * L::kTileBytes + j * kRows * L::kSwizzle;
          hp::tma_load_4d(base + L::kK + off, &k_map, full + 8 * st,
                          j * L::kAtom, hk, it * kRows, b);
          hp::tma_load_4d(base + L::kV + off, &v_map, full + 8 * st,
                          j * L::kAtom, hk, it * kRows, b);
        }
      }
    }
    return;
  }

  const int lane = tid & 31;
  const int r0 = (tid >> 5) * 16 + (lane >> 2);
  const int cq = lane & 3;
  const int64_t rbase = (static_cast<int64_t>(b) * sh.H + h) * sh.S_pad;
  const float4 st[2] = {rows[rbase + q0 + r0], rows[rbase + q0 + r0 + 8]};
  float acc[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;
  float s[kRows / 2], dp[kRows / 2];
#pragma unroll
  for (int j = 0; j < kRows / 2; ++j) s[j] = dp[j] = 0.f;
  if (t0 < t1) hp::mbar_wait(q_bar, 0);
  for (int it = t0; it < t1; ++it) {
    const int i = it - t0;
    const int stg = i % L::kStages;
    const uint32_t k_t = base + L::kK + stg * L::kTileBytes;
    const uint32_t v_t = base + L::kV + stg * L::kTileBytes;
    hp::mbar_wait(full + 8 * stg, (i / L::kStages) & 1);
    hp::fence_regs(s);
    hp::fence_regs(dp);
    hp::wgmma_fence();
    issue_ss<D, kRows>(s, base + L::kQ, k_t);    // S = Q K^T
    hp::wgmma_commit();
    issue_ss<D, kRows>(dp, base + L::kDO, v_t);  // dP = dO V^T
    hp::wgmma_commit();
    hp::wgmma_wait<1>();  // S is in: P while dP runs
    hp::fence_regs(s);
    dq_p(s, st, sl2);
    hp::fence_regs(s);
    hp::wgmma_wait<0>();
    hp::fence_regs(dp);
    const int k0 = it * kRows;
    if (pair_masked(sh, k0, q0, kRows))
      dq_ds<true>(s, dp, st, sh, q0 + r0, k0, cq);
    else
      dq_ds<false>(s, dp, st, sh, q0 + r0, k0, cq);
    uint32_t da[kRows / 16][4];
    pack_weights<kRows>(s, da);
    hp::fence_regs(acc);
    hp::wgmma_fence();
    issue_pv<D, kRows>(acc, da, k_t);  // dQ += dS K
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) hp::fence_regs(da[kk]);
    __syncwarp();
    if (lane == 0) hp::mbar_arrive(empty + 8 * stg);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int q = q0 + r0 + 8 * i;
    if (q >= sh.S_q) continue;
    bf16* row = dq + ((static_cast<int64_t>(b) * sh.S_q + q) * sh.H + h) * dh;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      if (!kAnyD || 8 * n < dh)
        *reinterpret_cast<__nv_bfloat162*>(row + 8 * n + 2 * cq) =
            __floats2bfloat162_rn(acc[4 * n + 2 * i] * sh.scale,
                                  acc[4 * n + 2 * i + 1] * sh.scale);
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA-core bodies, scalar FMAs on f32 tiles
// ---------------------------------------------------------------------------
constexpr int kThreads = 256;  // 16 x 16: ty = tid / 16, tx = tid % 16
constexpr int kDCols = kMaxD / 16;  // accumulator columns a thread owns
constexpr int kPStride = kRows + 1;

// rows [r0, r0 + 64) of head h of a (B, S, Hx, D) tensor into a 64 x D
// f32 tile of row stride D + 1; rows past S are zeros
__device__ void load_tile(float* dst, const float* __restrict__ src, int b,
                          int h, int r0, int S, int Hx, int D) {
  for (int idx = threadIdx.x; idx < kRows * D; idx += kThreads) {
    const int r = idx / D, d = idx - r * D;
    const int row = r0 + r;
    dst[r * (D + 1) + d] =
        row < S ? src[((static_cast<int64_t>(b) * S + row) * Hx + h) * D + d]
                : 0.f;
  }
}

// s[r][c] = A[ty + 16 r] . X[tx + 16 c] and p[r][c] = A2[ty + 16 r] .
// X2[tx + 16 c] (Q and K: S; dO and V: dP)
__device__ __forceinline__ void tile_products(const float* A, const float* X,
                                              const float* A2,
                                              const float* X2, int D,
                                              float (&s)[4][4],
                                              float (&p)[4][4]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int sd = D + 1;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[r][c] = p[r][c] = 0.f;
  for (int d = 0; d < D; ++d) {
    float a[4], x[4], a2[4], x2[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      a[r] = A[(ty + 16 * r) * sd + d];
      a2[r] = A2[(ty + 16 * r) * sd + d];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      x[c] = X[(tx + 16 * c) * sd + d];
      x2[c] = X2[(tx + 16 * c) * sd + d];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = fmaf(a[r], x[c], s[r][c]);
        p[r][c] = fmaf(a2[r], x2[c], p[r][c]);
      }
  }
}

// P and dS of one (query tile, key tile) pair into shared memory, rows
// ty + 16 r and keys tx + 16 c of the thread's fragment, from the rows'
// statistics: P = 2^(s - m) / l with a masked score NEG_INF
__device__ __forceinline__ void form_p_ds(const Shape& s,
                                          const float (&dots)[4][4],
                                          const float (&dp)[4][4], int q0,
                                          int k0,
                                          const float4* __restrict__ rows,
                                          int64_t row0, float* Ps,
                                          float* dSs) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float sl2 = s.scale * kLog2e;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + ty + 16 * r;
    const bool row_ok = i < s.S_q;
    const float4 st =
        row_ok ? rows[row0 + i] : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = k0 + tx + 16 * c;
      float p = 0.f, ds = 0.f;
      if (row_ok && j < s.S_kv) {
        const bool vis = visible(s, i, j);
        p = exp2f((vis ? dots[r][c] * sl2 : repro::kNegInf) - st.x) * st.y;
        if (vis) ds = p * (dp[r][c] - st.z);
      }
      Ps[(ty + 16 * r) * kPStride + tx + 16 * c] = p;
      dSs[(ty + 16 * r) * kPStride + tx + 16 * c] = ds;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    dkdv_f32_kernel(Shape s, const float* __restrict__ q,
                    const float* __restrict__ k, const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float4* __restrict__ rows, float* __restrict__ dk,
                    float* __restrict__ dv) {
  extern __shared__ float smem[];
  const int D = s.D, sd = D + 1;
  float* Ks = smem;
  float* Vs = Ks + kRows * sd;
  float* Qs = Vs + kRows * sd;
  float* dOs = Qs + kRows * sd;
  float* Ps = dOs + kRows * sd;
  float* dSs = Ps + kRows * kPStride;
  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int G = s.H / s.Hkv;
  const int k0 = kt * kRows, k1 = min(k0 + kRows, s.S_kv);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int n_qt = (s.S_q + kRows - 1) / kRows;

  load_tile(Ks, k, b, hk, k0, s.S_kv, s.Hkv, D);
  load_tile(Vs, v, b, hk, k0, s.S_kv, s.Hkv, D);
  // dK / dV of keys tx + 16 c, columns ty + 16 r
  float acc_k[4][kDCols], acc_v[4][kDCols];
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int r = 0; r < kDCols; ++r) acc_k[c][r] = acc_v[c][r] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const int64_t row0 = (static_cast<int64_t>(b) * s.H + h) * s.S_pad;
    const int qt_first = s.causal ? k0 / kRows : 0;
    for (int qt = qt_first; qt < n_qt; ++qt) {
      const int q0 = qt * kRows, q1 = min(q0 + kRows, s.S_q);
      if (!tile_needed(s, q0, q1, k0, k1)) continue;
      __syncthreads();  // the last tile's readers are done
      load_tile(Qs, q, b, h, q0, s.S_q, s.H, D);
      load_tile(dOs, dout, b, h, q0, s.S_q, s.H, D);
      __syncthreads();
      float dots[4][4], dp[4][4];
      tile_products(Qs, Ks, dOs, Vs, D, dots, dp);
      form_p_ds(s, dots, dp, q0, k0, rows, row0, Ps, dSs);
      __syncthreads();
      for (int i = 0; i < kRows; ++i) {
        float p[4], ds[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          p[c] = Ps[i * kPStride + tx + 16 * c];
          ds[c] = dSs[i * kPStride + tx + 16 * c];
        }
#pragma unroll
        for (int r = 0; r < kDCols; ++r) {
          const int d = ty + 16 * r;
          if (d < D) {
            const float o = dOs[i * sd + d], qq = Qs[i * sd + d];
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              acc_v[c][r] = fmaf(p[c], o, acc_v[c][r]);
              acc_k[c][r] = fmaf(ds[c], qq, acc_k[c][r]);
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int j = k0 + tx + 16 * c;
    if (j >= s.S_kv) continue;
    const int64_t base = ((static_cast<int64_t>(b) * s.S_kv + j) * s.Hkv
                          + hk) * D;
#pragma unroll
    for (int r = 0; r < kDCols; ++r) {
      const int d = ty + 16 * r;
      if (d < D) {
        dk[base + d] = acc_k[c][r] * s.scale;
        dv[base + d] = acc_v[c][r];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    dq_f32_kernel(Shape s, const float* __restrict__ q,
                  const float* __restrict__ k, const float* __restrict__ v,
                  const float* __restrict__ dout,
                  const float4* __restrict__ rows, float* __restrict__ dq) {
  extern __shared__ float smem[];
  const int D = s.D, sd = D + 1;
  float* Qs = smem;
  float* dOs = Qs + kRows * sd;
  float* Ks = dOs + kRows * sd;
  float* Vs = Ks + kRows * sd;
  float* Ps = Vs + kRows * sd;
  float* dSs = Ps + kRows * kPStride;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (s.H / s.Hkv);
  const int q0 = qt * kRows, q1 = min(q0 + kRows, s.S_q);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int64_t row0 = (static_cast<int64_t>(b) * s.H + h) * s.S_pad;

  load_tile(Qs, q, b, h, q0, s.S_q, s.H, D);
  load_tile(dOs, dout, b, h, q0, s.S_q, s.H, D);
  // dQ of rows tx + 16 c, columns ty + 16 r
  float acc[4][kDCols];
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int r = 0; r < kDCols; ++r) acc[c][r] = 0.f;
  int t0, t1;
  key_tiles(s, q0, q1, &t0, &t1);
  for (int kt = t0; kt < t1; ++kt) {
    const int k0 = kt * kRows;
    __syncthreads();
    load_tile(Ks, k, b, hk, k0, s.S_kv, s.Hkv, D);
    load_tile(Vs, v, b, hk, k0, s.S_kv, s.Hkv, D);
    __syncthreads();
    float dots[4][4], dp[4][4];
    tile_products(Qs, Ks, dOs, Vs, D, dots, dp);
    form_p_ds(s, dots, dp, q0, k0, rows, row0, Ps, dSs);
    __syncthreads();
    for (int j = 0; j < kRows; ++j) {
      float ds[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) ds[c] = dSs[(tx + 16 * c) * kPStride + j];
#pragma unroll
      for (int r = 0; r < kDCols; ++r) {
        const int d = ty + 16 * r;
        if (d < D) {
          const float kk = Ks[j * sd + d];
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[c][r] = fmaf(ds[c], kk, acc[c][r]);
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int i = q0 + tx + 16 * c;
    if (i >= s.S_q) continue;
    const int64_t base = ((static_cast<int64_t>(b) * s.S_q + i) * s.H + h)
                         * D;
#pragma unroll
    for (int r = 0; r < kDCols; ++r) {
      const int d = ty + 16 * r;
      if (d < D) dq[base + d] = acc[c][r] * s.scale;
    }
  }
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------
constexpr int kMaxKernels = 3;  // kernels a call launches

using KernelTimes = repro::KernelTimes<kMaxKernels>;

template <typename T>
cudaError_t launch_rows(const Shape& s, const void* o, const void* dout,
                        const float* stats, float4* rows, KernelTimes& t) {
  const int64_t n = static_cast<int64_t>(s.B) * s.H * s.S_pad;
  cudaError_t err = t.mark();
  if (err != cudaSuccess) return err;
  rows_kernel<T><<<static_cast<unsigned>((n + kRowsPerBlock - 1) /
                                         kRowsPerBlock),
                   kRowsPerBlock * 16, 0, t.stream>>>(
      s, static_cast<const T*>(o), static_cast<const T*>(dout), stats, rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return t.mark();
}

cudaError_t launch_f32(const Shape& s, const void* q, const void* k,
                       const void* v, const void* o, const void* dout,
                       void* dq, void* dk, void* dv, const float* stats,
                       float4* rows, KernelTimes& t) {
  const int n_qt = (s.S_q + kRows - 1) / kRows;
  const int n_kt = (s.S_kv + kRows - 1) / kRows;
  const size_t tile = static_cast<size_t>(kRows) * (s.D + 1) * sizeof(float);
  const size_t ptile = static_cast<size_t>(kRows) * kPStride * sizeof(float);
  const size_t smem = 4 * tile + 2 * ptile;
  cudaError_t err;
  if ((err = repro::set_smem(dkdv_f32_kernel, smem)) != cudaSuccess ||
      (err = repro::set_smem(dq_f32_kernel, smem)) != cudaSuccess ||
      (err = launch_rows<float>(s, o, dout, stats, rows, t)) != cudaSuccess)
    return err;
  const float* qq = static_cast<const float*>(q);
  const float* kk = static_cast<const float*>(k);
  const float* vv = static_cast<const float*>(v);
  const float* gg = static_cast<const float*>(dout);
  dkdv_f32_kernel<<<dim3(n_kt, s.Hkv, s.B), kThreads, smem, t.stream>>>(
      s, qq, kk, vv, gg, rows, static_cast<float*>(dk),
      static_cast<float*>(dv));
  if ((err = cudaGetLastError()) != cudaSuccess ||
      (err = t.mark()) != cudaSuccess)
    return err;
  dq_f32_kernel<<<dim3(n_qt, s.H, s.B), kThreads, smem, t.stream>>>(
      s, qq, kk, vv, gg, rows, static_cast<float*>(dq));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return t.mark();
}

// D: the tile layout's head dim; s.D the real one (equal unless kAnyD).
// plan_rows: the query rows a stage that the plan's tiles count in
// (BwdPlan.rows); it must be the layout's QN.
template <int D, bool kAnyD>
cudaError_t launch_bf16(const Shape& s, const void* q, const void* k,
                        const void* v, const void* o, const void* dout,
                        void* dq, void* dk, void* dv, const float* stats,
                        float4* rows, const int* plan, int blocks,
                        int plan_rows, KernelTimes& t) {
  using KL = DkdvLayout<D>;
  using QL = DqLayout<D>;
  if (plan_rows != KL::QN) return cudaErrorInvalidValue;
  const CUtensorMapSwizzle swizzle = KL::kSwizzle == 128
                                         ? CU_TENSOR_MAP_SWIZZLE_128B
                                         : CU_TENSOR_MAP_SWIZZLE_64B;
  // dK/dV: Q and dO in QN-row boxes, K and V in 64-row boxes; dQ: all
  // four in 64-row boxes
  CUtensorMap q_map, do_map, q64_map, do64_map, k_map, v_map;
  cudaError_t err = cudaSuccess;
  const struct {
    CUtensorMap* map;
    const void* ptr;
    int S, heads, rows;
  } maps[] = {{&q_map, q, s.S_q, s.H, KL::QN},
              {&do_map, dout, s.S_q, s.H, KL::QN},
              {&q64_map, q, s.S_q, s.H, kRows},
              {&do64_map, dout, s.S_q, s.H, kRows},
              {&k_map, k, s.S_kv, s.Hkv, kRows},
              {&v_map, v, s.S_kv, s.Hkv, kRows}};
  for (const auto& m : maps)
    if (err == cudaSuccess)
      err = hp::encode_bshd(m.map, m.ptr, s.B, m.S, m.heads, s.D, m.rows,
                            KL::kAtom, swizzle);
  if (err != cudaSuccess) return err;
  const size_t kv_smem = KL::kBytes + 1024;  // + slack to align the base
  const size_t q_smem = QL::kBytes + 1024;
  if ((err = repro::set_smem(dkdv_kernel<D, kAnyD>, kv_smem)) != cudaSuccess ||
      (err = repro::set_smem(dq_kernel<D, kAnyD>, q_smem)) != cudaSuccess ||
      (err = launch_rows<bf16>(s, o, dout, stats, rows, t)) != cudaSuccess)
    return err;
  const float sl2 = s.scale * kLog2e;
  dkdv_kernel<D, kAnyD><<<blocks, KL::kThreads, kv_smem, t.stream>>>(
      q_map, do_map, k_map, v_map, rows, plan, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), s, sl2);
  if ((err = cudaGetLastError()) != cudaSuccess ||
      (err = t.mark()) != cudaSuccess)
    return err;
  const dim3 grid(s.B * s.H, (s.S_q + kRows - 1) / kRows);
  dq_kernel<D, kAnyD><<<grid, QL::kThreads, q_smem, t.stream>>>(
      q64_map, do64_map, k_map, v_map, rows, static_cast<bf16*>(dq), s,
      sl2);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return t.mark();
}

cudaError_t launch_all(const repro::Args& a, const Shape& s,
                       KernelTimes& t) {
  const float* stats = static_cast<const float*>(a.ptr(10));
  float4* rows = static_cast<float4*>(a.ptr(11));
  const int* plan = static_cast<const int*>(a.ptr(12));
  const int blocks = a.i32(22), plan_rows = a.i32(23);
  const int dtype = a.i32(1);
  if (dtype == REPRO_F32)
    return launch_f32(s, a.ptr(2), a.ptr(3), a.ptr(4), a.ptr(5), a.ptr(6),
                      a.ptr(7), a.ptr(8), a.ptr(9), stats, rows, t);
  if (dtype != REPRO_BF16 || plan == nullptr || blocks <= 0)
    return cudaErrorInvalidValue;
#define REPRO_ARGS                                                        \
  s, a.ptr(2), a.ptr(3), a.ptr(4), a.ptr(5), a.ptr(6), a.ptr(7), a.ptr(8), \
      a.ptr(9), stats, rows, plan, blocks, plan_rows, t
  switch (s.D) {
    case 32:
      return launch_bf16<32, false>(REPRO_ARGS);
    case 64:
      return launch_bf16<64, false>(REPRO_ARGS);
    case 128:
      return launch_bf16<128, false>(REPRO_ARGS);
    default:
      if (s.D < 64) return launch_bf16<64, true>(REPRO_ARGS);
      return launch_bf16<128, true>(REPRO_ARGS);
  }
#undef REPRO_ARGS
}

}  // namespace

// Packed arguments (common.cuh: Args), in order: device, dtype, q, k, v,
// o, dout, dq, dk, dv, stats (the forward's (m, l), (B, S_q, H, 2) f32),
// rows (workspace of B * H * S_pad float4), plan (bf16: the int32 plan
// of plan_bwd on the device), B, S_q, S_kv, H, Hkv, D, causal, window,
// scale (double), blocks (bf16: the plan's blocks), plan_rows (bf16: the
// query rows a stage the plan was cut for; a mismatch with the compiled
// layout is refused), times (0, or a host array of kMaxKernels + 1 floats
// that the call fills with the kernels it launched and each one's device
// milliseconds, waiting for them: KernelTimes), stream.
extern "C" int repro_flash_attention_bwd(const void* packed) {
  const repro::Args a(packed);
  cudaError_t err = repro::use_device(a.i32(0));
  if (err != cudaSuccess) return err;
  Shape s;
  s.B = a.i32(13);
  s.S_q = a.i32(14);
  s.S_kv = a.i32(15);
  s.H = a.i32(16);
  s.Hkv = a.i32(17);
  s.D = a.i32(18);
  s.causal = a.i32(19);
  s.window = a.i32(20);
  s.scale = a.f32(21);
  s.S_pad = (s.S_q + kRows - 1) / kRows * kRows;
  if (s.B <= 0 || s.S_q <= 0 || s.S_kv <= 0 || s.Hkv <= 0 ||
      s.H % s.Hkv != 0 || s.D <= 0 || s.D > kMaxD || s.D % 8 != 0 ||
      s.window < 0)
    return cudaErrorInvalidValue;
  KernelTimes t{static_cast<float*>(a.ptr(24)),
                static_cast<cudaStream_t>(a.ptr(25))};
  return t.finish(launch_all(a, s, t));
}
