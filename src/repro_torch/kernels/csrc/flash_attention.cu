// Flash attention with a runtime query offset: the chunked prefill's
// causal attention and the encoder's full attention.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:85
// flash_attention_pallas (body _kernel): q (B, S_q, H, D), k and v
// (B, S_kv, Hkv, D), query head h reads kv head h / G (any group size G),
// masks kv_pos <= q_offset + q_pos when causal, kv_pos > q_pos - window
// when window > 0 (window keys, the row's own included) and kv_pos < S_kv,
// keeps the online softmax in f32 with NEG_INF = -1e30, rounds the weights
// to the value dtype before P.V and divides by max(l, 1e-30) at the end.
// q_offset and window are kernel arguments, so one build serves every
// chunk start and window.
//
// What bounds it on the H100.  Attention does 4 * D flops for each
// (query, visible key) pair on 2 * D bytes of K and V per key: the
// encoder's 1024 x 1024 at D 64 is some 500 flops per byte of HBM, the
// qwen2 chunk (128 queries over <= 896 keys, GQA 7) ~200, so both are
// bound by the tensor cores' 989 TFLOP/s in bf16, not by the 3.35 TB/s.
// Measured (PERF.md): at the encoder shape the kernel runs at about a
// third of that bound, paced by the softmax, whose exp2 per score on the
// 16-a-clock special-function pipe takes about as long as the tile's two
// products; at the chunk shape the device work is a few microseconds and
// the call's host work sets the pace.
//
// bf16: warp-specialised wgmma kernel (flash_wgmma_kernel).
//   * A block has NC consumer warpgroups (1 or 2; the host picks 2 where
//     128-row tiles still fill the 132 SMs: K and V are then read once for
//     128 query rows) and one producer warp.  Each consumer warpgroup owns
//     64 query rows.
//   * The producer keeps K and V tiles of KN keys x D (KN 128, or 64 where
//     the key range is split) in flight with TMA into a ring of kStages
//     stages, a full and an empty mbarrier per stage; Q is loaded once per
//     block.  The tensor maps are 4-D over (D, H, S, B), so a box of
//     (<= 64, 1, rows, 1) reads one head's rows of the (B, S, H, D) layout
//     as it stands, and rows past S arrive as zeros.  Each box lands in
//     shared memory with the 128-byte swizzle (64-byte for D 32) that the
//     wgmma descriptors name; D 128 is two boxes of 64 columns.
//   * S = Q.K^T is a wgmma with both operands in shared memory (K-major)
//     and the f32 accumulator in registers; the softmax runs on that
//     fragment (row max and sum through quad shuffles, four independent
//     chains a row), with log2(e) folded into the scale so that weights
//     are 2^(s - m) (ex2.approx); P is rounded to bf16 in registers and
//     fed as the A operand of O += P.V, a wgmma with V read from shared
//     memory in its natural (keys x D) layout through the transposed-B
//     form.
//   * Overlap: a warpgroup issues S_i and P_{i-1}.V_{i-1} together and
//     runs the softmax of S_i while the second product runs; the two
//     warpgroups of a block take turns to issue (named barriers), so one's
//     softmax runs beside the other's products.
//   * Causal work: key tiles past a block's horizon,
//     q_offset + min(q0 + rows, S_q), are not loaded; only tiles that
//     cross the diagonal or the ragged S_kv edge take the mask
//     arithmetic.  A warpgroup skips the compute of tiles past its own
//     horizon.
//   * Sliding window: key tiles before the block's first visible key,
//     q_offset + q0 - window + 1 (first_key), are not loaded either, and
//     a warpgroup skips the tiles before its own first key (64 keys later
//     for the second warpgroup: at most one 128-key tile, which it waits
//     for and releases before its first turn).  Tiles that hold a row's
//     lower edge take the mask arithmetic.  A 64-row fragment's edges
//     span 63 keys, so the first tile or two of a window are wholly
//     masked for some rows: their scores are the finite NEG_INF, and the
//     first unmasked tile's alpha = 2^(NEG_INF - m) wipes what they
//     summed, as in the Pallas body.  A row that sees no key at all
//     (q_pos - window + 1 >= S_kv) averages every key, as the Pallas
//     body's does: a block holding one reads every tile, and keys past
//     S_kv score -inf so that they weigh nothing even there.  The window
//     is a template flag chosen at launch (window > 0), so that calls
//     without one run no window arithmetic.
//   * Split-KV: where the q tiles alone give fewer than 132 blocks (one
//     qwen2 chunk is 2 x 14 tiles of 64 rows), the host splits the key
//     range into `splits` ranges of `tiles_per_split` tiles of 64 keys,
//     from shapes only, counted from the launch's first key tile (the
//     window's lower edge for the chunk's first row).  Each split writes
//     its partial (m, l, acc) in f32 to a workspace and
//     combine_splits_kernel (common.cuh) merges them.
//   * Row statistics for training: with a statistics buffer the kernel
//     also writes each row's final (m, l), f32, (B, S_q, H, 2), in its log2
//     domain (m the largest score times scale log2 e, a masked score
//     NEG_INF itself; l the sum of 2^(s - m)), and the split combine
//     writes the merged pair; the backward (flash_attention_bwd.cu)
//     rebuilds the weights 2^(s - m) / l from them.  Whether to write them
//     is a template flag chosen at launch (kStats), so that inference
//     calls, which pass no buffer, run the code they ran before.
// f32: the CUDA-core body of the first version (flash_fwd_kernel<float>),
//   chosen by dtype at every call.  It is not a fallback: the f32 path
//   serves the correctness checks held to 1e-4 (kernel) and 1e-3 (the
//   seamless and zamba2 models in f32), which TF32 tensor-core products
//   would miss.
// Head dims: any D with D % 8 == 0 and D <= 128.  f32 has one body for
//   every D, with D a run-time argument.  bf16 has compiled forms for
//   D 32, 64 and 128; any other D (phi3's 96, zamba2's 112) runs a
//   run-time-D form (kAnyD): the D 64 (D <= 64) or D 128 instantiation with
//   the tensor maps spanning the real D, so TMA writes zeros into columns
//   D .. 63 / 127 of every Q, K and V box, as it does for rows past S.
//   Zeros add nothing to Q.K^T; the P.V columns past D are never stored,
//   and the epilogue, the split workspace and the combine stride by the
//   real D.  A row of D % 8 == 0 columns is whole 16-byte units, which
//   the tensor maps' strides need.  The form runs one consumer warpgroup
//   (the two-warpgroup D 128 form spills) over key tiles of 64, so that
//   two blocks share an SM.
#include "common.cuh"
#include "flash_tiles.cuh"
#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// f32: 32 query rows per block over 128 threads, scalar f32 FMAs
// ---------------------------------------------------------------------------

constexpr int kThreads = 128;
constexpr int kBlockQ = 32;
constexpr int kBlockK = 64;

constexpr size_t smem_floats(int d) {
  return (kBlockQ + 2 * kBlockK) * (d + 1) + kBlockQ * (kBlockK + 1);
}

// The first key that query rows at positions [lo, hi] may see: the
// window's lower edge for the first row, or 0 without a window.  Where
// the last row sees no key at all (hi - window + 1 >= S_kv) it is 0 too:
// that row averages every key, as the Pallas body's fully masked rows do.
__device__ __forceinline__ int first_key(int lo, int hi, int window,
                                         int S_kv) {
  return window > 0 && hi - window + 1 < S_kv ? max(0, lo - window + 1) : 0;
}

// The score of a key past S_kv: -inf, so that it weighs 0 even in a row
// whose every key is masked (the Pallas body has no such keys: its key
// blocks divide S_kv).  Masked keys keep the finite NEG_INF, so that a
// wholly masked tile's weights are later wiped by alpha, never NaN.
__device__ __forceinline__ float pad_score() {
  return __int_as_float(static_cast<int>(0xff800000u));
}

// the accumulator is sized for the largest head dim; dh is the real one
constexpr int kMaxD = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q,  // (B, S_q, H, D)
                     const T* __restrict__ k,  // (B, S_kv, Hkv, D)
                     const T* __restrict__ v,  // (B, S_kv, Hkv, D)
                     T* __restrict__ out,      // (B, S_q, H, D)
                     float* __restrict__ stats,  // (B, S_q, H, 2) or null
                     int S_q, int S_kv, int H, int Hkv, int q_offset,
                     int causal, int window, float scale, int dh) {
  const int LD = dh + 1;
  constexpr int LP = kBlockK + 1;
  constexpr int KPT = kBlockK / 4;  // score columns per thread
  constexpr int DPT = kMaxD / 4;    // output columns per thread

  extern __shared__ float smem[];
  float* qs = smem;                 // kBlockQ * LD
  float* ks = qs + kBlockQ * LD;    // kBlockK * LD
  float* vs = ks + kBlockK * LD;    // kBlockK * LD
  float* ps = vs + kBlockK * LD;    // kBlockQ * LP

  const int iq = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int r = tid >> 2;
  const int c = tid & 3;
  const int q0 = iq * kBlockQ;

  const int64_t q_tok = static_cast<int64_t>(H) * dh;
  const int64_t kv_tok = static_cast<int64_t>(Hkv) * dh;
  const T* qb = q + static_cast<int64_t>(b) * S_q * q_tok +
                static_cast<int64_t>(h) * dh;
  const T* kb = k + static_cast<int64_t>(b) * S_kv * kv_tok +
                static_cast<int64_t>(hk) * dh;
  const T* vb = v + static_cast<int64_t>(b) * S_kv * kv_tok +
                static_cast<int64_t>(hk) * dh;

  for (int i = tid; i < kBlockQ * dh; i += kThreads) {
    const int rr = i / dh;
    const int d = i - rr * dh;
    const int qi = q0 + rr;
    qs[rr * LD + d] = qi < S_q ? repro::to_float(qb[qi * q_tok + d]) : 0.f;
  }

  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;
  float m = repro::kNegInf;
  float l = 0.f;
  const int q_pos = q_offset + q0 + r;

  const int q_hi = q_offset + min(q0 + kBlockQ, S_q) - 1;  // last row's
  int kv_end = S_kv;
  if (causal) kv_end = min(S_kv, q_hi + 1);
  const int n_tiles = (kv_end + kBlockK - 1) / kBlockK;
  const int t_first = first_key(q_offset + q0, q_hi, window, S_kv) / kBlockK;

  for (int it = t_first; it < n_tiles; ++it) {
    const int k0 = it * kBlockK;
    __syncthreads();  // the previous tile is done with ks / vs
    for (int i = tid; i < kBlockK * dh; i += kThreads) {
      const int t = i / dh;
      const int d = i - t * dh;
      const int kv = k0 + t;
      const bool in = kv < S_kv;
      ks[t * LD + d] = in ? repro::to_float(kb[kv * kv_tok + d]) : 0.f;
      vs[t * LD + d] = in ? repro::to_float(vb[kv * kv_tok + d]) : 0.f;
    }
    __syncthreads();

    float s[KPT];
    float mx = repro::kNegInf;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const int col = c + 4 * j;
      const float* qr = qs + r * LD;
      const float* kr = ks + col * LD;
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < dh; ++d) dot = fmaf(qr[d], kr[d], dot);
      const int kv_pos = k0 + col;
      bool ok = !causal || kv_pos <= q_pos;
      if (window > 0) ok = ok && kv_pos > q_pos - window;
      s[j] = kv_pos >= S_kv ? pad_score()
                            : ok ? dot * scale : repro::kNegInf;
      mx = fmaxf(mx, s[j]);
    }
    // the four lanes of a row are adjacent lanes of one warp
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const float p = expf(s[j] - m_new);
      sum += p;
      ps[r * LP + c + 4 * j] = repro::round_to<T>(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float alpha = expf(m - m_new);
    l = l * alpha + sum;
    m = m_new;
    __syncwarp();  // row r's weights come from lanes of this warp only

    const float* pr = ps + r * LP;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int d = c + 4 * i;
      if (d >= dh) break;
      float o = 0.f;
#pragma unroll 16
      for (int t = 0; t < kBlockK; ++t) o = fmaf(pr[t], vs[t * LD + d], o);
      acc[i] = acc[i] * alpha + o;
    }
  }

  const int qi = q0 + r;
  if (qi < S_q) {
    T* ob = out + static_cast<int64_t>(b) * S_q * q_tok + qi * q_tok +
            static_cast<int64_t>(h) * dh;
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      if (c + 4 * i >= dh) break;
      ob[c + 4 * i] = repro::from_float<T>(acc[i] / denom);
    }
    // the row's statistics in the log2 domain of the bf16 kernel: a row
    // that sees no key keeps m = NEG_INF, as its masked scores do there
    if (stats != nullptr && c == 0) {
      float* st = stats + ((static_cast<int64_t>(b) * S_q + qi) * H + h) * 2;
      st[0] = m == repro::kNegInf ? m : m * repro::flash::kLog2e;
      st[1] = l;
    }
  }
}

cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out,
                       float* stats, int B, int S_q, int S_kv, int H,
                       int Hkv, int d, int q_offset, int causal, int window,
                       float scale, cudaStream_t stream) {
  const size_t smem = smem_floats(d) * sizeof(float);
  cudaError_t err = repro::set_smem(flash_fwd_kernel<float>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S_q + kBlockQ - 1) / kBlockQ, H, B);
  flash_fwd_kernel<float><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), stats, S_q,
      S_kv, H, Hkv, q_offset, causal, window, scale, d);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: warpgroup MMA fed by TMA
// ---------------------------------------------------------------------------
namespace hp = repro::hopper;
using bf16 = __nv_bfloat16;
using namespace repro::flash;

constexpr int kRows = 64;    // query rows per consumer warpgroup

template <int D, int NC, int KN>
struct FlashLayout : TileSwizzle<D> {
  static constexpr uint32_t kQBytes = NC * kRows * D * 2;
  static constexpr uint32_t kTileBytes = KN * D * 2;
  // K / V ring depth: two stages where two blocks share an SM (NC 1);
  // a third where two warpgroups share the ring and drift apart by a tile
  static constexpr int kStages = NC == 1 ? 2 : 3;
  // offsets from a 1024-byte aligned base (the swizzle atom's period)
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kK = kQ + kQBytes;
  static constexpr uint32_t kV = kK + kStages * kTileBytes;
  static constexpr uint32_t kBars = kV + kStages * kTileBytes;
  static constexpr uint32_t kBytes = kBars + (2 * kStages + 1) * 8;
  static constexpr int kThreads = NC * 128 + 32;
  static_assert(kBytes + 1024 <= 232448, "shared memory per block");
};

// S = Q . K^T for one 64-row query tile and one key tile (D / 16 steps)
template <int D, int KN>
__device__ __forceinline__ void issue_s(float (&s)[KN / 2], uint32_t q_tile,
                                        uint32_t k_tile) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t a = kmajor_desc<D>(q_tile, kRows, kk);
    const uint64_t b = kmajor_desc<D>(k_tile, KN, kk);
    if constexpr (KN == 128)
      hp::wgmma_ss_m64n128k16(s, a, b, kk > 0);
    else
      hp::wgmma_ss_m64n64k16(s, a, b, kk > 0);
  }
}

// The online softmax of one 64 x KN score tile held as the accumulator
// fragment (element (r0 + 8 r, k0 + 8 n + 2 cq + e) in s[4 n + 2 r + e]),
// in the log2 domain (scores times scale_log2): update the rows' (m, l),
// leave the weights 2^(s - m) in s and the rescale factors of the old
// state in alpha.  kMask: the tile crosses the diagonal, a row's window
// edge or S_kv; scores of keys outside fragment row r0's visible range
// [lo0, hi0] (row r0 + 8: 8 later) become NEG_INF and keys past S_kv
// -inf; the lower bound lo0 only with kWindow.  The bounds are taken
// relative to the thread's first column, so that each score compares its
// compile-time column offset.  Maxima and sums run as four independent
// chains per row, not one serial chain.
template <int KN, bool kMask, bool kWindow>
__device__ __forceinline__ void online_softmax(
    float (&s)[KN / 2], float (&m)[2], float (&l)[2], float (&alpha)[2], int k0,
    int S_kv, int lo0, int hi0, int cq, float scale_log2) {
  // unmasked tiles scale inside the exponent's FMA; masked ones up front
  const float sc = kMask ? 1.f : scale_log2;
  if constexpr (kMask) {
    const int base = k0 + 2 * cq;  // key of column offset 0
    const int pad = S_kv - base;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int lo = lo0 + 8 * r - base, hi = hi0 + 8 * r - base;
#pragma unroll
      for (int n = 0; n < KN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 8 * n + e;  // key k0 + 2 cq + j
          float& x = s[4 * n + 2 * r + e];
          x = j >= pad                       ? pad_score()
              : (kWindow && j < lo) || j > hi ? repro::kNegInf
                                              : x * scale_log2;
        }
    }
  }
  float mx[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) mx[r][j] = repro::kNegInf;
#pragma unroll
  for (int n = 0; n < KN / 8; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        mx[r][(2 * n + e) & 3] =
            fmaxf(mx[r][(2 * n + e) & 3], s[4 * n + 2 * r + e]);
  float neg_m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float x = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
    // a row's KN scores lie in the four lanes of a quad
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
    const float m_new = fmaxf(m[r], x * sc);
    alpha[r] = hp::ex2(m[r] - m_new);
    m[r] = m_new;
    neg_m[r] = -m_new;
  }
  float sum[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) sum[r][j] = 0.f;
#pragma unroll
  for (int n = 0; n < KN / 8; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * n + 2 * r + e];
        x = hp::ex2(fmaf(x, sc, neg_m[r]));
        sum[r][(2 * n + e) & 3] += x;
      }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float x = (sum[r][0] + sum[r][1]) + (sum[r][2] + sum[r][3]);
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    l[r] = l[r] * alpha[r] + x;
  }
}

// The tile's softmax, with the mask arithmetic only where the tile
// crosses the ragged S_kv edge, the diagonal (a key past diag, the
// warpgroup's first row) or some row's window edge (a key at or before
// edge, the last key its last row's window masks): a uniform branch.
// Without kWindow the branch and the mask are those of a causal kernel
// with no window: no lower bound is held or compared.
template <int KN, bool kWindow>
__device__ __forceinline__ void tile_softmax(
    float (&s)[KN / 2], float (&m)[2], float (&l)[2], float (&alpha)[2], int k0,
    int S_kv, int lo0, int hi0, int diag, int edge, int cq,
    float scale_log2) {
  if (k0 + KN > S_kv || k0 + KN - 1 > diag || (kWindow && k0 <= edge))
    online_softmax<KN, true, kWindow>(s, m, l, alpha, k0, S_kv, lo0, hi0, cq,
                                      scale_log2);
  else
    online_softmax<KN, false, kWindow>(s, m, l, alpha, k0, S_kv, lo0, hi0,
                                       cq, scale_log2);
}

// D: the head dim the tiles are laid out for; with kAnyD the real one,
// d_rt <= D, is a run-time argument (columns past it load as zeros).
// kWindow: the launch has a window (window > 0); without it the window
// argument is not read, so that unwindowed calls run the unwindowed code.
// kStats: the caller asked for the rows' softmax statistics (training's
// forward); without it `stats` is not read, so that inference calls run
// the code they ran before the statistics existed.
template <int D, int NC, int KN, bool kAnyD, bool kWindow, bool kStats>
__global__ void __launch_bounds__(FlashLayout<D, NC, KN>::kThreads)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       bf16* __restrict__ out,      // (B, S_q, H, D)
                       float* __restrict__ ws_acc,  // (splits, B, S_q, H, D)
                       float* __restrict__ ws_ml,   // (splits, B, S_q, H, 2)
                       float* __restrict__ stats,   // (B, S_q, H, 2)
                       int B, int S_q, int S_kv, int H, int Hkv,
                       int q_offset, int causal, int window,
                       float scale_log2, int splits, int tiles_per_split,
                       int d_rt) {
  using L = FlashLayout<D, NC, KN>;
  const int dh = kAnyD ? d_rt : D;
  if constexpr (!kWindow) window = 0;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (hp::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base + L::kQ;
  const uint32_t k_s = base + L::kK;
  const uint32_t v_s = base + L::kV;
  const uint32_t full = base + L::kBars;  // full[i] = full + 8 i
  const uint32_t empty = full + 8 * L::kStages;
  const uint32_t q_bar = empty + 8 * L::kStages;

  const int tid = threadIdx.x;
  const int h = blockIdx.y;
  const int split = blockIdx.z % splits;
  const int b = blockIdx.z / splits;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.x * (NC * kRows);

  // key tiles this block loads: its split's range, cut at the causal
  // horizon of its last row and at the window's edge of its first.  The
  // splits count whole tiles from the launch's first key tile (t_base),
  // as the host's planner does.
  const int q_hi = q_offset + min(q0 + NC * kRows, S_q) - 1;  // last row's
  int kv_end = S_kv;
  if (causal) kv_end = min(S_kv, q_hi + 1);
  const int n_tiles = (kv_end + KN - 1) / KN;
  const int t_base = first_key(q_offset, q_offset + S_q - 1, window, S_kv) / KN;
  const int t_begin = max(first_key(q_offset + q0, q_hi, window, S_kv) / KN,
                          t_base + split * tiles_per_split);
  const int t_end = min(n_tiles, t_base + (split + 1) * tiles_per_split);

  if (tid == 0) {
    for (int i = 0; i < L::kStages; ++i) {
      hp::mbar_init(full + 8 * i, 1);
      hp::mbar_init(empty + 8 * i, NC * 4);  // one arrival per warp
    }
    hp::mbar_init(q_bar, 1);
    hp::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= NC * 128) {  // the producer warp: one lane issues every load
    if (tid == NC * 128 && t_begin < t_end) {
      hp::mbar_expect_tx(q_bar, L::kQBytes);
      for (int c = 0; c < NC; ++c)
        for (int j = 0; j < L::kChunks; ++j)
          hp::tma_load_4d(q_s + (c * L::kChunks + j) * kRows * L::kSwizzle,
                          &q_map, q_bar, j * L::kAtom, h, q0 + c * kRows, b);
      for (int it = t_begin; it < t_end; ++it) {
        const int i = it - t_begin;
        const int st = i % L::kStages;
        const uint32_t phase = (i / L::kStages) & 1;
        hp::mbar_wait(empty + 8 * st, phase ^ 1);  // round 0 passes at once
        hp::mbar_expect_tx(full + 8 * st, 2 * L::kTileBytes);
        for (int j = 0; j < L::kChunks; ++j) {
          const uint32_t off = st * L::kTileBytes + j * KN * L::kSwizzle;
          hp::tma_load_4d(k_s + off, &k_map, full + 8 * st, j * L::kAtom, hk,
                          it * KN, b);
          hp::tma_load_4d(v_s + off, &v_map, full + 8 * st, j * L::kAtom, hk,
                          it * KN, b);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroup c: query rows [qw0, qw0 + 64) ----
  const int c = tid >> 7;
  const int t = tid & 127;
  const int lane = t & 31;
  const int r0 = (t >> 5) * 16 + (lane >> 2);  // fragment rows r0, r0 + 8
  const int cq = lane & 3;                     // fragment column pair
  const int qw0 = q0 + c * kRows;
  // tiles before this warpgroup's first key or past its own horizon are
  // skipped; its first key is the block's rule (first_key over the
  // block's last row), so the second warpgroup starts at most one 128-key
  // tile after the first
  int wg_begin = 0, wg_end = 0, wq_hi = 0;
  if (qw0 < S_q) {
    wq_hi = q_offset + min(qw0 + kRows, S_q) - 1;
    wg_end = n_tiles;
    if (causal) wg_end = (min(S_kv, wq_hi + 1) + KN - 1) / KN;
    wg_begin = first_key(q_offset + qw0, q_hi, window, S_kv) / KN;
  }

  // accumulator fragments: element (row r0 + 8 i, column 8 n + 2 cq + e)
  // of a 64 x N product sits in register 4 n + 2 i + e
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {repro::kNegInf, repro::kNegInf};
  float l[2] = {0.f, 0.f};

  // Tiles [live_begin, live_end) are this warpgroup's to compute; the
  // rest of the block's tiles it only waits for and releases.  The loop
  // keeps two wgmma groups apart: while O += P_{i-1} . V_{i-1} runs on the
  // tensor cores, the softmax of S_i = Q . K_i^T runs on the CUDA cores.
  const int live_begin = max(t_begin, wg_begin);
  const int live_end = min(t_end, wg_end);
  const auto stage = [&](int it) { return (it - t_begin) % L::kStages; };
  const auto wait_full = [&](int it) {
    hp::mbar_wait(full + 8 * stage(it), ((it - t_begin) / L::kStages) & 1);
  };
  const auto release = [&](int it) {
    __syncwarp();
    if (lane == 0) hp::mbar_arrive(empty + 8 * stage(it));
  };
  // Two consumer warpgroups take turns to issue their products (named
  // barriers 1 and 2), so that one's softmax runs while the other's
  // products do.  Each takes t_end - t_begin + 1 turns, empty ones where
  // it has no tile to compute, so that the handshakes pair up.  The
  // tiles before live_begin (one at most, the second warpgroup's) are
  // released before the first turn: with three stages the first
  // warpgroup's turns never wait on them.
  const auto my_turn = [&]() {
    if constexpr (NC == 2) hp::named_bar_sync(1 + c, 256);
  };
  const auto pass_turn = [&]() {
    if constexpr (NC == 2) hp::named_bar_arrive(2 - c, 256);
  };
  if (NC == 2 && c == 1 && t_begin < t_end) pass_turn();  // warpgroup 0 first

  // fragment row r0's visible keys [lo0, hi0] (row r0 + 8: 8 later), and
  // the warpgroup's mask bounds for tile_softmax; "none" lies past every
  // key position either way
  constexpr int kNone = 1 << 30;
  const int q_pos0 = q_offset + qw0 + r0;
  const int lo0 = kWindow ? q_pos0 - window + 1 : -kNone;
  const int hi0 = causal ? q_pos0 : kNone;
  const int diag = causal ? q_offset + qw0 : kNone;
  const int edge = kWindow ? wq_hi - window : -kNone;
  // a warpgroup with no tile to compute (the second of the last block,
  // whose rows lie past S_q) releases its tiles one a turn, below
  const bool idle = live_begin >= live_end;
  if (!idle)
    for (int it = t_begin; it < live_begin; ++it) {
      wait_full(it);
      release(it);
    }
  if (!idle) {
    hp::mbar_wait(q_bar, 0);
    const uint32_t q_wg = q_s + c * (L::kQBytes / NC);
    float s[KN / 2];
    uint32_t pa[KN / 16][4];
    float alpha[2];
#pragma unroll
    for (int j = 0; j < KN / 2; ++j) s[j] = 0.f;

    wait_full(live_begin);
    my_turn();
    hp::fence_regs(s);
    hp::wgmma_fence();
    issue_s<D, KN>(s, q_wg, k_s + stage(live_begin) * L::kTileBytes);
    hp::wgmma_commit();
    pass_turn();
    hp::wgmma_wait<0>();
    hp::fence_regs(s);
    tile_softmax<KN, kWindow>(s, m, l, alpha, live_begin * KN, S_kv, lo0,
                              hi0, diag, edge, cq, scale_log2);
    pack_weights<KN>(s, pa);

    for (int it = live_begin + 1; it < live_end; ++it) {
      wait_full(it);
      my_turn();
      hp::fence_regs(s);
      hp::fence_regs(o);
      hp::wgmma_fence();
      issue_s<D, KN>(s, q_wg, k_s + stage(it) * L::kTileBytes);
      hp::wgmma_commit();
      issue_pv<D, KN>(o, pa, v_s + stage(it - 1) * L::kTileBytes);
      hp::wgmma_commit();
      pass_turn();
      hp::wgmma_wait<1>();  // S_i is in; P_{i-1} . V_{i-1} may still run
      hp::fence_regs(s);
      tile_softmax<KN, kWindow>(s, m, l, alpha, it * KN, S_kv, lo0, hi0, diag,
                                edge, cq, scale_log2);
      // pin the softmax here, ahead of the wait: the compiler would
      // otherwise sink its register-only arithmetic past the wait below
      hp::fence_regs(s);
      hp::fence_regs(l);
      hp::fence_regs(alpha);
      hp::wgmma_wait<0>();
      hp::fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < KN / 16; ++kk) hp::fence_regs(pa[kk]);
      release(it - 1);
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int e = 0; e < 2; ++e) o[4 * n + 2 * r + e] *= alpha[r];
      pack_weights<KN>(s, pa);
    }

    my_turn();
    hp::fence_regs(o);
    hp::wgmma_fence();
    issue_pv<D, KN>(o, pa, v_s + stage(live_end - 1) * L::kTileBytes);
    hp::wgmma_commit();
    pass_turn();
    hp::wgmma_wait<0>();
    hp::fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < KN / 16; ++kk) hp::fence_regs(pa[kk]);
    release(live_end - 1);
  }
  if (t_begin < t_end) {
    const int taken = idle ? 0 : live_end - live_begin + 1;
    for (int k = taken; k < t_end - t_begin + 1; ++k) {
      my_turn();
      pass_turn();
      // an idle warpgroup releases tile k after its turn k: the other
      // one's turn k + 1 waits for tile k + 1, whose stage held tile
      // k + 1 - kStages (kStages >= 2).  Releasing them all after its
      // turns would hold the producer once the block has more tiles than
      // stages, while the other warpgroup waits for its next tile.
      if (idle && t_begin + k < t_end) {
        wait_full(t_begin + k);
        release(t_begin + k);
      }
    }
  }
  if (!idle)
    for (int it = live_end; it < t_end; ++it) {
      wait_full(it);
      release(it);
    }

  // ---- epilogue: rows r0 and r0 + 8 of this warpgroup ----
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = qw0 + r0 + 8 * r;
    if (qi >= S_q) continue;
    const int64_t row = (static_cast<int64_t>(b) * S_q + qi) * H + h;
    // columns 8 n + 2 cq and + 1 lie below dh together (dh % 8 == 0)
    if (splits == 1) {
      const float denom = fmaxf(l[r], 1e-30f);
      bf16* orow = out + row * dh;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        if (!kAnyD || 8 * n < dh)
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n + 2 * cq) =
              __floats2bfloat162_rn(o[4 * n + 2 * r] / denom,
                                    o[4 * n + 2 * r + 1] / denom);
      // (m, l) in the log2 domain: the weights are 2^(s - m) / l
      if (kStats && cq == 0)
        *reinterpret_cast<float2*>(stats + row * 2) = make_float2(m[r], l[r]);
    } else {
      const int64_t srow =
          static_cast<int64_t>(split) * B * S_q * H + row;
      float* arow = ws_acc + srow * dh;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        if (!kAnyD || 8 * n < dh)
          *reinterpret_cast<float2*>(arow + 8 * n + 2 * cq) =
              make_float2(o[4 * n + 2 * r], o[4 * n + 2 * r + 1]);
      if (cq == 0) {
        ws_ml[srow * 2] = m[r];
        ws_ml[srow * 2 + 1] = l[r];
      }
    }
  }
}

// d: the real head dim (D itself unless kAnyD); the tensor maps span it
template <int D, int NC, int KN, bool kAnyD>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        void* out, float* ws, float* stats, int B, int S_q,
                        int S_kv, int H, int Hkv, int d, int q_offset,
                        int causal, int window, float scale, int splits,
                        int tiles_per_split, cudaStream_t stream) {
  using L = FlashLayout<D, NC, KN>;
  const CUtensorMapSwizzle swizzle = L::kSwizzle == 128
                                         ? CU_TENSOR_MAP_SWIZZLE_128B
                                         : CU_TENSOR_MAP_SWIZZLE_64B;
  CUtensorMap q_map, k_map, v_map;
  cudaError_t err = repro::hopper::encode_bshd(&q_map, q, B, S_q, H, d, kRows,
                                               L::kAtom, swizzle);
  if (err == cudaSuccess)
    err = repro::hopper::encode_bshd(&k_map, k, B, S_kv, Hkv, d, KN,
                                     L::kAtom, swizzle);
  if (err == cudaSuccess)
    err = repro::hopper::encode_bshd(&v_map, v, B, S_kv, Hkv, d, KN,
                                     L::kAtom, swizzle);
  if (err != cudaSuccess) return err;
  const size_t smem = L::kBytes + 1024;  // + slack to align the base
  const auto kernel =
      stats != nullptr
          ? (window > 0 ? flash_wgmma_kernel<D, NC, KN, kAnyD, true, true>
                        : flash_wgmma_kernel<D, NC, KN, kAnyD, false, true>)
          : (window > 0 ? flash_wgmma_kernel<D, NC, KN, kAnyD, true, false>
                        : flash_wgmma_kernel<D, NC, KN, kAnyD, false, false>);
  err = repro::set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int64_t rows = static_cast<int64_t>(B) * S_q * H;
  float* ws_acc = ws;
  float* ws_ml = splits > 1 ? ws + splits * rows * d : nullptr;
  const dim3 grid((S_q + NC * kRows - 1) / (NC * kRows), H, B * splits);
  kernel<<<grid, L::kThreads, smem, stream>>>(
      q_map, k_map, v_map, static_cast<bf16*>(out), ws_acc, ws_ml, stats, B,
      S_q, S_kv, H, Hkv, q_offset, causal, window, scale * kLog2e, splits,
      tiles_per_split, d);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return repro::launch_combine<bf16>(ws_acc, ws_ml, static_cast<bf16*>(out),
                                     rows, d, splits, stream, stats);
}

template <int D>
cudaError_t launch_bf16_nc(int consumers, int keys, const void* q,
                           const void* k, const void* v, void* out, float* ws,
                           float* stats, int B, int S_q, int S_kv, int H,
                           int Hkv, int q_offset, int causal, int window,
                           float scale, int splits, int tiles_per_split,
                           cudaStream_t stream) {
#define REPRO_LAUNCH(NC, KN)                                                 \
  if (consumers == NC && keys == KN)                                         \
    return launch_bf16<D, NC, KN, false>(q, k, v, out, ws, stats, B, S_q,    \
                                         S_kv, H, Hkv, D, q_offset, causal,  \
                                         window, scale, splits,              \
                                         tiles_per_split, stream);
  REPRO_LAUNCH(1, 64)   // split key ranges: small tiles, more blocks
  REPRO_LAUNCH(1, 128)
  REPRO_LAUNCH(2, 128)
#undef REPRO_LAUNCH
  return cudaErrorInvalidValue;
}

// the run-time-D form: tiles laid out for DP (64 or 128) columns, one
// consumer warpgroup, key tiles of 64 (two blocks an SM at DP 128)
template <int DP>
cudaError_t launch_bf16_any_d(int consumers, int keys, const void* q,
                              const void* k, const void* v, void* out,
                              float* ws, float* stats, int B, int S_q,
                              int S_kv, int H, int Hkv, int d, int q_offset,
                              int causal, int window, float scale, int splits,
                              int tiles_per_split, cudaStream_t stream) {
  if (consumers != 1 || keys != 64) return cudaErrorInvalidValue;
  return launch_bf16<DP, 1, 64, true>(q, k, v, out, ws, stats, B, S_q, S_kv,
                                      H, Hkv, d, q_offset, causal, window,
                                      scale, splits, tiles_per_split, stream);
}

}  // namespace

static int flash_entry(int device, int dtype, const void* q, const void* k,
                       const void* v, void* out, int B, int S_q, int S_kv,
                       int H, int Hkv, int D, int q_offset, int causal,
                       int window, float scale, int consumers, int keys,
                       int splits, int tiles_per_split, void* workspace,
                       void* stats_out, void* stream) {
  cudaError_t err = repro::use_device(device);
  if (err != cudaSuccess) return err;
  if (B <= 0 || S_q <= 0 || Hkv <= 0 || H % Hkv != 0 || q_offset < 0 ||
      window < 0 || D <= 0 || D > 128 || D % 8 != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* stats = static_cast<float*>(stats_out);
  if (dtype == REPRO_F32)
    return launch_f32(q, k, v, out, stats, B, S_q, S_kv, H, Hkv, D, q_offset,
                      causal, window, scale, s);
  // (consumers, keys) outside the built pairs: the launchers refuse
  if (dtype != REPRO_BF16 || S_kv <= 0 || splits < 1 ||
      tiles_per_split < 1 || static_cast<int64_t>(B) * splits > 65535 ||
      (splits > 1 && workspace == nullptr))
    return cudaErrorInvalidValue;
  float* ws = static_cast<float*>(workspace);
  switch (D) {
    case 32:
      return launch_bf16_nc<32>(consumers, keys, q, k, v, out, ws, stats, B,
                                S_q, S_kv, H, Hkv, q_offset, causal, window,
                                scale, splits, tiles_per_split, s);
    case 64:
      return launch_bf16_nc<64>(consumers, keys, q, k, v, out, ws, stats, B,
                                S_q, S_kv, H, Hkv, q_offset, causal, window,
                                scale, splits, tiles_per_split, s);
    case 128:
      return launch_bf16_nc<128>(consumers, keys, q, k, v, out, ws, stats, B,
                                 S_q, S_kv, H, Hkv, q_offset, causal, window,
                                 scale, splits, tiles_per_split, s);
    default:
      if (D < 64)
        return launch_bf16_any_d<64>(consumers, keys, q, k, v, out, ws,
                                     stats, B, S_q, S_kv, H, Hkv, D,
                                     q_offset, causal, window, scale, splits,
                                     tiles_per_split, s);
      return launch_bf16_any_d<128>(consumers, keys, q, k, v, out, ws, stats,
                                    B, S_q, S_kv, H, Hkv, D, q_offset, causal,
                                    window, scale, splits, tiles_per_split,
                                    s);
  }
}

// Packed arguments (common.cuh: Args), in order: device, dtype, q, k, v, out,
// B, S_q, S_kv, H, Hkv, D, q_offset, causal, window, scale (double),
// consumers, keys, splits, tiles_per_split, workspace, stats (the rows'
// (m, l) in f32, (B, S_q, H, 2), or 0 where the caller wants none), stream.
extern "C" int repro_flash_attention(const void* packed) {
  const repro::Args a(packed);
  return flash_entry(a.i32(0), a.i32(1), a.ptr(2), a.ptr(3), a.ptr(4),
                     a.ptr(5), a.i32(6), a.i32(7), a.i32(8), a.i32(9),
                     a.i32(10), a.i32(11), a.i32(12), a.i32(13), a.i32(14),
                     a.f32(15), a.i32(16), a.i32(17), a.i32(18), a.i32(19),
                     a.ptr(20), a.ptr(21), a.ptr(22));
}
