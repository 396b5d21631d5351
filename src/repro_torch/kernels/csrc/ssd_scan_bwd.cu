// Mamba2 SSD chunked scan, backward pass: dx, ddt, da, dB, dC and dd of
// what ssd_scan.cu computes, for training through it.
//
// Replaces no TPU kernel: the JAX package has no backward kernel and trains
// mamba2 and zamba2 by differentiating its plain scan (repro/kernels/ref.py
// ssd_chunk_scan).  The forward is repro/kernels/ssd_scan.py:83
// ssd_chunk_scan_pallas, ported as ssd_scan.cu; this is the gradient of
// that function.  It exists because the port sends no CUDA tensor to a
// plain version: without a backward kernel a training step on the card has
// no route through the SSD layers (kernels/ssd_scan.py: SSDChunkScan).
//
// The function (one B/C group, no initial state).  Per chunk of L <= 128
// tokens, with cum = cumsum(dt a), E_ij = e^{cum_i - cum_j} for j <= i and
// 0 above (a select, as in the forward: above the diagonal the exponent
// can overflow, and inf times a zero mask is NaN), CB_ij = C_i . B_j,
// Q_ij = dy_i . x_j, u_j = e^{total - cum_j} dt_j, S the state entering the
// chunk and G the gradient of the state leaving it:
//   dx_j  = dt_j sum_i CB_ij E_ij dy_i + u_j G B_j + d dy_j
//   dB_j  = sum_h [dt_j sum_i E_ij Q_ij C_i + u_j G^T x_j]
//   dC_i  = sum_h [sum_j E_ij dt_j Q_ij B_j + e^{cum_i} S^T dy_i]
//   ddt_j = sum_i W_ij + V_j + a dda_j,  W_ij = CB_ij E_ij Q_ij,
//           V_j = e^{total - cum_j} x_j^T G B_j,
//   dcum_i = sum_j dt_j W_ij - dt_i sum_k W_ki + dy_i . y_inter_i
//            - dt_i V_i (+ e^{total} <G, S> + sum_j dt_j V_j, the gradient
//            of total, at the chunk's last row), dda its reverse cumsum,
//   G of the chunk before = e^{total} G + sum_i e^{cum_i} dy_i (x) C_i,
// with G of the last chunk the final state's cotangent (0 if none).  da
// and dd sum over batch and sequence, da pairwise: the gaps cdt_i - cdt_j
// (cdt = cumsum(dt)) times each pair's term, where the sum of dt dda
// would cancel its row and column terms to rounding
// (kernels/ref.py: ssd_chunk_scan_bwd is the same formula in PyTorch).
//
// What bounds it on the H100.  At mamba2's train shape (B 2, S 4096, H 80,
// P 64, N 128, L 128) the least work is the chunk's products: scores C.B
// once a chunk (shared by the heads), Q, the intra products for dx, dB and
// dC, the inter and state products for dC, dB, dx, the states and their
// gradients, ~1e11 flops (0.1 ms on the bf16 tensor cores); the bytes, x,
// dy, dx, B, C, dB, dC once and dt, ddt in f32, ~0.2 GB (0.06 ms).  This
// first version runs every product on the CUDA cores in f32 (67 TFLOP/s at
// most), so operations bound it several times over; a wgmma design is
// later work (ROADMAP).  Its times are in PERF.md.
//
// Four kernels, no atomics: every output element and every partial is
// written once, by one thread, after a loop of fixed order, so two runs
// give the same bits (the training replay compares losses exactly).
//  1. carry_kernel, a block per (head, sequence, direction): walks the
//     chunks forward writing the state entering each (S), or backward
//     writing the state gradient leaving each (G), the (P, N) f32 state in
//     shared memory: the forward's f32 state update.  The states are
//     recomputed here, not saved by the forward, so that the forward kernel
//     runs unchanged and nothing more lives between the passes under remat
//     "full": S and G are f32 (B, S / L, H, P, N) each, 2 x 168 MB at
//     mamba2's train shape, alive for the call only.
//  2. chunk_kernel, a block per (head, chunk, sequence), 256 threads, the
//     chunk's x, dy, B and C rows in shared memory (in their dtype, rows
//     padded to an odd number of 32-bit words), every product in f32 on
//     CUDA cores in tiles of 32 rows.  A column pass per output tile t
//     (rows j) walks the pair tiles (I >= t, t): each thread forms 4 rows
//     by one column of Q and CB, hence E-weighted tiles in shared memory,
//     whose column sums give ddt's direct term and whose row sums dcum's
//     and da's pair terms (one thread a column or a row, in order); the
//     tiles' products accumulate dx and dB in registers (a warp 4 rows, a
//     lane columns lane + 32k); then the state terms u G B (a lane a row,
//     G read by all lanes at once), X G (dB's and V's) and the skip.  A row
//     pass per output tile (rows i) walks (t, J <= t) for dC, each warp its
//     own rows, then the inter term and dy . y_inter.  One thread then
//     takes the chunk's rows in order: dcum, its reverse cumsum, ddt, the
//     chunk's da and dd.  dB and dC go out per head as f32 partials
//     (B, S, H, N), 2 x 335 MB at mamba2's train shape.
//  3. reduce_bc_kernel: dB and dC, each partial summed over the heads in
//     order, stored in B's dtype.
//  4. reduce_heads_kernel: da and dd, the chunks' partials summed over
//     (sequence, chunk) in order.
// bf16 and f32 run the same bodies (operands widened on load, f32
// arithmetic): P 32 or 64, N 16, 32, 64 or 128.
#include "common.cuh"

namespace {

using repro::from_float;
using repro::to_float;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 128;
constexpr int kTile = 32;                 // rows of a tile
constexpr int kRows = kTile / kWarps;     // 4: rows of a tile a warp owns
constexpr int kTLd = kTile + 1;           // row stride of a pair tile
constexpr int kMaxKernels = 4;            // kernels a call launches

// row stride in elements for rows of W values: an odd number of 32-bit
// words, so that lanes reading one column of consecutive rows hit
// distinct banks
template <typename T, int W>
constexpr int ld() {
  return sizeof(T) == 4 ? W + 1 : W + 2;
}

constexpr size_t align16(size_t x) { return (x + 15) / 16 * 16; }

// ---------------------------------------------------------------------------
// 1. the states entering each chunk and the state gradients leaving it
// ---------------------------------------------------------------------------
template <typename T, int P, int N>
struct CarrySmem {
  static constexpr int kSLd = N + 1;
  static constexpr int kVLd = ld<T, P>();
  static constexpr int kMLd = ld<T, N>();
  static constexpr size_t kState = 0;
  static constexpr size_t kRow = align16(kState + sizeof(float) * P * kSLd);
  static constexpr size_t kV = align16(kRow + sizeof(float) * 3 * kMaxChunk);
  static constexpr size_t kM = align16(kV + sizeof(T) * kMaxChunk * kVLd);
  static constexpr size_t kBytes = align16(kM + sizeof(T) * kMaxChunk * kMLd);
};

// blockIdx.z 0: states[b, c, h] = S entering chunk c, then
//   S <- e^{total} S + sum_j u_j x_j (x) B_j;
// blockIdx.z 1, chunks in reverse: dstates[b, c, h] = G leaving chunk c,
//   then G <- e^{total} G + sum_i e^{cum_i} dy_i (x) C_i.
// Thread layout of the state update as in ssd_scan.cu's f32 body: NL =
// min(N, 32) lanes along N, each thread a (P / PG) x (N / NL) tile.
template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads)
    carry_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                 const float* __restrict__ dt, const float* __restrict__ a,
                 const T* __restrict__ bm, const T* __restrict__ cm,
                 const float* __restrict__ dstate,  // (B, H, P, N) or null
                 float* __restrict__ states, float* __restrict__ dstates,
                 int S, int H, int chunk) {
  using L = CarrySmem<T, P, N>;
  constexpr int SLD = L::kSLd;
  constexpr int VLD = L::kVLd;
  constexpr int MLD = L::kMLd;
  constexpr int NL = N < 32 ? N : 32;
  constexpr int PG = kThreads / NL;
  constexpr int SP = P / PG;
  constexpr int SN = N / NL;
  static_assert(P % PG == 0 && N % NL == 0, "tile shape");

  extern __shared__ __align__(16) unsigned char smem[];
  float* st = reinterpret_cast<float*>(smem + L::kState);  // P x SLD
  float* cum = reinterpret_cast<float*>(smem + L::kRow);
  float* dts = cum + kMaxChunk;
  float* wgt = dts + kMaxChunk;
  T* vs = reinterpret_cast<T*>(smem + L::kV);  // chunk x VLD: x or dy
  T* ms = reinterpret_cast<T*>(smem + L::kM);  // chunk x MLD: B or C

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const bool back = blockIdx.z == 1;
  const int tid = threadIdx.x;
  const float ah = a[h];
  const int64_t x_tok = static_cast<int64_t>(H) * P;
  const int nc = S / chunk;
  const T* v = back ? dy : x;
  const T* m = back ? cm : bm;
  float* out = back ? dstates : states;
  const int64_t bh = static_cast<int64_t>(b) * H + h;

  for (int i = tid; i < P * N; i += kThreads) {
    const int p = i / N;
    st[p * SLD + (i - p * N)] =
        back && dstate != nullptr ? dstate[bh * P * N + i] : 0.f;
  }
  const int sp0 = tid / NL;
  const int sn0 = tid % NL;

  for (int k = 0; k < nc; ++k) {
    const int ic = back ? nc - 1 - k : k;
    const int64_t s0 = static_cast<int64_t>(b) * S +
                       static_cast<int64_t>(ic) * chunk;  // first token
    __syncthreads();  // the previous chunk's update is in st
    float* o = out + ((static_cast<int64_t>(b) * nc + ic) * H + h) * P * N;
    for (int i = tid; i < P * N; i += kThreads) {
      const int p = i / N;
      o[i] = st[p * SLD + (i - p * N)];
    }
    for (int j = tid; j < chunk; j += kThreads) dts[j] = dt[(s0 + j) * H + h];
    for (int i = tid; i < chunk * N; i += kThreads) {
      const int j = i / N;
      ms[j * MLD + (i - j * N)] = m[s0 * N + i];
    }
    for (int i = tid; i < chunk * P; i += kThreads) {
      const int j = i / P;
      const int p = i - j * P;
      vs[j * VLD + p] = v[(s0 + j) * x_tok + static_cast<int64_t>(h) * P + p];
    }
    __syncthreads();
    if (tid == 0) {  // cumsum(dt * a), in order, as the forward's f32 body
      float acc = 0.f;
      for (int j = 0; j < chunk; ++j) {
        acc += dts[j] * ah;
        cum[j] = acc;
      }
    }
    __syncthreads();
    const float total = cum[chunk - 1];
    for (int j = tid; j < chunk; j += kThreads)
      wgt[j] = back ? expf(cum[j]) : expf(total - cum[j]) * dts[j];
    __syncthreads();

    float acc[SP][SN];
#pragma unroll
    for (int r = 0; r < SP; ++r)
#pragma unroll
      for (int q = 0; q < SN; ++q) acc[r][q] = 0.f;
    for (int j = 0; j < chunk; ++j) {
      const float w = wgt[j];
      float xv[SP];
#pragma unroll
      for (int r = 0; r < SP; ++r)
        xv[r] = w * to_float(vs[j * VLD + sp0 + PG * r]);
#pragma unroll
      for (int q = 0; q < SN; ++q) {
        const float mv = to_float(ms[j * MLD + sn0 + NL * q]);
#pragma unroll
        for (int r = 0; r < SP; ++r) acc[r][q] = fmaf(xv[r], mv, acc[r][q]);
      }
    }
    const float decay = expf(total);
#pragma unroll
    for (int r = 0; r < SP; ++r)
#pragma unroll
      for (int q = 0; q < SN; ++q) {
        float* sv = st + (sp0 + PG * r) * SLD + sn0 + NL * q;
        *sv = *sv * decay + acc[r][q];
      }
  }
}

// ---------------------------------------------------------------------------
// 2. the chunk's gradients
// ---------------------------------------------------------------------------
// the row arrays of chunk_kernel, kMaxChunk floats each
enum Row {
  kDt, kCum, kCdt, kEcum, kEto, kU, kColW, kRowW, kPairA, kInter, kVj,
  kDda, kRowArrays
};

template <typename T, int P, int N>
struct ChunkSmem {
  static constexpr int kXLd = ld<T, P>();
  static constexpr int kBLd = ld<T, N>();
  // three 32 x 33 pair tiles, or one 32 x (P + 1) tile of dx's state term
  static constexpr int kTileFloats =
      3 * kTile * kTLd > kTile * (P + 1) ? 3 * kTile * kTLd : kTile * (P + 1);
  static constexpr size_t kX = 0;
  static constexpr size_t kDy = align16(kX + sizeof(T) * kMaxChunk * kXLd);
  static constexpr size_t kB = align16(kDy + sizeof(T) * kMaxChunk * kXLd);
  static constexpr size_t kC = align16(kB + sizeof(T) * kMaxChunk * kBLd);
  static constexpr size_t kRow = align16(kC + sizeof(T) * kMaxChunk * kBLd);
  static constexpr size_t kTiles =
      align16(kRow + sizeof(float) * kRowArrays * kMaxChunk);
  static constexpr size_t kRed =
      align16(kTiles + sizeof(float) * kTileFloats);
  static constexpr size_t kBytes = align16(kRed + sizeof(float) * kThreads);
};

// out[r] = sum_k a[i0 + r][k] * b[j][k] over K columns of rows of stride LD
template <typename T, int K, int LD>
__device__ __forceinline__ void dot_rows(const T* a, const T* b, int i0,
                                         int j, float (&out)[kRows]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) out[r] = 0.f;
#pragma unroll 8
  for (int k = 0; k < K; ++k) {
    const float bv = to_float(b[j * LD + k]);
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      out[r] = fmaf(to_float(a[(i0 + r) * LD + k]), bv, out[r]);
  }
}

// the block's values summed in thread order by thread 0 (its return value;
// the others return 0)
__device__ __forceinline__ float block_sum(float v, float* red) {
  __syncthreads();  // red is free
  red[threadIdx.x] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int i = 0; i < kThreads; ++i) s += red[i];
  return s;
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads)
    chunk_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                 const float* __restrict__ dt, const float* __restrict__ a,
                 const T* __restrict__ bm, const T* __restrict__ cm,
                 const float* __restrict__ dsk,
                 const float* __restrict__ states,
                 const float* __restrict__ dstates, T* __restrict__ dx,
                 float* __restrict__ ddt, float* __restrict__ part_b,
                 float* __restrict__ part_c, float* __restrict__ part_a,
                 float* __restrict__ part_d, int S, int H, int chunk) {
  using L = ChunkSmem<T, P, N>;
  constexpr int XLD = L::kXLd;
  constexpr int BLD = L::kBLd;
  constexpr int PK = P / 32;            // dx columns a lane
  constexpr int NK = (N + 31) / 32;     // dB / dC columns a lane
  constexpr int PW = P / kWarps;        // dx state-term columns a warp
  static_assert(P % 32 == 0 && P % kWarps == 0, "P is 32 or 64");

  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem + L::kX);    // rows x XLD
  T* dys = reinterpret_cast<T*>(smem + L::kDy);  // rows x XLD
  T* bs = reinterpret_cast<T*>(smem + L::kB);    // rows x BLD
  T* cs = reinterpret_cast<T*>(smem + L::kC);    // rows x BLD
  float* row = reinterpret_cast<float*>(smem + L::kRow);
  float* dts = row + kDt * kMaxChunk;
  float* cum = row + kCum * kMaxChunk;
  float* cdt = row + kCdt * kMaxChunk;     // cumsum(dt)
  float* ecum = row + kEcum * kMaxChunk;   // e^{cum_i}
  float* eto = row + kEto * kMaxChunk;     // e^{total - cum_j}
  float* u = row + kU * kMaxChunk;         // e^{total - cum_j} dt_j
  float* colw = row + kColW * kMaxChunk;   // sum_i W_ij
  float* roww = row + kRowW * kMaxChunk;   // sum_j dt_j W_ij
  float* pair_a = row + kPairA * kMaxChunk;  // sum_j dt_j W_ij (cdt_i - cdt_j)
  float* inter = row + kInter * kMaxChunk;   // dy_i . y_inter_i
  float* vv = row + kVj * kMaxChunk;          // V_j
  float* dda = row + kDda * kMaxChunk;
  float* ta = reinterpret_cast<float*>(smem + L::kTiles);  // 32 x kTLd
  float* tb = ta + kTile * kTLd;
  float* tw = tb + kTile * kTLd;
  float* red = reinterpret_cast<float*>(smem + L::kRed);

  const int h = blockIdx.x;
  const int ic = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int nc = S / chunk;
  const int nt = (chunk + kTile - 1) / kTile;
  const int rows = nt * kTile;
  const int64_t s0 = static_cast<int64_t>(b) * S +
                     static_cast<int64_t>(ic) * chunk;  // first token
  const int64_t x_tok = static_cast<int64_t>(H) * P;
  const int64_t blk = (static_cast<int64_t>(b) * nc + ic) * H + h;
  const float* Sc = states + blk * P * N;  // entering the chunk
  const float* Gc = dstates + blk * P * N;  // leaving it
  const float ah = a[h];
  const float dh = dsk[h];
  const T zero = from_float<T>(0.f);

  // ---- the chunk's rows, zeros past `chunk` up to whole tiles ----
  for (int i = tid; i < rows * P; i += kThreads) {
    const int j = i / P;
    const int p = i - j * P;
    const int64_t g = (s0 + j) * x_tok + static_cast<int64_t>(h) * P + p;
    xs[j * XLD + p] = j < chunk ? x[g] : zero;
    dys[j * XLD + p] = j < chunk ? dy[g] : zero;
  }
  for (int i = tid; i < rows * N; i += kThreads) {
    const int j = i / N;
    const int n = i - j * N;
    bs[j * BLD + n] = j < chunk ? bm[(s0 + j) * N + n] : zero;
    cs[j * BLD + n] = j < chunk ? cm[(s0 + j) * N + n] : zero;
  }
  for (int j = tid; j < kMaxChunk; j += kThreads) {
    dts[j] = j < chunk ? dt[(s0 + j) * H + h] : 0.f;
    cum[j] = cdt[j] = 0.f;
    colw[j] = roww[j] = pair_a[j] = inter[j] = vv[j] = 0.f;
  }
  __syncthreads();
  if (tid == 0) {
    float c_ = 0.f, t_ = 0.f;
    for (int j = 0; j < chunk; ++j) {
      c_ += dts[j] * ah;
      t_ += dts[j];
      cum[j] = c_;
      cdt[j] = t_;
    }
  }
  __syncthreads();
  const float total = cum[chunk - 1];
  for (int j = tid; j < kMaxChunk; j += kThreads) {
    const bool in = j < chunk;
    ecum[j] = in ? expf(cum[j]) : 0.f;
    eto[j] = in ? expf(total - cum[j]) : 0.f;
    u[j] = in ? expf(total - cum[j]) * dts[j] : 0.f;
  }
  __syncthreads();

  // ---- column pass: dx and dB of the rows j of tile t ----
  for (int t = 0; t < nt; ++t) {
    const int j0 = t * kTile + warp * kRows;  // this warp's output rows
    float dxa[kRows][PK], dba[kRows][NK];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int k = 0; k < PK; ++k) dxa[r][k] = 0.f;
#pragma unroll
      for (int k = 0; k < NK; ++k) dba[r][k] = 0.f;
    }
    float cw = 0.f;  // threads tid < 32: sum_i W_ij of column t * 32 + tid
    const int j = t * kTile + lane;  // this lane's column of the pair tiles
    for (int I = t; I < nt; ++I) {
      const int i0 = I * kTile + warp * kRows;
      float q[kRows], cb[kRows];
      dot_rows<T, P, XLD>(dys, xs, i0, j, q);
      dot_rows<T, N, BLD>(cs, bs, i0, j, cb);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = i0 + r;
        const bool valid = i < chunk && j < chunk && j <= i;
        const float e = valid ? expf(cum[i] - cum[j]) : 0.f;
        const int at = (warp * kRows + r) * kTLd + lane;
        ta[at] = cb[r] * e * dts[j];  // dx's weight of dy_i
        tb[at] = e * dts[j] * q[r];   // dB's weight of C_i (R_ij)
        tw[at] = cb[r] * e * q[r];    // W_ij
      }
      __syncthreads();
      if (tid < kTile) {
        for (int ri = 0; ri < kTile; ++ri) cw += tw[ri * kTLd + tid];
      } else if (tid < 2 * kTile) {
        const int ri = tid - kTile;
        const int i = I * kTile + ri;
        float rs = 0.f, ps = 0.f;
        for (int cj = 0; cj < kTile; ++cj) {
          const int jj = t * kTile + cj;
          const float w = tw[ri * kTLd + cj] * dts[jj];
          rs += w;
          ps += w * (cdt[i] - cdt[jj]);
        }
        roww[i] += rs;
        pair_a[i] += ps;
      }
      for (int ri = 0; ri < kTile; ++ri) {
        const int i = I * kTile + ri;
        float mv[kRows], rv[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          mv[r] = ta[ri * kTLd + warp * kRows + r];
          rv[r] = tb[ri * kTLd + warp * kRows + r];
        }
#pragma unroll
        for (int k = 0; k < PK; ++k) {
          const float g = to_float(dys[i * XLD + lane + 32 * k]);
#pragma unroll
          for (int r = 0; r < kRows; ++r) dxa[r][k] = fmaf(mv[r], g, dxa[r][k]);
        }
#pragma unroll
        for (int k = 0; k < NK; ++k) {
          const int n = lane + 32 * k;
          const float cv = n < N ? to_float(cs[i * BLD + n]) : 0.f;
#pragma unroll
          for (int r = 0; r < kRows; ++r) dba[r][k] = fmaf(rv[r], cv, dba[r][k]);
        }
      }
      __syncthreads();  // the tiles are free
    }

    // X G: dB's state term u_j (G^T x_j) and V_j = e^{total - cum_j}
    // x_j^T G B_j (a warp owns each row: a warp sum)
    {
      float xg[kRows][NK];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int k = 0; k < NK; ++k) xg[r][k] = 0.f;
      for (int p = 0; p < P; ++p) {
        float xv[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          xv[r] = to_float(xs[(j0 + r) * XLD + p]);
#pragma unroll
        for (int k = 0; k < NK; ++k) {
          const int n = lane + 32 * k;
          const float gv = n < N ? Gc[p * N + n] : 0.f;
#pragma unroll
          for (int r = 0; r < kRows; ++r) xg[r][k] = fmaf(xv[r], gv, xg[r][k]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int jr = j0 + r;
        float vsum = 0.f;
#pragma unroll
        for (int k = 0; k < NK; ++k) {
          const int n = lane + 32 * k;
          if (n < N) vsum = fmaf(xg[r][k], to_float(bs[jr * BLD + n]), vsum);
          dba[r][k] = fmaf(u[jr], xg[r][k], dba[r][k]);
        }
        vsum = repro::warp_sum(vsum);
        if (lane == 0) vv[jr] = eto[jr] * vsum;
      }
    }
    // dx's state term u_j (G B_j): a lane a row of the tile, a warp PW
    // columns, each G value read by the warp's lanes at once; through
    // shared memory into dx's layout
    {
      float acc[PW];
#pragma unroll
      for (int mm = 0; mm < PW; ++mm) acc[mm] = 0.f;
      const int jr = t * kTile + lane;
      for (int n = 0; n < N; ++n) {
        const float bv = to_float(bs[jr * BLD + n]);
#pragma unroll
        for (int mm = 0; mm < PW; ++mm)
          acc[mm] = fmaf(bv, Gc[(warp + kWarps * mm) * N + n], acc[mm]);
      }
#pragma unroll
      for (int mm = 0; mm < PW; ++mm)
        ta[lane * (P + 1) + warp + kWarps * mm] = acc[mm];
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int jr = j0 + r;
#pragma unroll
      for (int k = 0; k < PK; ++k)
        dxa[r][k] = fmaf(u[jr], ta[(warp * kRows + r) * (P + 1) + lane + 32 * k],
                         dxa[r][k]);
      if (jr < chunk) {
        T* o = dx + (s0 + jr) * x_tok + static_cast<int64_t>(h) * P;
#pragma unroll
        for (int k = 0; k < PK; ++k) {
          const int p = lane + 32 * k;
          o[p] = from_float<T>(fmaf(dh, to_float(dys[jr * XLD + p]),
                                    dxa[r][k]));
        }
        float* pb = part_b + ((s0 + jr) * H + h) * N;
#pragma unroll
        for (int k = 0; k < NK; ++k) {
          const int n = lane + 32 * k;
          if (n < N) pb[n] = dba[r][k];
        }
      }
    }
    if (tid < kTile) colw[t * kTile + tid] = cw;
    __syncthreads();  // ta is free for the next tile
  }

  // ---- row pass: dC of the rows i of tile t (each warp its own rows) ----
  float* tr = tb + warp * kRows * kTLd;  // this warp's 4 rows of R
  for (int t = 0; t < nt; ++t) {
    const int i0 = t * kTile + warp * kRows;
    float dca[kRows][NK];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int k = 0; k < NK; ++k) dca[r][k] = 0.f;
    for (int J = 0; J <= t; ++J) {
      const int j = J * kTile + lane;
      float q[kRows];
      dot_rows<T, P, XLD>(dys, xs, i0, j, q);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = i0 + r;
        const bool valid = i < chunk && j < chunk && j <= i;
        const float e = valid ? expf(cum[i] - cum[j]) : 0.f;
        tr[r * kTLd + lane] = e * dts[j] * q[r];
      }
      __syncwarp();
      for (int cj = 0; cj < kTile; ++cj) {
        float rv[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) rv[r] = tr[r * kTLd + cj];
        const int jj = J * kTile + cj;
#pragma unroll
        for (int k = 0; k < NK; ++k) {
          const int n = lane + 32 * k;
          const float bv = n < N ? to_float(bs[jj * BLD + n]) : 0.f;
#pragma unroll
          for (int r = 0; r < kRows; ++r) dca[r][k] = fmaf(rv[r], bv, dca[r][k]);
        }
      }
      __syncwarp();  // before the next J writes this warp's rows
    }
    // the inter term e^{cum_i} S^T dy_i, and dy_i . y_inter_i = its dot
    // with C_i
    float ci[kRows][NK];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int k = 0; k < NK; ++k) ci[r][k] = 0.f;
    for (int p = 0; p < P; ++p) {
      float gv[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        gv[r] = to_float(dys[(i0 + r) * XLD + p]);
#pragma unroll
      for (int k = 0; k < NK; ++k) {
        const int n = lane + 32 * k;
        const float sv = n < N ? Sc[p * N + n] : 0.f;
#pragma unroll
        for (int r = 0; r < kRows; ++r) ci[r][k] = fmaf(gv[r], sv, ci[r][k]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = i0 + r;
      float isum = 0.f;
#pragma unroll
      for (int k = 0; k < NK; ++k) {
        const int n = lane + 32 * k;
        const float v = ecum[i] * ci[r][k];
        if (n < N) isum = fmaf(v, to_float(cs[i * BLD + n]), isum);
        dca[r][k] += v;
      }
      isum = repro::warp_sum(isum);
      if (lane == 0) inter[i] = isum;
      if (i < chunk) {
        float* pc = part_c + ((s0 + i) * H + h) * N;
#pragma unroll
        for (int k = 0; k < NK; ++k) {
          const int n = lane + 32 * k;
          if (n < N) pc[n] = dca[r][k];
        }
      }
    }
  }

  // ---- the chunk's rows in order: dcum, dda, ddt, da and dd ----
  float gs = 0.f;  // <G, S>
  for (int i = tid; i < P * N; i += kThreads) gs = fmaf(Gc[i], Sc[i], gs);
  float ds = 0.f;  // sum dy . x
  for (int i = tid; i < chunk * P; i += kThreads) {
    const int jr = i / P;
    const int p = i - jr * P;
    ds = fmaf(to_float(dys[jr * XLD + p]), to_float(xs[jr * XLD + p]), ds);
  }
  const float gsum = block_sum(gs, red);
  const float dsum = block_sum(ds, red);
  if (tid == 0) {
    const float carried = expf(total) * gsum;
    float dtv = 0.f;  // sum_j dt_j V_j
    for (int jr = 0; jr < chunk; ++jr) dtv = fmaf(dts[jr], vv[jr], dtv);
    const float last = cdt[chunk - 1];
    float tail = 0.f;
    float da_part = last * carried;
    for (int i = chunk - 1; i >= 0; --i) {
      float dc = roww[i] - dts[i] * colw[i] + inter[i] - dts[i] * vv[i];
      if (i == chunk - 1) dc += carried + dtv;
      tail += dc;
      dda[i] = tail;
      da_part += pair_a[i] + cdt[i] * inter[i] +
                 dts[i] * vv[i] * (last - cdt[i]);
    }
    part_a[blk] = da_part;
    part_d[blk] = dsum;
  }
  __syncthreads();
  for (int jr = tid; jr < chunk; jr += kThreads)
    ddt[(s0 + jr) * H + h] = colw[jr] + vv[jr] + ah * dda[jr];
}

// ---------------------------------------------------------------------------
// 3, 4. the sums over heads and over (sequence, chunk)
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
    reduce_bc_kernel(const float* __restrict__ part_b,
                     const float* __restrict__ part_c, T* __restrict__ db,
                     T* __restrict__ dc, int64_t tokens, int H, int N) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= tokens * N) return;
  const int64_t tok = e / N;
  const int n = static_cast<int>(e - tok * N);
  const float* pb = part_b + tok * H * N + n;
  const float* pc = part_c + tok * H * N + n;
  float sb = 0.f, sc = 0.f;
  for (int h = 0; h < H; ++h) {
    sb += pb[static_cast<int64_t>(h) * N];
    sc += pc[static_cast<int64_t>(h) * N];
  }
  db[e] = from_float<T>(sb);
  dc[e] = from_float<T>(sc);
}

__global__ void __launch_bounds__(kThreads)
    reduce_heads_kernel(const float* __restrict__ part_a,
                        const float* __restrict__ part_d,
                        float* __restrict__ da, float* __restrict__ dd,
                        int blocks, int H) {
  const int h = blockIdx.x * kThreads + threadIdx.x;
  if (h >= H) return;
  float sa = 0.f, sd = 0.f;
  for (int k = 0; k < blocks; ++k) {
    sa += part_a[static_cast<int64_t>(k) * H + h];
    sd += part_d[static_cast<int64_t>(k) * H + h];
  }
  da[h] = sa;
  dd[h] = sd;
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------
using KernelTimes = repro::KernelTimes<kMaxKernels>;

struct Call {
  const void *x, *b, *c, *dy;
  const float *dt, *a, *d, *dstate;
  void *dx, *db, *dc;
  float *ddt, *da, *dd, *work;
  int B, S, H, P, N, chunk;
};

// floats of the workspace: S and G, (B, nc, H, P, N) each; the dB and dC
// partials, (B, S, H, N) each; the da and dd partials, (B, nc, H) each
int64_t workspace_floats(int B, int S, int H, int P, int N, int chunk) {
  const int64_t nc = S / chunk;
  return 2 * B * nc * H * P * N + 2 * static_cast<int64_t>(B) * S * H * N +
         2 * B * nc * H;
}

template <typename T, int P, int N>
cudaError_t launch(const Call& c, KernelTimes& t) {
  const size_t carry_smem = CarrySmem<T, P, N>::kBytes;
  const size_t chunk_smem = ChunkSmem<T, P, N>::kBytes;
  cudaError_t err;
  if ((err = repro::set_smem(carry_kernel<T, P, N>, carry_smem)) !=
          cudaSuccess ||
      (err = repro::set_smem(chunk_kernel<T, P, N>, chunk_smem)) !=
          cudaSuccess)
    return err;
  const int nc = c.S / c.chunk;
  const int64_t state_floats =
      static_cast<int64_t>(c.B) * nc * c.H * P * N;
  const int64_t part_floats = static_cast<int64_t>(c.B) * c.S * c.H * N;
  float* states = c.work;
  float* dstates = states + state_floats;
  float* part_b = dstates + state_floats;
  float* part_c = part_b + part_floats;
  float* part_a = part_c + part_floats;
  float* part_d = part_a + static_cast<int64_t>(c.B) * nc * c.H;
  const T* x = static_cast<const T*>(c.x);
  const T* dy = static_cast<const T*>(c.dy);
  const T* bm = static_cast<const T*>(c.b);
  const T* cm = static_cast<const T*>(c.c);
  if ((err = t.mark()) != cudaSuccess) return err;
  carry_kernel<T, P, N><<<dim3(c.H, c.B, 2), kThreads, carry_smem,
                          t.stream>>>(x, dy, c.dt, c.a, bm, cm, c.dstate,
                                      states, dstates, c.S, c.H, c.chunk);
  if ((err = cudaGetLastError()) != cudaSuccess ||
      (err = t.mark()) != cudaSuccess)
    return err;
  chunk_kernel<T, P, N><<<dim3(c.H, nc, c.B), kThreads, chunk_smem,
                          t.stream>>>(
      x, dy, c.dt, c.a, bm, cm, c.d, states, dstates, static_cast<T*>(c.dx),
      c.ddt, part_b, part_c, part_a, part_d, c.S, c.H, c.chunk);
  if ((err = cudaGetLastError()) != cudaSuccess ||
      (err = t.mark()) != cudaSuccess)
    return err;
  const int64_t tokens = static_cast<int64_t>(c.B) * c.S;
  reduce_bc_kernel<T><<<static_cast<unsigned>((tokens * N + kThreads - 1) /
                                              kThreads),
                        kThreads, 0, t.stream>>>(
      part_b, part_c, static_cast<T*>(c.db), static_cast<T*>(c.dc), tokens,
      c.H, N);
  if ((err = cudaGetLastError()) != cudaSuccess ||
      (err = t.mark()) != cudaSuccess)
    return err;
  reduce_heads_kernel<<<(c.H + kThreads - 1) / kThreads, kThreads, 0,
                        t.stream>>>(part_a, part_d, c.da, c.dd, c.B * nc,
                                    c.H);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return t.mark();
}

template <typename T, int P>
cudaError_t launch_n(const Call& c, KernelTimes& t) {
  switch (c.N) {
    case 16:
      return launch<T, P, 16>(c, t);
    case 32:
      return launch<T, P, 32>(c, t);
    case 64:
      return launch<T, P, 64>(c, t);
    case 128:
      return launch<T, P, 128>(c, t);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_pn(const Call& c, KernelTimes& t) {
  switch (c.P) {
    case 32:
      return launch_n<T, 32>(c, t);
    case 64:
      return launch_n<T, 64>(c, t);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Packed arguments (common.cuh: Args), in order: device, dtype, x, dt, a,
// b, c, d (H f32: the skip weight, zeros for none), dy, dstate (the final
// state's cotangent, (B, H, P, N) f32, or 0 for none), dx, ddt (f32), da,
// db, dc, dd (f32), work (f32 workspace), work_floats (its length, at least
// workspace_floats), B, S, H, P, N, chunk, times (0, or a host array of
// kMaxKernels + 1 floats that the call fills with the kernels it launched
// and each one's device milliseconds, waiting for them: KernelTimes),
// stream.
extern "C" int repro_ssd_chunk_scan_bwd(const void* packed) {
  const repro::Args a(packed);
  cudaError_t err = repro::use_device(a.i32(0));
  if (err != cudaSuccess) return err;
  Call c;
  c.x = a.ptr(2);
  c.dt = static_cast<const float*>(a.ptr(3));
  c.a = static_cast<const float*>(a.ptr(4));
  c.b = a.ptr(5);
  c.c = a.ptr(6);
  c.d = static_cast<const float*>(a.ptr(7));
  c.dy = a.ptr(8);
  c.dstate = static_cast<const float*>(a.ptr(9));
  c.dx = a.ptr(10);
  c.ddt = static_cast<float*>(a.ptr(11));
  c.da = static_cast<float*>(a.ptr(12));
  c.db = a.ptr(13);
  c.dc = a.ptr(14);
  c.dd = static_cast<float*>(a.ptr(15));
  c.work = static_cast<float*>(a.ptr(16));
  const int64_t work_floats = a.i64(17);
  c.B = a.i32(18);
  c.S = a.i32(19);
  c.H = a.i32(20);
  c.P = a.i32(21);
  c.N = a.i32(22);
  c.chunk = a.i32(23);
  if (c.B <= 0 || c.B > 65535 || c.S <= 0 || c.H <= 0 || c.chunk <= 0 ||
      c.chunk > kMaxChunk || c.S % c.chunk != 0 || c.S / c.chunk > 65535 ||
      work_floats < workspace_floats(c.B, c.S, c.H, c.P, c.N, c.chunk))
    return cudaErrorInvalidValue;
  KernelTimes t{static_cast<float*>(a.ptr(24)),
                static_cast<cudaStream_t>(a.ptr(25))};
  switch (a.i32(1)) {
    case REPRO_F32:
      return t.finish(launch_pn<float>(c, t));
    case REPRO_BF16:
      return t.finish(launch_pn<bf16>(c, t));
    default:
      return cudaErrorInvalidValue;
  }
}
