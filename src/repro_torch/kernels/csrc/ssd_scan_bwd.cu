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
//   S of the chunk after = e^{total} S + sum_j u_j x_j (x) B_j,
//   G of the chunk before = e^{total} G + sum_i e^{cum_i} dy_i (x) C_i,
// with G of the last chunk the final state's cotangent (0 if none).  da
// and dd sum over batch and sequence, da pairwise: the gaps cdt_i - cdt_j
// (cdt = cumsum(dt)) times each pair's term, where the sum of dt dda
// would cancel its row and column terms to rounding
// (kernels/ref.py: ssd_chunk_scan_bwd is the same formula in PyTorch).
//
// What bounds it on the H100.  At mamba2's train shape (B 2, S 4096, H 80,
// P 64, N 128, L 128) the chunks' products are ~1.1e11 flops: C.B once a
// chunk (shared by the heads); a head's Q and Q^T, the intra products for
// dx, dB and dC over the causal pairs, X G (dB's state term and V), B G^T
// (dx's), dY S (dC's inter term), and each chunk's local state and state
// gradient, ~0.11 ms on the bf16 tensor cores; the bytes the function
// must move, x, dy, dx, B, C, dB, dC once and dt, ddt in f32, ~0.27 GB
// (0.08 ms).  Beyond those the design moves the chunks' states: the local
// states and state gradients written and read in f32 and the carried
// states' bf16 copies written and read, ~1.1 GB at that shape (~0.33 ms at
// 3.35 TB/s), which the states and pass kernels' times follow.  The column
// and row kernels are latency-bound: one block an SM (255 registers a
// thread), each wgmma group waited on before the elementwise work on its
// fragments; their outputs leave in whole rows (scattered 4-byte stores
// of dx, of the row sums and of ddt cost more than their tiles' products).
// Times in PERF.md.
//
// bf16: five kernels on wgmma fed by TMA, no atomics (every output and
// partial is written once after sums of fixed order, so two runs give the
// same bits: the training replay compares losses exactly).
//  1. states_kernel: a block per (head group, chunk, sequence), two
//     warpgroups; TMA brings the chunk's B and C once and each head's x and
//     dy through a ring of two stages.  Warpgroup 0 forms the chunk's local
//     state x^T (u (x) B) (u_j x_j a bf16 A operand, x^T by ldmatrix.trans),
//     warpgroup 1 its local state gradient dy^T (e^{cum} (x) C), 64 x N each,
//     f32 into the workspace, in parallel over all chunks (the split of
//     mamba_ssm's ssd_chunk_state).  cum = cumsum(dt a log2 e) and
//     cumsum(dt) are warp scans plus the warp totals added in order, as in
//     the forward; the chunk's total goes to the workspace.
//  2. pass_kernel: a block per (head, sequence, slice of 2048 elements of
//     the (P, N) state), a thread 8 elements: S walked forward in f32
//     registers (a bf16 copy), then G walked from the last chunk back in
//     f32 registers (a bf16 copy), each chunk's loads issued a chunk
//     ahead, and e^{total} <G, S> of each chunk (G in f32 against S's bf16
//     copy, the operand the row products read) summed by warp shuffles and
//     the warps' sums in order, 32 chunks a barrier (mamba_ssm's
//     ssd_state_passing, both ways).  The carried states stay f32: their
//     bf16 copies are operands only.
//  3. col_kernel: the column products, rows j.  A block per (head group,
//     chunk, sequence) as in 1, its two warpgroups 64 rows each, x, dy and G
//     by TMA a head.  B . C^T is formed once a block (G == 1: shared by the
//     heads) and kept as f32 fragments in shared memory.  Per head: X G
//     (V_j and dB's state term u_j X G, f32 on the accumulator), B G^T (dx's
//     state term), then per 64-column tile i of the causal half X . dY^T on
//     wgmma, and on its f32 fragment dt_j CB E (dx's A operand) and dt_j E
//     Q (dB's), rounded to bf16 only as operands, and sum_i W_ij (ddt's
//     direct term) in f32; dx += A . dY and dB += A . C.  dx leaves through
//     the warpgroup's own rows of the x tile (stmatrix, 16-byte stores);
//     sum_i W_ij and V_j a head's rows contiguous.  dB stays in f32
//     registers across the group's heads in order and leaves once a group:
//     (B, S, groups, N).  Warpgroup 0 skips no tile; warpgroup 1 (rows 64
//     up) skips the tile of columns below 64, above the diagonal.
//  4. row_kernel: the row products, rows i, laid out as 3: C . B^T once a
//     block; per head dY S (dC's inter term and dy . y_inter), dY . X^T per
//     tile j <= i with E dt_j Q (dC's A operand) and sum_j dt_j W_ij and the
//     pairs' gaps for da on the f32 fragment; dC += A . B, kept across the
//     group.  Then warpgroup 0 takes the chunk's rows, a thread a row (its
//     inputs from the column pass and the carry read at the head's start):
//     dcum from both passes' row sums, its reverse cumsum by a mirrored warp
//     scan and the later warps' totals, ddt (a head's rows contiguous), and
//     the chunk's da and dd partials by shuffle trees and the warps' sums
//     in order.
//  5. sums_kernel: dB and dC, the groups' partials summed in order; ddt to
//     (B, S, H); da and dd, the chunks' partials summed in order.
//  A group is the heads g * heads_per_group up to H (the wrapper's
//  plan_bwd_groups: about two blocks an SM over the (chunk, sequence)
//  pairs, one fitting an SM).  Shared memory, N 128: B, C 64 KB, the ring
//  96 KB, the score fragments 48 KB.
// f32: the first version's four kernels, every product an f32 FMA on CUDA
// cores, kept for the correctness checks held to 1e-4 (bf16 operands would
// miss them):
//  1. carry_kernel, a block per (head, sequence, direction): walks the
//     chunks forward writing the state entering each (S), or backward
//     writing the state gradient leaving each (G), the (P, N) f32 state in
//     shared memory: the forward's f32 state update.  The states are
//     recomputed here, not saved by the forward, so that the forward kernel
//     runs unchanged and nothing more lives between the passes under remat
//     "full".
//  2. chunk_kernel, a block per (head, chunk, sequence), 256 threads, the
//     chunk's x, dy, B and C rows in shared memory (rows padded to an odd
//     number of floats), every product in f32 on
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
//     (B, S, H, N).
//  3. reduce_bc_kernel: dB and dC, each partial summed over the heads in
//     order, stored in B's dtype.
//  4. reduce_heads_kernel: da and dd, the chunks' partials summed over
//     (sequence, chunk) in order.
//  P 32 or 64, N 16, 32, 64 or 128.
#include "common.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 128;
constexpr int kTile = 32;                 // rows of a tile
constexpr int kRows = kTile / kWarps;     // 4: rows of a tile a warp owns
constexpr int kTLd = kTile + 1;           // row stride of a pair tile

// row stride in floats for rows of W values: an odd number, so that lanes
// reading one column of consecutive rows hit distinct banks
template <int W>
constexpr int ld() {
  return W + 1;
}

constexpr size_t align16(size_t x) { return (x + 15) / 16 * 16; }

// ---------------------------------------------------------------------------
// 1. the states entering each chunk and the state gradients leaving it
// ---------------------------------------------------------------------------
template <int P, int N>
struct CarrySmem {
  static constexpr int kSLd = N + 1;
  static constexpr int kVLd = ld<P>();
  static constexpr int kMLd = ld<N>();
  static constexpr size_t kState = 0;
  static constexpr size_t kRow = align16(kState + sizeof(float) * P * kSLd);
  static constexpr size_t kV = align16(kRow + sizeof(float) * 3 * kMaxChunk);
  static constexpr size_t kM = align16(kV + sizeof(float) * kMaxChunk * kVLd);
  static constexpr size_t kBytes =
      align16(kM + sizeof(float) * kMaxChunk * kMLd);
};

// blockIdx.z 0: states[b, c, h] = S entering chunk c, then
//   S <- e^{total} S + sum_j u_j x_j (x) B_j;
// blockIdx.z 1, chunks in reverse: dstates[b, c, h] = G leaving chunk c,
//   then G <- e^{total} G + sum_i e^{cum_i} dy_i (x) C_i.
// Thread layout of the state update as in ssd_scan.cu's f32 body: NL =
// min(N, 32) lanes along N, each thread a (P / PG) x (N / NL) tile.
template <int P, int N>
__global__ void __launch_bounds__(kThreads)
    carry_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                 const float* __restrict__ dt, const float* __restrict__ a,
                 const float* __restrict__ bm, const float* __restrict__ cm,
                 const float* __restrict__ dstate,  // (B, H, P, N) or null
                 float* __restrict__ states, float* __restrict__ dstates,
                 int S, int H, int chunk) {
  using L = CarrySmem<P, N>;
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
  float* vs = reinterpret_cast<float*>(smem + L::kV);  // chunk x VLD: x or dy
  float* ms = reinterpret_cast<float*>(smem + L::kM);  // chunk x MLD: B or C

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const bool back = blockIdx.z == 1;
  const int tid = threadIdx.x;
  const float ah = a[h];
  const int64_t x_tok = static_cast<int64_t>(H) * P;
  const int nc = S / chunk;
  const float* v = back ? dy : x;
  const float* m = back ? cm : bm;
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
        xv[r] = w * vs[j * VLD + sp0 + PG * r];
#pragma unroll
      for (int q = 0; q < SN; ++q) {
        const float mv = ms[j * MLD + sn0 + NL * q];
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

template <int P, int N>
struct ChunkSmem {
  static constexpr int kXLd = ld<P>();
  static constexpr int kBLd = ld<N>();
  // three 32 x 33 pair tiles, or one 32 x (P + 1) tile of dx's state term
  static constexpr int kTileFloats =
      3 * kTile * kTLd > kTile * (P + 1) ? 3 * kTile * kTLd : kTile * (P + 1);
  static constexpr size_t kX = 0;
  static constexpr size_t kDy = align16(kX + sizeof(float) * kMaxChunk * kXLd);
  static constexpr size_t kB = align16(kDy + sizeof(float) * kMaxChunk * kXLd);
  static constexpr size_t kC = align16(kB + sizeof(float) * kMaxChunk * kBLd);
  static constexpr size_t kRow = align16(kC + sizeof(float) * kMaxChunk * kBLd);
  static constexpr size_t kTiles =
      align16(kRow + sizeof(float) * kRowArrays * kMaxChunk);
  static constexpr size_t kRed =
      align16(kTiles + sizeof(float) * kTileFloats);
  static constexpr size_t kBytes = align16(kRed + sizeof(float) * kThreads);
};

// out[r] = sum_k a[i0 + r][k] * b[j][k] over K columns of rows of stride LD
template <int K, int LD>
__device__ __forceinline__ void dot_rows(const float* a, const float* b,
                                         int i0, int j,
                                         float (&out)[kRows]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) out[r] = 0.f;
#pragma unroll 8
  for (int k = 0; k < K; ++k) {
    const float bv = b[j * LD + k];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      out[r] = fmaf(a[(i0 + r) * LD + k], bv, out[r]);
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

template <int P, int N>
__global__ void __launch_bounds__(kThreads)
    chunk_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                 const float* __restrict__ dt, const float* __restrict__ a,
                 const float* __restrict__ bm, const float* __restrict__ cm,
                 const float* __restrict__ dsk,
                 const float* __restrict__ states,
                 const float* __restrict__ dstates, float* __restrict__ dx,
                 float* __restrict__ ddt, float* __restrict__ part_b,
                 float* __restrict__ part_c, float* __restrict__ part_a,
                 float* __restrict__ part_d, int S, int H, int chunk) {
  using L = ChunkSmem<P, N>;
  constexpr int XLD = L::kXLd;
  constexpr int BLD = L::kBLd;
  constexpr int PK = P / 32;            // dx columns a lane
  constexpr int NK = (N + 31) / 32;     // dB / dC columns a lane
  constexpr int PW = P / kWarps;        // dx state-term columns a warp
  static_assert(P % 32 == 0 && P % kWarps == 0, "P is 32 or 64");

  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem + L::kX);    // rows x XLD
  float* dys = reinterpret_cast<float*>(smem + L::kDy);  // rows x XLD
  float* bs = reinterpret_cast<float*>(smem + L::kB);    // rows x BLD
  float* cs = reinterpret_cast<float*>(smem + L::kC);    // rows x BLD
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

  // ---- the chunk's rows, zeros past `chunk` up to whole tiles ----
  for (int i = tid; i < rows * P; i += kThreads) {
    const int j = i / P;
    const int p = i - j * P;
    const int64_t g = (s0 + j) * x_tok + static_cast<int64_t>(h) * P + p;
    xs[j * XLD + p] = j < chunk ? x[g] : 0.f;
    dys[j * XLD + p] = j < chunk ? dy[g] : 0.f;
  }
  for (int i = tid; i < rows * N; i += kThreads) {
    const int j = i / N;
    const int n = i - j * N;
    bs[j * BLD + n] = j < chunk ? bm[(s0 + j) * N + n] : 0.f;
    cs[j * BLD + n] = j < chunk ? cm[(s0 + j) * N + n] : 0.f;
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
      dot_rows<P, XLD>(dys, xs, i0, j, q);
      dot_rows<N, BLD>(cs, bs, i0, j, cb);
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
          const float g = dys[i * XLD + lane + 32 * k];
#pragma unroll
          for (int r = 0; r < kRows; ++r) dxa[r][k] = fmaf(mv[r], g, dxa[r][k]);
        }
#pragma unroll
        for (int k = 0; k < NK; ++k) {
          const int n = lane + 32 * k;
          const float cv = n < N ? cs[i * BLD + n] : 0.f;
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
          xv[r] = xs[(j0 + r) * XLD + p];
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
          if (n < N) vsum = fmaf(xg[r][k], bs[jr * BLD + n], vsum);
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
        const float bv = bs[jr * BLD + n];
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
        float* o = dx + (s0 + jr) * x_tok + static_cast<int64_t>(h) * P;
#pragma unroll
        for (int k = 0; k < PK; ++k) {
          const int p = lane + 32 * k;
          o[p] = fmaf(dh, dys[jr * XLD + p], dxa[r][k]);
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
      dot_rows<P, XLD>(dys, xs, i0, j, q);
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
          const float bv = n < N ? bs[jj * BLD + n] : 0.f;
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
        gv[r] = dys[(i0 + r) * XLD + p];
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
        if (n < N) isum = fmaf(v, cs[i * BLD + n], isum);
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
    ds = fmaf(dys[jr * XLD + p], xs[jr * XLD + p], ds);
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
__global__ void __launch_bounds__(kThreads)
    reduce_bc_kernel(const float* __restrict__ part_b,
                     const float* __restrict__ part_c, float* __restrict__ db,
                     float* __restrict__ dc, int64_t tokens, int H, int N) {
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
  db[e] = sb;
  dc[e] = sc;
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
// bf16: warpgroup MMA fed by TMA
// ---------------------------------------------------------------------------
namespace hp = repro::hopper;

constexpr int kL = 128;                 // rows of a chunk tile
constexpr uint32_t kTile64 = kL * 128;  // 128 rows of 64 bf16: 16 KB
constexpr uint32_t kHalf = 64 * 128;    // 64 rows of 64 bf16: 8 KB
constexpr int kGroupThreads = 128;      // a warpgroup
constexpr int kBlockThreads = 2 * kGroupThreads;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kFrag = 32;  // f32 registers of a 64 x 64 accumulator
// C . B^T formed in every head's pass instead of once a block: a timing
// variant only, built with -DREPRO_SSD_BWD_CB_PER_HEAD=1 by
// tools/ssd_bwd_probe.py
#ifndef REPRO_SSD_BWD_CB_PER_HEAD
#define REPRO_SSD_BWD_CB_PER_HEAD 0
#endif
constexpr bool kCbPerHead = REPRO_SSD_BWD_CB_PER_HEAD;

// f32 row arrays of a warpgroup, offsets in floats: thread t is row t
enum RowSet {
  kRCum = 0,     // cumsum(dt a log2 e)
  kRDt = 128,    // dt (0 past the chunk)
  kREcum = 256,  // e^{cum} (0 past the chunk)
  kREto = 384,   // e^{cum_L - cum} (0 past the chunk)
  kRCdt = 512,   // cumsum(dt)
  kRTotC = 640,  // warp totals of the two scans
  kRTotT = 644,
  kRRed = 648,   // warp sums of three reductions
  kRRev = 660,   // warp totals of the reverse scan
  kRowFloats = 664
};

// Byte offsets from a 1024-byte aligned base (the swizzle atom's period).
// NP: the columns a C / B / state tile is laid out for (64 or 128, N <= NP);
// x and dy tiles take 64 columns (P <= 64).  kState: the column and row
// kernels' layout (a state tile a stage and the score fragments); the
// states kernel's has neither.  (Deeper rings, where shared memory allows
// three or four stages, timed no faster.)
template <int NP, bool kState>
struct BwdLayout {
  static constexpr int kStages = 2;
  static constexpr uint32_t kCB = NP / 64 * kTile64;  // a C or B tile
  static constexpr uint32_t kStateTile =
      kState ? NP / 64 * kHalf : 0;  // S or G, P rows
  static constexpr uint32_t kStage = 2 * kTile64 + kStateTile;  // x, dy, S/G
  // the score tiles' f32 fragments, three 64 x 64 tiles in register order
  static constexpr uint32_t kFragBytes =
      kState ? 3 * kFrag * kGroupThreads * 4 : 0;
  static constexpr uint32_t kC = 0;
  static constexpr uint32_t kB = kCB;
  static constexpr uint32_t kRing = 2 * kCB;
  static constexpr uint32_t kFrags = kRing + kStages * kStage;
  static constexpr uint32_t kRows = kFrags + kFragBytes;
  // the row pass's per-row sums of both warpgroups, a stage each: sum_j
  // dt_j W_ij, its gaps for da, dy . y_inter, Q_ii
  static constexpr uint32_t kCross = kRows + 2 * kRowFloats * 4;
  static constexpr uint32_t kBars = kCross + kStages * 4 * kL * 4;
  // mbarriers: full and empty a stage, B and C loaded
  static constexpr uint32_t kBytes = kBars + 8 * (2 * kStages + 1);
  static_assert(kBytes + 1024 <= 232448, "shared memory per block");
};

template <int NP, bool kState>
constexpr int bwd_smem_bytes() {
  return BwdLayout<NP, kState>::kBytes + 1024;
}

// byte offset of element (row, col) in a 128-byte-swizzled 64-column chunk
__device__ __forceinline__ uint32_t swz(int row, int col) {
  return row * 128 + ((((col >> 3) ^ row) & 7) << 4) + (col & 7) * 2;
}

// Operand descriptors (128-byte swizzle).  K-major: a tile of 64-column
// chunks `cstride` bytes apart; k-step kk starts 32 bytes further along the
// row inside its chunk.  MN-major: K runs down the rows, k-step kk starts 16
// rows further down; the M / N extent is one 64-column chunk.
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, uint32_t cstride,
                                           int kk) {
  const int col = kk * 16;
  return hp::smem_desc(tile + (col / 64) * cstride + (col % 64) * 2, 16,
                       1024, 1);
}
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return hp::smem_desc(tile + kk * 16 * 128, kTile64, 1024, 1);
}

// A fragments (ldmatrix) of 64 rows from `row0` of a tile of 64-column
// chunks `cstride` apart, KS k-steps of 16 columns
template <int KS>
__device__ __forceinline__ void load_a(uint32_t (&f)[KS][4], uint32_t tile,
                                       uint32_t cstride, int row0, int t) {
  const int lane = t & 31;
  const int lm_row = lane & 7;
  const int lm_mat = lane >> 3;
  const int row = row0 + (t >> 5) * 16 + lm_row + 8 * (lm_mat & 1);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int col = kk * 16 + 8 * (lm_mat >> 1);
    hp::ldmatrix_x4(f[kk], tile + (col / 64) * cstride + swz(row, col % 64));
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.f;
}

// the sum over the four lanes of a fragment row (lanes 4r .. 4r + 3)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// two bf16 of a swizzled tile as floats
__device__ __forceinline__ float2 bf2(const uint8_t* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// The head's row arrays, thread t of the warpgroup row t: cum = cumsum(dt
// a log2 e) and cumsum(dt) as warp scans (shuffles), then the totals of
// the warps before added in order; e^{cum} and e^{cum_L - cum}, 0 past the
// chunk.  Returns the chunk's total of cum (rows past the chunk add 0).
__device__ __forceinline__ float head_rows(float* rs, float dtv, float a2,
                                           int chunk, int t, int bar) {
  const int lane = t & 31;
  const int warp = t >> 5;
  float v = dtv * a2;
  float w = dtv;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, o);
    const float z = __shfl_up_sync(0xffffffffu, w, o);
    if (lane >= o) {
      v += u;
      w += z;
    }
  }
  if (lane == 31) {
    rs[kRTotC + warp] = v;
    rs[kRTotT + warp] = w;
  }
  hp::named_bar_sync(bar, kGroupThreads);
  float off = 0.f, tot = 0.f, offt = 0.f, tott = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (k == warp) {
      off = tot;
      offt = tott;
    }
    tot += rs[kRTotC + k];
    tott += rs[kRTotT + k];
  }
  const float cum = v + off;
  rs[kRCum + t] = cum;
  rs[kRDt + t] = dtv;
  rs[kREcum + t] = t < chunk ? hp::ex2(cum) : 0.f;
  rs[kREto + t] = t < chunk ? hp::ex2(tot - cum) : 0.f;
  rs[kRCdt + t] = w + offt;
  hp::named_bar_sync(bar, kGroupThreads);  // every row is in
  return tot;
}

// What the three wgmma kernels share: the block's (group, chunk,
// sequence), its barriers, and the loads.  One thread of warpgroup 1
// issues every TMA load: B and C once, then each head's x and dy (and S or
// G where kState) into stage k % stages, head k + stages' once both
// warpgroups have released head k's stage.
template <int NP, bool kState>
struct Block {
  using L = BwdLayout<NP, kState>;
  uint32_t base;
  uint8_t* gbase;
  const CUtensorMap* x_map;
  const CUtensorMap* dy_map;
  const CUtensorMap* st_map;  // S or G copies, or null
  int b, ic, h0, nh, nc, chunk, H;
  uint32_t full, empty, bc_bar;
  bool loader;

  __device__ void init(uint8_t* smem_raw, const CUtensorMap* xm,
                       const CUtensorMap* dym, const CUtensorMap* stm,
                       const CUtensorMap* bm, const CUtensorMap* cm, int S,
                       int H_, int chunk_, int hpg) {
    const uint32_t raw = hp::smem_u32(smem_raw);
    base = (raw + 1023u) & ~1023u;
    gbase = smem_raw + (base - raw);
    x_map = xm;
    dy_map = dym;
    st_map = stm;
    H = H_;
    chunk = chunk_;
    b = blockIdx.z;
    ic = blockIdx.y;
    h0 = blockIdx.x * hpg;
    nh = min(H, h0 + hpg) - h0;
    nc = S / chunk;
    full = base + L::kBars;
    empty = full + 8 * L::kStages;
    bc_bar = empty + 8 * L::kStages;
    loader = threadIdx.x == kGroupThreads;
    if (threadIdx.x == 0) {
      for (int i = 0; i < L::kStages; ++i) {
        hp::mbar_init(full + 8 * i, 1);
        hp::mbar_init(empty + 8 * i, kBlockThreads / 32);  // a warp each
      }
      hp::mbar_init(bc_bar, 1);
      hp::mbar_fence_init();
    }
    __syncthreads();
    if (loader) {
      hp::mbar_expect_tx(bc_bar, 2 * L::kCB);
#pragma unroll
      for (int j = 0; j < NP / 64; ++j) {
        hp::tma_load_4d(base + L::kC + j * kTile64, cm, bc_bar, 64 * j, 0,
                        ic * chunk, b);
        hp::tma_load_4d(base + L::kB + j * kTile64, bm, bc_bar, 64 * j, 0,
                        ic * chunk, b);
      }
      for (int k = 0; k < L::kStages && k < nh; ++k) load(k);
    }
  }
  __device__ uint32_t stage(int k) const {
    return base + L::kRing + (k % L::kStages) * L::kStage;
  }
  __device__ void load(int k) const {
    const uint32_t s = stage(k);
    const uint32_t bar = full + 8 * (k % L::kStages);
    const int h = h0 + k;
    hp::mbar_expect_tx(bar, kState ? L::kStage : 2 * kTile64);
    hp::tma_load_4d(s, x_map, bar, 0, h, ic * chunk, b);
    hp::tma_load_4d(s + kTile64, dy_map, bar, 0, h, ic * chunk, b);
    if constexpr (kState) {
      const int bch = (b * nc + ic) * H + h;
#pragma unroll
      for (int j = 0; j < NP / 64; ++j)
        hp::tma_load_4d(s + 2 * kTile64 + j * kHalf, st_map, bar, 64 * j, 0,
                        0, bch);
    }
  }
  __device__ void wait_full(int k) const {
    hp::mbar_wait(full + 8 * (k % L::kStages), (k / L::kStages) & 1);
  }
  // every lane of the warp is done with head k's stage
  __device__ void release(int k) const {
    __syncwarp();
    const int s = k % L::kStages;
    if ((threadIdx.x & 31) == 0) hp::mbar_arrive(empty + 8 * s);
    if (loader && k + L::kStages < nh) {
      hp::mbar_wait(empty + 8 * s, (k / L::kStages) & 1);
      load(k + L::kStages);
    }
  }
  // the generic address of a shared-memory address
  __device__ const uint8_t* at(uint32_t addr) const {
    return gbase + (addr - base);
  }
  // row t's index in (B, S, H) arrays
  __device__ int64_t row(int t, int h) const {
    return (static_cast<int64_t>(b) * nc * chunk +
            static_cast<int64_t>(ic) * chunk + t) *
               H +
           h;
  }
  __device__ float* rows(int wg) const {
    return reinterpret_cast<float*>(gbase + L::kRows) + wg * kRowFloats;
  }
  // f32 fragments of score tile `slot`, this thread's 32 in 8 float4
  __device__ float4* frag(int slot, int t) const {
    return reinterpret_cast<float4*>(gbase + L::kFrags) +
           slot * (kFrag / 4) * kGroupThreads + t;
  }
};

// The score tiles of this warpgroup's 64 rows (from rows0) of the A tile
// a_t against the 64-row tiles lo up to hi - 1 of b_t, each into the f32
// fragment slot wg + its index: B . C^T in the column kernel, C . B^T in
// the row kernel.  Formed once a block and shared by the group's heads
// (G == 1), or once a head where kCbPerHead.
template <int NP, bool kState>
__device__ __forceinline__ void score_tiles(const Block<NP, kState>& blk,
                                            uint32_t a_t, uint32_t b_t,
                                            int rows0, int lo, int hi,
                                            int wg, int t) {
  uint32_t af[NP / 16][4];
  load_a<NP / 16>(af, a_t, kTile64, rows0, t);
  for (int i = lo; i < hi; ++i) {
    float acc[kFrag];
    zero(acc);
    hp::fence_regs(acc);
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NP / 16; ++kk)
      hp::wgmma_rs_m64n64k16<0>(acc, af[kk],
                                desc_k(b_t + i * kHalf, kTile64, kk), 1);
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(acc);
    float4* fr = blk.frag(wg + i, t);
#pragma unroll
    for (int q = 0; q < kFrag / 4; ++q)
      fr[q * kGroupThreads] = make_float4(acc[4 * q], acc[4 * q + 1],
                                          acc[4 * q + 2], acc[4 * q + 3]);
  }
}

// dt of row t of head h, 0 past the chunk
__device__ __forceinline__ float load_dt(const float* __restrict__ dt,
                                         int64_t row0, int t, int chunk,
                                         int H, int h, bool in) {
  return in && t < chunk ? __ldg(dt + (row0 + t) * H + h) : 0.f;
}

// ---------------------------------------------------------------------------
// 1. each chunk's local state and state gradient
// ---------------------------------------------------------------------------
template <int NP>
__global__ void __launch_bounds__(kBlockThreads, 1)
    states_kernel(const __grid_constant__ CUtensorMap x_map,
                  const __grid_constant__ CUtensorMap dy_map,
                  const __grid_constant__ CUtensorMap b_map,
                  const __grid_constant__ CUtensorMap c_map,
                  const float* __restrict__ dt, const float* __restrict__ a,
                  float* __restrict__ d_s,     // (B, nc, H, P, N)
                  float* __restrict__ d_g,     // (B, nc, H, P, N)
                  float* __restrict__ tot_out,  // (B, nc, H)
                  int S, int H, int P, int N, int chunk, int hpg) {
  extern __shared__ uint8_t smem_raw[];
  Block<NP, false> blk;
  blk.init(smem_raw, &x_map, &dy_map, nullptr, &b_map, &c_map, S, H, chunk,
           hpg);
  const int wg = threadIdx.x >> 7;
  const int t = threadIdx.x & 127;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int r0 = warp * 16 + (lane >> 2);
  const int cq = lane & 3;
  const int lm_row = lane & 7;
  const int lm_mat = lane >> 3;
  float* rs = blk.rows(wg);
  const int64_t row0 = static_cast<int64_t>(blk.b) * S +
                       static_cast<int64_t>(blk.ic) * chunk;
  // warpgroup 0: x weighted by u against B; 1: dy by e^{cum} against C
  const uint32_t m_t = blk.base + (wg == 0 ? BwdLayout<NP, false>::kB
                                           : BwdLayout<NP, false>::kC);
  float* out = wg == 0 ? d_s : d_g;
  float dt_next = load_dt(dt, row0, t, chunk, H, blk.h0, true);
  hp::mbar_wait(blk.bc_bar, 0);

  for (int k = 0; k < blk.nh; ++k) {
    const int h = blk.h0 + k;
    const float tot = head_rows(rs, dt_next, a[h] * kLog2e, chunk, t, 1 + wg);
    dt_next = load_dt(dt, row0, t, chunk, H, h + 1, k + 1 < blk.nh);
    const int64_t bch = (static_cast<int64_t>(blk.b) * blk.nc + blk.ic) * H +
                        h;
    if (wg == 0 && t == 0) tot_out[bch] = tot;
    blk.wait_full(k);
    const uint32_t v_t = blk.stage(k) + wg * kTile64;  // x or dy
    // A = (w (x) v)^T: v^T by ldmatrix.trans, scaled column by column
    uint32_t va[kL / 16][4];
    const int p = warp * 16 + 8 * (lm_mat & 1);
#pragma unroll
    for (int kk = 0; kk < kL / 16; ++kk) {
      const int l = kk * 16 + lm_row + 8 * (lm_mat >> 1);
      uint32_t vr[4];
      hp::ldmatrix_x4_trans(vr, v_t + swz(l, p));
      // vr[j]: row p + 8 (j & 1) of v^T, columns l0 and l0 + 1
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int l0 = kk * 16 + 8 * (j >> 1) + 2 * cq;
        float w0, w1;
        if (wg == 0) {
          w0 = rs[kREto + l0] * rs[kRDt + l0];
          w1 = rs[kREto + l0 + 1] * rs[kRDt + l0 + 1];
        } else {
          w0 = rs[kREcum + l0];
          w1 = rs[kREcum + l0 + 1];
        }
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<__nv_bfloat162*>(&vr[j]));
        va[kk][j] = hp::pack_bf16(f.x * w0, f.y * w1);
      }
    }
    float acc[NP / 2];
    zero(acc);
    hp::fence_regs(acc);
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kL / 16; ++kk)
#pragma unroll
      for (int j = 0; j < NP / 64; ++j) {
        float(&aj)[32] = *reinterpret_cast<float(*)[32]>(&acc[32 * j]);
        hp::wgmma_rs_m64n64k16<1>(aj, va[kk], desc_mn(m_t + j * kTile64, kk),
                                  1);
      }
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < kL / 16; ++kk) hp::fence_regs(va[kk]);
    blk.release(k);
    float* o = out + bch * P * N;
#pragma unroll
    for (int j = 0; j < NP / 64; ++j)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int pr = r0 + 8 * r;
          const int col = 64 * j + 8 * n + 2 * cq;
          if (pr < P && col < N)  // N % 8 == 0: a pair is in or out
            *reinterpret_cast<float2*>(o + pr * N + col) =
                make_float2(acc[32 * j + 4 * n + 2 * r],
                            acc[32 * j + 4 * n + 2 * r + 1]);
        }
  }
}

// ---------------------------------------------------------------------------
// 2. the carry across chunks
// ---------------------------------------------------------------------------
constexpr int kPassElems = 8;      // state elements a thread
constexpr int kPassThreads = 256;  // a block: a slice of the (P, N) state
constexpr int kMaxSlices = 4;      // slices of a (head, sequence): P N <= 8192
constexpr int kPassBatch = 32;     // chunks whose dots a block sums at once

// 8 floats at p, and 8 stored as bf16, 16-byte aligned
struct F8 {
  float4 lo, hi;
};
__device__ __forceinline__ F8 load8(const float* p) {
  return {*reinterpret_cast<const float4*>(p),
          *reinterpret_cast<const float4*>(p + 4)};
}
__device__ __forceinline__ void store8_bf16(bf16* p, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(hp::pack_bf16(v[0], v[1]), hp::pack_bf16(v[2], v[3]),
                 hp::pack_bf16(v[4], v[5]), hp::pack_bf16(v[6], v[7]));
}
// v <- decay v + f
__device__ __forceinline__ void decay_add(float (&v)[8], float decay,
                                          const F8& f) {
  const float a[8] = {f.lo.x, f.lo.y, f.lo.z, f.lo.w,
                      f.hi.x, f.hi.y, f.hi.z, f.hi.w};
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = decay * v[i] + a[i];
}

// 8 bf16 at p as floats, 16-byte aligned
__device__ __forceinline__ void load8_bf16(float (&v)[8], const bf16* p) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// A block per (head, sequence, slice of kPassThreads x 8 state elements).
// S is walked from the first chunk on, then G from the last back, each in
// f32 registers, each chunk's loads issued a chunk ahead (the walk's only
// dependence is the state in registers).  The backward walk forms each
// chunk's e^{total} <G, S> against S's bf16 copy (the operand the row
// products read; G in f32), and the slice's dots of kPassBatch chunks at a
// time are summed by warp shuffles and the warps' sums in order after one
// barrier; the slices' sums are added in order by row_kernel.
__global__ void __launch_bounds__(kPassThreads)
    pass_kernel(const float* __restrict__ d_s,  // (B, nc, H, P, N)
                const float* __restrict__ d_g,  // (B, nc, H, P, N)
                bf16* __restrict__ s_bf, bf16* __restrict__ g_bf,
                const float* __restrict__ dstate,  // (B, H, P, N) or null
                const float* __restrict__ tot,     // (B, nc, H)
                float* __restrict__ carried,       // (B, nc, H, slices)
                int nc, int H, int PN) {
  __shared__ float red[kPassBatch][kPassThreads / 32 + 1];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int slice = blockIdx.z;
  const int slices = gridDim.z;
  const int e0 = (slice * kPassThreads + threadIdx.x) * kPassElems;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  constexpr int nw = kPassThreads / 32;
  const bool live = e0 < PN;  // PN < 2048: the block's tail is idle
  const int64_t bh = static_cast<int64_t>(b) * H + h;
  const auto at = [&](int k) {  // (sequence, chunk, head)
    return (static_cast<int64_t>(b) * nc + k) * H + h;
  };
  float v[kPassElems];
  // S entering each chunk, from the first on: a bf16 copy
  if (live) {
#pragma unroll
    for (int i = 0; i < kPassElems; ++i) v[i] = 0.f;
    F8 next = load8(d_s + at(0) * PN + e0);
    float dnext = tot[at(0)];
    for (int k = 0; k < nc; ++k) {
      const F8 cur = next;
      const float decay = hp::ex2(dnext);
      if (k + 1 < nc) {
        next = load8(d_s + at(k + 1) * PN + e0);
        dnext = tot[at(k + 1)];
      }
      store8_bf16(s_bf + at(k) * PN + e0, v);
      decay_add(v, decay, cur);
    }
  }
  // G leaving each chunk, from the last back: a bf16 copy, and the dot
  // with S
  {
    const F8 d = live && dstate != nullptr
                     ? load8(dstate + bh * PN + e0)
                     : F8{make_float4(0.f, 0.f, 0.f, 0.f),
                          make_float4(0.f, 0.f, 0.f, 0.f)};
    const float a[8] = {d.lo.x, d.lo.y, d.lo.z, d.lo.w,
                        d.hi.x, d.hi.y, d.hi.z, d.hi.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = a[i];
  }
  F8 gn{};
  float sn[kPassElems] = {};
  float dn = 0.f;
  if (live) {
    gn = load8(d_g + at(nc - 1) * PN + e0);
    load8_bf16(sn, s_bf + at(nc - 1) * PN + e0);
    dn = tot[at(nc - 1)];
  }
  for (int k0 = nc - 1; k0 >= 0; k0 -= kPassBatch) {
    const int kn = min(kPassBatch, k0 + 1);
    for (int kk = 0; kk < kn; ++kk) {
      const int k = k0 - kk;
      float dot = 0.f;
      if (live) {
        const F8 gc = gn;
        float sc[kPassElems];
#pragma unroll
        for (int i = 0; i < kPassElems; ++i) sc[i] = sn[i];
        const float decay = hp::ex2(dn);
        if (k > 0) {
          gn = load8(d_g + at(k - 1) * PN + e0);
          load8_bf16(sn, s_bf + at(k - 1) * PN + e0);
          dn = tot[at(k - 1)];
        }
#pragma unroll
        for (int i = 0; i < kPassElems; ++i) dot += v[i] * sc[i];
        dot *= decay;
        store8_bf16(g_bf + at(k) * PN + e0, v);
        decay_add(v, decay, gc);
      }
      dot = repro::warp_sum(dot);
      if (lane == 0) red[kk][warp] = dot;
    }
    __syncthreads();
    for (int kk = warp; kk < kn; kk += nw) {
      float x = lane < nw ? red[kk][lane] : 0.f;
      x = repro::warp_sum(x);
      if (lane == 0) carried[at(k0 - kk) * slices + slice] = x;
    }
    __syncthreads();  // red is free for the next batch
  }
}

// ---------------------------------------------------------------------------
// 3. the column products: dx, dB, sum_i W_ij and V_j
// ---------------------------------------------------------------------------
template <int NP>
__global__ void __launch_bounds__(kBlockThreads, 1)
    col_kernel(const __grid_constant__ CUtensorMap x_map,
               const __grid_constant__ CUtensorMap dy_map,
               const __grid_constant__ CUtensorMap b_map,
               const __grid_constant__ CUtensorMap c_map,
               const __grid_constant__ CUtensorMap g_map,
               const float* __restrict__ dt, const float* __restrict__ a,
               const float* __restrict__ dsk, bf16* __restrict__ dx,
               float* __restrict__ colw_out,  // (B, nc, H, chunk)
               float* __restrict__ v_out,     // (B, nc, H, chunk)
               float* __restrict__ part_b,    // (B, S, groups, N)
               int S, int H, int P, int N, int chunk, int hpg) {
  using L = BwdLayout<NP, true>;
  extern __shared__ uint8_t smem_raw[];
  Block<NP, true> blk;
  blk.init(smem_raw, &x_map, &dy_map, &g_map, &b_map, &c_map, S, H, chunk,
           hpg);
  const int wg = threadIdx.x >> 7;
  const int t = threadIdx.x & 127;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int r0 = warp * 16 + (lane >> 2);
  const int cq = lane & 3;
  const int j0 = 64 * wg;  // this warpgroup's rows
  float* rs = blk.rows(wg);
  const int64_t row0 = static_cast<int64_t>(blk.b) * S +
                       static_cast<int64_t>(blk.ic) * chunk;
  const uint32_t c_t = blk.base + L::kC;
  const uint32_t b_t = blk.base + L::kB;
  float dt_next = load_dt(dt, row0, t, chunk, H, blk.h0, true);
  hp::mbar_wait(blk.bc_bar, 0);

  // B . C^T of the rows j, the column tiles I >= wg: slot I for
  // warpgroup 0, 2 for warpgroup 1
  if constexpr (!kCbPerHead) score_tiles(blk, b_t, c_t, j0, wg, 2, wg, t);

  float db[NP / 2];  // dB of the rows j, summed over the group's heads
  zero(db);
  for (int k = 0; k < blk.nh; ++k) {
    const int h = blk.h0 + k;
    head_rows(rs, dt_next, a[h] * kLog2e, chunk, t, 1 + wg);
    dt_next = load_dt(dt, row0, t, chunk, H, h + 1, k + 1 < blk.nh);
    float cumj[2], dtj[2], uj[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = j0 + r0 + 8 * r;
      cumj[r] = rs[kRCum + j];
      dtj[r] = rs[kRDt + j];
      uj[r] = rs[kREto + j] * dtj[r];
    }
    blk.wait_full(k);
    if constexpr (kCbPerHead) score_tiles(blk, b_t, c_t, j0, wg, 2, wg, t);
    const uint32_t x_t = blk.stage(k);
    const uint32_t dy_t = x_t + kTile64;
    const uint32_t g_t = x_t + 2 * kTile64;
    uint32_t xf[4][4];  // x of the rows j: the A operand of X G and Q^T
    load_a<4>(xf, x_t, 0, j0, t);

    // X G (one wgmma group, a 64-column chunk an instruction): V_j's sums
    // and dB's state term
    float vs[2] = {0.f, 0.f};
    {
      float xg[NP / 2];
      zero(xg);
      hp::fence_regs(xg);
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int jn = 0; jn < NP / 64; ++jn) {
          float(&xj)[32] = *reinterpret_cast<float(*)[32]>(&xg[32 * jn]);
          hp::wgmma_rs_m64n64k16<1>(xj, xf[kk],
                                    desc_mn(g_t + jn * kHalf, kk), 1);
        }
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_regs(xg);
#pragma unroll
      for (int jn = 0; jn < NP / 64; ++jn)
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int q = 32 * jn + 4 * n + 2 * r;
            const float2 bv = bf2(blk.at(
                b_t + jn * kTile64 + swz(j0 + r0 + 8 * r, 8 * n + 2 * cq)));
            vs[r] += xg[q] * bv.x + xg[q + 1] * bv.y;
            db[q] += uj[r] * xg[q];
            db[q + 1] += uj[r] * xg[q + 1];
          }
    }
    // dx's state term u_j (G B_j)
    float dxa[kFrag];
    {
      uint32_t bf[NP / 16][4];
      load_a<NP / 16>(bf, b_t, kTile64, j0, t);
      zero(dxa);
      hp::fence_regs(dxa);
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NP / 16; ++kk)
        hp::wgmma_rs_m64n64k16<0>(dxa, bf[kk], desc_k(g_t, kHalf, kk), 1);
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_regs(dxa);
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        dxa[4 * n + 2 * r] *= uj[r];
        dxa[4 * n + 2 * r + 1] *= uj[r];
      }

    // the column tiles i >= j: Q^T = X . dY^T, then on its f32 fragment
    // W (summed into sum_i W_ij) and the A operands of dx and dB
    float cw[2] = {0.f, 0.f};
    for (int I = wg; I < 2; ++I) {
      float qt[kFrag];
      zero(qt);
      hp::fence_regs(qt);
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hp::wgmma_rs_m64n64k16<0>(qt, xf[kk], desc_k(dy_t + I * kHalf, 0, kk),
                                  1);
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_regs(qt);
      const float4* fr = blk.frag(wg == 0 ? I : 2, t);
      uint32_t adx[4][4], adb[4][4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float4 c0 = fr[(2 * m) * kGroupThreads];
        const float4 c1 = fr[(2 * m + 1) * kGroupThreads];
        const float cbv[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
        for (int nn = 0; nn < 2; ++nn) {
          const int n = 2 * m + nn;
          const int i = 64 * I + 8 * n + 2 * cq;
          const float2 ci = *reinterpret_cast<const float2*>(rs + kRCum + i);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int j = j0 + r0 + 8 * r;
            const int q = 4 * n + 2 * r;
            const float e0 =
                i >= j && i < chunk ? hp::ex2(ci.x - cumj[r]) : 0.f;
            const float e1 =
                i + 1 >= j && i + 1 < chunk ? hp::ex2(ci.y - cumj[r]) : 0.f;
            const float m0 = cbv[4 * nn + 2 * r] * e0;
            const float m1 = cbv[4 * nn + 2 * r + 1] * e1;
            cw[r] += m0 * qt[q] + m1 * qt[q + 1];
            adx[m][2 * nn + r] = hp::pack_bf16(m0 * dtj[r], m1 * dtj[r]);
            adb[m][2 * nn + r] =
                hp::pack_bf16(e0 * dtj[r] * qt[q], e1 * dtj[r] * qt[q + 1]);
          }
        }
      }
      hp::fence_regs(dxa);
      hp::fence_regs(db);
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hp::wgmma_rs_m64n64k16<1>(dxa, adx[kk],
                                  desc_mn(dy_t + I * kHalf, kk), 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int jn = 0; jn < NP / 64; ++jn) {
          float(&dj)[32] = *reinterpret_cast<float(*)[32]>(&db[32 * jn]);
          hp::wgmma_rs_m64n64k16<1>(
              dj, adb[kk], desc_mn(c_t + jn * kTile64 + I * kHalf, kk), 1);
        }
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_regs(dxa);
      hp::fence_regs(db);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        hp::fence_regs(adx[kk]);
        hp::fence_regs(adb[kk]);
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hp::fence_regs(xf[kk]);

    // sum_i W_ij and V_j of the rows j, for the row pass: a head's rows
    // of the chunk contiguous, (B, nc, H, chunk)
    const int64_t bch =
        (static_cast<int64_t>(blk.b) * blk.nc + blk.ic) * H + h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float c_ = quad_sum(cw[r]);
      const float v_ = quad_sum(vs[r]);
      const int j = j0 + r0 + 8 * r;
      if (cq == 0 && j < chunk) {
        colw_out[bch * chunk + j] = c_;
        v_out[bch * chunk + j] = rs[kREto + j] * v_;
      }
    }
    // dx + d dy in bf16, staged by stmatrix in this warpgroup's own rows of
    // the x tile (x lives in registers since its A fragments were loaded)
    // and stored in 16-byte pieces: rows below the chunk, columns below P
    const float dh = dsk[h];
    const uint32_t stage_t = x_t + j0 * 128;
    {
      const int lm_row = lane & 7;
      const int lm_mat = lane >> 3;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        uint32_t v[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int n = 2 * m + (jj >> 1);
          const int r = jj & 1;
          const int q = 4 * n + 2 * r;
          const float2 dv =
              bf2(blk.at(dy_t + swz(j0 + r0 + 8 * r, 8 * n + 2 * cq)));
          v[jj] = hp::pack_bf16(dxa[q] + dh * dv.x, dxa[q + 1] + dh * dv.y);
        }
        hp::stmatrix_x4(stage_t + swz(warp * 16 + lm_row + 8 * (lm_mat & 1),
                                      16 * m + 8 * (lm_mat >> 1)),
                        v);
      }
    }
    __syncwarp();
#pragma unroll
    for (int qq = 0; qq < 4; ++qq) {
      const int row = warp * 16 + qq * 4 + (lane >> 3);  // of the group
      const int col = 8 * (lane & 7);
      const int j = j0 + row;
      const uint4 v =
          *reinterpret_cast<const uint4*>(blk.at(stage_t + swz(row, col)));
      if (j < chunk && col < P)
        *reinterpret_cast<uint4*>(dx + blk.row(j, h) * P + col) = v;
    }
    // the staging writes come before the stage's next TMA load
    hp::fence_proxy_async();
    blk.release(k);
  }

  // dB of the group, f32
  float* pb = part_b + (row0 * gridDim.x + blockIdx.x) * N;
#pragma unroll
  for (int jn = 0; jn < NP / 64; ++jn)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int j = j0 + r0 + 8 * r;
        const int col = 64 * jn + 8 * n + 2 * cq;
        const int q = 32 * jn + 4 * n + 2 * r;
        if (j < chunk && col < N)
          *reinterpret_cast<float2*>(
              pb + static_cast<int64_t>(j) * gridDim.x * N + col) =
              make_float2(db[q], db[q + 1]);
      }
}

// ---------------------------------------------------------------------------
// 4. the row products: dC; then the chunk's rows: ddt, da and dd partials
// ---------------------------------------------------------------------------
template <int NP>
__global__ void __launch_bounds__(kBlockThreads, 1)
    row_kernel(const __grid_constant__ CUtensorMap x_map,
               const __grid_constant__ CUtensorMap dy_map,
               const __grid_constant__ CUtensorMap b_map,
               const __grid_constant__ CUtensorMap c_map,
               const __grid_constant__ CUtensorMap s_map,
               const float* __restrict__ dt, const float* __restrict__ a,
               const float* __restrict__ colw_in,  // (B, nc, H, chunk)
               const float* __restrict__ v_in,     // (B, nc, H, chunk)
               const float* __restrict__ carried,  // (B, nc, H, slices)
               float* __restrict__ ddt_w,          // (B, nc, H, chunk)
               float* __restrict__ part_c,         // (B, S, groups, N)
               float* __restrict__ part_a,         // (B, nc, H)
               float* __restrict__ part_d,         // (B, nc, H)
               int S, int H, int N, int chunk, int hpg, int slices) {
  using L = BwdLayout<NP, true>;
  extern __shared__ uint8_t smem_raw[];
  Block<NP, true> blk;
  blk.init(smem_raw, &x_map, &dy_map, &s_map, &b_map, &c_map, S, H, chunk,
           hpg);
  const int wg = threadIdx.x >> 7;
  const int t = threadIdx.x & 127;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int r0 = warp * 16 + (lane >> 2);
  const int cq = lane & 3;
  const int i0 = 64 * wg;  // this warpgroup's rows
  float* rs = blk.rows(wg);
  float* cross = reinterpret_cast<float*>(blk.gbase + L::kCross);
  const int64_t row0 = static_cast<int64_t>(blk.b) * S +
                       static_cast<int64_t>(blk.ic) * chunk;
  const uint32_t c_t = blk.base + L::kC;
  const uint32_t b_t = blk.base + L::kB;
  float dt_next = load_dt(dt, row0, t, chunk, H, blk.h0, true);
  hp::mbar_wait(blk.bc_bar, 0);

  // C . B^T of the rows i, the column tiles J <= wg: slot 0 for warpgroup
  // 0, 1 + J for warpgroup 1
  if constexpr (!kCbPerHead) score_tiles(blk, c_t, b_t, i0, 0, wg + 1, wg, t);

  float dc[NP / 2];  // dC of the rows i, summed over the group's heads
  zero(dc);
  for (int k = 0; k < blk.nh; ++k) {
    const int h = blk.h0 + k;
    head_rows(rs, dt_next, a[h] * kLog2e, chunk, t, 1 + wg);
    dt_next = load_dt(dt, row0, t, chunk, H, h + 1, k + 1 < blk.nh);
    float cumi[2], ecumi[2], cdti[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = i0 + r0 + 8 * r;
      cumi[r] = rs[kRCum + i];
      ecumi[r] = rs[kREcum + i];
      cdti[r] = rs[kRCdt + i];
    }
    // warpgroup 0's row t: the column pass's sum_i W_ij and V_j and the
    // carried term, read now for the rows after the products
    const int64_t bch =
        (static_cast<int64_t>(blk.b) * blk.nc + blk.ic) * H + h;
    float colw = 0.f, vj = 0.f, carry = 0.f;
    if (wg == 0) {
      if (t < chunk) {
        colw = colw_in[bch * chunk + t];
        vj = v_in[bch * chunk + t];
      }
      for (int sl = 0; sl < slices; ++sl)  // the pass's slices in order
        carry += carried[bch * slices + sl];
    }
    blk.wait_full(k);
    if constexpr (kCbPerHead)
      score_tiles(blk, c_t, b_t, i0, 0, wg + 1, wg, t);
    const uint32_t x_t = blk.stage(k);
    const uint32_t dy_t = x_t + kTile64;
    const uint32_t s_t = x_t + 2 * kTile64;
    uint32_t yf[4][4];  // dy of the rows i: the A operand of dY S and Q
    load_a<4>(yf, dy_t, 0, i0, t);

    // dC's inter term e^{cum_i} S^T dy_i and its dot with C_i (one wgmma
    // group, a 64-column chunk an instruction)
    float ip[2] = {0.f, 0.f};
    {
      float ds[NP / 2];
      zero(ds);
      hp::fence_regs(ds);
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int jn = 0; jn < NP / 64; ++jn) {
          float(&dj)[32] = *reinterpret_cast<float(*)[32]>(&ds[32 * jn]);
          hp::wgmma_rs_m64n64k16<1>(dj, yf[kk],
                                    desc_mn(s_t + jn * kHalf, kk), 1);
        }
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_regs(ds);
#pragma unroll
      for (int jn = 0; jn < NP / 64; ++jn)
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int q = 32 * jn + 4 * n + 2 * r;
            const float2 cv = bf2(blk.at(
                c_t + jn * kTile64 + swz(i0 + r0 + 8 * r, 8 * n + 2 * cq)));
            ip[r] += ds[q] * cv.x + ds[q + 1] * cv.y;
            dc[q] += ecumi[r] * ds[q];
            dc[q + 1] += ecumi[r] * ds[q + 1];
          }
    }

    // the column tiles j <= i: Q = dY . X^T, then on its f32 fragment the
    // row sums of dt_j W_ij and of their gaps, Q_ii, and dC's A operand
    float rw[2] = {0.f, 0.f}, pr[2] = {0.f, 0.f}, dg[2] = {0.f, 0.f};
    for (int J = 0; J <= wg; ++J) {
      float qv[kFrag];
      zero(qv);
      hp::fence_regs(qv);
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hp::wgmma_rs_m64n64k16<0>(qv, yf[kk], desc_k(x_t + J * kHalf, 0, kk),
                                  1);
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_regs(qv);
      const float4* fr = blk.frag(wg == 0 ? 0 : 1 + J, t);
      uint32_t adc[4][4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float4 c0 = fr[(2 * m) * kGroupThreads];
        const float4 c1 = fr[(2 * m + 1) * kGroupThreads];
        const float cbv[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
        for (int nn = 0; nn < 2; ++nn) {
          const int n = 2 * m + nn;
          const int j = 64 * J + 8 * n + 2 * cq;
          const float2 cj = *reinterpret_cast<const float2*>(rs + kRCum + j);
          const float2 dj = *reinterpret_cast<const float2*>(rs + kRDt + j);
          const float2 tj = *reinterpret_cast<const float2*>(rs + kRCdt + j);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int i = i0 + r0 + 8 * r;
            const int q = 4 * n + 2 * r;
            const bool in0 = j <= i && i < chunk;
            const bool in1 = j + 1 <= i && i < chunk;
            const float e0 = in0 ? hp::ex2(cumi[r] - cj.x) : 0.f;
            const float e1 = in1 ? hp::ex2(cumi[r] - cj.y) : 0.f;
            const float w0 = cbv[4 * nn + 2 * r] * e0 * qv[q] * dj.x;
            const float w1 = cbv[4 * nn + 2 * r + 1] * e1 * qv[q + 1] * dj.y;
            rw[r] += w0 + w1;
            pr[r] += w0 * (cdti[r] - tj.x) + w1 * (cdti[r] - tj.y);
            if (in0 && j == i) dg[r] += qv[q];
            if (in1 && j + 1 == i) dg[r] += qv[q + 1];
            adc[m][2 * nn + r] =
                hp::pack_bf16(e0 * dj.x * qv[q], e1 * dj.y * qv[q + 1]);
          }
        }
      }
      hp::fence_regs(dc);
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int jn = 0; jn < NP / 64; ++jn) {
          float(&dj)[32] = *reinterpret_cast<float(*)[32]>(&dc[32 * jn]);
          hp::wgmma_rs_m64n64k16<1>(
              dj, adc[kk], desc_mn(b_t + jn * kTile64 + J * kHalf, kk), 1);
        }
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_regs(dc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) hp::fence_regs(adc[kk]);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hp::fence_regs(yf[kk]);

    // the rows' sums to both warpgroups' shared arrays (head parity)
    float* xr = cross + (k % L::kStages) * 4 * kL;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float rw_ = quad_sum(rw[r]);
      const float pr_ = quad_sum(pr[r]);
      const float ip_ = quad_sum(ip[r]);
      const float dg_ = quad_sum(dg[r]);
      const int i = i0 + r0 + 8 * r;
      if (cq == 0) {
        xr[i] = rw_;
        xr[kL + i] = pr_;
        xr[2 * kL + i] = ecumi[r] * ip_;
        xr[3 * kL + i] = dg_;
      }
    }
    // warpgroup 1 hands its rows over (a barrier and rows a stage: it
    // cannot lap warpgroup 0, which releases head k's stage only after
    // reading them); warpgroup 0 takes the chunk's rows, thread t row t
    if (wg == 1) {
      hp::named_bar_arrive(3 + k % L::kStages, kBlockThreads);
    } else {
      hp::named_bar_sync(3 + k % L::kStages, kBlockThreads);
      const bool in = t < chunk;
      const float dtv = rs[kRDt + t];
      const float cdtv = rs[kRCdt + t];
      const float last = rs[kRCdt + kL - 1];
      const float inter = xr[2 * kL + t];
      // sum_j dt_j V_j, the chunk's da and dd: shuffle trees, then the
      // four warps' sums in order
      float red[3] = {dtv * vj,
                      xr[kL + t] + cdtv * inter + dtv * vj * (last - cdtv),
                      xr[3 * kL + t]};
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        red[i] = repro::warp_sum(red[i]);
        if (lane == 0) rs[kRRed + 4 * i + warp] = red[i];
      }
      hp::named_bar_sync(1, kGroupThreads);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < 4; ++w) s += rs[kRRed + 4 * i + w];
        red[i] = s;
      }
      float dcum = xr[t] - dtv * colw + inter - dtv * vj;
      if (t == chunk - 1) dcum += carry + red[0];
      // dda: the reverse cumsum, a mirrored warp scan plus the later
      // warps' totals added from the last back
      float v = dcum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_down_sync(0xffffffffu, v, o);
        if (lane + o < 32) v += u;
      }
      if (lane == 0) rs[kRRev + warp] = v;
      hp::named_bar_sync(1, kGroupThreads);
      float off = 0.f, acc = 0.f;
#pragma unroll
      for (int w = 3; w >= 0; --w) {
        if (w == warp) off = acc;
        acc += rs[kRRev + w];
      }
      if (in) ddt_w[bch * chunk + t] = colw + vj + a[h] * (v + off);
      if (t == 0) {
        part_a[bch] = red[1] + last * carry;
        part_d[bch] = red[2];
      }
    }
    blk.release(k);
  }

  // dC of the group, f32
  float* pc = part_c + (row0 * gridDim.x + blockIdx.x) * N;
#pragma unroll
  for (int jn = 0; jn < NP / 64; ++jn)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = i0 + r0 + 8 * r;
        const int col = 64 * jn + 8 * n + 2 * cq;
        const int q = 32 * jn + 4 * n + 2 * r;
        if (i < chunk && col < N)
          *reinterpret_cast<float2*>(
              pc + static_cast<int64_t>(i) * gridDim.x * N + col) =
              make_float2(dc[q], dc[q + 1]);
      }
}

// ---------------------------------------------------------------------------
// 5. dB and dC over the groups, da and dd over (sequence, chunk), in order;
//    ddt from the row kernel's (B, nc, H, chunk) rows to (B, S, H)
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
    sums_kernel(const float* __restrict__ part_b,
                const float* __restrict__ part_c, bf16* __restrict__ db,
                bf16* __restrict__ dc, const float* __restrict__ ddt_w,
                float* __restrict__ ddt, const float* __restrict__ part_a,
                const float* __restrict__ part_d, float* __restrict__ da,
                float* __restrict__ dd, int64_t tokens, int N, int groups,
                int H, int S, int chunk, int bc_blocks, int ddt_blocks) {
  const int blk = blockIdx.x;
  if (blk < bc_blocks) {
    const int64_t e = static_cast<int64_t>(blk) * kThreads + threadIdx.x;
    if (e >= tokens * N) return;
    const int64_t tok = e / N;
    const int n = static_cast<int>(e - tok * N);
    const float* pb = part_b + tok * groups * N + n;
    const float* pc = part_c + tok * groups * N + n;
    float sb = 0.f, sc = 0.f;
    for (int g = 0; g < groups; ++g) {
      sb += pb[static_cast<int64_t>(g) * N];
      sc += pc[static_cast<int64_t>(g) * N];
    }
    db[e] = __float2bfloat16(sb);
    dc[e] = __float2bfloat16(sc);
  } else if (blk < bc_blocks + ddt_blocks) {
    const int64_t e =
        static_cast<int64_t>(blk - bc_blocks) * kThreads + threadIdx.x;
    if (e >= tokens * H) return;
    const int64_t tok = e / H;
    const int h = static_cast<int>(e - tok * H);
    const int64_t b = tok / S;
    const int s = static_cast<int>(tok - b * S);
    const int nc = S / chunk;
    const int ic = s / chunk;
    ddt[e] = ddt_w[((b * nc + ic) * H + h) * chunk + (s - ic * chunk)];
  } else {
    const int h = (blk - bc_blocks - ddt_blocks) * kThreads + threadIdx.x;
    if (h >= H) return;
    const int chunks = static_cast<int>(tokens / chunk);
    float sa = 0.f, sd = 0.f;
    for (int k = 0; k < chunks; ++k) {
      sa += part_a[static_cast<int64_t>(k) * H + h];
      sd += part_d[static_cast<int64_t>(k) * H + h];
    }
    da[h] = sa;
    dd[h] = sd;
  }
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------
constexpr int kMaxKernels = 5;  // kernels a call launches (bf16; f32 4)
using KernelTimes = repro::KernelTimes<kMaxKernels>;

struct Call {
  const void *x, *b, *c, *dy;
  const float *dt, *a, *d, *dstate;
  void *dx, *db, *dc;
  float *ddt, *da, *dd, *work;
  int B, S, H, P, N, chunk, hpg;
};

// floats of the workspace.  bf16: the local states and state gradients
// (B, nc, H, P, N) f32 each, the carried states' bf16 copies (half as many
// floats), the chunks' totals and the da and dd partials (B, nc, H) each,
// the carried terms' slices (B, nc, H, kMaxSlices), sum_i W_ij, V_j and
// ddt (B, nc, H, chunk) each, dB's and dC's partials a head group (B, S,
// groups, N) each.  f32: S and G, (B, nc, H, P, N) each; the dB and dC
// partials, (B, S, H, N) each; the da and dd partials, (B, nc, H) each.
int64_t workspace_floats(bool bf16_route, int B, int S, int H, int P, int N,
                         int chunk, int groups) {
  const int64_t nc = S / chunk;
  const int64_t bs = static_cast<int64_t>(B) * S;
  if (!bf16_route)
    return 2 * B * nc * H * P * N + 2 * bs * H * N + 2 * B * nc * H;
  return 3 * B * nc * H * P * N + (3 + kMaxSlices) * B * nc * H +
         3 * bs * H + 2 * bs * groups * N;
}

template <int P, int N>
cudaError_t launch(const Call& c, KernelTimes& t) {
  const size_t carry_smem = CarrySmem<P, N>::kBytes;
  const size_t chunk_smem = ChunkSmem<P, N>::kBytes;
  cudaError_t err;
  if ((err = repro::set_smem(carry_kernel<P, N>, carry_smem)) !=
          cudaSuccess ||
      (err = repro::set_smem(chunk_kernel<P, N>, chunk_smem)) !=
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
  const float* x = static_cast<const float*>(c.x);
  const float* dy = static_cast<const float*>(c.dy);
  const float* bm = static_cast<const float*>(c.b);
  const float* cm = static_cast<const float*>(c.c);
  if ((err = t.mark()) != cudaSuccess) return err;
  carry_kernel<P, N><<<dim3(c.H, c.B, 2), kThreads, carry_smem, t.stream>>>(
      x, dy, c.dt, c.a, bm, cm, c.dstate, states, dstates, c.S, c.H, c.chunk);
  if ((err = cudaGetLastError()) != cudaSuccess ||
      (err = t.mark()) != cudaSuccess)
    return err;
  chunk_kernel<P, N><<<dim3(c.H, nc, c.B), kThreads, chunk_smem, t.stream>>>(
      x, dy, c.dt, c.a, bm, cm, c.d, states, dstates,
      static_cast<float*>(c.dx), c.ddt, part_b, part_c, part_a, part_d, c.S,
      c.H, c.chunk);
  if ((err = cudaGetLastError()) != cudaSuccess ||
      (err = t.mark()) != cudaSuccess)
    return err;
  const int64_t tokens = static_cast<int64_t>(c.B) * c.S;
  reduce_bc_kernel<<<static_cast<unsigned>((tokens * N + kThreads - 1) /
                                            kThreads),
                      kThreads, 0, t.stream>>>(
      part_b, part_c, static_cast<float*>(c.db), static_cast<float*>(c.dc),
      tokens, c.H, N);
  if ((err = cudaGetLastError()) != cudaSuccess ||
      (err = t.mark()) != cudaSuccess)
    return err;
  reduce_heads_kernel<<<(c.H + kThreads - 1) / kThreads, kThreads, 0,
                        t.stream>>>(part_a, part_d, c.da, c.dd, c.B * nc,
                                    c.H);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return t.mark();
}

template <int P>
cudaError_t launch_n(const Call& c, KernelTimes& t) {
  switch (c.N) {
    case 16:
      return launch<P, 16>(c, t);
    case 32:
      return launch<P, 32>(c, t);
    case 64:
      return launch<P, 64>(c, t);
    case 128:
      return launch<P, 128>(c, t);
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t launch_pn(const Call& c, KernelTimes& t) {
  switch (c.P) {
    case 32:
      return launch_n<32>(c, t);
    case 64:
      return launch_n<64>(c, t);
    default:
      return cudaErrorInvalidValue;
  }
}

// the bf16 route: maps over x, dy, B, C and the states' bf16 copies, then
// the five kernels in order
template <int NP>
cudaError_t launch_bf16(const Call& c, KernelTimes& t) {
  const int nc = c.S / c.chunk;
  const int groups = (c.H + c.hpg - 1) / c.hpg;
  const int64_t X = static_cast<int64_t>(c.B) * nc * c.H * c.P * c.N;
  const int64_t bch = static_cast<int64_t>(c.B) * nc * c.H;
  const int64_t bsh = static_cast<int64_t>(c.B) * c.S * c.H;
  float* d_s = c.work;
  float* d_g = d_s + X;
  bf16* s_bf = reinterpret_cast<bf16*>(d_g + X);
  bf16* g_bf = s_bf + X;
  float* tot = d_g + 2 * X;
  float* carried = tot + bch;  // kMaxSlices a (sequence, chunk, head)
  float* part_a = carried + kMaxSlices * bch;
  float* part_d = part_a + bch;
  float* colw = part_d + bch;
  float* vj = colw + bsh;
  float* ddt_w = vj + bsh;
  float* part_b = ddt_w + bsh;
  float* part_c = part_b + static_cast<int64_t>(c.B) * c.S * groups * c.N;

  CUtensorMap x_map, dy_map, b_map, c_map, s_map, g_map;
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  cudaError_t err = hp::encode_bshd(&x_map, c.x, c.B, c.S, c.H, c.P, kL, 64,
                                    sw);
  if (err == cudaSuccess)
    err = hp::encode_bshd(&dy_map, c.dy, c.B, c.S, c.H, c.P, kL, 64, sw);
  if (err == cudaSuccess)
    err = hp::encode_bshd(&b_map, c.b, c.B, c.S, 1, c.N, kL, 64, sw);
  if (err == cudaSuccess)
    err = hp::encode_bshd(&c_map, c.c, c.B, c.S, 1, c.N, kL, 64, sw);
  // the (P, N) states of each (sequence, chunk, head) as 64-row boxes
  if (err == cudaSuccess)
    err = hp::encode_bshd(&s_map, s_bf, static_cast<int>(bch), c.P, 1, c.N,
                          64, 64, sw);
  if (err == cudaSuccess)
    err = hp::encode_bshd(&g_map, g_bf, static_cast<int>(bch), c.P, 1, c.N,
                          64, 64, sw);
  if (err != cudaSuccess) return err;
  const size_t smem_s = bwd_smem_bytes<NP, false>();
  const size_t smem = bwd_smem_bytes<NP, true>();
  if ((err = repro::set_smem(states_kernel<NP>, smem_s)) != cudaSuccess ||
      (err = repro::set_smem(col_kernel<NP>, smem)) != cudaSuccess ||
      (err = repro::set_smem(row_kernel<NP>, smem)) != cudaSuccess)
    return err;
  const dim3 grid(groups, nc, c.B);
  const float* dt = c.dt;
  if ((err = t.mark()) != cudaSuccess) return err;
  states_kernel<NP><<<grid, kBlockThreads, smem_s, t.stream>>>(
      x_map, dy_map, b_map, c_map, dt, c.a, d_s, d_g, tot, c.S, c.H, c.P,
      c.N, c.chunk, c.hpg);
  if ((err = cudaGetLastError()) != cudaSuccess ||
      (err = t.mark()) != cudaSuccess)
    return err;
  const int pn = c.P * c.N;
  const int slices = (pn + kPassThreads * kPassElems - 1) /
                     (kPassThreads * kPassElems);
  pass_kernel<<<dim3(c.H, c.B, slices), kPassThreads, 0, t.stream>>>(
      d_s, d_g, s_bf, g_bf, c.dstate, tot, carried, nc, c.H, pn);
  if ((err = cudaGetLastError()) != cudaSuccess ||
      (err = t.mark()) != cudaSuccess)
    return err;
  col_kernel<NP><<<grid, kBlockThreads, smem, t.stream>>>(
      x_map, dy_map, b_map, c_map, g_map, dt, c.a, c.d,
      static_cast<bf16*>(c.dx), colw, vj, part_b, c.S, c.H, c.P, c.N,
      c.chunk, c.hpg);
  if ((err = cudaGetLastError()) != cudaSuccess ||
      (err = t.mark()) != cudaSuccess)
    return err;
  row_kernel<NP><<<grid, kBlockThreads, smem, t.stream>>>(
      x_map, dy_map, b_map, c_map, s_map, dt, c.a, colw, vj, carried, ddt_w,
      part_c, part_a, part_d, c.S, c.H, c.N, c.chunk, c.hpg, slices);
  if ((err = cudaGetLastError()) != cudaSuccess ||
      (err = t.mark()) != cudaSuccess)
    return err;
  const int64_t tokens = static_cast<int64_t>(c.B) * c.S;
  const int bc_blocks =
      static_cast<int>((tokens * c.N + kThreads - 1) / kThreads);
  const int ddt_blocks =
      static_cast<int>((tokens * c.H + kThreads - 1) / kThreads);
  sums_kernel<<<bc_blocks + ddt_blocks + (c.H + kThreads - 1) / kThreads,
                kThreads, 0, t.stream>>>(
      part_b, part_c, static_cast<bf16*>(c.db), static_cast<bf16*>(c.dc),
      ddt_w, c.ddt, part_a, part_d, c.da, c.dd, tokens, c.N, groups, c.H,
      c.S, c.chunk, bc_blocks, ddt_blocks);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return t.mark();
}

// registers and local memory a thread (spills) of a compiled kernel
template <typename Kernel>
cudaError_t kernel_regs(Kernel kernel, int64_t* out) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = static_cast<int64_t>(attr.localSizeBytes);
  return cudaSuccess;
}

// The bf16 route's wgmma kernels as built: registers and local bytes a
// thread of states_kernel, col_kernel and row_kernel, then their dynamic
// shared memory.
template <int NP>
cudaError_t plan_bf16(int64_t* out) {
  cudaError_t err;
  if ((err = kernel_regs(states_kernel<NP>, out)) != cudaSuccess ||
      (err = kernel_regs(col_kernel<NP>, out + 2)) != cudaSuccess ||
      (err = kernel_regs(row_kernel<NP>, out + 4)) != cudaSuccess)
    return err;
  out[6] = bwd_smem_bytes<NP, true>();
  return cudaSuccess;
}

}  // namespace

// Packed arguments (common.cuh: Args), in order: device, dtype, x, dt, a,
// b, c, d (H f32: the skip weight, zeros for none), dy, dstate (the final
// state's cotangent, (B, H, P, N) f32, or 0 for none), dx, ddt (f32), da,
// db, dc, dd (f32), work (f32 workspace), work_floats (its length, at least
// workspace_floats), B, S, H, P, N, chunk, heads_per_group (bf16: the heads
// a block of the wgmma kernels takes), times (0, or a host array of
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
  c.hpg = a.i32(24);
  const int dtype = a.i32(1);
  const bool bf16_route = dtype == REPRO_BF16;
  if (c.B <= 0 || c.B > 65535 || c.S <= 0 || c.H <= 0 || c.chunk <= 0 ||
      c.chunk > kMaxChunk || c.S % c.chunk != 0 || c.S / c.chunk > 65535 ||
      c.hpg <= 0 || c.hpg > c.H ||
      work_floats < workspace_floats(bf16_route, c.B, c.S, c.H, c.P, c.N,
                                     c.chunk, (c.H + c.hpg - 1) / c.hpg))
    return cudaErrorInvalidValue;
  KernelTimes t{static_cast<float*>(a.ptr(25)),
                static_cast<cudaStream_t>(a.ptr(26))};
  switch (dtype) {
    case REPRO_F32:
      return t.finish(launch_pn(c, t));
    case REPRO_BF16:
      if ((c.P != 32 && c.P != 64) || c.N % 16 != 0 || c.N > 128)
        return cudaErrorInvalidValue;
      return t.finish(c.N <= 64 ? launch_bf16<64>(c, t)
                                : launch_bf16<128>(c, t));
    default:
      return cudaErrorInvalidValue;
  }
}

// Packed arguments (common.cuh: Args), in order: device, N, out (host
// int64[7]): plan_bf16's registers and local bytes of states_kernel,
// col_kernel and row_kernel, then their dynamic shared memory.
extern "C" int repro_ssd_bwd_plan(const void* packed) {
  const repro::Args a(packed);
  cudaError_t err = repro::use_device(a.i32(0));
  if (err != cudaSuccess) return err;
  const int N = a.i32(1);
  if (N <= 0 || N > 128) return cudaErrorInvalidValue;
  int64_t* out = static_cast<int64_t*>(a.ptr(2));
  return N <= 64 ? plan_bf16<64>(out) : plan_bf16<128>(out);
}
