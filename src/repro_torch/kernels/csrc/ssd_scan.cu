// Mamba2 SSD chunked scan (prefill).
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py:83 ssd_chunk_scan_pallas
// (body _kernel).  It computes what that body computes, not block for
// block.  Per chunk of L <= 128 tokens, with cum = cumsum(dt * a):
//
//   y_i   = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j   (intra)
//         + exp(cum_i) C_i . state                                 (inter)
//         + d x_i                                                  (skip)
//   state <- state exp(cum_L) + sum_j exp(cum_L - cum_j) dt_j B_j (x) x_j
//
// y is stored in x's dtype, the final state (B, H, P, N) in f32.  The
// decay is evaluated only for j <= i, as a select: above the diagonal
// cum_i - cum_j > 0 could overflow, and inf times a zero mask is NaN.  The
// TPU kernel's sequential chunk axis becomes a loop over chunks inside the
// block, and its VMEM state scratch a state that lives for the whole
// sequence.
//
// What bounds it on the H100.  At mamba2's prefill (B 8, S 1024, H 80,
// P 64, N 128) the scan moves ~196 MB (x and y dominate: ~0.06 ms at
// 3.35 TB/s) and does ~27 GFLOP (~0.03 ms on the bf16 tensor cores, ~0.4
// ms on f32 CUDA cores).  Each block walks its chunks in order, so what
// sets the pace is the chain of dependent steps a chunk takes inside one
// block (one block an SM: ~216 KB of shared memory at N 128): the scores,
// the decayed weights (one exp2 per score), the products, the epilogue.
// The design runs every product on the tensor cores, keeps loads off that
// chain and overlaps what it can inside it.
//
// bf16: warpgroup MMA fed by TMA (ssd_wgmma_kernel).
//   * A block takes one (head, sequence), 640 blocks at mamba2's shape,
//     and runs two warpgroups of 64 chunk rows each; one thread of the
//     second also issues the loads.  No producer warp: with 256 threads a
//     thread may hold 255 registers, with a ninth warp 168, and the state
//     update's operands then spill.
//   * TMA brings each chunk's C and B (128 rows x N) and x (128 rows x 64)
//     into a ring of two stages, a full and an empty mbarrier each, so
//     chunk k + 1 arrives while chunk k computes.  The tensor maps are 4-D
//     over (N, 1, S, B) and (P, H, S, B): rows past S and columns past P
//     or N (x tiles are laid out for 64 columns, C and B for 64 or 128)
//     arrive as zeros, never the next sequence's rows.  Rows of the box at
//     or past `chunk` (the next chunk's) are masked by `chunk`.  Each box
//     lands with the 128-byte swizzle the wgmma descriptors name.
//   * dt is read one chunk ahead into registers (a row a thread).  cum =
//     cumsum(dt a log2 e) is a warp scan (shuffles) plus the warp totals
//     added in order; the order differs from the plain scan's, which
//     moves the last bits only.
//   * Products, bf16 operands and f32 accumulators, all on wgmma with the
//     A operand in registers (C and x^T by ldmatrix) and B in shared
//     memory, so that each reads half the shared-memory bytes of a
//     two-operand product:
//       S = C . B^T        B K-major;
//       y = C . state^T    the inter term, B = a bf16 copy of the state,
//                          issued while W is formed, then scaled row by row
//                          by e^{cum_i} in f32;
//       y += W . X         W (i, j) = j <= i ? S e^{cum_i - cum_j} dt_j : 0
//                          on the S fragment, rounded to bf16 as the A
//                          operand (as flash does P . V); X N-major;
//       state += xu^T . B  xu_j = e^{cum_L - cum_j} dt_j x_j (u folded into
//                          x, a 64-column operand, not into B) as two bf16
//                          operands, its rounding and the remainder: the
//                          state, which decode steps carry on, keeps ~16
//                          bits of it (with one bf16 operand it misses the
//                          1e-4 of its magnitude that the per-layer checks
//                          hold it to); B N-major.
//     Warpgroup 0 (rows 0-63) forms only the columns j < 64 of S and W.
//   * The state stays f32 for the whole sequence, as the accumulator of
//     warpgroup 0 (whose rows see half the columns), decayed in registers
//     each chunk.  Only a bf16 copy, double-buffered and announced by an
//     mbarrier a parity, is an operand.  The TPU's MXU rounds f32 factors
//     to bf16 the same way at default precision.  (Splitting the state's
//     columns between the warpgroups was slower at N 128: the second
//     warpgroup's chain, with all 128 score columns, grew the longer.)
//   * Overlap: the inter term runs while W is formed; the state update's
//     first half is built while W . X runs, its second runs beside the
//     epilogue; warpgroup 1 issues chunk k + 1's scores right after its
//     W . X, warpgroup 0 after the state update.
//   * Epilogue: y + d x in f32, rounded to bf16, staged through shared
//     memory by stmatrix (a warp's own 16 rows) and stored in 16-byte
//     pieces for rows below `chunk` and columns below P.
//   Scores shared by two heads of a block (G == 1 makes them equal) were
//   built and timed: no faster per head, with half the blocks (PERF.md).
// f32: the first version's CUDA-core body (ssd_scan_kernel), one block per
//   (head, sequence), the (P, N) state in shared memory, every product an
//   f32 FMA; kept for the correctness checks held to 1e-4, which bf16
//   operands would miss.  Its thread layout is noted at the kernel.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 128;
constexpr int kTileRows = 32;                     // rows of a C / W tile
constexpr int kRowsPerWarp = kTileRows / kWarps;  // 4
constexpr int kColGroups = kMaxChunk / 32;        // score columns per lane

// padded row stride of B in shared memory, in elements: an odd number of
// 32-bit words
template <typename T, int N>
constexpr int b_ld() {
  return sizeof(T) == 4 ? N + 1 : N + 2;
}

constexpr size_t align16(size_t x) { return (x + 15) / 16 * 16; }

// byte offsets of the shared-memory buffers, each 16-byte aligned
template <typename T, int P, int N>
struct Smem {
  static constexpr int kBLd = b_ld<T, N>();
  static constexpr int kSLd = N + 1;  // state row stride (f32, odd)
  static constexpr size_t kState = 0;
  static constexpr size_t kW = align16(kState + sizeof(float) * P * kSLd);
  static constexpr size_t kRow = align16(kW + sizeof(float) * kTileRows *
                                       kMaxChunk);  // cum, dt, e^cum, u
  static constexpr size_t kB = align16(kRow + sizeof(float) * 4 * kMaxChunk);
  static constexpr size_t kX = align16(kB + sizeof(T) * kMaxChunk * kBLd);
  static constexpr size_t kC = align16(kX + sizeof(T) * kMaxChunk * P);
  static constexpr size_t kBytes = align16(kC + sizeof(T) * kTileRows * N);
};

// The f32 body: blocks run one per (head, sequence): 640 blocks at B = 8,
// H = 80.  Inputs stay in their storage dtype in shared memory: the B and
// x rows of the chunk, and C in tiles of 32 rows.  256 threads = 8 warps;
// for a row tile warp w owns rows 4w .. 4w + 3:
//   scores  lane owns columns j = lane + 32k (k up to the causal horizon);
//           the decayed weights W (32 x L, f32) go to shared memory and are
//           read back by the same warp only;
//   y       lane owns columns p = lane + 32k of P, intra and inter parts
//           summed in registers, then the skip term, then one store;
//   state   thread owns a (P / (256 / NL)) x (N / NL) register tile, NL =
//           min(N, 32) lanes along N, accumulated over the chunk's rows and
//           folded into the shared state after every row tile has read it.
// Row strides of B in shared memory are padded to an odd number of 32-bit
// words, so lanes reading consecutive rows hit distinct banks.
template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const T* __restrict__ x,       // (B, S, H, P)
                    const float* __restrict__ dt,  // (B, S, H)
                    const float* __restrict__ a,   // (H,)
                    const T* __restrict__ bm,      // (B, S, N)
                    const T* __restrict__ cm,      // (B, S, N)
                    const float* __restrict__ dsk, // (H,)
                    T* __restrict__ y,             // (B, S, H, P)
                    float* __restrict__ state_out, // (B, H, P, N)
                    int S, int H, int chunk) {
  using L = Smem<T, P, N>;
  constexpr int BLD = L::kBLd;
  constexpr int SLD = L::kSLd;
  constexpr int PK = P / 32;                   // y columns per lane
  constexpr int NL = N < 32 ? N : 32;          // state lanes along N
  constexpr int PG = kThreads / NL;            // state row groups
  constexpr int SP = P / PG;                   // state rows per thread
  constexpr int SN = N / NL;                   // state columns per thread
  static_assert(P % 32 == 0 && N % 16 == 0 && P % PG == 0, "tile shape");

  extern __shared__ __align__(16) unsigned char smem[];
  float* st = reinterpret_cast<float*>(smem + L::kState);  // P x SLD
  float* ws = reinterpret_cast<float*>(smem + L::kW);      // 32 x 128
  float* cum = reinterpret_cast<float*>(smem + L::kRow);
  float* dts = cum + kMaxChunk;
  float* ecum = dts + kMaxChunk;  // exp(cum_i)
  float* us = ecum + kMaxChunk;   // exp(cum_L - cum_j) * dt_j
  T* bs = reinterpret_cast<T*>(smem + L::kB);  // chunk x BLD
  T* xs = reinterpret_cast<T*>(smem + L::kX);  // chunk x P
  T* cs = reinterpret_cast<T*>(smem + L::kC);  // 32 x N

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const float ah = a[h];
  const float dh = dsk[h];
  const int64_t x_tok = static_cast<int64_t>(H) * P;

  for (int i = tid; i < P * SLD; i += kThreads) st[i] = 0.f;

  // state tile of this thread: rows sp0 + PG * r, columns sn0 + NL * k
  const int sp0 = tid / NL;
  const int sn0 = tid % NL;

  const int n_chunks = S / chunk;
  for (int ic = 0; ic < n_chunks; ++ic) {
    const int64_t s0 = static_cast<int64_t>(b) * S + ic * chunk;  // token
    __syncthreads();  // the previous chunk is done with every buffer
    // ---- this chunk's rows: dt, B, x ----
    for (int j = tid; j < chunk; j += kThreads)
      dts[j] = dt[(s0 + j) * H + h];
    for (int i = tid; i < chunk * N; i += kThreads) {
      const int j = i / N;
      bs[j * BLD + (i - j * N)] = bm[s0 * N + i];
    }
    for (int i = tid; i < chunk * P; i += kThreads) {
      const int j = i / P;
      const int p = i - j * P;
      xs[i] = x[(s0 + j) * x_tok + static_cast<int64_t>(h) * P + p];
    }
    __syncthreads();
    if (tid == 0) {  // cumsum(dt * a), in order, as the TPU kernel's cumsum
      float acc = 0.f;
      for (int j = 0; j < chunk; ++j) {
        acc += dts[j] * ah;
        cum[j] = acc;
      }
    }
    __syncthreads();
    const float total = cum[chunk - 1];
    for (int j = tid; j < chunk; j += kThreads) {
      ecum[j] = expf(cum[j]);
      us[j] = expf(total - cum[j]) * dts[j];
    }
    __syncthreads();

    // ---- y, 32 rows at a time ----
    for (int i0 = 0; i0 < chunk; i0 += kTileRows) {
      const int rows = min(kTileRows, chunk - i0);
      for (int i = tid; i < kTileRows * N; i += kThreads)
        cs[i] = i < rows * N ? cm[(s0 + i0) * N + i]
                             : repro::from_float<T>(0.f);
      __syncthreads();

      const int r0 = warp * kRowsPerWarp;  // first tile row of this warp
      // scores and decayed weights W[r][j] for j < i0 + 32
      const int n_groups = (i0 + kTileRows) / 32;
      float sc[kRowsPerWarp][kColGroups];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
        for (int k = 0; k < kColGroups; ++k) sc[r][k] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[kRowsPerWarp];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r)
          cv[r] = repro::to_float(cs[(r0 + r) * N + n]);
#pragma unroll
        for (int k = 0; k < kColGroups; ++k) {
          if (k < n_groups) {
            const int j = lane + 32 * k;
            const float bv = j < chunk ? repro::to_float(bs[j * BLD + n]) : 0.f;
#pragma unroll
            for (int r = 0; r < kRowsPerWarp; ++r)
              sc[r][k] = fmaf(cv[r], bv, sc[r][k]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int i = i0 + r0 + r;
#pragma unroll
        for (int k = 0; k < kColGroups; ++k) {
          if (k < n_groups) {
            const int j = lane + 32 * k;
            float w = 0.f;
            if (i < chunk && j <= i)
              w = sc[r][k] * expf(cum[i] - cum[j]) * dts[j];
            ws[(r0 + r) * kMaxChunk + j] = w;
          }
        }
      }
      __syncwarp();  // W rows r0 .. r0 + 3 are this warp's own

      float yi[kRowsPerWarp][PK];  // intra
      float ye[kRowsPerWarp][PK];  // inter (before exp(cum_i))
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
        for (int k = 0; k < PK; ++k) yi[r][k] = ye[r][k] = 0.f;
      const int j_end = min(i0 + r0 + kRowsPerWarp, chunk);
      for (int j = 0; j < j_end; ++j) {
        float wv[kRowsPerWarp];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r)
          wv[r] = ws[(r0 + r) * kMaxChunk + j];
#pragma unroll
        for (int k = 0; k < PK; ++k) {
          const float xv = repro::to_float(xs[j * P + lane + 32 * k]);
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r)
            yi[r][k] = fmaf(wv[r], xv, yi[r][k]);
        }
      }
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[kRowsPerWarp];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r)
          cv[r] = repro::to_float(cs[(r0 + r) * N + n]);
#pragma unroll
        for (int k = 0; k < PK; ++k) {
          const float sv = st[(lane + 32 * k) * SLD + n];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r)
            ye[r][k] = fmaf(cv[r], sv, ye[r][k]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int i = i0 + r0 + r;
        if (i < chunk) {
          T* yr = y + (s0 + i) * x_tok + static_cast<int64_t>(h) * P;
#pragma unroll
          for (int k = 0; k < PK; ++k) {
            const int p = lane + 32 * k;
            const float xv = repro::to_float(xs[i * P + p]);
            const float out = yi[r][k] + ye[r][k] * ecum[i] + dh * xv;
            yr[p] = repro::from_float<T>(out);
          }
        }
      }
      __syncthreads();  // every warp is done with cs (and with st, last tile)
    }

    // ---- state update ----
    float acc[SP][SN];
#pragma unroll
    for (int r = 0; r < SP; ++r)
#pragma unroll
      for (int k = 0; k < SN; ++k) acc[r][k] = 0.f;
    for (int j = 0; j < chunk; ++j) {
      const float u = us[j];
      float xv[SP];
#pragma unroll
      for (int r = 0; r < SP; ++r)
        xv[r] = u * repro::to_float(xs[j * P + sp0 + PG * r]);
#pragma unroll
      for (int k = 0; k < SN; ++k) {
        const float bv = repro::to_float(bs[j * BLD + sn0 + NL * k]);
#pragma unroll
        for (int r = 0; r < SP; ++r) acc[r][k] = fmaf(xv[r], bv, acc[r][k]);
      }
    }
    const float decay = expf(total);
#pragma unroll
    for (int r = 0; r < SP; ++r)
#pragma unroll
      for (int k = 0; k < SN; ++k) {
        float* sv = st + (sp0 + PG * r) * SLD + sn0 + NL * k;
        *sv = *sv * decay + acc[r][k];
      }
  }

  __syncthreads();
  float* so = state_out + (static_cast<int64_t>(b) * H + h) * P * N;
  for (int i = tid; i < P * N; i += kThreads) {
    const int p = i / N;
    so[i] = st[p * SLD + (i - p * N)];
  }
}

template <typename T, int P, int N>
cudaError_t launch(const void* x, const float* dt, const float* a,
                   const void* b, const void* c, const float* d, void* y,
                   float* state, int B, int S, int H, int chunk,
                   cudaStream_t stream) {
  const size_t smem = Smem<T, P, N>::kBytes;
  cudaError_t err = repro::set_smem(ssd_scan_kernel<T, P, N>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, B);
  ssd_scan_kernel<T, P, N><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, a, static_cast<const T*>(b),
      static_cast<const T*>(c), d, static_cast<T*>(y), state, S, H, chunk);
  return cudaGetLastError();
}

template <typename T, int P>
cudaError_t launch_n(int N, const void* x, const float* dt, const float* a,
                     const void* b, const void* c, const float* d, void* y,
                     float* state, int B, int S, int H, int chunk,
                     cudaStream_t s) {
  switch (N) {
    case 16:
      return launch<T, P, 16>(x, dt, a, b, c, d, y, state, B, S, H, chunk, s);
    case 32:
      return launch<T, P, 32>(x, dt, a, b, c, d, y, state, B, S, H, chunk, s);
    case 64:
      return launch<T, P, 64>(x, dt, a, b, c, d, y, state, B, S, H, chunk, s);
    case 128:
      return launch<T, P, 128>(x, dt, a, b, c, d, y, state, B, S, H, chunk,
                               s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_pn(int P, int N, const void* x, const float* dt,
                      const float* a, const void* b, const void* c,
                      const float* d, void* y, float* state, int B, int S,
                      int H, int chunk, cudaStream_t s) {
  switch (P) {
    case 32:
      return launch_n<T, 32>(N, x, dt, a, b, c, d, y, state, B, S, H, chunk,
                             s);
    case 64:
      return launch_n<T, 64>(N, x, dt, a, b, c, d, y, state, B, S, H, chunk,
                             s);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bf16: warpgroup MMA fed by TMA
// ---------------------------------------------------------------------------
namespace hp = repro::hopper;
using bf16 = __nv_bfloat16;

constexpr int kL = 128;                 // rows of a chunk tile
constexpr int kPP = 64;                 // columns of an x tile (P <= 64)
constexpr uint32_t kTile64 = kL * 128;  // 128 rows of 64 bf16: 16 KB
constexpr int kGroupThreads = 128;      // a warpgroup
constexpr float kLog2e = 1.4426950408889634f;

// Byte offsets from a 1024-byte aligned base (the swizzle atom's period).
// NP: the columns a C / B tile is laid out for (64 or 128, N <= NP).
template <int NP>
struct ScanLayout {
  static constexpr int kStages = 2;
  static constexpr uint32_t kCB = NP / 64 * kTile64;  // a C or a B tile
  static constexpr uint32_t kStage = 2 * kCB + kTile64;  // C, B, x
  // bf16 state copies (P x NP, K-major for C . state^T), one a parity
  static constexpr uint32_t kCopyBytes = kPP * NP * 2;
  static constexpr uint32_t kCopy = kStages * kStage;
  // f32 rows of a (group, parity): cum, dt, u, 4 warp totals
  static constexpr uint32_t kRowSet = (3 * kL + 4) * 4;
  static constexpr uint32_t kRows = kCopy + 2 * kCopyBytes;
  // y staging: 64 rows x 64 bf16 a group
  static constexpr uint32_t kY = (kRows + 4 * kRowSet + 1023) / 1024 * 1024;
  // mbarriers: full and empty a stage, copy ready a parity
  static constexpr uint32_t kBars = kY + 2 * kL / 2 * 128;
  static constexpr uint32_t kBytes = kBars + 3 * kStages * 8;
  static constexpr int kThreads = 2 * kGroupThreads;
  static_assert(kBytes + 1024 <= 232448, "shared memory per block");
};

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

// byte offset of element (row, col) in a 128-byte-swizzled 64-column chunk
__device__ __forceinline__ uint32_t swz(int row, int col) {
  return row * 128 + ((((col >> 3) ^ row) & 7) << 4) + (col & 7) * 2;
}

// One warpgroup WG: chunk rows [64 WG, 64 WG + 64) and the columns j < KN
// of the scores that those rows can see; group 0 (whose rows see half the
// columns) also holds the state.
template <int NP, int WG>
__device__ __forceinline__ void consume(
    uint32_t base, uint8_t* gbase, const CUtensorMap* x_map,
    const CUtensorMap* b_map, const CUtensorMap* c_map,
    const float* __restrict__ dt, const float* __restrict__ a,
    const float* __restrict__ dsk, bf16* __restrict__ y,
    float* __restrict__ state_out, int b, int h, int S, int H, int P, int N,
    int chunk) {
  using L = ScanLayout<NP>;
  constexpr int KN = WG == 0 ? 64 : 128;
  constexpr bool kOwner = WG == 0;
  constexpr int NS = kOwner ? NP / 2 : 1;  // state accumulator registers
  // xu^T fragments: the state update's K of 128 rows goes in two halves
  constexpr int NX = kOwner ? kL / 32 : 1;
  const uint32_t full = base + L::kBars;
  const uint32_t empty = full + 8 * L::kStages;
  const uint32_t copy_bar = empty + 8 * L::kStages;
  const int t = threadIdx.x & 127;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int r0 = warp * 16 + (lane >> 2);  // fragment rows r0, r0 + 8
  const int cq = lane & 3;                 // fragment column pair
  const int row0 = WG * 64;                // first chunk row of the group
  const int n_chunks = S / chunk;
  // ldmatrix / stmatrix: the row (of 8) and the matrix (of 4) this lane
  // addresses; in A-fragment order matrix m covers rows + 8 (m & 1) and
  // columns + 8 (m >> 1) of a 16 x 16 slice
  const int lm_row = lane & 7;
  const int lm_mat = lane >> 3;
  const uint32_t y_stage = base + L::kY + WG * (kL / 2 * 128);
  const float a2 = a[h] * kLog2e;
  const float dh = dsk[h];

  // dt of row t of chunk k, zero past `chunk`, read a chunk ahead
  float dt_next = 0.f;
  const auto load_dt = [&](int k) {
    dt_next = k < n_chunks && t < chunk
                  ? __ldg(dt + ((static_cast<int64_t>(b) * S +
                                 static_cast<int64_t>(k) * chunk + t) *
                                    H +
                                h))
                  : 0.f;
  };
  // f32 rows of chunk k's parity: cum, dt, u, warp totals
  const auto row_set = [&](int k) {
    return reinterpret_cast<float*>(gbase + L::kRows +
                                    (WG * 2 + (k & 1)) * L::kRowSet);
  };
  // cum = cumsum(dt a) of chunk k in the log2 domain: a warp scan, then
  // the totals of the warps before, added in order; u_j = e^{cum_L -
  // cum_j} dt_j (cum_L = cum at row 127: rows past `chunk` add zero)
  const auto cumsum = [&](int k) {
    float* rs = row_set(k);
    float v = dt_next * a2;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    if (lane == 31) rs[3 * kL + warp] = v;
    hp::named_bar_sync(1 + WG, kGroupThreads);
    float off = 0.f, tot = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      if (w == warp) off = tot;
      tot += rs[3 * kL + w];
    }
    const float cum = v + off;
    rs[t] = cum;
    rs[kL + t] = dt_next;
    rs[2 * kL + t] = t < chunk ? hp::ex2(tot - cum) * dt_next : 0.f;
    hp::named_bar_sync(1 + WG, kGroupThreads);  // every row is in
    load_dt(k + 1);
  };

  float s[KN / 2];
  uint32_t cf[NP / 16][4];  // C rows of the group: the A operand of S, inter
  uint32_t pa[KN / 16][4];  // W
  uint32_t xa[NX][4];       // xu^T in bf16 and the rounding's remainder: the
  uint32_t xl[NX][4];       // owner's A operands of the state update
  float acc[32];            // y
  float st[NS];             // the state (P x NP), f32
#pragma unroll
  for (int i = 0; i < NS; ++i) st[i] = 0.f;

  // Chunk k's C, B and x tiles by TMA into stage k % 2.  One thread of
  // group 1 issues every load: the first two at the start, then chunk
  // k + 2's once both groups have released chunk k's stage.
  const bool loader = WG == 1 && t == 0;
  const auto load_chunk = [&](int k) {
    const uint32_t c_t = base + (k & 1) * L::kStage;
    const uint32_t bar = full + 8 * (k & 1);
    hp::mbar_expect_tx(bar, L::kStage);
#pragma unroll
    for (int j = 0; j < NP / 64; ++j) {
      hp::tma_load_4d(c_t + j * kTile64, c_map, bar, 64 * j, 0, k * chunk, b);
      hp::tma_load_4d(c_t + L::kCB + j * kTile64, b_map, bar, 64 * j, 0,
                      k * chunk, b);
    }
    hp::tma_load_4d(c_t + 2 * L::kCB, x_map, bar, 0, h, k * chunk, b);
  };
  // chunk k's C fragments, then S = C . B^T: the group's 64 rows, KN
  // columns (one group)
  const auto issue_scores = [&](int k) {
    const uint32_t c_t = base + (k & 1) * L::kStage;
    const uint32_t b_t = c_t + L::kCB;
    const int row = row0 + warp * 16 + lm_row + 8 * (lm_mat & 1);
#pragma unroll
    for (int kk = 0; kk < NP / 16; ++kk) {
      const int col = kk * 16 + 8 * (lm_mat >> 1);
      hp::ldmatrix_x4(cf[kk],
                      c_t + (col / 64) * kTile64 + swz(row, col % 64));
    }
    // a fresh value: the old scores are dead here, and the wgmma's read-
    // write operands would otherwise keep them live since the weights
#pragma unroll
    for (int i = 0; i < KN / 2; ++i) s[i] = 0.f;
    hp::fence_regs(s);
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NP / 16; ++kk) {
      const uint64_t db = desc_k(b_t, kTile64, kk);
      if constexpr (KN == 128)
        hp::wgmma_rs_m64n128k16<0>(s, cf[kk], db, kk > 0);
      else
        hp::wgmma_rs_m64n64k16<0>(s, cf[kk], db, kk > 0);
    }
    hp::wgmma_commit();
  };
  // The owner's bf16 copy of the state for chunk k's inter term.
  // Written after chunk k's full wait: every reader of the copy two
  // chunks back has then released its stage.
  const auto write_copy = [&](int k) {
    if constexpr (kOwner) {
      uint8_t* cp = gbase + L::kCopy + (k & 1) * L::kCopyBytes;
#pragma unroll
      for (int j = 0; j < NP / 64; ++j)
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int p = r0 + 8 * r;
            const float* sv = st + 32 * j + 4 * n + 2 * r;
            *reinterpret_cast<uint32_t*>(cp + j * (kPP * 128) +
                                         swz(p, 8 * n + 2 * cq)) =
                hp::pack_bf16(sv[0], sv[1]);
          }
      hp::fence_proxy_async();
      __syncwarp();
      if (lane == 0) hp::mbar_arrive(copy_bar + 8 * (k & 1));
    }
  };

  if (loader) {
    load_chunk(0);
    if (n_chunks > 1) load_chunk(1);
  }
  load_dt(0);
  cumsum(0);
  hp::mbar_wait(full, 0);
  issue_scores(0);
  hp::wgmma_wait<0>();
  hp::fence_regs(s);

  for (int k = 0; k < n_chunks; ++k) {
    const int stg = k & 1;
    const uint32_t b_t = base + stg * L::kStage + L::kCB;
    const uint32_t x_t = b_t + L::kCB;
    const bool next = k + 1 < n_chunks;
    const float* rs = row_set(k);
    const float* cum = rs;
    const float* dts = rs + kL;
    const float* us = rs + 2 * kL;

    // the inter term C . state^T once the owner's copy is in, in
    // flight while the weights are formed
    if (k > 0) {
      // the copies of chunks 1, 3, ... and 2, 4, ...: the ((k - 1) / 2)th
      // completion of the parity's barrier
      hp::mbar_wait(copy_bar + 8 * stg, ((k - 1) >> 1) & 1);
      const uint32_t cp = base + L::kCopy + stg * L::kCopyBytes;
      hp::fence_regs(acc);
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NP / 16; ++kk)
        hp::wgmma_rs_m64n64k16<0>(acc, cf[kk], desc_k(cp, kPP * 128, kk),
                                  kk > 0);
      hp::wgmma_commit();
    }

    // W (i, j) = j <= i ? S e^{cum_i - cum_j} dt_j : 0, in bf16 A
    // fragments: the S accumulator's layout is the A operand's
    float ci[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) ci[r] = cum[row0 + r0 + 8 * r];
#pragma unroll
    for (int n = 0; n < KN / 8; ++n) {
      const int j0 = 8 * n + 2 * cq;
      const float2 cj = *reinterpret_cast<const float2*>(cum + j0);
      const float2 dj = *reinterpret_cast<const float2*>(dts + j0);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = row0 + r0 + 8 * r;
        const float w0 =
            j0 <= i ? s[4 * n + 2 * r] * hp::ex2(ci[r] - cj.x) * dj.x : 0.f;
        const float w1 = j0 + 1 <= i
                             ? s[4 * n + 2 * r + 1] *
                                   hp::ex2(ci[r] - cj.y) * dj.y
                             : 0.f;
        pa[n >> 1][2 * (n & 1) + r] = hp::pack_bf16(w0, w1);
      }
    }

    // y = e^{cum_i} inter, then y += W . X (X N-major: keys down the rows)
    hp::wgmma_wait<0>();
    hp::fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < NP / 16; ++kk) hp::fence_regs(cf[kk]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float e = hp::ex2(ci[r]);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int q = 4 * n + 2 * r;
        acc[q] = k > 0 ? acc[q] * e : 0.f;
        acc[q + 1] = k > 0 ? acc[q + 1] * e : 0.f;
      }
    }
    hp::fence_regs(acc);
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KN / 16; ++kk)
      hp::wgmma_rs_m64n64k16<1>(acc, pa[kk], desc_mn(x_t, kk), 1);
    hp::wgmma_commit();

    // The owner: state <- state e^{cum_L} + xu^T . B,
    // xu_j = u_j x_j as two bf16 A operands, its rounding and the
    // rounding's remainder (x^T by ldmatrix.trans, scaled column by
    // column), so that the state -- which a decode step carries on -- gets
    // ~16 bits of xu, not 8.  In two halves of 64 rows, so that the
    // operands of one half are live at a time; the first half is built
    // while W . X runs, the second runs beside the epilogue, and chunk
    // k + 1's scores are issued after it.  A group without state issues
    // the scores at once.
    if constexpr (kOwner) {
      const int p = warp * 16 + 8 * (lm_mat & 1);
      const float decay = hp::ex2(cum[kL - 1]);
#pragma unroll
      for (int i = 0; i < NS; ++i) st[i] *= decay;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (half == 1) {
          // W . X and the first half are done with pa, xa and xl
          hp::wgmma_wait<0>();
#pragma unroll
          for (int q = 0; q < NX; ++q) {
            hp::fence_regs(xa[q]);
            hp::fence_regs(xl[q]);
          }
        }
#pragma unroll
        for (int q = 0; q < NX; ++q) {
          const int kk = half * NX + q;
          const int l = kk * 16 + lm_row + 8 * (lm_mat >> 1);
          uint32_t xr[4];
          hp::ldmatrix_x4_trans(xr, x_t + swz(l, p));
          // xr[j]: row p + 8 (j & 1) of x^T, columns l0 and l0 + 1
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int l0 = kk * 16 + 8 * (j >> 1) + 2 * cq;
            const float2 u = *reinterpret_cast<const float2*>(us + l0);
            const float2 f = __bfloat1622float2(
                *reinterpret_cast<__nv_bfloat162*>(&xr[j]));
            const float v0 = f.x * u.x, v1 = f.y * u.y;
            xa[q][j] = hp::pack_bf16(v0, v1);
            const float2 hi = __bfloat1622float2(
                *reinterpret_cast<__nv_bfloat162*>(&xa[q][j]));
            xl[q][j] = hp::pack_bf16(v0 - hi.x, v1 - hi.y);
          }
        }
        hp::fence_regs(st);
        hp::wgmma_fence();
#pragma unroll
        for (int q = 0; q < NX; ++q)
#pragma unroll
          for (int j = 0; j < NP / 64; ++j) {
            float(&sj)[32] = *reinterpret_cast<float(*)[32]>(&st[32 * j]);
            const uint64_t db = desc_mn(b_t + j * kTile64, half * NX + q);
            hp::wgmma_rs_m64n64k16<1>(sj, xa[q], db, 1);
            hp::wgmma_rs_m64n64k16<1>(sj, xl[q], db, 1);
          }
        hp::wgmma_commit();
      }
    } else {
      if (next) {
        hp::mbar_wait(full + 8 * (stg ^ 1), ((k + 1) >> 1) & 1);
        issue_scores(k + 1);
        hp::wgmma_wait<1>();
      } else {
        hp::wgmma_wait<0>();
      }
    }
    hp::fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < KN / 16; ++kk) hp::fence_regs(pa[kk]);

    // ---- epilogue: y + d x rounded to bf16, staged through shared memory
    // (stmatrix, the warp's own 16 rows) and stored in 16-byte pieces, rows
    // below `chunk` and columns below P ----
    const uint8_t* gx = gbase + (x_t - base);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      uint32_t v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = 2 * m + (j >> 1);
        const int r = j & 1;
        const float2 xf =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                gx + swz(row0 + r0 + 8 * r, 8 * n + 2 * cq)));
        const int q = 4 * n + 2 * r;
        v[j] = hp::pack_bf16(fmaf(dh, xf.x, acc[q]),
                             fmaf(dh, xf.y, acc[q + 1]));
      }
      hp::stmatrix_x4(y_stage + swz(warp * 16 + lm_row + 8 * (lm_mat & 1),
                                    16 * m + 8 * (lm_mat >> 1)),
                      v);
    }
    __syncwarp();
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = warp * 16 + q * 4 + (lane >> 3);  // of the group
      const int col = 8 * (lane & 7);
      const int i = row0 + row;
      const uint4 v = *reinterpret_cast<const uint4*>(
          gbase + (y_stage - base) + swz(row, col));
      if (i < chunk && col < P)
        *reinterpret_cast<uint4*>(
            y + ((static_cast<int64_t>(b) * S +
                  static_cast<int64_t>(k) * chunk + i) *
                     H +
                 h) *
                    P +
            col) = v;
    }

    if constexpr (kOwner) {
      hp::wgmma_wait<0>();
      hp::fence_regs(st);
#pragma unroll
      for (int kk = 0; kk < NX; ++kk) {
        hp::fence_regs(xa[kk]);
        hp::fence_regs(xl[kk]);
      }
      if (next) {
        hp::mbar_wait(full + 8 * (stg ^ 1), ((k + 1) >> 1) & 1);
        write_copy(k + 1);
        issue_scores(k + 1);
      }
    }
    hp::wgmma_wait<0>();
    hp::fence_regs(s);
#pragma unroll
    for (int kk = 0; kk < NP / 16; ++kk) hp::fence_regs(cf[kk]);
    __syncwarp();  // every lane is done with the stage and the staging rows
    if (lane == 0) hp::mbar_arrive(empty + 8 * stg);
    if (loader && k + 2 < n_chunks) {
      hp::mbar_wait(empty + 8 * stg, (k >> 1) & 1);
      load_chunk(k + 2);
    }
    if (next) cumsum(k + 1);
  }

  // ---- the final state, f32 (B, H, P, N) ----
  if constexpr (kOwner) {
    float* so = state_out + (static_cast<int64_t>(b) * H + h) * P * N;
#pragma unroll
    for (int j = 0; j < NP / 64; ++j)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int p = r0 + 8 * r;
          const int col = 64 * j + 8 * n + 2 * cq;
          if (p < P && col < N)  // N % 8 == 0: a pair is in or out
            *reinterpret_cast<float2*>(so + p * N + col) =
                make_float2(st[32 * j + 4 * n + 2 * r],
                            st[32 * j + 4 * n + 2 * r + 1]);
        }
  }
}

template <int NP>
__global__ void __launch_bounds__(ScanLayout<NP>::kThreads, 1)
    ssd_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                     const __grid_constant__ CUtensorMap b_map,
                     const __grid_constant__ CUtensorMap c_map,
                     const float* __restrict__ dt,   // (B, S, H)
                     const float* __restrict__ a,    // (H,)
                     const float* __restrict__ dsk,  // (H,)
                     bf16* __restrict__ y,           // (B, S, H, P)
                     float* __restrict__ state_out,  // (B, H, P, N)
                     int S, int H, int P, int N, int chunk) {
  using L = ScanLayout<NP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hp::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t full = base + L::kBars;
  const uint32_t empty = full + 8 * L::kStages;
  const uint32_t copy_bar = empty + 8 * L::kStages;
  const int tid = threadIdx.x;
  const int h = blockIdx.x;
  const int b = blockIdx.y;

  if (tid == 0) {
    for (int i = 0; i < L::kStages; ++i) {
      hp::mbar_init(full + 8 * i, 1);
      hp::mbar_init(empty + 8 * i, L::kThreads / 32);  // one arrival a warp
      hp::mbar_init(copy_bar + 8 * i, 4);  // the owner's four warps
    }
    hp::mbar_fence_init();
  }
  __syncthreads();

  if (tid < kGroupThreads)
    consume<NP, 0>(base, gbase, &x_map, &b_map, &c_map, dt, a, dsk, y,
                   state_out, b, h, S, H, P, N, chunk);
  else
    consume<NP, 1>(base, gbase, &x_map, &b_map, &c_map, dt, a, dsk, y,
                   state_out, b, h, S, H, P, N, chunk);
}

// dynamic shared memory of a launch: the layout and slack to align its
// base to 1024 bytes
template <int NP>
constexpr int smem_bytes() {
  return ScanLayout<NP>::kBytes + 1024;
}

// one block a (head, sequence)
dim3 bf16_grid(int B, int H) { return dim3(H, B); }

// The bf16 launch plan at (B, H) as the built kernel has it: blocks,
// threads a block, ring stages, dynamic shared memory, and from the
// compiled function its registers a thread, local memory a thread (spills)
// and the most threads a block it takes.
template <int NP>
cudaError_t plan_bf16(int B, int H, int64_t* out) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, ssd_wgmma_kernel<NP>);
  if (err != cudaSuccess) return err;
  const dim3 grid = bf16_grid(B, H);
  out[0] = static_cast<int64_t>(grid.x) * grid.y * grid.z;
  out[1] = ScanLayout<NP>::kThreads;
  out[2] = ScanLayout<NP>::kStages;
  out[3] = smem_bytes<NP>();
  out[4] = attr.numRegs;
  out[5] = static_cast<int64_t>(attr.localSizeBytes);
  out[6] = attr.maxThreadsPerBlock;
  return cudaSuccess;
}

template <int NP>
cudaError_t launch_bf16(const void* x, const float* dt, const float* a,
                        const void* b, const void* c, const float* d, void* y,
                        float* state, int B, int S, int H, int P, int N,
                        int chunk, cudaStream_t stream) {
  CUtensorMap x_map, b_map, c_map;
  cudaError_t err = hp::encode_bshd(&x_map, x, B, S, H, P, kL, 64,
                                    CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)
    err = hp::encode_bshd(&b_map, b, B, S, 1, N, kL, 64,
                          CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)
    err = hp::encode_bshd(&c_map, c, B, S, 1, N, kL, 64,
                          CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  const size_t smem = smem_bytes<NP>();
  err = repro::set_smem(ssd_wgmma_kernel<NP>, smem);
  if (err != cudaSuccess) return err;
  ssd_wgmma_kernel<NP><<<bf16_grid(B, H), ScanLayout<NP>::kThreads, smem,
                         stream>>>(
      x_map, b_map, c_map, dt, a, d, static_cast<bf16*>(y), state, S, H, P, N,
      chunk);
  return cudaGetLastError();
}

// C and B tiles laid out for 64 columns where N <= 64, else 128
cudaError_t launch_bf16_np(const void* x, const float* dt, const float* a,
                           const void* b, const void* c, const float* d,
                           void* y, float* state, int B, int S, int H, int P,
                           int N, int chunk, cudaStream_t s) {
  if (P > kPP || P % 8 != 0 || N > 128 || N % 8 != 0 || B > 65535)
    return cudaErrorInvalidValue;
  if (N <= 64)
    return launch_bf16<64>(x, dt, a, b, c, d, y, state, B, S, H, P, N, chunk,
                           s);
  return launch_bf16<128>(x, dt, a, b, c, d, y, state, B, S, H, P, N, chunk,
                          s);
}

}  // namespace

static int ssd_entry(int device, int dtype, const void* x, const void* dt,
                     const void* a, const void* b, const void* c,
                     const void* d, void* y, void* state, int B, int S, int H,
                     int P, int N, int chunk, void* stream) {
  cudaError_t err = repro::use_device(device);
  if (err != cudaSuccess) return err;
  if (B <= 0 || S <= 0 || H <= 0 || chunk <= 0 || chunk > kMaxChunk ||
      S % chunk != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  const float* df = static_cast<const float*>(d);
  float* sf = static_cast<float*>(state);
  switch (dtype) {
    case REPRO_F32:
      return launch_pn<float>(P, N, x, dtf, af, b, c, df, y, sf, B, S, H,
                              chunk, s);
    case REPRO_BF16:
      return launch_bf16_np(x, dtf, af, b, c, df, y, sf, B, S, H, P, N, chunk,
                            s);
    default:
      return cudaErrorInvalidValue;
  }
}

// Packed arguments (common.cuh: Args), in order: device, B, H, P, N, out
// (host int64[7]): the bf16 launch plan, in plan_bf16's order.  Refuses
// what the bf16 launch refuses.
extern "C" int repro_ssd_plan(const void* packed) {
  const repro::Args a(packed);
  cudaError_t err = repro::use_device(a.i32(0));
  if (err != cudaSuccess) return err;
  const int B = a.i32(1), H = a.i32(2), P = a.i32(3), N = a.i32(4);
  int64_t* out = static_cast<int64_t*>(a.ptr(5));
  if (B <= 0 || B > 65535 || H <= 0 || P <= 0 || P > kPP || P % 8 != 0 ||
      N <= 0 || N > 128 || N % 8 != 0)
    return cudaErrorInvalidValue;
  return N <= 64 ? plan_bf16<64>(B, H, out) : plan_bf16<128>(B, H, out);
}

// Packed arguments (common.cuh: Args), in order: device, dtype, x, dt, a, b,
// c, d, y, state, B, S, H, P, N, chunk, stream.
extern "C" int repro_ssd_chunk_scan(const void* packed) {
  const repro::Args a(packed);
  return ssd_entry(a.i32(0), a.i32(1), a.ptr(2), a.ptr(3), a.ptr(4),
                   a.ptr(5), a.ptr(6), a.ptr(7), a.ptr(8), a.ptr(9),
                   a.i32(10), a.i32(11), a.i32(12), a.i32(13), a.i32(14),
                   a.i32(15), a.ptr(16));
}
