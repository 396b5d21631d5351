// Mamba2 SSD chunked scan (prefill), one sequence and one head per block.
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py: ssd_chunk_scan_pallas
// (body _kernel).  It computes what that body computes, not block for
// block.  Per chunk of L <= 128 tokens, with cum = cumsum(dt * a):
//
//   y_i   = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j   (intra)
//         + exp(cum_i) C_i . state                                 (inter)
//         + d x_i                                                  (skip)
//   state <- state exp(cum_L) + sum_j exp(cum_L - cum_j) dt_j B_j (x) x_j
//
// All arithmetic is f32; y is stored in x's dtype, the final state in f32.
// The decay is evaluated only for j <= i (above the diagonal cum_i - cum_j
// > 0 could overflow; a select, never a product with a zero mask).
//
// The TPU kernel's sequential chunk axis of the grid becomes the loop over
// chunks inside the block, and its VMEM state scratch becomes a (P, N) f32
// tile in shared memory that lives for the whole sequence.  Blocks run one
// per (head, sequence): 640 blocks at B = 8, H = 80.  Inputs stay in their
// storage dtype in shared memory: the B and x rows of the chunk, and C in
// tiles of 32 rows.  256 threads = 8 warps; for a row tile warp w owns
// rows 4w .. 4w + 3:
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
//
// Bound on the H100: at B 8, S 1024, H 80, P 64, N 128 the scan moves
// ~196 MB (x and y dominate) and does ~27 GFLOP, so it is bound by bytes
// (~0.06 ms) if the flops ran on the tensor cores; on f32 CUDA cores as
// here the flops take ~0.4 ms at peak.  The scores C . B are shared by
// all heads but recomputed per head (~40% more flops).  wgmma tiles fed
// by TMA, and sharing the scores across a block of heads, are later work.
#include "common.cuh"

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

}  // namespace

extern "C" int repro_ssd_chunk_scan(int device, int dtype, const void* x,
                                    const void* dt, const void* a,
                                    const void* b, const void* c,
                                    const void* d, void* y, void* state,
                                    int B, int S, int H, int P, int N,
                                    int chunk, void* stream) {
  cudaError_t err = cudaSetDevice(device);
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
      return launch_pn<__nv_bfloat16>(P, N, x, dtf, af, b, c, df, y, sf, B,
                                      S, H, chunk, s);
    default:
      return cudaErrorInvalidValue;
  }
}
