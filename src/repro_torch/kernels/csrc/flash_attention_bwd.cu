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
// Design (FlashAttention-2's three passes, CUDA cores, f32 arithmetic on
// operands widened from their storage dtype):
//   1. stats_kernel, a block per (b, h, 64-row query tile): the row's
//      max m and sum l of exp(s - m) over its keys (recomputed from Q and
//      K: the wgmma forward is left as it is), and D_i.
//   2. dkdv_kernel, a block per (b, kv head, 64-key tile): K and V stay
//      in shared memory; the block walks the G heads and the query tiles
//      that see its keys, recomputes S and dP, forms P and dS in shared
//      memory and accumulates dK and dV in registers.
//   3. dq_kernel, a block per (b, h, query tile): Q and dO stay in shared
//      memory; it walks the key tiles the rows see and accumulates dQ in
//      registers.
// No atomics anywhere: each output element is written once by one thread
// after a loop of fixed order, so two runs give the same bits.  dQ costs
// a second recomputation of S and dP instead of atomics.
//
// What bounds it on the H100: operations.  The pairs (row, visible key)
// cost 8 products of length D over the three passes (S three times, dP
// twice, dV, dK, dQ), on CUDA cores at 67 TFLOP/s f32 (the tensor cores
// are not used).  Each thread keeps a 4 x 4 fragment of S and dP and a
// 4 x 8 fragment of each accumulator, so a product step reads 2 shared
// words per 4 multiply-adds; tiles are f32 in shared memory with a row
// stride of D + 1 (odd), so the 16 rows a half-warp reads sit in 16
// banks.  Its speed is later work (ROADMAP Queue B: a wgmma redesign).
#include "common.cuh"

namespace {

constexpr int kRows = 64;      // query rows and keys per tile
constexpr int kThreads = 256;  // 16 x 16: ty = tid / 16, tx = tid % 16
constexpr int kMaxD = 128;
constexpr int kDCols = kMaxD / 16;  // accumulator columns a thread owns
constexpr int kPStride = kRows + 1;

struct Shape {
  int B, S_q, S_kv, H, Hkv, D, causal, window;
  float scale;
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

// rows [r0, r0 + 64) of head h of a (B, S, Hx, D) tensor into a 64 x D
// f32 tile of row stride D + 1; rows past S are zeros
template <typename T>
__device__ void load_tile(float* dst, const T* __restrict__ src, int b,
                          int h, int r0, int S, int Hx, int D) {
  for (int idx = threadIdx.x; idx < kRows * D; idx += kThreads) {
    const int r = idx / D, d = idx - r * D;
    const int row = r0 + r;
    float x = 0.f;
    if (row < S)
      x = repro::to_float(
          src[((static_cast<int64_t>(b) * S + row) * Hx + h) * D + d]);
    dst[r * (D + 1) + d] = x;
  }
}

// s[r][c] = A[ty + 16 r] . X[tx + 16 c]; with kDual also p, the same of
// A2 and X2 (dO and V: dP).  Without it A2, X2 and p are not touched.
template <bool kDual>
__device__ __forceinline__ void tile_products(
    const float* A, const float* X, const float* A2, const float* X2,
    int D, float (&s)[4][4], float (&p)[4][4]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int sd = D + 1;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      s[r][c] = 0.f;
      if constexpr (kDual) p[r][c] = 0.f;
    }
  for (int d = 0; d < D; ++d) {
    float a[4], x[4], a2[4], x2[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      a[r] = A[(ty + 16 * r) * sd + d];
      if constexpr (kDual) a2[r] = A2[(ty + 16 * r) * sd + d];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      x[c] = X[(tx + 16 * c) * sd + d];
      if constexpr (kDual) x2[c] = X2[(tx + 16 * c) * sd + d];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = fmaf(a[r], x[c], s[r][c]);
        if constexpr (kDual) p[r][c] = fmaf(a2[r], x2[c], p[r][c]);
      }
  }
}

// the single product: s[r][c] = A[ty + 16 r] . X[tx + 16 c]
__device__ __forceinline__ void tile_dots(const float* A, const float* X,
                                          int D, float (&s)[4][4]) {
  float none[4][4];
  tile_products<false>(A, X, nullptr, nullptr, D, s, none);
}

// the masked, scaled score of row i and key j (NEG_INF where not visible)
__device__ __forceinline__ float score(const Shape& s, float dot, int i,
                                       int j) {
  return visible(s, i, j) ? dot * s.scale : repro::kNegInf;
}

// ---------------------------------------------------------------------------
// 1. row statistics: m, l and D_i = rowsum(dO * O)
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
    stats_kernel(Shape s, const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ o, const T* __restrict__ dout,
                 float* __restrict__ m_out, float* __restrict__ l_out,
                 float* __restrict__ d_out) {
  extern __shared__ float smem[];
  const int D = s.D, sd = D + 1;
  float* Qs = smem;
  float* Ks = Qs + kRows * sd;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (s.H / s.Hkv);
  const int q0 = qt * kRows, q1 = min(q0 + kRows, s.S_q);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_tile(Qs, q, b, h, q0, s.S_q, s.H, D);
  float m[4], l[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
  }
  int t0, t1;
  key_tiles(s, q0, q1, &t0, &t1);
  for (int kt = t0; kt < t1; ++kt) {
    const int k0 = kt * kRows;
    __syncthreads();
    load_tile(Ks, k, b, hk, k0, s.S_kv, s.Hkv, D);
    __syncthreads();
    float dots[4][4];
    tile_dots(Qs, Ks, D, dots);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = q0 + ty + 16 * r;
      float sc[4], tmax = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = k0 + tx + 16 * c;
        sc[c] = j < s.S_kv ? score(s, dots[r][c], i, j) : -INFINITY;
        tmax = fmaxf(tmax, sc[c]);
      }
#pragma unroll
      for (int o2 = 8; o2 > 0; o2 >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o2));
      const float m_new = fmaxf(m[r], tmax);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) sum += __expf(sc[c] - m_new);
#pragma unroll
      for (int o2 = 8; o2 > 0; o2 >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o2);
      l[r] = l[r] * __expf(m[r] - m_new) + sum;
      m[r] = m_new;
    }
  }
  const int64_t row0 = (static_cast<int64_t>(b) * s.H + h) * s.S_q;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + ty + 16 * r;
    // D_i over the row's D columns, 16 threads a row
    float dsum = 0.f;
    if (i < s.S_q) {
      const int64_t base = ((static_cast<int64_t>(b) * s.S_q + i) * s.H + h)
                           * D;
      for (int d = tx; d < D; d += 16)
        dsum += repro::to_float(dout[base + d]) * repro::to_float(o[base + d]);
    }
#pragma unroll
    for (int o2 = 8; o2 > 0; o2 >>= 1)
      dsum += __shfl_xor_sync(0xffffffffu, dsum, o2);
    if (tx == 0 && i < s.S_q) {
      m_out[row0 + i] = m[r];
      l_out[row0 + i] = l[r];
      d_out[row0 + i] = dsum;
    }
  }
}

// P and dS of one (query tile, key tile) pair into shared memory, rows
// ty + 16 r and keys tx + 16 c of the thread's fragment
__device__ __forceinline__ void form_p_ds(
    const Shape& s, const float (&dots)[4][4], const float (&dp)[4][4],
    int q0, int k0, const float* __restrict__ m, const float* __restrict__ l,
    const float* __restrict__ dd, int64_t row0, float* Ps, float* dSs) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + ty + 16 * r;
    const bool row_ok = i < s.S_q;
    const float mi = row_ok ? m[row0 + i] : 0.f;
    const float inv_l = row_ok ? 1.f / l[row0 + i] : 0.f;
    const float di = row_ok ? dd[row0 + i] : 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = k0 + tx + 16 * c;
      float p = 0.f, ds = 0.f;
      if (row_ok && j < s.S_kv) {
        p = __expf(score(s, dots[r][c], i, j) - mi) * inv_l;
        if (visible(s, i, j)) ds = p * (dp[r][c] - di);
      }
      Ps[(ty + 16 * r) * kPStride + tx + 16 * c] = p;
      dSs[(ty + 16 * r) * kPStride + tx + 16 * c] = ds;
    }
  }
}

// ---------------------------------------------------------------------------
// 2. dK and dV: a block per (b, kv head, key tile)
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
    dkdv_kernel(Shape s, const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ m, const float* __restrict__ l,
                const float* __restrict__ dd, T* __restrict__ dk,
                T* __restrict__ dv) {
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
    const int64_t row0 = (static_cast<int64_t>(b) * s.H + h) * s.S_q;
    const int qt_first = s.causal ? k0 / kRows : 0;
    for (int qt = qt_first; qt < n_qt; ++qt) {
      const int q0 = qt * kRows, q1 = min(q0 + kRows, s.S_q);
      if (!tile_needed(s, q0, q1, k0, k1)) continue;
      __syncthreads();  // the last tile's readers are done
      load_tile(Qs, q, b, h, q0, s.S_q, s.H, D);
      load_tile(dOs, dout, b, h, q0, s.S_q, s.H, D);
      __syncthreads();
      float dots[4][4], dp[4][4];
      tile_products<true>(Qs, Ks, dOs, Vs, D, dots, dp);
      form_p_ds(s, dots, dp, q0, k0, m, l, dd, row0, Ps, dSs);
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
        dk[base + d] = repro::from_float<T>(acc_k[c][r] * s.scale);
        dv[base + d] = repro::from_float<T>(acc_v[c][r]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 3. dQ: a block per (b, h, query tile)
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(Shape s, const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ m, const float* __restrict__ l,
              const float* __restrict__ dd, T* __restrict__ dq) {
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
  const int64_t row0 = (static_cast<int64_t>(b) * s.H + h) * s.S_q;

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
    tile_products<true>(Qs, Ks, dOs, Vs, D, dots, dp);
    form_p_ds(s, dots, dp, q0, k0, m, l, dd, row0, Ps, dSs);
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
      if (d < D) dq[base + d] = repro::from_float<T>(acc[c][r] * s.scale);
    }
  }
}

template <typename T>
cudaError_t launch(const Shape& s, const void* q, const void* k,
                   const void* v, const void* o, const void* dout, void* dq,
                   void* dk, void* dv, float* ws, cudaStream_t stream) {
  const int64_t rows = static_cast<int64_t>(s.B) * s.H * s.S_q;
  float* m = ws;
  float* l = ws + rows;
  float* dd = ws + 2 * rows;
  const int n_qt = (s.S_q + kRows - 1) / kRows;
  const int n_kt = (s.S_kv + kRows - 1) / kRows;
  const size_t tile = static_cast<size_t>(kRows) * (s.D + 1) * sizeof(float);
  const size_t ptile = static_cast<size_t>(kRows) * kPStride * sizeof(float);
  const size_t smem_stats = 2 * tile, smem_big = 4 * tile + 2 * ptile;
  cudaError_t err;
  if ((err = repro::set_smem(stats_kernel<T>, smem_stats)) != cudaSuccess ||
      (err = repro::set_smem(dkdv_kernel<T>, smem_big)) != cudaSuccess ||
      (err = repro::set_smem(dq_kernel<T>, smem_big)) != cudaSuccess)
    return err;
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  const T* oo = static_cast<const T*>(o);
  const T* gg = static_cast<const T*>(dout);
  stats_kernel<T><<<dim3(n_qt, s.H, s.B), kThreads, smem_stats, stream>>>(
      s, qq, kk, oo, gg, m, l, dd);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dkdv_kernel<T><<<dim3(n_kt, s.Hkv, s.B), kThreads, smem_big, stream>>>(
      s, qq, kk, vv, gg, m, l, dd, static_cast<T*>(dk), static_cast<T*>(dv));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dq_kernel<T><<<dim3(n_qt, s.H, s.B), kThreads, smem_big, stream>>>(
      s, qq, kk, vv, gg, m, l, dd, static_cast<T*>(dq));
  return cudaGetLastError();
}

}  // namespace

// Packed arguments (common.cuh: Args), in order: device, dtype, q, k, v,
// o, dout, dq, dk, dv, workspace (3 * B * H * S_q f32), B, S_q, S_kv, H,
// Hkv, D, causal, window, scale (double), stream.
extern "C" int repro_flash_attention_bwd(const void* packed) {
  const repro::Args a(packed);
  cudaError_t err = repro::use_device(a.i32(0));
  if (err != cudaSuccess) return err;
  Shape s;
  s.B = a.i32(11);
  s.S_q = a.i32(12);
  s.S_kv = a.i32(13);
  s.H = a.i32(14);
  s.Hkv = a.i32(15);
  s.D = a.i32(16);
  s.causal = a.i32(17);
  s.window = a.i32(18);
  s.scale = a.f32(19);
  if (s.B <= 0 || s.S_q <= 0 || s.S_kv <= 0 || s.Hkv <= 0 ||
      s.H % s.Hkv != 0 || s.D <= 0 || s.D > kMaxD || s.D % 8 != 0 ||
      s.window < 0)
    return cudaErrorInvalidValue;
  const auto stream = static_cast<cudaStream_t>(a.ptr(20));
  float* ws = static_cast<float*>(a.ptr(10));
  if (a.i32(1) == REPRO_BF16)
    return launch<__nv_bfloat16>(s, a.ptr(2), a.ptr(3), a.ptr(4), a.ptr(5),
                                 a.ptr(6), a.ptr(7), a.ptr(8), a.ptr(9), ws,
                                 stream);
  if (a.i32(1) == REPRO_F32)
    return launch<float>(s, a.ptr(2), a.ptr(3), a.ptr(4), a.ptr(5), a.ptr(6),
                         a.ptr(7), a.ptr(8), a.ptr(9), ws, stream);
  return cudaErrorInvalidValue;
}
