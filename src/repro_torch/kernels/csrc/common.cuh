// Shared helpers of the hand-written Hopper kernels (sm_90a).
//
// Each kernel source is compiled on its own by nvcc into a shared library
// with a plain C interface, loaded from Python with ctypes (see _build.py).
// Entry points return the cudaError_t of the launch as an int; 0 is success.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes passed from Python
enum ReproDtype { REPRO_F32 = 0, REPRO_BF16 = 1 };

namespace repro {

// the masked-score fill of the TPU kernels and the plain versions
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

// Round through T and back: the softmax weights are cast to the value
// dtype before the PV product, as in the TPU kernels.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Opt a kernel into more than 48 KB of dynamic shared memory when needed.
template <typename Kernel>
inline cudaError_t set_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// ---------------------------------------------------------------------------
// Single-token GQA decode attention for one (sequence, kv head): the block
// body shared by the paged kernel (paged_attention.cu) and the contiguous
// one (decode_attention.cu), which differ only in where a tile's rows lie.
//
// The block streams n_tiles tiles of `block` key/value rows.  Tile ik's
// rows for this kv head start at element offset tile_off(ik) of k and v,
// consecutive rows row_stride elements apart.  For each tile it
//   1. stages the tile's K and V rows in shared memory (f32, rows padded
//      by one word so per-token reads fall in distinct banks);
//   2. scores all G query rows of the group against the tile in f32 (G
//      need not be a power of two: qwen2-0.5b has G = 7);
//   3. updates the online softmax (m, l) per row with one warp per row
//      and accumulates p @ V in f32, p rounded to the value dtype first.
// Positions >= length are masked to kNegInf.  Once a row has seen a real
// key, every later masked position contributes exp(-1e30 - m) == 0
// exactly, so callers stop at the last tile holding a valid position; a
// row with length <= 0 has none and sweeps every tile, as the TPU kernels
// do (uniform weights over the masked window).  The output is
// acc / max(l, 1e-30), stored in T.
// ---------------------------------------------------------------------------
inline size_t decode_smem_bytes(int G, int D, int block) {
  return sizeof(float) *
         (2 * static_cast<size_t>(block) * (D + 1) + 2 * G * D + G * block +
          3 * G);
}

template <typename T, typename TileOffset>
__device__ __forceinline__ void decode_block(
    const T* __restrict__ q_g,  // the group's G query rows, (G, D)
    const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out_g,      // (G, D)
    int G, int D, int block, int64_t row_stride, int length, int n_tiles,
    float scale, TileOffset tile_off, float* smem) {
  const int ld = D + 1;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;

  float* ks = smem;               // block * ld
  float* vs = ks + block * ld;    // block * ld
  float* qs = vs + block * ld;    // G * D
  float* acc = qs + G * D;        // G * D
  float* ps = acc + G * D;        // G * block: scores, then weights
  float* m_s = ps + G * block;    // G
  float* l_s = m_s + G;           // G
  float* a_s = l_s + G;           // G

  for (int i = tid; i < G * D; i += blockDim.x) {
    qs[i] = to_float(q_g[i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += blockDim.x) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  __syncthreads();

  for (int ik = 0; ik < n_tiles; ++ik) {
    const int64_t off = tile_off(ik);
    const T* kp = k + off;
    const T* vp = v + off;
    for (int i = tid; i < block * D; i += blockDim.x) {
      const int t = i / D;
      const int d = i - t * D;
      ks[t * ld + d] = to_float(kp[t * row_stride + d]);
      vs[t * ld + d] = to_float(vp[t * row_stride + d]);
    }
    __syncthreads();

    // scores: one thread per token, all G rows of the group
    for (int t = tid; t < block; t += blockDim.x) {
      const float* kr = ks + t * ld;
      const bool valid = ik * block + t < length;
      for (int g = 0; g < G; ++g) {
        const float* qr = qs + g * D;
        float s = 0.f;
        for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
        ps[g * block + t] = valid ? s * scale : kNegInf;
      }
    }
    __syncthreads();

    // online softmax: one warp per query row
    for (int g = warp; g < G; g += n_warps) {
      float* pr = ps + g * block;
      float mx = kNegInf;
      for (int t = lane; t < block; t += 32) mx = fmaxf(mx, pr[t]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < block; t += 32) {
        const float p = expf(pr[t] - m_new);
        sum += p;
        pr[t] = round_to<T>(p);
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p @ V
    for (int i = tid; i < G * D; i += blockDim.x) {
      const int g = i / D;
      const int d = i - g * D;
      const float* pr = ps + g * block;
      float o = 0.f;
      for (int t = 0; t < block; ++t) o = fmaf(pr[t], vs[t * ld + d], o);
      acc[i] = acc[i] * a_s[g] + o;
    }
    __syncthreads();
  }

  for (int i = tid; i < G * D; i += blockDim.x) {
    const int g = i / D;
    out_g[i] = from_float<T>(acc[i] / fmaxf(l_s[g], 1e-30f));
  }
}

// ---------------------------------------------------------------------------
// Combine of a split key range.  Each of `splits` blocks of one output row
// left its partial online-softmax state in f32: (m_s, l_s) at ml[(s * rows
// + row) * 2 + {0, 1}], the unnormalised sum acc_s at acc[(s * rows + row)
// * D + d], with m_s in the log2 domain (scores pre-multiplied by log2 e).
// The row is
//   out = sum_s 2^(m_s - M) acc_s / max(sum_s 2^(m_s - M) l_s, 1e-30),
// M = max_s m_s.  A split with l_s == 0 saw no key (it lay wholly past the
// row's keys) and is skipped: its acc is not read.  A split that saw keys
// has l_s >= 1, since its largest weight is 2^0.  One warp per row: the
// lanes take the splits for (m, l), then the columns for acc, 128 at a
// time.
// ---------------------------------------------------------------------------
constexpr int kCombineWarps = 8;

template <typename T>
__global__ void __launch_bounds__(kCombineWarps * 32)
    combine_splits_kernel(const float* __restrict__ acc,
                          const float* __restrict__ ml, T* __restrict__ out,
                          int64_t rows, int D, int splits) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kCombineWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  float M = kNegInf;
  for (int s = lane; s < splits; s += 32) {
    const float* p = ml + (s * rows + row) * 2;
    if (p[1] > 0.f) M = fmaxf(M, p[0]);
  }
  M = warp_max(M);
  float den = 0.f;
  for (int s = lane; s < splits; s += 32) {
    const float* p = ml + (s * rows + row) * 2;
    if (p[1] > 0.f) den += exp2f(p[0] - M) * p[1];
  }
  den = fmaxf(warp_sum(den), 1e-30f);
  T* o = out + row * D;
  for (int c0 = 0; c0 < D; c0 += 128) {
    float num[4] = {0.f, 0.f, 0.f, 0.f};  // columns c0 + lane + 32 j
    for (int s0 = 0; s0 < splits; s0 += 32) {
      const int s = s0 + lane;
      float w = 0.f;
      if (s < splits) {
        const float* p = ml + (s * rows + row) * 2;
        if (p[1] > 0.f) w = exp2f(p[0] - M);
      }
      const int n = min(32, splits - s0);
      for (int j = 0; j < n; ++j) {
        const float wj = __shfl_sync(0xffffffffu, w, j);
        if (wj == 0.f) continue;  // the same for every lane: no divergence
        const float* a = acc + ((s0 + j) * rows + row) * D + c0;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (c0 + lane + 32 * c < D) num[c] += wj * a[lane + 32 * c];
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (c0 + lane + 32 * c < D)
        o[c0 + lane + 32 * c] = from_float<T>(num[c] / den);
  }
}

template <typename T>
inline cudaError_t launch_combine(const float* acc, const float* ml, T* out,
                                  int64_t rows, int D, int splits,
                                  cudaStream_t stream) {
  combine_splits_kernel<T>
      <<<static_cast<unsigned>((rows + kCombineWarps - 1) / kCombineWarps),
         kCombineWarps * 32, 0, stream>>>(acc, ml, out, rows, D, splits);
  return cudaGetLastError();
}

}  // namespace repro

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
