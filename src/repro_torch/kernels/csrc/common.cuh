// Shared helpers of the hand-written Hopper kernels (sm_90a).
//
// Each kernel source is compiled on its own by nvcc into a shared library
// with a plain C interface, loaded from Python with ctypes (see _build.py).
// Entry points return the cudaError_t of the launch as an int; 0 is success.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

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

// Arguments of a C entry point arrive packed in one block (_build.Entry):
// 8 bytes each, little-endian, an int64 (a size, a flag, a data pointer or
// the stream) or a double (a scale), in the order the entry documents.
// memcpy reads them: the block need not be aligned.
class Args {
 public:
  explicit Args(const void* block) : p_(static_cast<const char*>(block)) {}
  int64_t i64(int k) const {
    int64_t x;
    memcpy(&x, p_ + 8 * k, 8);
    return x;
  }
  int i32(int k) const { return static_cast<int>(i64(k)); }
  float f32(int k) const {
    double x;
    memcpy(&x, p_ + 8 * k, 8);
    return static_cast<float>(x);
  }
  void* ptr(int k) const {
    return reinterpret_cast<void*>(static_cast<intptr_t>(i64(k)));
  }

 private:
  const char* p_;
};

// Make `device` current for the launch; a no-op when it already is, as on
// every call but the first of a single-card process.
inline cudaError_t use_device(int device) {
  int current = -1;
  const cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return err;
  return current == device ? cudaSuccess : cudaSetDevice(device);
}

// ---------------------------------------------------------------------------
// Combine of a split key range.  Each of `splits` blocks of one output row
// left its partial online-softmax state in f32: (m_s, l_s) at ml[(s * rows
// + row) * 2 + {0, 1}], the unnormalised sum acc_s at acc[(s * rows + row)
// * D + d], with m_s in the log2 domain (scores pre-multiplied by log2 e).
// The row is
//   out = sum_s 2^(m_s - M) acc_s / max(sum_s 2^(m_s - M) l_s, 1e-30),
// M = max_s m_s.  A split with l_s == 0 saw no key (it lay wholly past the
// row's keys) and is skipped: its acc, never written, is not added.  A
// split that saw keys has l_s >= 1, since its largest weight is 2^0.  One
// warp per row: the lanes take the splits for (m, l), then the columns for
// acc, 128 at a time, loading kCombineBatch splits' sums before adding
// them.
//
// It is launched to overlap the split kernel before it (programmatic
// dependent launch): its blocks may be scheduled once every block of that
// grid has started and run griddepcontrol.launch_dependents (or exited),
// and they wait at griddepcontrol.wait until the grid has finished and its
// writes are visible.
// ---------------------------------------------------------------------------
constexpr int kCombineWarps = 8;
constexpr int kCombineBatch = 4;  // splits whose sums load together

template <typename T>
__global__ void __launch_bounds__(kCombineWarps * 32)
    combine_splits_kernel(const float* __restrict__ acc,
                          const float* __restrict__ ml, T* __restrict__ out,
                          int64_t rows, int D, int splits) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
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
      for (int j0 = 0; j0 < n; j0 += kCombineBatch) {
        // the batch's loads first, so that they are in flight together,
        // then the sums in split order (a skipped split's value, read from
        // the workspace but never written, is not added)
        float x[kCombineBatch][4];
#pragma unroll
        for (int jj = 0; jj < kCombineBatch; ++jj) {
          const int j = min(j0 + jj, n - 1);
          const float* a = acc + ((s0 + j) * rows + row) * D + c0;
#pragma unroll
          for (int c = 0; c < 4; ++c)
            x[jj][c] = c0 + lane + 32 * c < D ? a[lane + 32 * c] : 0.f;
        }
#pragma unroll
        for (int jj = 0; jj < kCombineBatch; ++jj) {
          const float wj = __shfl_sync(0xffffffffu, w, min(j0 + jj, 31));
          // the same for every lane: no divergence
          if (j0 + jj >= n || wj == 0.f) continue;
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (c0 + lane + 32 * c < D) num[c] += wj * x[jj][c];
        }
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
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim =
      dim3(static_cast<unsigned>((rows + kCombineWarps - 1) / kCombineWarps));
  cfg.blockDim = dim3(kCombineWarps * 32);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, combine_splits_kernel<T>, acc, ml, out,
                            rows, D, splits);
}

}  // namespace repro

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
