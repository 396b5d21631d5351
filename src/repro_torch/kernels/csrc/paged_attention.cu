// Paged decode attention over a slot-flattened KV pool (global page ids).
//
// Replaces the TPU kernel repro/kernels/paged_attention.py:
// paged_attention_pallas (body _paged_kernel, flat-pool branch).
//
// One block per (sequence b, kv head h).  The block loops over the first
// n_kv columns of row b of the block table — the TPU kernel's sequential
// grid axis becomes this loop — and for each page:
//   1. reads gid = table[b, ik] and stages that page's (block, D) K and V
//      rows of kv head h in shared memory (f32, rows padded by one word so
//      per-token reads fall in distinct banks);
//   2. scores all G = H / Hkv query rows of the group against the page in
//      f32 (G need not be a power of two: qwen2-0.5b has G = 7);
//   3. updates the online softmax (m, l) per row with one warp per row and
//      accumulates p @ V in f32, p rounded to the value dtype first.
// Positions >= lengths[b] are masked to -1e30.  Once a row has seen a real
// key, every later masked position contributes exp(-1e30 - m) == 0 exactly,
// so the sweep stops at the last page holding a valid position.  A row
// with lengths[b] <= 0 has none and sweeps all n_kv pages, as the TPU
// kernel does (uniform weights over the masked window).
//
// Bound on the H100: bytes.  Each (b, h) reads its K and V rows once (2 *
// len * D elements) and does 4 * G * D flops per key, about 14 flops per
// byte in bf16 at G = 7, far below the ~295 the card needs to be compute
// bound.  This first version does not reach that bound: B * Hkv blocks
// (16 at 8 slots with 2 kv heads) leave most of the 132 SMs idle, and each
// block stages a page before computing on it, with no overlap.  Splitting
// the page sweep across blocks (split-K with a combine pass) and
// double-buffering the page loads are the first things a later version does.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const T* __restrict__ q,        // (B, H, D)
                        const T* __restrict__ k_pool,   // (P, block, Hkv, D)
                        const T* __restrict__ v_pool,   // (P, block, Hkv, D)
                        const int* __restrict__ table,  // (B, table_stride)
                        const int* __restrict__ lengths,  // (B,)
                        T* __restrict__ out,            // (B, H, D)
                        int H, int Hkv, int D, int block, int table_stride,
                        int n_kv, float scale) {
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int G = H / Hkv;
  const int ld = D + 1;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;

  extern __shared__ float smem[];
  float* ks = smem;               // block * ld
  float* vs = ks + block * ld;    // block * ld
  float* qs = vs + block * ld;    // G * D
  float* acc = qs + G * D;        // G * D
  float* ps = acc + G * D;        // G * block: scores, then weights
  float* m_s = ps + G * block;    // G
  float* l_s = m_s + G;           // G
  float* a_s = l_s + G;           // G

  const int64_t q_base = (static_cast<int64_t>(b) * H +
                          static_cast<int64_t>(h) * G) * D;
  for (int i = tid; i < G * D; i += blockDim.x) {
    qs[i] = repro::to_float(q[q_base + i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += blockDim.x) {
    m_s[g] = repro::kNegInf;
    l_s[g] = 0.f;
  }
  const int length = lengths[b];
  int n_pages = n_kv;
  if (length > 0) n_pages = min(n_kv, (length + block - 1) / block);
  __syncthreads();

  const int64_t tok_stride = static_cast<int64_t>(Hkv) * D;
  const int64_t page_stride = static_cast<int64_t>(block) * tok_stride;
  const int* row = table + static_cast<int64_t>(b) * table_stride;

  for (int ik = 0; ik < n_pages; ++ik) {
    const int64_t gid = row[ik];
    const T* kp = k_pool + gid * page_stride + static_cast<int64_t>(h) * D;
    const T* vp = v_pool + gid * page_stride + static_cast<int64_t>(h) * D;
    for (int i = tid; i < block * D; i += blockDim.x) {
      const int t = i / D;
      const int d = i - t * D;
      ks[t * ld + d] = repro::to_float(kp[t * tok_stride + d]);
      vs[t * ld + d] = repro::to_float(vp[t * tok_stride + d]);
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
        ps[g * block + t] = valid ? s * scale : repro::kNegInf;
      }
    }
    __syncthreads();

    // online softmax: one warp per query row
    for (int g = warp; g < G; g += n_warps) {
      float* pr = ps + g * block;
      float mx = repro::kNegInf;
      for (int t = lane; t < block; t += 32) mx = fmaxf(mx, pr[t]);
      mx = repro::warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < block; t += 32) {
        const float p = expf(pr[t] - m_new);
        sum += p;
        pr[t] = repro::round_to<T>(p);
      }
      sum = repro::warp_sum(sum);
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
    out[q_base + i] =
        repro::from_float<T>(acc[i] / fmaxf(l_s[g], 1e-30f));
  }
}

size_t smem_bytes(int G, int D, int block) {
  return sizeof(float) *
         (2 * static_cast<size_t>(block) * (D + 1) + 2 * G * D + G * block +
          3 * G);
}

template <typename T>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* table, const void* lengths, void* out, int B,
                   int H, int Hkv, int D, int block, int table_stride,
                   int n_kv, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(H / Hkv, D, block);
  cudaError_t err = repro::set_smem(paged_decode_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B, Hkv);
  paged_decode_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(table),
      static_cast<const int*>(lengths), static_cast<T*>(out), H, Hkv, D,
      block, table_stride, n_kv, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int repro_paged_attention(int device, int dtype, const void* q,
                                     const void* k_pool, const void* v_pool,
                                     const void* table, const void* lengths,
                                     void* out, int B, int H, int Hkv, int D,
                                     int block, int table_stride, int n_kv,
                                     float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || n_kv <= 0 ||
      n_kv > table_stride || smem_bytes(H / Hkv, D, block) > 227 * 1024)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case REPRO_F32:
      return launch<float>(q, k_pool, v_pool, table, lengths, out, B, H, Hkv,
                           D, block, table_stride, n_kv, scale, s);
    case REPRO_BF16:
      return launch<__nv_bfloat16>(q, k_pool, v_pool, table, lengths, out, B,
                                   H, Hkv, D, block, table_stride, n_kv,
                                   scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
