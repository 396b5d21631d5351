// Causal flash attention with a runtime query offset (prefill chunk).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:
// flash_attention_pallas (body _kernel).
//
// One block per (q tile iq, query head h, sequence b); query head h reads
// kv head h / G, so the GQA group needs no power-of-two size.  The block
// keeps its 32 query rows in shared memory and loops over 64-key tiles —
// the TPU kernel's sequential KV grid axis becomes this loop — up to the
// causal horizon of its last row, q_offset + min((iq + 1) * 32, S_q).
// Tiles past the horizon are all masked for every row of the block and
// contribute exp(-1e30 - m) == 0 exactly, so they are skipped.  The masks
// are the TPU kernel's predicates: kv_pos <= q_pos when causal, and
// kv_pos < S_kv for a ragged last tile.  q_offset is a kernel argument, so
// one build serves every chunk start.  Sliding windows are not supported
// here (no caller on the serving path passes one); the wrapper raises.
//
// 128 threads: thread (r, c) = (tid / 4, tid % 4) owns query row r of the
// tile, score columns c, c + 4, ... of each key tile and output columns
// c, c + 4, ... of D.  Scores, the online softmax (m, l) and the output
// accumulator are f32; the weights are rounded to the value dtype before
// the PV product, as in the TPU kernel.
//
// Bound on the H100: for a 128-token chunk over up to 1k keys the work is
// ~4 * S_q * S_kv * D * H flops over S_kv * Hkv * D * 2 bytes of K/V, a few
// hundred flops per byte — compute bound on the tensor cores.  This first
// version multiplies with scalar f32 FMAs out of shared memory, far from
// the card's 989 TFLOP/s bf16 peak; wgmma tiles fed by TMA are the later
// version.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBlockQ = 32;
constexpr int kBlockK = 64;

template <int D>
constexpr size_t smem_floats() {
  return (kBlockQ + 2 * kBlockK) * (D + 1) + kBlockQ * (kBlockK + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q,  // (B, S_q, H, D)
                     const T* __restrict__ k,  // (B, S_kv, Hkv, D)
                     const T* __restrict__ v,  // (B, S_kv, Hkv, D)
                     T* __restrict__ out,      // (B, S_q, H, D)
                     int S_q, int S_kv, int H, int Hkv, int q_offset,
                     int causal, float scale) {
  constexpr int LD = D + 1;
  constexpr int LP = kBlockK + 1;
  constexpr int KPT = kBlockK / 4;  // score columns per thread
  constexpr int DPT = D / 4;        // output columns per thread

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

  const int64_t q_tok = static_cast<int64_t>(H) * D;
  const int64_t kv_tok = static_cast<int64_t>(Hkv) * D;
  const T* qb = q + static_cast<int64_t>(b) * S_q * q_tok +
                static_cast<int64_t>(h) * D;
  const T* kb = k + static_cast<int64_t>(b) * S_kv * kv_tok +
                static_cast<int64_t>(hk) * D;
  const T* vb = v + static_cast<int64_t>(b) * S_kv * kv_tok +
                static_cast<int64_t>(hk) * D;

  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int rr = i / D;
    const int d = i - rr * D;
    const int qi = q0 + rr;
    qs[rr * LD + d] = qi < S_q ? repro::to_float(qb[qi * q_tok + d]) : 0.f;
  }

  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;
  float m = repro::kNegInf;
  float l = 0.f;
  const int q_pos = q_offset + q0 + r;

  int kv_end = S_kv;
  if (causal) kv_end = min(S_kv, q_offset + min(q0 + kBlockQ, S_q));
  const int n_tiles = (kv_end + kBlockK - 1) / kBlockK;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kBlockK;
    __syncthreads();  // the previous tile is done with ks / vs
    for (int i = tid; i < kBlockK * D; i += kThreads) {
      const int t = i / D;
      const int d = i - t * D;
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
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
      const int kv_pos = k0 + col;
      bool ok = kv_pos < S_kv;
      if (causal) ok = ok && kv_pos <= q_pos;
      s[j] = ok ? dot * scale : repro::kNegInf;
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
      float o = 0.f;
#pragma unroll 16
      for (int t = 0; t < kBlockK; ++t) o = fmaf(pr[t], vs[t * LD + d], o);
      acc[i] = acc[i] * alpha + o;
    }
  }

  const int qi = q0 + r;
  if (qi < S_q) {
    T* ob = out + static_cast<int64_t>(b) * S_q * q_tok + qi * q_tok +
            static_cast<int64_t>(h) * D;
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < DPT; ++i)
      ob[c + 4 * i] = repro::from_float<T>(acc[i] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int S_q, int S_kv, int H, int Hkv, int q_offset,
                   int causal, float scale, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = repro::set_smem(flash_fwd_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S_q + kBlockQ - 1) / kBlockQ, H, B);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S_q, S_kv, H, Hkv,
      q_offset, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     void* out, int B, int S_q, int S_kv, int H, int Hkv,
                     int q_offset, int causal, float scale,
                     cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, out, B, S_q, S_kv, H, Hkv, q_offset,
                           causal, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, B, S_q, S_kv, H, Hkv, q_offset,
                           causal, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, B, S_q, S_kv, H, Hkv, q_offset,
                            causal, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int repro_flash_attention(int device, int dtype, const void* q,
                                     const void* k, const void* v, void* out,
                                     int B, int S_q, int S_kv, int H,
                                     int Hkv, int D, int q_offset, int causal,
                                     float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B <= 0 || S_q <= 0 || Hkv <= 0 || H % Hkv != 0 || q_offset < 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case REPRO_F32:
      return launch_d<float>(D, q, k, v, out, B, S_q, S_kv, H, Hkv, q_offset,
                             causal, scale, s);
    case REPRO_BF16:
      return launch_d<__nv_bfloat16>(D, q, k, v, out, B, S_q, S_kv, H, Hkv,
                                     q_offset, causal, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
