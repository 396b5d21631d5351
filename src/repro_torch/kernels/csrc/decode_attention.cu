// Single-token GQA decode attention over a contiguous (B, S_max, Hkv, D)
// cache, masked by per-sequence lengths, with the key range split across
// blocks.
//
// Replaces the TPU kernel repro/kernels/paged_attention.py:74
// decode_attention_pallas (body _decode_kernel).  On the ported path it is
// the encoder-decoder's cross-attention decode: each decoder layer's query
// against the (B, 4096, Hkv, D) cross cache of the encoder output, lengths
// = the encoder length of each row.
//
// What bounds it on the H100: bytes.  Each (b, kv head) reads lengths[b]
// K and V rows of D elements once and does 4 * G * D flops per row: at
// G = 1 (seamless: 16 heads over 16 kv heads) one flop per byte in bf16.
// At seamless's shape that is 33.5 MB, 10 us at 3.35 TB/s.  A block per
// (b, kv head) walking the row's keys gives 128 blocks, each serial over
// its tiles, far from the rate; so the key range is split across blocks.
//
// Grid (splits, Hkv, B).  A split is `tiles_per_split` tiles of `block`
// (<= 128) cache rows; the host picks the split from S_max and B * Hkv
// alone (it cannot read lengths without a sync).  At seamless's shape a
// split is one tile: 32 splits per (b, h), of which the 8 that hold the
// 1024 live rows work (1024 blocks) and the rest return at once.
//   * A split wholly past a row's length > 0 writes l = 0, m = -1e30 and
//     leaves; the combine skips it.  A row with length <= 0 has no valid
//     key: every split sweeps its tiles fully masked, and the combine gives
//     the mean of all S_max V rows, as the TPU kernel does (uniform
//     weights over the masked window).
//   * K and V tiles arrive by 16-byte cp.async in the storage dtype (two
//     commit groups: V lands while K is scored).
//   * Scores: D / 8 lanes (bf16) share one key, 16 bytes each, and reduce
//     with shuffles; a warp scores 32 / (D / 8) keys at a time, all G query
//     rows of the group against each.
//   * Those two need D in {32, 64, 128}, fixed when compiled.  Any other
//     D > 0 (zamba2's 112, for one) takes the same kernel with D given at
//     run time: a warp scores one key with its lanes strided over D, the
//     tiles arrive by 16-byte cp.async where a row is whole 16-byte chunks
//     and element by element where it is not, and P . V gives a thread one
//     column instead of two.
//   * Online softmax per query row (one warp a row) in the log2 domain
//     (log2 e folded into the scale): NEG_INF = -1e30, f32 (m, l), the
//     weights rounded to the value dtype against the split's running max
//     before P . V, as the TPU kernel rounds against its running max.
//   * P . V: every thread owns two adjacent columns of one query row and a
//     share of the tile's keys (at G = 1, D 64: 4 threads a column pair),
//     partial sums meet in shared memory.
//   * With one split the block divides by max(l, 1e-30) and stores; with
//     more, it writes (m, l, acc) in f32 to the workspace and
//     combine_splits_kernel (common.cuh) merges the splits.
#include "common.cuh"
#include "hopper.cuh"

namespace {

namespace hp = repro::hopper;

constexpr int kThreads = 128;
constexpr int kMaxBlock = 128;
constexpr float kLog2e = 1.4426950408889634f;

template <typename T>
size_t smem_bytes(int G, int D) {
  const int red = G * D > 2 * kThreads ? G * D : 2 * kThreads;
  return 2 * static_cast<size_t>(kMaxBlock) * D * sizeof(T) +
         sizeof(float) * (2 * G * D + G * kMaxBlock + red + 3 * G);
}

// kD > 0: D = kD, one of 32, 64 and 128; kD == 0: D = D_rt, any D > 0.
template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
    decode_split_kernel(const T* __restrict__ q,        // (B, H, D)
                        const T* __restrict__ k,        // (B, S_max, Hkv, D)
                        const T* __restrict__ v,        // (B, S_max, Hkv, D)
                        const int* __restrict__ lengths,  // (B,)
                        T* __restrict__ out,            // (B, H, D)
                        float* __restrict__ ws_acc,  // (splits, B, H, D)
                        float* __restrict__ ws_ml,   // (splits, B, H, 2)
                        int B, int H, int Hkv, int D_rt, int S_max,
                        int block, int tiles_per_split, int splits,
                        float scale_log2) {
  constexpr int kPerChunk = 16 / sizeof(T);  // elements per 16 bytes
  constexpr int kLanesPerKey = kD > 0 ? kD / kPerChunk : 1;
  constexpr int kKeysPerWarp = 32 / kLanesPerKey;
  const int D = kD > 0 ? kD : D_rt;
  // a row of whole 16-byte chunks (always, for kD > 0) loads by cp.async
  const bool vec = D * sizeof(T) % 16 == 0;
  const int chunks = D * static_cast<int>(sizeof(T)) / 16;
  const int split = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / Hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const int length = lengths[b];
  const int n_max = S_max / block;
  const int n_live =
      length > 0 ? min(n_max, (length + block - 1) / block) : n_max;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(n_live, t_begin + tiles_per_split);
  const int64_t q_row = static_cast<int64_t>(b) * H + hk * G;  // group's 1st
  const int64_t s_row = static_cast<int64_t>(split) * B * H + q_row;
  if (t_begin >= t_end) {  // wholly past the row's keys: nothing to add
    for (int g = tid; g < G; g += kThreads) {
      ws_ml[(s_row + g) * 2] = repro::kNegInf;
      ws_ml[(s_row + g) * 2 + 1] = 0.f;
    }
    return;
  }

  extern __shared__ __align__(16) uint8_t smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);           // block x D
  T* vs = ks + kMaxBlock * D;                       // block x D
  float* qs = reinterpret_cast<float*>(vs + kMaxBlock * D);  // G x D
  float* acc = qs + G * D;                          // G x D
  float* ps = acc + G * D;                          // G x block
  float* red = ps + G * kMaxBlock;                  // max(G D, 256)
  float* m_s = red + (G * D > 2 * kThreads ? G * D : 2 * kThreads);
  float* l_s = m_s + G;
  float* a_s = l_s + G;

  for (int i = tid; i < G * D; i += kThreads) {
    qs[i] = repro::to_float(q[q_row * D + i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = repro::kNegInf;
    l_s[g] = 0.f;
  }

  // P . V work split: column pairs of the group (single columns at a run-
  // time D), each over `parts` strided shares of the tile's keys (a power
  // of two, <= 128 / units)
  const int units = kD > 0 ? G * D / 2 : G * D;
  int parts = 1;
  while (units * parts * 2 <= kThreads) parts *= 2;

  const int64_t row_stride = static_cast<int64_t>(Hkv) * D;
  for (int it = t_begin; it < t_end; ++it) {
    const int64_t off = (static_cast<int64_t>(b) * S_max +
                         static_cast<int64_t>(it) * block) * row_stride +
                        static_cast<int64_t>(hk) * D;
    if (vec) {
      for (int i = tid; i < block * chunks; i += kThreads) {
        const int r = i / chunks;
        const int ch = (i - r * chunks) * kPerChunk;
        hp::cp_async16(ks + r * D + ch, k + off + r * row_stride + ch);
      }
      hp::cp_async_commit();
      for (int i = tid; i < block * chunks; i += kThreads) {
        const int r = i / chunks;
        const int ch = (i - r * chunks) * kPerChunk;
        hp::cp_async16(vs + r * D + ch, v + off + r * row_stride + ch);
      }
      hp::cp_async_commit();
    } else {  // element by element; the barrier below publishes both
      for (int i = tid; i < block * D; i += kThreads) {
        const int r = i / D;
        const int c = i - r * D;
        ks[r * D + c] = k[off + r * row_stride + c];
        vs[r * D + c] = v[off + r * row_stride + c];
      }
    }
    hp::cp_async_wait<1>();  // K has landed; V may still be in flight
    __syncthreads();

    // scores: kLanesPerKey lanes per key, 16 bytes each
    if constexpr (kD > 0) {
      const int sub = lane % kLanesPerKey;
      const int kw = lane / kLanesPerKey;
      for (int t0 = warp * kKeysPerWarp; t0 < block;
           t0 += (kThreads / 32) * kKeysPerWarp) {
        const int tok = t0 + kw;
        const bool in = tok < block;
        float kf[kPerChunk];
        {
          const uint4 raw = *reinterpret_cast<const uint4*>(
              ks + (in ? tok : 0) * D + sub * kPerChunk);
          const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int j = 0; j < kPerChunk; ++j) kf[j] = repro::to_float(e[j]);
        }
        const bool valid = it * block + tok < length;
        for (int g = 0; g < G; ++g) {
          const float* qr = qs + g * D + sub * kPerChunk;
          float dot = 0.f;
#pragma unroll
          for (int j = 0; j < kPerChunk; ++j) dot = fmaf(qr[j], kf[j], dot);
#pragma unroll
          for (int o = kLanesPerKey / 2; o > 0; o >>= 1)
            dot += __shfl_xor_sync(0xffffffffu, dot, o);
          if (in && sub == 0)
            ps[g * kMaxBlock + tok] =
                valid ? dot * scale_log2 : repro::kNegInf;
        }
      }
    } else {  // a warp a key, lanes strided over D
      for (int tok = warp; tok < block; tok += kThreads / 32) {
        const bool valid = it * block + tok < length;
        const T* kr = ks + tok * D;
        for (int g = 0; g < G; ++g) {
          const float* qr = qs + g * D;
          float dot = 0.f;
          for (int d = lane; d < D; d += 32)
            dot = fmaf(qr[d], repro::to_float(kr[d]), dot);
          dot = repro::warp_sum(dot);
          if (lane == 0)
            ps[g * kMaxBlock + tok] =
                valid ? dot * scale_log2 : repro::kNegInf;
        }
      }
    }
    __syncthreads();

    // online softmax: one warp per query row
    for (int g = warp; g < G; g += kThreads / 32) {
      float* pr = ps + g * kMaxBlock;
      float mx = repro::kNegInf;
      for (int t = lane; t < block; t += 32) mx = fmaxf(mx, pr[t]);
      mx = repro::warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < block; t += 32) {
        const float p = exp2f(pr[t] - m_new);
        sum += p;
        pr[t] = repro::round_to<T>(p);
      }
      sum = repro::warp_sum(sum);
      if (lane == 0) {
        const float alpha = exp2f(m_prev - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    hp::cp_async_wait<0>();  // V has landed
    __syncthreads();

    // P . V over column pairs (or columns), keys strided over `parts`
    for (int w = tid; w < units * parts; w += kThreads) {
      const int u = w % units;
      const int part = w / units;
      if constexpr (kD > 0) {
        const int g = u / (D / 2);
        const int d = 2 * (u - g * (D / 2));
        const float* pr = ps + g * kMaxBlock;
        float x = 0.f, y = 0.f;
        for (int t = part; t < block; t += parts) {
          const float p = pr[t];
          x = fmaf(p, repro::to_float(vs[t * D + d]), x);
          y = fmaf(p, repro::to_float(vs[t * D + d + 1]), y);
        }
        red[part * G * D + g * D + d] = x;
        red[part * G * D + g * D + d + 1] = y;
      } else {
        const int d = u % D;
        const float* pr = ps + (u / D) * kMaxBlock;
        float x = 0.f;
        for (int t = part; t < block; t += parts)
          x = fmaf(pr[t], repro::to_float(vs[t * D + d]), x);
        red[part * G * D + u] = x;
      }
    }
    __syncthreads();
    for (int i = tid; i < G * D; i += kThreads) {
      float sum = 0.f;
      for (int part = 0; part < parts; ++part) sum += red[part * G * D + i];
      acc[i] = acc[i] * a_s[i / D] + sum;
    }
    __syncthreads();  // the next tile overwrites ks, vs, ps and red
  }

  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D;
    if (splits == 1) {
      out[q_row * D + i] = repro::from_float<T>(acc[i] / fmaxf(l_s[g], 1e-30f));
    } else {
      ws_acc[s_row * D + i] = acc[i];
      if (i - g * D == 0) {
        ws_ml[(s_row + g) * 2] = m_s[g];
        ws_ml[(s_row + g) * 2 + 1] = l_s[g];
      }
    }
  }
}

template <typename T, int kD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* lengths, void* out, float* ws, int B, int H,
                   int Hkv, int D, int S_max, int block, int splits,
                   int tiles_per_split, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(H / Hkv, D);
  cudaError_t err = repro::set_smem(decode_split_kernel<T, kD>, smem);
  if (err != cudaSuccess) return err;
  const int64_t rows = static_cast<int64_t>(B) * H;
  float* ws_acc = ws;
  float* ws_ml = splits > 1 ? ws + splits * rows * D : nullptr;
  const dim3 grid(splits, Hkv, B);
  decode_split_kernel<T, kD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(lengths),
      static_cast<T*>(out), ws_acc, ws_ml, B, H, Hkv, D, S_max, block,
      tiles_per_split, splits, scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return repro::launch_combine<T>(ws_acc, ws_ml, static_cast<T*>(out), rows,
                                  D, splits, stream);
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     const void* lengths, void* out, float* ws, int B, int H,
                     int Hkv, int S_max, int block, int splits,
                     int tiles_per_split, float scale, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, lengths, out, ws, B, H, Hkv, D, S_max,
                           block, splits, tiles_per_split, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, lengths, out, ws, B, H, Hkv, D, S_max,
                           block, splits, tiles_per_split, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, lengths, out, ws, B, H, Hkv, D, S_max,
                            block, splits, tiles_per_split, scale, stream);
    default:
      return launch<T, 0>(q, k, v, lengths, out, ws, B, H, Hkv, D, S_max,
                          block, splits, tiles_per_split, scale, stream);
  }
}

}  // namespace

extern "C" int repro_decode_attention(int device, int dtype, const void* q,
                                      const void* k, const void* v,
                                      const void* lengths, void* out, int B,
                                      int H, int Hkv, int D, int S_max,
                                      int block, float scale, int splits,
                                      int tiles_per_split, void* workspace,
                                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const size_t smem = dtype == REPRO_F32
                          ? smem_bytes<float>(Hkv > 0 ? H / Hkv : 1, D)
                          : smem_bytes<__nv_bfloat16>(Hkv > 0 ? H / Hkv : 1, D);
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || D <= 0 || block <= 0 ||
      block > kMaxBlock || S_max <= 0 || S_max % block != 0 ||
      splits < 1 || tiles_per_split < 1 ||
      static_cast<int64_t>(splits) * tiles_per_split * block < S_max ||
      splits > 65535 || (splits > 1 && workspace == nullptr) ||
      smem > 227 * 1024)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(workspace);
  switch (dtype) {
    case REPRO_F32:
      return launch_d<float>(D, q, k, v, lengths, out, ws, B, H, Hkv, S_max,
                             block, splits, tiles_per_split, scale, s);
    case REPRO_BF16:
      return launch_d<__nv_bfloat16>(D, q, k, v, lengths, out, ws, B, H, Hkv,
                                     S_max, block, splits, tiles_per_split,
                                     scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
