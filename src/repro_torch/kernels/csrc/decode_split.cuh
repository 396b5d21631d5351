// Single-token GQA decode attention with the key range split across
// blocks: the body shared by the contiguous decode kernel
// (decode_attention.cu) and the paged one (paged_attention.cu).  The two
// differ only in where a tile's rows lie, which a TileRows functor gives:
// rows(b, it) is the index of tile it's first row of sequence b, counted
// in rows of Hkv * D elements (the contiguous cache: b * S_max + it *
// block; the paged pool: the page the block table names, plus the tile's
// place in it).  Rows within a tile are Hkv * D elements apart in both, and
// kv head h's columns start h * D elements into a row.
//
// What bounds it on the H100: bytes.  Each (b, kv head) reads its live K
// and V rows once, D elements each, and does 4 * G * D flops per row: at
// G = 1 one flop per byte in bf16, at G = 7 seven.  One block walking a
// row's keys alone leaves most SMs idle and serialises every load behind
// the compute before it, so the key range is split across blocks.
//
// Grid (splits, Hkv, B).  A split is tiles_per_split tiles of `block` (<=
// 128) rows; the host picks the plan from shapes alone (it cannot read
// lengths without a sync).
//   * A split wholly past a row's length > 0 writes l = 0, m = -1e30 and
//     leaves; the combine skips it.  A row with length <= 0 has no valid
//     key: every split sweeps its tiles fully masked, and the combine gives
//     the mean of all n_tiles * block V rows, as the TPU kernels do
//     (uniform weights over the masked window).
//   * K and V tiles arrive by 16-byte cp.async in the storage dtype (two
//     commit groups: V lands while K is scored) where a row is whole
//     16-byte chunks and both bases are 16-byte aligned (`vec`), else
//     element by element.
//   * Scores: D / 8 lanes (bf16) share one key, 16 bytes each, and reduce
//     with shuffles; a warp scores 32 / (D / 8) keys at a time (the lanes
//     of a key padded to a power of two), all G query rows of the group
//     against each, four rows' reductions at a time when G > 1.  That needs
//     D fixed when compiled: 32, 64, 112 (zamba2's) and 128.  Any other
//     D > 0 takes the same kernel with D given at run time: a warp scores
//     one key with its lanes strided over D, and P . V gives a thread one
//     column of one row.
//   * Online softmax per query row (one warp a row) in the log2 domain
//     (log2 e folded into the scale): NEG_INF = -1e30, f32 (m, l), the
//     weights rounded to the value dtype against the split's running max
//     before P . V, as the TPU kernels round against their running max.
//   * P . V: every thread owns two adjacent columns for all the group's
//     query rows (one load of the value pair serves every row) and a share
//     of the tile's keys (at D 64: 4 threads a column pair); partial sums
//     meet in shared memory.
//   * The first tile's row (for the paged kernel, its page id) is read
//     beside the row's length, and the queries while the first tile is in
//     flight.  The combine is launched to overlap this grid's tail
//     (programmatic dependent launch).  At the serving engine's small
//     grids a call is latency-bound: the block's chain of reads, its
//     compute and the second launch, not bytes, set its time (PERF.md).
//   * With one split the block divides by max(l, 1e-30) and stores; with
//     more, it writes (m, l, acc) in f32 to the workspace and
//     combine_splits_kernel (common.cuh) merges the splits.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace repro {
namespace decode {

namespace hp = repro::hopper;

constexpr int kThreads = 128;
constexpr int kMaxBlock = 128;
constexpr float kLog2e = 1.4426950408889634f;

// the least power of two >= x
__host__ __device__ constexpr int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p *= 2;
  return p;
}

// floats of the P . V partial sums: `parts` shares of the keys for each of
// the G x D outputs, parts * D <= 2 * kThreads (see the kernel)
__host__ __device__ constexpr int red_floats(int G, int D) {
  return G * (D > 2 * kThreads ? D : 2 * kThreads);
}

// shared memory of a block: the K and V tiles in the storage dtype, then
// f32 queries, accumulators, scores, P . V partials and (m, l, alpha)
template <typename T>
size_t smem_bytes(int G, int D, int block) {
  return 2 * static_cast<size_t>(block) * D * sizeof(T) +
         sizeof(float) * (2 * G * D + G * block + red_floats(G, D) + 3 * G);
}

// Columns d and d + 1 of a row in shared memory (d even) in one load.
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Scores of one key against the group's G query rows, kRows rows at a time
// so that their shuffle reductions overlap: this lane's 16-byte slice of the
// key (kf) against the same slice of each row (qk + g * D), summed over the
// key's kLanes lanes, stored at pk[g * block].  A padding lane (not `live`)
// adds zero.  Each row's sum is the same fma chain and shuffle order
// whatever kRows is.
constexpr int kScoreRows = 4;

template <int kRows, int kLanes, int kPer>
__device__ __forceinline__ void score_rows(const float (&kf)[kPer],
                                           const float* qk, int D, int G,
                                           int block, bool live, bool valid,
                                           bool store, float scale_log2,
                                           float* pk) {
  for (int g0 = 0; g0 < G; g0 += kRows) {
    float dot[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      // the row's slice in 16-byte loads (qs rows are 16-byte aligned at a
      // compiled D)
      const float4* qr = reinterpret_cast<const float4*>(
          qk + min(g0 + r, G - 1) * D);
      float qv[kPer];
#pragma unroll
      for (int j = 0; j < kPer / 4; ++j) {
        const float4 x = qr[j];
        qv[4 * j] = x.x;
        qv[4 * j + 1] = x.y;
        qv[4 * j + 2] = x.z;
        qv[4 * j + 3] = x.w;
      }
      float d = 0.f;
#pragma unroll
      for (int j = 0; j < kPer; ++j) d = fmaf(qv[j], kf[j], d);
      dot[r] = live ? d : 0.f;
    }
#pragma unroll
    for (int o = kLanes / 2; o > 0; o >>= 1)
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], o);
    if (store)
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (g0 + r < G)
          pk[(g0 + r) * block] = valid ? dot[r] * scale_log2 : kNegInf;
  }
}

// P . V of one column pair (d, d + 1) for the group's G rows, kRows at a
// time: the keys t = part, part + parts, ... of the tile, each pair of
// values loaded once for all the rows; the sums go to rp[g * D + d].  Each
// row's sum is the same fma chain whatever kRows is.
constexpr int kPVRows = 8;

template <int kRows, typename T>
__device__ __forceinline__ void pv_rows(const float* ps, const T* vs, int D,
                                        int G, int block, int part,
                                        int parts, int d, float* rp) {
  for (int g0 = 0; g0 < G; g0 += kRows) {
    float x[kRows], y[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) x[r] = y[r] = 0.f;
#pragma unroll 4
    for (int t = part; t < block; t += parts) {
      const float2 v2 = load_pair(vs + t * D + d);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float p = ps[min(g0 + r, G - 1) * block + t];
        x[r] = fmaf(p, v2.x, x[r]);
        y[r] = fmaf(p, v2.y, y[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (g0 + r < G) {
        rp[(g0 + r) * D + d] = x[r];
        rp[(g0 + r) * D + d + 1] = y[r];
      }
    }
  }
}

// kD > 0: D = kD, one of the compiled head dims (launch_d); kD == 0: D =
// D_rt, any D > 0.
template <typename T, int kD, typename TileRows>
__global__ void __launch_bounds__(kThreads)
    split_kernel(const T* __restrict__ q,        // (B, H, D)
                 const T* __restrict__ k,        // rows of (Hkv, D)
                 const T* __restrict__ v,        // rows of (Hkv, D)
                 const int* __restrict__ lengths,  // (B,)
                 T* __restrict__ out,            // (B, H, D)
                 float* __restrict__ ws_acc,     // (splits, B, H, D)
                 float* __restrict__ ws_ml,      // (splits, B, H, 2)
                 int B, int H, int Hkv, int D_rt, int n_tiles, int block,
                 int tiles_per_split, int splits, float scale_log2, int vec,
                 TileRows rows) {
  constexpr int kPerChunk = 16 / sizeof(T);  // elements per 16 bytes
  // a compiled D's row is kChunks 16-byte chunks, one a lane; the lanes of
  // a key are padded to a power of two for the shuffle reduction (D 112 in
  // bf16: 14 chunks on 16 lanes), and the padding lanes add zeros
  constexpr int kChunks = kD > 0 ? kD / kPerChunk : 1;
  constexpr int kLanesPerKey = pow2_at_least(kChunks);
  constexpr int kKeysPerWarp = 32 / kLanesPerKey;
  static_assert(kD % kPerChunk == 0 && kLanesPerKey <= 32,
                "a compiled D is whole 16-byte chunks, at most 32 a row");
  const int D = kD > 0 ? kD : D_rt;
  const int chunks = D * static_cast<int>(sizeof(T)) / 16;
  const int split = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / Hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // the combine (launched to overlap this grid) may be scheduled now; it
  // waits for this grid to finish before it reads the workspace
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int t_begin = split * tiles_per_split;
  // the first tile's row does not depend on the length: its page id (if
  // any) is read beside the length
  const int64_t first_row = rows(b, min(t_begin, n_tiles - 1));
  const int length = lengths[b];
  const int n_live =
      length > 0 ? min(n_tiles, (length + block - 1) / block) : n_tiles;
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
  T* vs = ks + block * D;                           // block x D
  float* qs = reinterpret_cast<float*>(vs + block * D);  // G x D
  float* acc = qs + G * D;                          // G x D
  float* ps = acc + G * D;                          // G x block
  float* red = ps + G * block;                      // red_floats(G, D)
  float* m_s = red + red_floats(G, D);
  float* l_s = m_s + G;
  float* a_s = l_s + G;

  // P . V work split: at a compiled D, column pairs, each thread one pair
  // for all G rows of the group (a pair of values loaded once serves every
  // row); at a run-time D, single columns of the group.  Each unit takes
  // `parts` strided shares of the tile's keys (a power of two, <= 128 /
  // units)
  const int units = kD > 0 ? D / 2 : G * D;
  int parts = 1;
  while (units * parts * 2 <= kThreads) parts *= 2;

  const int64_t row_stride = static_cast<int64_t>(Hkv) * D;
  for (int it = t_begin; it < t_end; ++it) {
    const int64_t row = it == t_begin ? first_row : rows(b, it);
    const int64_t off = row * row_stride + static_cast<int64_t>(hk) * D;
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
    if (it == t_begin) {  // the group's queries, while the tile is in flight
      for (int i = tid; i < G * D; i += kThreads) {
        qs[i] = repro::to_float(q[q_row * D + i]);
        acc[i] = 0.f;
      }
      for (int g = tid; g < G; g += kThreads) {
        m_s[g] = repro::kNegInf;
        l_s[g] = 0.f;
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
        const bool live = sub < kChunks;  // always, for a power of two
        float kf[kPerChunk];
        {
          const uint4 raw = *reinterpret_cast<const uint4*>(
              ks + (in ? tok : 0) * D + (live ? sub : 0) * kPerChunk);
          const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int j = 0; j < kPerChunk; ++j) kf[j] = repro::to_float(e[j]);
        }
        const bool valid = it * block + tok < length;
        const float* qk = qs + (live ? sub : 0) * kPerChunk;
        float* pk = ps + tok;
        const bool store = in && sub == 0;
        if (G == 1)
          score_rows<1, kLanesPerKey>(kf, qk, D, 1, block, live, valid,
                                      store, scale_log2, pk);
        else
          score_rows<kScoreRows, kLanesPerKey>(kf, qk, D, G, block, live,
                                               valid, store, scale_log2, pk);
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
            ps[g * block + tok] =
                valid ? dot * scale_log2 : repro::kNegInf;
        }
      }
    }
    __syncthreads();

    // online softmax: one warp per query row
    for (int g = warp; g < G; g += kThreads / 32) {
      float* pr = ps + g * block;
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
        float* rp = red + part * G * D;
        if (G == 1)
          pv_rows<1>(ps, vs, D, 1, block, part, parts, 2 * u, rp);
        else
          pv_rows<kPVRows>(ps, vs, D, G, block, part, parts, 2 * u, rp);
      } else {
        const int d = u % D;
        const float* pr = ps + (u / D) * block;
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

// What both kernels pass to the launch besides their TileRows.
struct SplitLaunch {
  const void* q;
  const void* k;
  const void* v;
  const int* lengths;
  void* out;
  float* ws;  // (splits, B, H, D + 2) f32 when splits > 1
  int B, H, Hkv, D;
  int n_tiles;          // tiles of `block` rows a row can hold
  int block;            // rows per tile, <= kMaxBlock
  int splits;           // key ranges per (row, kv head)
  int tiles_per_split;  // tiles in each range
  float scale;
};

template <typename T, int kD, typename TileRows>
cudaError_t launch_form(const SplitLaunch& a, TileRows rows,
                        cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(a.H / a.Hkv, a.D, a.block);
  cudaError_t err = repro::set_smem(split_kernel<T, kD, TileRows>, smem);
  if (err != cudaSuccess) return err;
  const int64_t n_rows = static_cast<int64_t>(a.B) * a.H;
  float* ws_acc = a.ws;
  float* ws_ml = a.splits > 1 ? a.ws + a.splits * n_rows * a.D : nullptr;
  // 16-byte loads need rows of whole 16-byte chunks and aligned bases
  const int vec = a.D * sizeof(T) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(a.k) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(a.v) % 16 == 0;
  const dim3 grid(a.splits, a.Hkv, a.B);
  split_kernel<T, kD, TileRows><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.lengths, static_cast<T*>(a.out), ws_acc,
      ws_ml, a.B, a.H, a.Hkv, a.D, a.n_tiles, a.block, a.tiles_per_split,
      a.splits, a.scale * kLog2e, vec, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  return repro::launch_combine<T>(ws_acc, ws_ml, static_cast<T*>(a.out),
                                  n_rows, a.D, a.splits, stream);
}

template <typename T, typename TileRows>
cudaError_t launch_d(const SplitLaunch& a, TileRows rows,
                     cudaStream_t stream) {
  switch (a.D) {  // the compiled head dims: 112 is zamba2's
    case 32:
      return launch_form<T, 32>(a, rows, stream);
    case 64:
      return launch_form<T, 64>(a, rows, stream);
    case 112:
      return launch_form<T, 112>(a, rows, stream);
    case 128:
      return launch_form<T, 128>(a, rows, stream);
    default:
      return launch_form<T, 0>(a, rows, stream);
  }
}

// Check the launch shape, then launch the split kernel and, with more than
// one split, the combine.  Returns cudaErrorInvalidValue, launching
// nothing, on a shape the kernel does not take.
template <typename TileRows>
cudaError_t launch(int dtype, const SplitLaunch& a, TileRows rows,
                   cudaStream_t stream) {
  if (a.B <= 0 || a.B > 65535 || a.Hkv <= 0 || a.Hkv > 65535 ||
      a.H % a.Hkv != 0 || a.D <= 0 || a.block <= 0 || a.block > kMaxBlock ||
      a.n_tiles <= 0 || a.splits < 1 || a.splits > 65535 ||
      a.tiles_per_split < 1 ||
      static_cast<int64_t>(a.splits) * a.tiles_per_split < a.n_tiles ||
      (a.splits > 1 && a.ws == nullptr))
    return cudaErrorInvalidValue;
  const int G = a.H / a.Hkv;
  switch (dtype) {
    case REPRO_F32:
      if (smem_bytes<float>(G, a.D, a.block) > 227 * 1024)
        return cudaErrorInvalidValue;
      return launch_d<float>(a, rows, stream);
    case REPRO_BF16:
      if (smem_bytes<__nv_bfloat16>(G, a.D, a.block) > 227 * 1024)
        return cudaErrorInvalidValue;
      return launch_d<__nv_bfloat16>(a, rows, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace decode
}  // namespace repro
