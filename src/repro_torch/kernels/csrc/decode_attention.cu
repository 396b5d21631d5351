// Single-token GQA decode attention over a contiguous (B, S_max, Hkv, D)
// cache, masked by per-sequence lengths.
//
// Replaces the TPU kernel repro/kernels/paged_attention.py:
// decode_attention_pallas (body _decode_kernel).  On the ported path it is
// the encoder-decoder's cross-attention decode: each decoder layer's query
// against the (B, enc_len_max, Hkv, D) cross cache of the encoder output,
// lengths = the encoder length of each row.
//
// One block per (sequence b, kv head h).  The TPU kernel's sequential grid
// axis over S_max / block tiles becomes a loop inside the block; tile ik
// covers cache rows [ik * block, (ik + 1) * block) of sequence b, addressed
// directly (no block table).  Each tile goes through the shared decode body
// (common.cuh: decode_block): K and V rows of kv head h staged in shared
// memory, the whole GQA group scored in f32, online softmax with the
// weights rounded to the value dtype before P @ V, NEG_INF = -1e30 and the
// max(l, 1e-30) clamp.
//
// Where the sweep stops: the TPU kernel sweeps all S_max / block tiles and
// masks.  Past a row's last valid tile every position contributes
// exp(-1e30 - m) == 0 exactly, so a row with lengths[b] > 0 stops at its
// last valid tile and gives the same numbers.  A row with lengths[b] <= 0
// has no valid position: it sweeps every tile and comes out as the mean of
// all S_max V rows, as the TPU kernel and the plain softmax give.
//
// Bound on the H100: bytes.  Each (b, h) reads lengths[b] K and V rows of D
// elements once and does 4 * G * D flops per row — at G = 1 (seamless:
// 16 heads over 16 kv heads) about one flop per byte in bf16.  At B 8,
// Hkv 16 the grid is 128 blocks for 132 SMs, one wave; each block stages a
// tile before computing on it, with no overlap of load and compute.
// Splitting long rows across blocks and double-buffered (TMA) tile loads
// are the later version.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    decode_kernel(const T* __restrict__ q,        // (B, H, D)
                  const T* __restrict__ k,        // (B, S_max, Hkv, D)
                  const T* __restrict__ v,        // (B, S_max, Hkv, D)
                  const int* __restrict__ lengths,  // (B,)
                  T* __restrict__ out,            // (B, H, D)
                  int H, int Hkv, int D, int S_max, int block, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int G = H / Hkv;
  const int length = lengths[b];
  const int n_max = S_max / block;
  int n_tiles = n_max;
  if (length > 0) n_tiles = min(n_max, (length + block - 1) / block);

  const int64_t tok_stride = static_cast<int64_t>(Hkv) * D;
  const int64_t seq_off = static_cast<int64_t>(b) * S_max * tok_stride +
                          static_cast<int64_t>(h) * D;
  const int64_t tile_stride = static_cast<int64_t>(block) * tok_stride;
  const auto tile_off = [=](int ik) -> int64_t {
    return seq_off + ik * tile_stride;
  };
  const int64_t q_off = (static_cast<int64_t>(b) * H +
                         static_cast<int64_t>(h) * G) * D;
  repro::decode_block<T>(q + q_off, k, v, out + q_off, G, D, block,
                         tok_stride, length, n_tiles, scale, tile_off, smem);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* lengths, void* out, int B, int H, int Hkv,
                   int D, int S_max, int block, float scale,
                   cudaStream_t stream) {
  const size_t smem = repro::decode_smem_bytes(H / Hkv, D, block);
  cudaError_t err = repro::set_smem(decode_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B, Hkv);
  decode_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(lengths),
      static_cast<T*>(out), H, Hkv, D, S_max, block, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int repro_decode_attention(int device, int dtype, const void* q,
                                      const void* k, const void* v,
                                      const void* lengths, void* out, int B,
                                      int H, int Hkv, int D, int S_max,
                                      int block, float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || D <= 0 || block <= 0 ||
      S_max <= 0 || S_max % block != 0 ||
      repro::decode_smem_bytes(H / Hkv, D, block) > 227 * 1024)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case REPRO_F32:
      return launch<float>(q, k, v, lengths, out, B, H, Hkv, D, S_max, block,
                           scale, s);
    case REPRO_BF16:
      return launch<__nv_bfloat16>(q, k, v, lengths, out, B, H, Hkv, D, S_max,
                                   block, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
