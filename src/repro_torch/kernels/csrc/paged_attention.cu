// Paged decode attention over per-slot KV pools, by global or local page id.
//
// Replaces the TPU kernel repro/kernels/paged_attention.py:
// paged_attention_pallas (body _paged_kernel), both branches:
//   global_pages != 0  table entries are global ids slot * n_pool + page
//                      into the slot-flattened pool (the serving engine's
//                      rows may name other slots' pages);
//   global_pages == 0  table entries are page ids inside row b's own pool,
//                      so page ik of row b is b * n_pool + table[b, ik]
//                      (the encoder-decoder's self-attention cache).
// Only the page address differs; one build serves both.
//
// One block per (sequence b, kv head h).  The block loops over the first
// n_kv columns of row b of the block table — the TPU kernel's sequential
// grid axis becomes this loop — and runs the shared decode body
// (common.cuh: decode_block) on each page: stage the page's K and V rows
// of kv head h in shared memory, score the whole GQA group, online softmax
// in f32 with the weights rounded to the value dtype before P @ V.  The
// sweep stops at the last page holding a valid position; a row with
// lengths[b] <= 0 sweeps all n_kv pages, as the TPU kernel does.
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
                        const T* __restrict__ k_pool,   // (B*n_pool, block, Hkv, D)
                        const T* __restrict__ v_pool,   // (B*n_pool, block, Hkv, D)
                        const int* __restrict__ table,  // (B, table_stride)
                        const int* __restrict__ lengths,  // (B,)
                        T* __restrict__ out,            // (B, H, D)
                        int H, int Hkv, int D, int block, int n_pool,
                        int table_stride, int n_kv, int global_pages,
                        float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int G = H / Hkv;
  const int length = lengths[b];
  int n_pages = n_kv;
  if (length > 0) n_pages = min(n_kv, (length + block - 1) / block);

  const int64_t tok_stride = static_cast<int64_t>(Hkv) * D;
  const int64_t page_stride = static_cast<int64_t>(block) * tok_stride;
  const int* row = table + static_cast<int64_t>(b) * table_stride;
  const int64_t slot_base =
      global_pages ? 0 : static_cast<int64_t>(b) * n_pool;
  const int64_t head_off = static_cast<int64_t>(h) * D;
  const auto tile_off = [=](int ik) -> int64_t {
    return (slot_base + row[ik]) * page_stride + head_off;
  };
  const int64_t q_off = (static_cast<int64_t>(b) * H +
                         static_cast<int64_t>(h) * G) * D;
  repro::decode_block<T>(q + q_off, k_pool, v_pool, out + q_off, G, D,
                         block, tok_stride, length, n_pages, scale, tile_off,
                         smem);
}

template <typename T>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* table, const void* lengths, void* out, int B,
                   int H, int Hkv, int D, int block, int n_pool,
                   int table_stride, int n_kv, int global_pages, float scale,
                   cudaStream_t stream) {
  const size_t smem = repro::decode_smem_bytes(H / Hkv, D, block);
  cudaError_t err = repro::set_smem(paged_decode_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B, Hkv);
  paged_decode_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(table),
      static_cast<const int*>(lengths), static_cast<T*>(out), H, Hkv, D,
      block, n_pool, table_stride, n_kv, global_pages, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int repro_paged_attention(int device, int dtype, const void* q,
                                     const void* k_pool, const void* v_pool,
                                     const void* table, const void* lengths,
                                     void* out, int B, int H, int Hkv, int D,
                                     int block, int n_pool, int table_stride,
                                     int n_kv, int global_pages, float scale,
                                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || n_pool <= 0 || n_kv <= 0 ||
      n_kv > table_stride ||
      repro::decode_smem_bytes(H / Hkv, D, block) > 227 * 1024)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case REPRO_F32:
      return launch<float>(q, k_pool, v_pool, table, lengths, out, B, H, Hkv,
                           D, block, n_pool, table_stride, n_kv, global_pages,
                           scale, s);
    case REPRO_BF16:
      return launch<__nv_bfloat16>(q, k_pool, v_pool, table, lengths, out, B,
                                   H, Hkv, D, block, n_pool, table_stride,
                                   n_kv, global_pages, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
