// KV-page gather: out[i] = pool[idx[i]] for whole pages.
//
// Replaces the TPU kernel repro/kernels/block_gather.py: block_gather_pallas
// (body _kernel), which streams M pages HBM -> VMEM -> HBM with the page ids
// as a scalar-prefetched index.  On the ported path it is the read half of
// DeviceState.copy_pages: the copy-on-write fork admission (one partial
// prompt page per secondary branch) and the prefix-cache replay admission
// (the cached pages), each one launch per pool (K, V) over all layers of
// the pool viewed as (L * B * N_pool, block, Hkv, D).
//
// The kernel copies bytes, so it takes any dtype.  A page is page_bytes
// contiguous bytes; blockIdx.x picks the gathered page i, blockIdx.y one of
// the page's pieces, and the block copies its piece with a block-stride loop
// in words of W bytes.  The host picks W = 16 (uint4, one vector load and
// store per thread per step) when the page size and both base addresses
// allow it, else the widest of 8, 4, 2 or 1 that does.
//
// An index outside [0, n_pool) reads nothing: its output page is zeroed.
// The host checks the indices it builds before they reach the card, so this
// only keeps a bad index from faulting.
//
// Bound on the H100: bytes.  Each gathered page is read once and written
// once.  At the serving path's sizes (24 and 144 pages of 32 KiB) the copy
// is a few microseconds of HBM traffic, so the launch's fixed cost weighs
// as much as the copy; the times are in PERF.md.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
// pieces of a page at most: a 32 KiB page of uint4 words is 8 pieces of
// 256 threads x 16 B
constexpr int kMaxPieces = 8;

template <typename W>
__global__ void __launch_bounds__(kThreads)
    gather_kernel(const W* __restrict__ pool, const int* __restrict__ idx,
                  W* __restrict__ out, int64_t n_pool, int64_t page_words) {
  const int64_t i = blockIdx.x;
  const int64_t src = idx[i];
  W* dst = out + i * page_words;
  const int64_t step = static_cast<int64_t>(gridDim.y) * kThreads;
  const int64_t first = static_cast<int64_t>(blockIdx.y) * kThreads +
                        threadIdx.x;
  if (src < 0 || src >= n_pool) {
    for (int64_t w = first; w < page_words; w += step) dst[w] = W{};
    return;
  }
  const W* from = pool + src * page_words;
  for (int64_t w = first; w < page_words; w += step) dst[w] = from[w];
}

template <typename W>
cudaError_t launch(const void* pool, const void* idx, void* out, int m,
                   int64_t n_pool, int64_t page_bytes, cudaStream_t stream) {
  const int64_t words = page_bytes / static_cast<int64_t>(sizeof(W));
  const int64_t pieces =
      (words + kThreads - 1) / kThreads < kMaxPieces
          ? (words + kThreads - 1) / kThreads
          : kMaxPieces;
  const dim3 grid(m, static_cast<unsigned>(pieces > 0 ? pieces : 1));
  gather_kernel<W><<<grid, kThreads, 0, stream>>>(
      static_cast<const W*>(pool), static_cast<const int*>(idx),
      static_cast<W*>(out), n_pool, words);
  return cudaGetLastError();
}

// the widest word of 16, 8, 4, 2, 1 bytes that divides the page size and
// both base addresses
int word_bytes(const void* pool, const void* out, int64_t page_bytes) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(pool) |
                      reinterpret_cast<uintptr_t>(out) |
                      static_cast<uintptr_t>(page_bytes);
  for (int w = 16; w > 1; w >>= 1)
    if (a % w == 0) return w;
  return 1;
}

}  // namespace

// Packed arguments (common.cuh: Args), in order: device, pool, idx, out, m,
// n_pool, page_bytes, stream.
extern "C" int repro_block_gather(const void* packed) {
  const repro::Args a(packed);
  cudaError_t err = repro::use_device(a.i32(0));
  if (err != cudaSuccess) return err;
  const void* pool = a.ptr(1);
  const void* idx = a.ptr(2);
  void* out = a.ptr(3);
  const int64_t m = a.i64(4), n_pool = a.i64(5), page_bytes = a.i64(6);
  if (m < 0 || m > 0x7fffffff || n_pool <= 0 || page_bytes <= 0)
    return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(a.ptr(7));
  switch (word_bytes(pool, out, page_bytes)) {
    case 16:
      return launch<uint4>(pool, idx, out, m, n_pool, page_bytes, s);
    case 8:
      return launch<uint2>(pool, idx, out, m, n_pool, page_bytes, s);
    case 4:
      return launch<uint32_t>(pool, idx, out, m, n_pool, page_bytes, s);
    case 2:
      return launch<uint16_t>(pool, idx, out, m, n_pool, page_bytes, s);
    default:
      return launch<uint8_t>(pool, idx, out, m, n_pool, page_bytes, s);
  }
}
