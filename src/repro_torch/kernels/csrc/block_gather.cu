// KV-page gather: out[i] = pool[idx[i]] for whole pages, any dtype.
//
// Replaces the TPU kernel repro/kernels/block_gather.py: block_gather_pallas
// (body _kernel), which streams M pages HBM -> VMEM -> HBM with the page ids
// as a scalar-prefetched index.  On the ported path it is the read half of
// DeviceState.copy_pages (a copy-on-write fork admission, a prefix-cache
// replay) and the whole of DeviceState.read_pages (a handoff or migration
// read), one launch per pool over all layers of the pool viewed as
// (L * B * N_pool, block, Hkv, D).
//
// Bound on the H100: bytes.  Each gathered page is read once and written
// once: 1.57 MB at M 24 of qwen2's 32 KB pages is 0.47 us at 3.35 TB/s,
// below one launch.  What a call costs is fixed: the pages it moves were
// written long before (a forked prompt page, a page held under a handoff),
// and on a cold L2 an empty kernel of this library takes ~5 us and one that
// only reads the index ~0.6 us more, of the ~7 us that 24 pages take
// (PERF.md, tools/gather_probe.py).  So the kernel keeps the chain to one
// index read and one round of loads, and starts every SM:
//
// Block (i, p) of a 2-D grid copies piece p of gathered page i.  Thread 0
// reads the page id once; then each thread loads all its words of the piece
// (up to kUnroll) before its first store.  The word is the widest of 16, 8,
// 4, 2 or 1 bytes that the page size and both bases allow (a 30-byte page,
// a pool viewed at an odd element offset).  The host plans the piece and
// the word (kernels/block_gather.py: plan_gather); this entry refuses a
// plan it cannot run.
//
// An index outside [0, n_pool) reads nothing: its output page is zeroed.
// The host checks the indices it builds before they reach the card, so this
// only keeps a bad index from faulting.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // words a thread has in flight
constexpr int kProbeThreads = 32;

template <typename W>
__global__ void __launch_bounds__(kThreads)
    gather_kernel(const char* __restrict__ pool, const int* __restrict__ idx,
                  char* __restrict__ out, int64_t n_pool, int64_t page_bytes,
                  int64_t piece_bytes) {
  __shared__ int64_t src_s;
  const int64_t page = blockIdx.x;
  const int64_t begin = static_cast<int64_t>(blockIdx.y) * piece_bytes;
  if (threadIdx.x == 0) src_s = idx[page];
  __syncthreads();
  const int64_t src = src_s;
  const int64_t end = page_bytes - begin < piece_bytes ? page_bytes - begin
                                                       : piece_bytes;
  const int64_t words = end / static_cast<int64_t>(sizeof(W));
  W* dst = reinterpret_cast<W*>(out + page * page_bytes + begin);
  if (src < 0 || src >= n_pool) {
    for (int64_t w = threadIdx.x; w < words; w += kThreads) dst[w] = W{};
    return;
  }
  const W* from = reinterpret_cast<const W*>(pool + src * page_bytes + begin);
  W v[kUnroll];
#pragma unroll
  for (int j = 0; j < kUnroll; ++j) {
    const int64_t w = threadIdx.x + j * kThreads;
    if (w < words) v[j] = from[w];
  }
#pragma unroll
  for (int j = 0; j < kUnroll; ++j) {
    const int64_t w = threadIdx.x + j * kThreads;
    if (w < words) dst[w] = v[j];
  }
}

template <typename W>
cudaError_t launch(const char* pool, const int* idx, char* out, int64_t m,
                   int64_t n_pool, int64_t page_bytes, int64_t piece_bytes,
                   int64_t pieces, cudaStream_t stream) {
  if (piece_bytes > static_cast<int64_t>(sizeof(W)) * kThreads * kUnroll)
    return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(m), static_cast<unsigned>(pieces));
  gather_kernel<W><<<grid, kThreads, 0, stream>>>(pool, idx, out, n_pool,
                                                  page_bytes, piece_bytes);
  return cudaGetLastError();
}

__global__ void empty_kernel() {}

// one index read per block, kept alive by a store that never happens
__global__ void index_kernel(const int* __restrict__ idx, int64_t m,
                             int* sink) {
  if (threadIdx.x == 0) {
    const int v = idx[blockIdx.x % m];
    if (v == INT_MIN) *sink = v;
  }
}

}  // namespace

// Packed arguments (common.cuh: Args), in order: device, pool, idx, out, m,
// n_pool, page_bytes, stream, then the plan (GatherPlan): piece_bytes,
// pieces (a page's), word_bytes.  m is at least 1: the host launches
// nothing for m 0.
extern "C" int repro_block_gather(const void* packed) {
  const repro::Args a(packed);
  const char* pool = static_cast<const char*>(a.ptr(1));
  const int* idx = static_cast<const int*>(a.ptr(2));
  char* out = static_cast<char*>(a.ptr(3));
  const int64_t m = a.i64(4), n_pool = a.i64(5), page_bytes = a.i64(6);
  cudaStream_t stream = static_cast<cudaStream_t>(a.ptr(7));
  const int64_t piece = a.i64(8), pieces = a.i64(9), word = a.i64(10);
  const uintptr_t align = reinterpret_cast<uintptr_t>(pool) |
                          reinterpret_cast<uintptr_t>(out) |
                          static_cast<uintptr_t>(page_bytes) |
                          static_cast<uintptr_t>(piece);
  if (m <= 0 || m > INT_MAX || n_pool <= 0 || page_bytes <= 0 || piece <= 0 ||
      pieces != (page_bytes + piece - 1) / piece || pieces > 65535 ||
      word < 1 || word > 16 || (word & (word - 1)) != 0 || align % word != 0)
    return cudaErrorInvalidValue;
  cudaError_t err = repro::use_device(a.i32(0));
  if (err != cudaSuccess) return err;
  switch (word) {
    case 16:
      return launch<uint4>(pool, idx, out, m, n_pool, page_bytes, piece,
                           pieces, stream);
    case 8:
      return launch<uint2>(pool, idx, out, m, n_pool, page_bytes, piece,
                           pieces, stream);
    case 4:
      return launch<uint32_t>(pool, idx, out, m, n_pool, page_bytes, piece,
                              pieces, stream);
    case 2:
      return launch<uint16_t>(pool, idx, out, m, n_pool, page_bytes, piece,
                              pieces, stream);
    default:
      return launch<uint8_t>(pool, idx, out, m, n_pool, page_bytes, piece,
                             pieces, stream);
  }
}

// The launch floor and the index read alone, for timing the gather's fixed
// cost from the same library.  Packed arguments: device, idx, sink (an int
// on the card), m, grid, kind (0: an empty kernel of one warp a block; 1:
// lane 0 of each block reads idx[block % m]), stream.
extern "C" int repro_block_gather_probe(const void* packed) {
  const repro::Args a(packed);
  const int* idx = static_cast<const int*>(a.ptr(1));
  int* sink = static_cast<int*>(a.ptr(2));
  const int64_t m = a.i64(3), grid = a.i64(4), kind = a.i64(5);
  cudaStream_t stream = static_cast<cudaStream_t>(a.ptr(6));
  if (grid <= 0 || grid > INT_MAX || (kind == 1 && m <= 0) || kind < 0 ||
      kind > 1)
    return cudaErrorInvalidValue;
  cudaError_t err = repro::use_device(a.i32(0));
  if (err != cudaSuccess) return err;
  if (kind == 0)
    empty_kernel<<<static_cast<unsigned>(grid), kProbeThreads, 0, stream>>>();
  else
    index_kernel<<<static_cast<unsigned>(grid), kProbeThreads, 0, stream>>>(
        idx, m, sink);
  return cudaGetLastError();
}
