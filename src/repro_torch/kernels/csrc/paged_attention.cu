// Paged decode attention over per-slot KV pools, by global or local page id,
// with the key range split across blocks.
//
// Replaces the TPU kernel repro/kernels/paged_attention.py:128
// paged_attention_pallas (body _paged_kernel), both branches:
//   global_pages != 0  table entries are global ids slot * n_pool + page
//                      into the slot-flattened pool (the serving engine's
//                      rows may name other slots' pages: copy-on-write
//                      forks);
//   global_pages == 0  table entries are page ids inside row b's own pool,
//                      so page p of row b is b * n_pool + table[b, p]
//                      (the encoder-decoder's self-attention cache and the
//                      hybrid's shared-block pools).
// Only the page address differs; one build serves both.
//
// What bounds it on the H100: bytes.  Each (b, kv head) reads its live K
// and V rows once and does 4 * G * D flops per key, about 14 flops per byte
// in bf16 at G = 7 and 1 at G = 1, far below the ~295 the card needs to be
// compute bound.  The block body is the contiguous decode kernel's
// (decode_split.cuh): the row's key range split across blocks, a grid of
// (split, Hkv, B), K and V tiles by 16-byte cp.async in the storage dtype
// with V landing while K is scored, lanes sharing a key, and the split
// combine.  Here a tile is `block` rows of one page (a page holds
// page_rows / block tiles, and a tile never crosses a page): tile it of row
// b starts at row (slot_base + table[b, it / tpp]) * page_rows + (it % tpp)
// * block of the pool, tpp = page_rows / block, slot_base = 0 for global
// ids and b * n_pool for per-slot ids.  A block reads its own table entries
// (the TPU kernel's scalar prefetch has no counterpart).  Only the first
// n_kv table columns are swept; the table's stride is its full width.  The
// host picks the plan from shapes alone (kernels/paged_attention.py:
// plan_splits); positions are logical, tile it covering [it * block, (it +
// 1) * block), so the length mask is the contiguous kernel's.
#include "decode_split.cuh"

namespace {

struct PagedRows {
  const int* table;  // (B, table_stride) page ids
  int64_t table_stride;
  int64_t n_pool;    // pages in each slot's pool
  int global_pages;
  int page_rows;
  int block;         // rows per tile; divides page_rows
  __device__ int64_t operator()(int b, int it) const {
    const int tpp = page_rows / block;
    const int page = it / tpp;
    const int64_t slot_base = global_pages ? 0 : b * n_pool;
    return (slot_base + table[b * table_stride + page]) * page_rows +
           static_cast<int64_t>(it - page * tpp) * block;
  }
};

}  // namespace

// Packed arguments (common.cuh: Args), in order: device, dtype, q, k_pool,
// v_pool, table, lengths, out, B, H, Hkv, D, page_rows, n_pool,
// table_stride, n_kv, global_pages, scale (double), block, splits,
// tiles_per_split, workspace, stream.
extern "C" int repro_paged_attention(const void* packed) {
  const repro::Args a(packed);
  cudaError_t err = repro::use_device(a.i32(0));
  if (err != cudaSuccess) return err;
  const int page_rows = a.i32(12), n_pool = a.i32(13);
  const int table_stride = a.i32(14), n_kv = a.i32(15);
  const int block = a.i32(18);
  if (page_rows <= 0 || n_pool <= 0 || n_kv <= 0 || n_kv > table_stride ||
      block <= 0 || page_rows % block != 0 ||
      static_cast<int64_t>(n_kv) * (page_rows / block) > (1 << 30))
    return cudaErrorInvalidValue;
  repro::decode::SplitLaunch s;
  s.q = a.ptr(2);
  s.k = a.ptr(3);
  s.v = a.ptr(4);
  s.lengths = static_cast<const int*>(a.ptr(6));
  s.out = a.ptr(7);
  s.B = a.i32(8);
  s.H = a.i32(9);
  s.Hkv = a.i32(10);
  s.D = a.i32(11);
  s.n_tiles = n_kv * (page_rows / block);
  s.block = block;
  s.scale = a.f32(17);
  s.splits = a.i32(19);
  s.tiles_per_split = a.i32(20);
  s.ws = static_cast<float*>(a.ptr(21));
  const PagedRows rows{static_cast<const int*>(a.ptr(5)), table_stride,
                       n_pool, a.i32(16), page_rows, block};
  return repro::decode::launch(a.i32(1), s, rows,
                               static_cast<cudaStream_t>(a.ptr(22)));
}
