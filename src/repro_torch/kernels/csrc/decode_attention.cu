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
// What bounds it on the H100: bytes.  At seamless's shape (G = 1, one flop
// per byte in bf16) it reads 33.5 MB, 10 us at 3.35 TB/s.  The block body
// (decode_split.cuh, shared with the paged kernel) splits each row's key
// range across blocks; here tile it of row b starts at cache row b * S_max
// + it * block.  The host picks the split from S_max and B * Hkv alone: at
// seamless's shape a split is one tile of 128 rows, 32 splits per (b, h),
// of which the 8 that hold the 1024 live rows work (1024 blocks) and the
// rest return at once.
#include "decode_split.cuh"

namespace {

// tile it of row b starts at row b * S_max + it * block of the cache
struct ContiguousRows {
  int S_max;
  int block;
  __device__ int64_t operator()(int b, int it) const {
    return static_cast<int64_t>(b) * S_max + static_cast<int64_t>(it) * block;
  }
};

}  // namespace

// Packed arguments (common.cuh: Args), in order: device, dtype, q, k, v,
// lengths, out, B, H, Hkv, D, S_max, block, scale (double), splits,
// tiles_per_split, workspace, stream.
extern "C" int repro_decode_attention(const void* packed) {
  const repro::Args a(packed);
  cudaError_t err = repro::use_device(a.i32(0));
  if (err != cudaSuccess) return err;
  const int S_max = a.i32(11), block = a.i32(12);
  if (S_max <= 0 || block <= 0 || S_max % block != 0)
    return cudaErrorInvalidValue;
  repro::decode::SplitLaunch s;
  s.q = a.ptr(2);
  s.k = a.ptr(3);
  s.v = a.ptr(4);
  s.lengths = static_cast<const int*>(a.ptr(5));
  s.out = a.ptr(6);
  s.B = a.i32(7);
  s.H = a.i32(8);
  s.Hkv = a.i32(9);
  s.D = a.i32(10);
  s.n_tiles = S_max / block;
  s.block = block;
  s.scale = a.f32(13);
  s.splits = a.i32(14);
  s.tiles_per_split = a.i32(15);
  s.ws = static_cast<float*>(a.ptr(16));
  return repro::decode::launch(a.i32(1), s, ContiguousRows{S_max, block},
                               static_cast<cudaStream_t>(a.ptr(17)));
}
