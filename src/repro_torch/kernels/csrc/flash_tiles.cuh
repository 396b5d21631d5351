// The bf16 attention tiles of the flash kernels (flash_attention.cu and
// flash_attention_bwd.cu): how a TMA box lays a tile of D columns out in
// shared memory, the wgmma descriptors that read it as a K-major or an
// N-major operand, the register-A product over such a tile, and the
// conversion of an accumulator fragment into A fragments.
#pragma once

#include "hopper.cuh"

namespace repro {
namespace flash {

constexpr float kLog2e = 1.4426950408889634f;

// How a tile of D columns lies in shared memory: in chunks of kAtom
// columns, rows of kSwizzle bytes, swizzled in the mode the TMA box writes
// and the wgmma descriptor names.
template <int D>
struct TileSwizzle {
  static constexpr int kSwizzle = D * 2 < 128 ? D * 2 : 128;  // bytes
  static constexpr int kAtom = kSwizzle / 2;  // columns per swizzled row
  static constexpr int kChunks = D / kAtom;   // column chunks of a tile
  static constexpr uint32_t kSwizzleMode = kSwizzle == 128 ? 1 : 2;
};

// A tile of `rows` rows stored as kChunks chunks of (rows x kAtom), each
// swizzled.  K-major operand (Q, or K for S = Q.K^T): the 16 columns of
// k-step kk start 32 bytes further along the row inside their chunk.
template <int D>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int rows,
                                                int kk) {
  using L = TileSwizzle<D>;
  const int col = kk * 16;
  const uint32_t addr = tile + (col / L::kAtom) * rows * L::kSwizzle +
                        (col % L::kAtom) * 2;
  return hopper::smem_desc(addr, 16, 8 * L::kSwizzle, L::kSwizzleMode);
}

// N-major B operand (V for O += P.V): keys are the K dimension, D the N
// dimension; k-step kk starts 16 rows further down, chunk j covers
// columns [j * kAtom, (j + 1) * kAtom).
template <int D, int KN>
__device__ __forceinline__ uint64_t nmajor_desc(uint32_t tile, int kk,
                                                int j) {
  using L = TileSwizzle<D>;
  const uint32_t addr =
      tile + j * KN * L::kSwizzle + kk * 16 * L::kSwizzle;
  return hopper::smem_desc(addr, KN * L::kSwizzle, 8 * L::kSwizzle,
                           L::kSwizzleMode);
}

// O += P . V for one key tile: KN / 16 key steps, N = D in chunks of 64
template <int D, int KN>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&pa)[KN / 16][4],
                                         uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < KN / 16; ++kk) {
    if constexpr (D == 32) {
      hopper::wgmma_rs_m64n32k16<1>(o, pa[kk],
                                    nmajor_desc<D, KN>(v_tile, kk, 0), 1);
    } else {
#pragma unroll
      for (int j = 0; j < D / 64; ++j)
        hopper::wgmma_rs_m64n64k16<1>(
            *reinterpret_cast<float(*)[32]>(&o[32 * j]), pa[kk],
            nmajor_desc<D, KN>(v_tile, kk, j), 1);
    }
  }
}

// P in bf16 as the A fragments of the KN / 16 key steps: the S
// accumulator's layout is the A operand's, two columns a register
template <int KN>
__device__ __forceinline__ void pack_weights(const float (&s)[KN / 2],
                                             uint32_t (&pa)[KN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < KN / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      pa[kk][j] =
          hopper::pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
}

}  // namespace flash
}  // namespace repro
