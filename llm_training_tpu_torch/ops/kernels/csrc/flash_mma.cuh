// bf16 tensor-core pieces of the flash-attention forward kernel
// (flash_fwd.cu, replacing the Pallas `_fwd_kernel`): warp-level
// mma.sync.m16n8k16 (bf16 inputs, fp32 accumulation) and the fragment loads
// from shared memory that feed it. The backward kernels no longer use this
// file: they are built on wgmma and TMA (flash_wgmma.cuh).
//
// Work split. A block of 4 warps owns 64 q rows; warp w owns rows
// 16 w .. 16 w + 15 of every 64 x 64 score tile and of the 64 x D output
// tile. Within a warp, lane = 4 g + t holds, of a 16 x 8 fp32 accumulator,
// rows g and g + 8 and columns 2 t, 2 t + 1 (PTX's m16n8 C layout). That
// layout is also the m16n8k16 A layout of two adjacent score tiles, so P
// goes from the score product into P V in registers, rounded to bf16 as
// the Pallas kernel rounds it.
//
// Shared tiles are 64 x D bf16, row-major, rows D + 8 elements apart: 16
// bytes of padding keep rows 16-byte aligned and put the rows g = 0..7 of a
// fragment load on distinct banks.
//
// Bound: the forward is bound by tensor-core operations (4 D flops per
// visible pair per q head); mma.sync from one shared-memory stage reaches
// under a tenth of that rate (PERF.md), and the forward is next in line
// for the backward kernels' design.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace flash {

constexpr int kMmaThreads = 128;  // 4 warps x 16 rows

template <int D>
struct MmaLd {
  static constexpr int value = D + 8;
};

template <int D>
__host__ __device__ constexpr size_t mma_tile_bytes() {
  return (size_t)kTile * MmaLd<D>::value * sizeof(__nv_bfloat16);
}

// c += a * b for one 16 x 8 x 16 step
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t word(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Copy 64 rows of one head (rows `row_stride` elements apart in global
// memory) into a padded shared tile: 16-byte loads and stores.
template <int D>
__device__ __forceinline__ void load_tile_mma(__nv_bfloat16* dst,
                                              const __nv_bfloat16* __restrict__ src,
                                              size_t row_stride) {
  constexpr int kLd = MmaLd<D>::value;
  constexpr int kChunks = D / 8;
  for (int ci = threadIdx.x; ci < kTile * kChunks; ci += kMmaThreads) {
    const int r = ci / kChunks;
    const int c = ci % kChunks;
    *reinterpret_cast<uint4*>(dst + r * kLd + c * 8) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * row_stride + c * 8);
  }
}

// A fragment (16 x 16) of rows r0.. and columns k0.. of a row-major tile
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* x, int r0, int k0,
                                       int g, int t) {
  constexpr int kLd = MmaLd<D>::value;
  const __nv_bfloat16* p = x + (r0 + g) * kLd + k0 + 2 * t;
  a[0] = word(p);
  a[1] = word(p + 8 * kLd);
  a[2] = word(p + 8);
  a[3] = word(p + 8 * kLd + 8);
}

// B fragment (16 x 8) for A B^T: B^T is the row-major tile y, so the
// fragment's column n is row n0 + n of y and its k runs along that row
template <int D>
__device__ __forceinline__ void load_b_t(uint32_t (&b)[2], const __nv_bfloat16* y, int n0, int k0,
                                         int g, int t) {
  constexpr int kLd = MmaLd<D>::value;
  const __nv_bfloat16* p = y + (n0 + g) * kLd + k0 + 2 * t;
  b[0] = word(p);
  b[1] = word(p + 8);
}

// B fragment (16 x 8) of the row-major tile v itself (rows are k): two k
// rows make one register
template <int D>
__device__ __forceinline__ void load_b(uint32_t (&b)[2], const __nv_bfloat16* v, int k0, int n0,
                                       int g, int t) {
  constexpr int kLd = MmaLd<D>::value;
  const uint16_t* p = reinterpret_cast<const uint16_t*>(v) + (k0 + 2 * t) * kLd + n0 + g;
  b[0] = (uint32_t)p[0] | ((uint32_t)p[kLd] << 16);
  b[1] = (uint32_t)p[8 * kLd] | ((uint32_t)p[9 * kLd] << 16);
}

// The A fragment of columns 16 kk .. 16 kk + 15 of a warp's 16 x 64 score
// tile held as eight m16n8 accumulators, rounded to bf16
__device__ __forceinline__ void scores_as_a(uint32_t (&a)[4], const float (&s)[8][4], int kk) {
  a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
  a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
  a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
  a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
}

// max / sum over the 4 lanes (t) that hold one row's columns of a fragment
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

}  // namespace flash
