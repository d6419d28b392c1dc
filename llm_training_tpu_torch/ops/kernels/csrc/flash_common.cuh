// Shared pieces of the flash-attention kernels (flash_fwd.cu, flash_bwd.cu).
//
// Layouts. q, o, dq, dout: [B, Sq, Hq, D]; k, v, dk, dv: [B, Skv, Hkv, D]
// (the model's own layout, no transposes); seg_q [B, Sq], seg_kv [B, Skv]
// int32 (0 = padding); lse, delta: [B, Hq, Sq] fp32. q heads are kv-major:
// q head h reads kv head h / (Hq / Hkv). Sq and Skv are multiples of the
// 64-row tile, and of the 128-row block for the bf16 backward kernels (the
// wrapper pads to 128 with segment id 0). D is 64 or 128.
//
// Work split of the fp32 kernels (the bf16 ones: flash_mma.cuh for the
// forward, flash_wgmma.cuh for the backward). A block of
// 256 threads owns a 64 x 64 score tile at a time.
// Thread (ty, tx) = (tid / 16, tid % 16) holds rows ty + 16 i (i < 4) and
// columns tx + 16 j of every tile it computes: 4 x 4 scores, 4 x D/16 of an
// output tile. A row's 16 columns holders are 16 lanes of one warp, so row
// max and row sum are half-warp shuffles. Tiles live in shared memory with
// one 4-byte word of padding per row, so the column reads of 16 rows and
// the row reads of 2 rows that the products below make hit distinct banks.
// All arithmetic is fp32 FMA: a first version that is right, not fast.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace flash {

constexpr int kTile = 64;          // q rows and kv rows per tile
constexpr int kThreads = 256;      // 16 x 16
constexpr int kScoreLd = kTile + 1;  // row stride of the fp32 64 x 64 tiles
// masked scores before the running max, as in the Pallas kernels: finite,
// so a row whose tiles are all masked keeps m finite and exp(m - m) = 1
constexpr float kMaskValue = -0.7f * 3.402823466e38f;

// row stride, in floats, of a 64 x D fp32 tile in shared memory
template <int D>
struct TileLd {
  static constexpr int value = D + 1;
};

template <int D>
__host__ __device__ constexpr size_t tile_bytes() {
  return (size_t)kTile * TileLd<D>::value * sizeof(float);
}

// Copy 64 rows of one head into a padded shared tile. `src` points at the
// head's first row; rows are `row_stride` floats apart. 16-byte global
// loads, consecutive threads on consecutive chunks of a row; 4-byte shared
// stores (the padding breaks 16-byte alignment).
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src,
                                          size_t row_stride) {
  constexpr int kLd = TileLd<D>::value;
  constexpr int kChunks = D / 4;
  for (int ci = threadIdx.x; ci < kTile * kChunks; ci += kThreads) {
    const int r = ci / kChunks;
    const int c = ci % kChunks;
    const float4 x = *reinterpret_cast<const float4*>(src + (size_t)r * row_stride + c * 4);
    float* w = dst + r * kLd + c * 4;
    w[0] = x.x;
    w[1] = x.y;
    w[2] = x.z;
    w[3] = x.w;
  }
}

// acc[i][j] = sum_d A[ty + 16 i][d] * B[tx + 16 j][d] for two 64 x D shared
// tiles: the A B^T products (scores, dP, and their transposes in dK/dV).
template <int D>
__device__ __forceinline__ void gemm_abt(const float* A, const float* B, int ty, int tx,
                                         float (&acc)[4][4]) {
  constexpr int kLd = TileLd<D>::value;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * kLd + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(tx + 16 * j) * kLd + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][j] += sum_c P[ty + 16 i][c] * V[c][tx + 16 j] for a 64 x 64 fp32
// tile P and a 64 x D shared tile V (P V, and P^T dO, dS K, dS^T Q).
template <int D>
__device__ __forceinline__ void gemm_pv(const float* P, const float* V, int ty, int tx,
                                        float (&acc)[4][D / 16]) {
  constexpr int kLd = TileLd<D>::value;
#pragma unroll 4
  for (int c = 0; c < kTile; ++c) {
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = P[(ty + 16 * i) * kScoreLd + c];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      const float x = V[c * kLd + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], x, acc[i][j]);
    }
  }
}

// max / sum over the 16 lanes (tx) that hold one row's columns
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float soft_cap(float s, float cap) {
  return cap > 0.f ? cap * tanhf(s / cap) : s;
}

// d soft_cap / ds, from the capped score c: 1 - tanh^2 = 1 - (c / cap)^2
__device__ __forceinline__ float soft_cap_grad(float capped, float cap) {
  if (cap <= 0.f) return 1.f;
  const float t = capped / cap;
  return 1.f - t * t;
}

// The element mask of make_attention_mask: same packed document, the q row
// is not padding, k <= q when causal, q - k < window when windowed.
__device__ __forceinline__ bool visible(int q_pos, int k_pos, int q_seg, int k_seg, int causal,
                                        int window) {
  return q_seg > 0 && q_seg == k_seg && (!causal || k_pos <= q_pos) &&
         (window <= 0 || q_pos - k_pos < window);
}

// Whether the q tile starting at position q_lo (q_offset included) and the
// kv tile starting at k_lo can hold a visible pair: by position, then by
// the tiles' segment-id ranges (x = smallest nonzero id, or a huge value
// for an all-padding tile; y = largest id). The ranges are a superset test
// for any id pattern; the element mask stays authoritative.
__device__ __forceinline__ bool tile_visible(int q_lo, int k_lo, int causal, int window,
                                             int2 q_range, int2 k_range) {
  if (causal && k_lo > q_lo + kTile - 1) return false;
  if (window > 0 && q_lo - (k_lo + kTile - 1) >= window) return false;
  return q_range.y > 0 && q_range.x <= k_range.y && k_range.x <= q_range.y;
}

}  // namespace flash
