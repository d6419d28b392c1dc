// The random streams of jax.random on the card: threefry 2x32 in JAX's
// partitionable mode, and from its bits the uniform values of
// `prng.uniform` and the Gumbel-perturbed logits of `prng.categorical`,
// one launch each. The plain versions (`prng.uniform_torch`,
// `prng.categorical_torch`) take ~190 elementwise torch ops over int64
// words for the same values; these kernels keep the words in registers.
//
// - Element i (row-major flat index, 64 bits) hashes the count pair
//   (i >> 32, i & 0xFFFFFFFF) under the key (k0, k1); its 32 bits are the
//   two output words XOR-ed, its 8 bits their low byte.
// - fp32 uniform: the top 23 bits under the exponent of 1.0, minus 1, then
//   one fused multiply-add by (maxval - minval) and minval (XLA fuses it:
//   one rounding), at least minval.
// - bf16 uniform: 8 random bits, the top 7 under the exponent of 1.0,
//   minus 1, then a multiply and an add each rounded to bf16 (as XLA and
//   torch do in bf16), at least minval.
// - Gumbel logits (fp32): u uniform on [tiny, 1), logits - log(-log(u)).
// - A uniform draw may be a block of a larger one (a rank's rows and
//   sequence chunk of a global batch): its element i is element
//   base + (i / seg_len) * seg_stride + i % seg_len of the whole draw, and
//   takes that element's bits; a single segment (seg_len >= n) skips the
//   division.
//
// The arithmetic is the plain versions' op for op with the rounding made
// explicit (__fmaf_rn, __fmul_rn, __fadd_rn: nothing is contracted), so
// the uniform values equal theirs bit for bit; `logf` is the CUDA math
// library's, as torch's `log` on the card.

#include <cfloat>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kParity = 0x1BD11BDAu;

__device__ __forceinline__ uint32_t rotate_left(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Threefry 2x32 of the count pair (x0, x1) under (k0, k1): 20 rounds in 5
// groups of 4, a key injection after each group. Returns the two output
// words XOR-ed.
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1, uint32_t x0,
                                                  uint32_t x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ kParity};
  constexpr int kRotations[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int group = 0; group < 5; ++group) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x0 += x1;
      x1 = rotate_left(x1, kRotations[group % 2][i]) ^ x0;
    }
    x0 += ks[(group + 1) % 3];
    x1 += ks[(group + 2) % 3] + (uint32_t)(group + 1);
  }
  return x0 ^ x1;
}

__device__ __forceinline__ uint32_t element_bits(uint32_t k0, uint32_t k1, int64_t i) {
  const uint64_t u = (uint64_t)i;
  return threefry_bits(k0, k1, (uint32_t)(u >> 32), (uint32_t)u);
}

// fp32 uniform on [low, high) from an element's 32 bits
__device__ __forceinline__ float uniform_f32(uint32_t bits, float low, float span) {
  const float f = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
  return fmaxf(low, __fmaf_rn(f, span, low));
}

// where a block's elements lie in the whole draw
struct Block {
  int64_t base, seg_len, seg_stride;
};

template <bool kStrided>
__device__ __forceinline__ int64_t whole_index(const Block& block, int64_t i) {
  if (kStrided) return block.base + (i / block.seg_len) * block.seg_stride + i % block.seg_len;
  return block.base + i;
}

template <bool kStrided>
__global__ void uniform_f32_kernel(uint32_t k0, uint32_t k1, int64_t n, Block block, float low,
                                   float high, float* __restrict__ out) {
  const float span = __fsub_rn(high, low);
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * kThreads)
    out[i] = uniform_f32(element_bits(k0, k1, whole_index<kStrided>(block, i)), low, span);
}

// low and high are bf16 values (rounded on the host)
template <bool kStrided>
__global__ void uniform_bf16_kernel(uint32_t k0, uint32_t k1, int64_t n, Block block, float low,
                                    float high, __nv_bfloat16* __restrict__ out) {
  const float span = __bfloat162float(__float2bfloat16_rn(__fsub_rn(high, low)));
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * kThreads) {
    const uint32_t byte = element_bits(k0, k1, whole_index<kStrided>(block, i)) & 0xFFu;
    const float one_to_two = __uint_as_float(((byte >> 1) | 0x3F80u) << 16);
    const float f = __fsub_rn(one_to_two, 1.0f);  // exact in bf16
    const float product = __bfloat162float(__float2bfloat16_rn(__fmul_rn(f, span)));
    const float value = __bfloat162float(__float2bfloat16_rn(__fadd_rn(product, low)));
    out[i] = __float2bfloat16_rn(fmaxf(low, value));
  }
}

__global__ void gumbel_logits_kernel(uint32_t k0, uint32_t k1, int64_t n,
                                     const float* __restrict__ logits, float* __restrict__ out) {
  const float span = __fsub_rn(1.0f, FLT_MIN);  // FLT_MIN: finfo(float32).tiny
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * kThreads) {
    const float u = uniform_f32(element_bits(k0, k1, i), FLT_MIN, span);
    const float noise = -logf(-logf(u));
    out[i] = __fadd_rn(noise, logits[i]);
  }
}

int grid_for(int64_t n) {
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  const int64_t cap = (int64_t)sms * 16;  // the rest is the grid-stride loop
  return (int)(blocks < cap ? blocks : cap);
}

template <bool kStrided>
int launch_uniform(int dtype, uint32_t k0, uint32_t k1, int64_t n, Block block, float low,
                   float high, void* out, cudaStream_t s) {
  if (dtype == 0)
    uniform_f32_kernel<kStrided><<<grid_for(n), kThreads, 0, s>>>(k0, k1, n, block, low, high,
                                                                   (float*)out);
  else if (dtype == 1)
    uniform_bf16_kernel<kStrided><<<grid_for(n), kThreads, 0, s>>>(
        k0, k1, n, block, low, high, (__nv_bfloat16*)out);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

// dtype 0: fp32, 1: bf16; low/high already rounded to the dtype
extern "C" int prng_uniform_launch(int dtype, uint32_t k0, uint32_t k1, int64_t n, int64_t base,
                                   int64_t seg_len, int64_t seg_stride, float low, float high,
                                   void* out, void* stream) {
  if (n < 0 || base < 0 || seg_len < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const Block block{base, seg_len, seg_stride};
  cudaStream_t s = (cudaStream_t)stream;
  if (seg_len < n) return launch_uniform<true>(dtype, k0, k1, n, block, low, high, out, s);
  return launch_uniform<false>(dtype, k0, k1, n, block, low, high, out, s);
}

extern "C" int prng_gumbel_logits_launch(uint32_t k0, uint32_t k1, int64_t n,
                                         const float* logits, float* out, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  gumbel_logits_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(k0, k1, n, logits,
                                                                            out);
  return (int)cudaGetLastError();
}
