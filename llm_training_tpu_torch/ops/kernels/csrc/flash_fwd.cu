// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fwd_kernel` in
// llm_training_tpu/ops/pallas/flash_attention.py (pallas_call in
// `flash_fwd_flat`): an online softmax (m, l, acc in fp32) over the kv
// tiles a q tile can see, with causal and sliding-window masks, q_offset,
// soft cap, packed segment ids and gpt-oss sinks (m starts at the sink, l
// at 1). It returns O in the input type and the row logsumexp in fp32; a
// row that sees nothing gives O = 0 and LSE = -inf (sink, with sinks).
//
// Design. The TPU grid (batch-head, q block, kv block) carried (m, l, acc)
// in VMEM across its sequential kv axis and skipped tiles by redirecting
// their DMA. Here one block owns (batch, q head, 64-row q tile), keeps the
// q tile on chip and its rows' (m, l, acc) in registers, and loops over the
// kv tiles itself; a tile that position or segment ranges rule out is
// never loaded (the loop bound replaces `_kv_clamp` and
// `_segment_block_bounds`). Per kv tile: S = Q K^T, soft cap, then the mask
// BEFORE the row max (masked scores are kMaskValue, their p is forced to
// 0), the usual rescale, and acc += P V.
//
// Two kernels. bf16 (the training path): 4 warps on tensor cores
// (mma.sync m16n8k16, flash_mma.cuh), P rounded to bf16 in registers before
// P V, as the Pallas kernel rounds it for the MXU. fp32: 256 threads of
// fp32 FMA from shared memory (flash_common.cuh), P kept in fp32.
//
// Bound. At the training shape the kernel does 4 D flops per visible
// (q, k) pair per q head and moves only q, k, v, out and lse once: it is
// bound by operations, at the bf16 tensor-core rate. mma.sync from shared
// memory, one stage, reaches about a tenth of it (PERF.md); wgmma fed by
// TMA through a multi-stage ring, with warp specialisation, is the next
// step.

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace {

using namespace flash;

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const int* __restrict__ seg_q,
                     const int* __restrict__ seg_kv, const int2* __restrict__ q_ranges,
                     const int2* __restrict__ k_ranges, const float* __restrict__ sinks,
                     float* __restrict__ out, float* __restrict__ lse, int sq, int skv, int hq,
                     int hkv, int causal, int window, float cap, int q_offset) {
  constexpr int kCols = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* ks = reinterpret_cast<float*>(smem + tile_bytes<D>());
  float* vs = reinterpret_cast<float*>(smem + 2 * tile_bytes<D>());
  float* ps = reinterpret_cast<float*>(smem + 3 * tile_bytes<D>());
  int* qseg = reinterpret_cast<int*>(ps + kTile * kScoreLd);
  int* kseg = qseg + kTile;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nq = sq / kTile, nk = skv / kTile;
  const int hk = h / (hq / hkv);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = qt * kTile;
  const size_t q_stride = (size_t)hq * D, kv_stride = (size_t)hkv * D;

  load_tile<D>(qs, q + ((size_t)b * sq + q0) * q_stride + (size_t)h * D, q_stride);
  if (tid < kTile) qseg[tid] = seg_q[(size_t)b * sq + q0 + tid];
  const int2 q_range = q_ranges[(size_t)b * nq + qt];

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = sinks != nullptr ? sinks[h] : kMaskValue;
    l[i] = sinks != nullptr ? 1.f : 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  }

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    if (!tile_visible(q0 + q_offset, k0, causal, window, q_range, k_ranges[(size_t)b * nk + kt]))
      continue;  // uniform across the block
    __syncthreads();  // the previous tile's readers are done with ks, vs, ps
    load_tile<D>(ks, k + ((size_t)b * skv + k0) * kv_stride + (size_t)hk * D, kv_stride);
    load_tile<D>(vs, v + ((size_t)b * skv + k0) * kv_stride + (size_t)hk * D, kv_stride);
    if (tid < kTile) kseg[tid] = seg_kv[(size_t)b * skv + k0 + tid];
    __syncthreads();

    float s[4][4];
    gemm_abt<D>(qs, ks, ty, tx, s);
    unsigned vis = 0;  // bit 4 i + j: score (i, j) is visible
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = ty + 16 * i;
      float mx = kMaskValue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = tx + 16 * j;
        if (visible(q0 + qi + q_offset, k0 + kj, qseg[qi], kseg[kj], causal, window)) {
          vis |= 1u << (4 * i + j);
          s[i][j] = soft_cap(s[i][j], cap);
        } else {
          s[i][j] = kMaskValue;
        }
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = (vis >> (4 * i + j)) & 1u ? expf(s[i][j] - m_new) : 0.f;
        ps[qi * kScoreLd + tx + 16 * j] = p;
        rs += p;
      }
      l[i] = alpha * l[i] + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
    gemm_pv<D>(ps, vs, ty, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    const float l_safe = l[i] > 0.f ? l[i] : 1.f;
    float* out_row = out + ((size_t)b * sq + row) * q_stride + (size_t)h * D;
#pragma unroll
    for (int j = 0; j < kCols; ++j) out_row[tx + 16 * j] = acc[i][j] / l_safe;
    if (tx == 0)
      lse[((size_t)b * hq + h) * sq + row] = l[i] > 0.f ? m[i] + logf(l_safe) : -INFINITY;
  }
}

template <int D>
int launch_fma(const void* q, const void* k, const void* v, const int* seg_q, const int* seg_kv,
           const int* q_ranges, const int* k_ranges, const float* sinks, void* out, float* lse,
           int batch, int sq, int skv, int hq, int hkv, int causal, int window, float cap,
           int q_offset, cudaStream_t stream) {
  const size_t smem = 3 * tile_bytes<D>() + kTile * kScoreLd * sizeof(float) +
                      2 * kTile * sizeof(int);
  auto kernel = flash_fwd_fma_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(sq / kTile, hq, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, seg_q, seg_kv, (const int2*)q_ranges,
      (const int2*)k_ranges, sinks, (float*)out, lse, sq, skv, hq, hkv, causal, window, cap,
      q_offset);
  return (int)cudaGetLastError();
}

// The bf16 kernel: the same algorithm on tensor cores (flash_mma.cuh). A
// block of 4 warps owns (batch, q head, 64-row q tile); each warp keeps the
// A fragments of its 16 q rows in registers, computes its 16 x 64 scores
// with mma.sync, masks them, updates (m, l) for its rows, and multiplies
// the probabilities, rounded to bf16 in registers, by the V tile.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const int* __restrict__ seg_q,
                     const int* __restrict__ seg_kv, const int2* __restrict__ q_ranges,
                     const int2* __restrict__ k_ranges, const float* __restrict__ sinks,
                     __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int sq, int skv,
                     int hq, int hkv, int causal, int window, float cap, int q_offset) {
  constexpr int kN = D / 8;   // 8-column accumulators of the output
  constexpr int kK = D / 16;  // 16-deep steps over head_dim
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem + mma_tile_bytes<D>());
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem + 2 * mma_tile_bytes<D>());
  int* qseg = reinterpret_cast<int*>(smem + 3 * mma_tile_bytes<D>());
  int* kseg = qseg + kTile;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nq = sq / kTile, nk = skv / kTile;
  const int hk = h / (hq / hkv);
  const int warp = threadIdx.x >> 5, g = (threadIdx.x >> 2) & 7, t = threadIdx.x & 3;
  const int q0 = qt * kTile;
  const size_t q_stride = (size_t)hq * D, kv_stride = (size_t)hkv * D;

  load_tile_mma<D>(qs, q + ((size_t)b * sq + q0) * q_stride + (size_t)h * D, q_stride);
  if (threadIdx.x < kTile) qseg[threadIdx.x] = seg_q[(size_t)b * sq + q0 + threadIdx.x];
  const int2 q_range = q_ranges[(size_t)b * nq + qt];
  __syncthreads();

  uint32_t qa[kK][4];
#pragma unroll
  for (int kk = 0; kk < kK; ++kk) load_a<D>(qa[kk], qs, 16 * warp, 16 * kk, g, t);
  int row[2], q_pos[2], q_id[2];  // this lane's rows g and g + 8 of the warp's 16
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row[r] = 16 * warp + g + 8 * r;
    q_pos[r] = q0 + row[r] + q_offset;
    q_id[r] = qseg[row[r]];
  }
  // l is this lane's share of the row sum (the 4 lanes of a row add up at
  // the end); a sink's 1 is counted once, by lane t = 0
  float m[2], l[2], acc[kN][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = sinks != nullptr ? sinks[h] : kMaskValue;
    l[r] = sinks != nullptr && t == 0 ? 1.f : 0.f;
  }
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    if (!tile_visible(q0 + q_offset, k0, causal, window, q_range, k_ranges[(size_t)b * nk + kt]))
      continue;  // uniform across the block
    __syncthreads();  // every warp is done with the previous ks, vs
    load_tile_mma<D>(ks, k + ((size_t)b * skv + k0) * kv_stride + (size_t)hk * D, kv_stride);
    load_tile_mma<D>(vs, v + ((size_t)b * skv + k0) * kv_stride + (size_t)hk * D, kv_stride);
    if (threadIdx.x < kTile) kseg[threadIdx.x] = seg_kv[(size_t)b * skv + k0 + threadIdx.x];
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t bk[2];
        load_b_t<D>(bk, ks, 8 * j, 16 * kk, g, t);
        mma_bf16(s[j], qa[kk], bk);
      }
    }
    uint32_t vis = 0;  // bit 4 j + e: element e of accumulator j is visible
    float mx[2] = {kMaskValue, kMaskValue};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, col = 8 * j + 2 * t + (e & 1);
        if (visible(q_pos[r], k0 + col, q_id[r], kseg[col], causal, window)) {
          vis |= 1u << (4 * j + e);
          s[j][e] = soft_cap(s[j][e], cap);
        } else {
          s[j][e] = kMaskValue;
        }
        mx[r] = fmaxf(mx[r], s[j][e]);
      }
    }
    float alpha[2], m_new[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_new[r] = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = expf(m[r] - m_new[r]);
      m[r] = m_new[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        s[j][e] = (vis >> (4 * j + e)) & 1u ? expf(s[j][e] - m_new[r]) : 0.f;
        l[r] += s[j][e];
      }
    }
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4];
      scores_as_a(pa, s, kk);
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        uint32_t bv[2];
        load_b<D>(bv, vs, 16 * kk, 8 * n, g, t);
        mma_bf16(acc[n], pa, bv);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l_row = quad_sum(l[r]);
    const float l_safe = l_row > 0.f ? l_row : 1.f;
    __nv_bfloat16* out_row =
        out + ((size_t)b * sq + q0 + row[r]) * q_stride + (size_t)h * D + 2 * t;
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(out_row + 8 * n) =
          __floats2bfloat162_rn(acc[n][2 * r] / l_safe, acc[n][2 * r + 1] / l_safe);
    }
    if (t == 0)
      lse[((size_t)b * hq + h) * sq + q0 + row[r]] = l_row > 0.f ? m[r] + logf(l_safe) : -INFINITY;
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, const int* seg_q, const int* seg_kv,
               const int* q_ranges, const int* k_ranges, const float* sinks, void* out, float* lse,
               int batch, int sq, int skv, int hq, int hkv, int causal, int window, float cap,
               int q_offset, cudaStream_t stream) {
  const size_t smem = 3 * mma_tile_bytes<D>() + 2 * kTile * sizeof(int);
  auto kernel = flash_fwd_mma_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(sq / kTile, hq, batch);
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, seg_q, seg_kv,
      (const int2*)q_ranges, (const int2*)k_ranges, sinks, (__nv_bfloat16*)out, lse, sq, skv, hq,
      hkv, causal, window, cap, q_offset);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. q_ranges [B, Sq/64, 2] and k_ranges
// [B, Skv/64, 2] int32 hold each tile's (smallest nonzero, largest) segment
// id; sinks is [Hq] fp32 or null; window <= 0 means none, cap <= 0 means
// none. Returns a cudaError_t (0 on success) read right after the launch.
extern "C" int flash_fwd_launch(int dtype, int head_dim, const void* q, const void* k,
                                const void* v, const int* seg_q, const int* seg_kv,
                                const int* q_ranges, const int* k_ranges, const float* sinks,
                                void* out, float* lse, int batch, int sq, int skv, int hq,
                                int hkv, int causal, int window, float cap, int q_offset,
                                void* stream) {
  if (sq % kTile || skv % kTile || hkv < 1 || hq % hkv || q_offset < 0)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || sq == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define FLASH_FWD_ARGS                                                                      \
  q, k, v, seg_q, seg_kv, q_ranges, k_ranges, sinks, out, lse, batch, sq, skv, hq, hkv, causal, \
      window, cap, q_offset, s
  if (dtype == 0 && head_dim == 64) return launch_fma<64>(FLASH_FWD_ARGS);
  if (dtype == 0 && head_dim == 128) return launch_fma<128>(FLASH_FWD_ARGS);
  if (dtype == 1 && head_dim == 64) return launch_mma<64>(FLASH_FWD_ARGS);
  if (dtype == 1 && head_dim == 128) return launch_mma<128>(FLASH_FWD_ARGS);
#undef FLASH_FWD_ARGS
  return (int)cudaErrorInvalidValue;
}
