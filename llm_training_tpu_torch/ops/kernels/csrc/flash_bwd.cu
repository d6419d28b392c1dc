// Flash-attention backward for Hopper (sm_90a): dQ, and dK/dV.
//
// Replace the Pallas TPU kernels `_dq_kernel` and `_dkv_kernel` in
// llm_training_tpu/ops/pallas/flash_attention.py (the two pallas_calls of
// `flash_bwd_flat`). Both recompute P = exp(S - LSE) from q, k and the
// forward's row logsumexp (which already holds the sink mass), and form
// dS = P * (dP - delta) with dP = dO V^T, delta = rowsum(dO * O) and the
// soft-cap chain rule. LSE and delta come in from outside, as ring
// attention needs. Fully masked rows have P = 0: they contribute nothing.
// Each block writes its own rows once: no atomics, the same bits on every
// run, as in JAX. dq and dkv stay separate kernels.
//
// Bound. Per visible (q, k) pair per q head, dQ does 6 D flops (S, dP,
// dS K) and dK/dV 8 D (S, dP, P^T dO, dS^T Q): bound by tensor-core
// operations, not bytes (PERF.md has the times beside the bound).
//
// The bf16 kernels (the training path) are built for this card
// (flash_wgmma.cuh): a block owns 128 rows and one head, and is two consumer
// warpgroups of 64 rows each plus a producer warpgroup.
//  - dK/dV: the block owns (batch, kv head, 128 kv rows). K and V stay in
//    shared memory for the block's life. The producer streams, over the
//    flattened list of (q head of the group, visible 64-row q tile), the Q
//    and dO tiles with their LSE, delta and segment ids. A consumer computes
//    S^T = K Q^T and dP^T = V dO^T (A = K or V from shared memory, B = the
//    Q or dO tile as it lies), then P^T or dS^T, masked and rounded to
//    bf16 in registers as the next A operand, times the same dO or Q tile
//    read MN-major: dV += P^T dO, dK += dS^T Q, summed in registers over
//    the group. dV and dK come from two launches of the one kernel
//    (S^T = K Q^T is computed in both; the dV launch loads neither V nor
//    delta): one 64 x D accumulator at a time is what fits the registers
//    the compiler gives this code (flash_wgmma.cuh). With both at once
//    (128 registers at D 128) and the score tiles beside them it spilled
//    and waited after every product: five products in step beat four that
//    wait.
//  - dQ: the block owns (batch, q head, 128 q rows). Q and dO stay in shared
//    memory, LSE, delta and segment ids of a lane's rows in registers. The
//    producer streams the visible 64-row K and V tiles with their segment
//    ids; S = Q K^T, dP = dO V^T, dS in registers as A, dQ += dS K with the
//    K tile read MN-major.
//  - The ring. kStages stages in shared memory, a full and an empty
//    mbarrier each. One lane of the producer warpgroup (its registers cut
//    with setmaxnreg, the consumers' raised) waits for a stage to be empty,
//    announces the stage's bytes and starts its copies: TMA boxes for the
//    tiles, bulk copies for the vectors, all completing on the full
//    barrier. Every consumer thread arrives on the empty barrier after the
//    wgmma.wait_group that retires the stage's last reader. Tile skipping
//    lives in the producer: a pair of spans that cannot hold a visible
//    element (by position, or by the spans' segment-id ranges) is never
//    requested, and a span's test reads only its own ranges. A consumer
//    whose own 64 rows cannot see a requested tile skips its products.
//  - Blocks are numbered so that the heaviest start first under a causal
//    mask: low kv tiles for dK/dV, high q tiles for dQ, heads fastest.
//
//  - At D 256 (Gemma) each head's dQ, dK and dV are two 128-wide halves,
//    each computed by a block of its own over the scores of the whole D,
//    with one stage of 64-row streamed tiles (flash_wgmma.cuh, `OutSplit`).
//
// The fp32 kernels (parity and the CPU tests' type, not the training path)
// are 256 threads of fp32 FMA from shared memory over 64 x 64 tiles, P and
// dS kept in fp32. At D 256 the streamed pair (K and V for dQ, Q and dO for
// dK/dV) comes in 128-column chunks beside the whole resident pair (230 KB
// of shared memory): the products over D add the chunks, and the products
// into the accumulators take one chunk of columns at a time, the last
// chunk first, while it is still loaded.

#include "flash_common.cuh"
#include "flash_wgmma.cuh"

namespace {

using namespace flash;

// columns of a streamed chunk of the fp32 kernels: all of D up to 128
template <int D>
__host__ __device__ constexpr int fma_chunk() {
  return D > 128 ? 128 : D;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const int* __restrict__ seg_q,
                    const int* __restrict__ seg_kv, const int2* __restrict__ q_ranges,
                    const int2* __restrict__ k_ranges, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, int sq, int skv, int hq, int hkv, int causal,
                    int window, float cap, int q_offset) {
  constexpr int kCols = D / 16;
  constexpr int kC = fma_chunk<D>(), kChunks = D / kC;
  constexpr int kLd = TileLd<D>::value, kLdC = TileLd<kC>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* dos = reinterpret_cast<float*>(smem + tile_bytes<D>());
  float* ks = reinterpret_cast<float*>(smem + 2 * tile_bytes<D>());
  float* vs = reinterpret_cast<float*>(smem + 2 * tile_bytes<D>() + tile_bytes<kC>());
  float* dss = reinterpret_cast<float*>(smem + 2 * tile_bytes<D>() + 2 * tile_bytes<kC>());
  int* qseg = reinterpret_cast<int*>(dss + kTile * kScoreLd);
  int* kseg = qseg + kTile;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nq = sq / kTile, nk = skv / kTile;
  const int hk = h / (hq / hkv);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = qt * kTile;
  const size_t q_stride = (size_t)hq * D, kv_stride = (size_t)hkv * D;
  const size_t q_head = ((size_t)b * sq + q0) * q_stride + (size_t)h * D;

  load_tile<D>(qs, q + q_head, q_stride);
  load_tile<D>(dos, dout + q_head, q_stride);
  if (tid < kTile) qseg[tid] = seg_q[(size_t)b * sq + q0 + tid];
  const int2 q_range = q_ranges[(size_t)b * nq + qt];
  float row_lse[4], row_delta[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const size_t r = ((size_t)b * hq + h) * sq + q0 + ty + 16 * i;
    row_lse[i] = lse[r];
    row_delta[i] = delta[r];
  }
  zero_tile(acc);

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    if (!tile_visible(q0 + q_offset, k0, causal, window, q_range, k_ranges[(size_t)b * nk + kt]))
      continue;  // uniform across the block
    const size_t kv_head = ((size_t)b * skv + k0) * kv_stride + (size_t)hk * D;
    float s[4][4], dp[4][4];
    zero_tile(s);
    zero_tile(dp);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      __syncthreads();  // the previous readers are done with ks, vs, dss
      load_tile<kC>(ks, k + kv_head + c * kC, kv_stride);
      load_tile<kC>(vs, v + kv_head + c * kC, kv_stride);
      if (c == 0 && tid < kTile) kseg[tid] = seg_kv[(size_t)b * skv + k0 + tid];
      __syncthreads();
      gemm_abt_add<kC, kLd, kLdC>(qs + c * kC, ks, ty, tx, s);
      gemm_abt_add<kC, kLd, kLdC>(dos + c * kC, vs, ty, tx, dp);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = tx + 16 * j;
        float ds = 0.f;
        if (visible(q0 + qi + q_offset, k0 + kj, qseg[qi], kseg[kj], causal, window)) {
          const float c = soft_cap(s[i][j], cap);
          ds = expf(c - row_lse[i]) * (dp[i][j] - row_delta[i]) * soft_cap_grad(c, cap);
        }
        dss[qi * kScoreLd + kj] = ds;
      }
    }
    __syncthreads();
    // dQ += dS K, the last chunk of K (still in ks) first
    gemm_pv_into<kC, kLdC, (kChunks - 1) * kC / 16>(dss, ks, ty, tx, acc);
    if constexpr (kChunks == 2) {
      __syncthreads();
      load_tile<kC>(ks, k + kv_head, kv_stride);
      __syncthreads();
      gemm_pv_into<kC, kLdC, 0>(dss, ks, ty, tx, acc);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float* row = dq + q_head + (size_t)(ty + 16 * i) * q_stride;
#pragma unroll
    for (int j = 0; j < kCols; ++j) row[tx + 16 * j] = acc[i][j];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dkv_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const int* __restrict__ seg_q,
                     const int* __restrict__ seg_kv, const int2* __restrict__ q_ranges,
                     const int2* __restrict__ k_ranges, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv, int sq, int skv, int hq,
                     int hkv, int causal, int window, float cap, int q_offset) {
  constexpr int kCols = D / 16;
  constexpr int kC = fma_chunk<D>(), kChunks = D / kC;
  constexpr int kLd = TileLd<D>::value, kLdC = TileLd<kC>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = reinterpret_cast<float*>(smem + tile_bytes<D>());
  float* qs = reinterpret_cast<float*>(smem + 2 * tile_bytes<D>());
  float* dos = reinterpret_cast<float*>(smem + 2 * tile_bytes<D>() + tile_bytes<kC>());
  float* pts = reinterpret_cast<float*>(smem + 2 * tile_bytes<D>() + 2 * tile_bytes<kC>());
  float* dsts = pts + kTile * kScoreLd;
  int* kseg = reinterpret_cast<int*>(dsts + kTile * kScoreLd);
  int* qseg = kseg + kTile;
  float* lse_s = reinterpret_cast<float*>(qseg + kTile);
  float* delta_s = lse_s + kTile;

  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int nq = sq / kTile, nk = skv / kTile;
  const int group = hq / hkv;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int k0 = kt * kTile;
  const size_t q_stride = (size_t)hq * D, kv_stride = (size_t)hkv * D;
  const size_t kv_head = ((size_t)b * skv + k0) * kv_stride + (size_t)hk * D;

  load_tile<D>(ks, k + kv_head, kv_stride);
  load_tile<D>(vs, v + kv_head, kv_stride);
  if (tid < kTile) kseg[tid] = seg_kv[(size_t)b * skv + k0 + tid];
  const int2 k_range = k_ranges[(size_t)b * nk + kt];
  float dk_acc[4][kCols], dv_acc[4][kCols];
  zero_tile(dk_acc);
  zero_tile(dv_acc);

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    for (int qt = 0; qt < nq; ++qt) {
      const int q0 = qt * kTile;
      if (!tile_visible(q0 + q_offset, k0, causal, window, q_ranges[(size_t)b * nq + qt], k_range))
        continue;  // uniform across the block
      const size_t q_head = ((size_t)b * sq + q0) * q_stride + (size_t)h * D;
      // transposed tiles: the block's rows are kv rows, its columns q rows
      float st[4][4], dpt[4][4];
      zero_tile(st);
      zero_tile(dpt);
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        __syncthreads();  // the previous readers are done with qs, dos, pts, dsts
        load_tile<kC>(qs, q + q_head + c * kC, q_stride);
        load_tile<kC>(dos, dout + q_head + c * kC, q_stride);
        if (c == 0) {
          if (tid < kTile) {
            qseg[tid] = seg_q[(size_t)b * sq + q0 + tid];
          } else if (tid < 2 * kTile) {
            const size_t r = ((size_t)b * hq + h) * sq + q0 + tid - kTile;
            lse_s[tid - kTile] = lse[r];
            delta_s[tid - kTile] = delta[r];
          }
        }
        __syncthreads();
        gemm_abt_add<kC, kLd, kLdC>(ks + c * kC, qs, ty, tx, st);
        gemm_abt_add<kC, kLd, kLdC>(vs + c * kC, dos, ty, tx, dpt);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ki = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qj = tx + 16 * j;
          float p = 0.f, ds = 0.f;
          if (visible(q0 + qj + q_offset, k0 + ki, qseg[qj], kseg[ki], causal, window)) {
            const float c = soft_cap(st[i][j], cap);
            p = expf(c - lse_s[qj]);
            ds = p * (dpt[i][j] - delta_s[qj]) * soft_cap_grad(c, cap);
          }
          pts[ki * kScoreLd + qj] = p;
          dsts[ki * kScoreLd + qj] = ds;
        }
      }
      __syncthreads();
      // dV += P^T dO and dK += dS^T Q, the last chunk of dO and Q first
      gemm_pv_into<kC, kLdC, (kChunks - 1) * kC / 16>(pts, dos, ty, tx, dv_acc);
      gemm_pv_into<kC, kLdC, (kChunks - 1) * kC / 16>(dsts, qs, ty, tx, dk_acc);
      if constexpr (kChunks == 2) {
        __syncthreads();
        load_tile<kC>(qs, q + q_head, q_stride);
        load_tile<kC>(dos, dout + q_head, q_stride);
        __syncthreads();
        gemm_pv_into<kC, kLdC, 0>(pts, dos, ty, tx, dv_acc);
        gemm_pv_into<kC, kLdC, 0>(dsts, qs, ty, tx, dk_acc);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const size_t row = kv_head + (size_t)(ty + 16 * i) * kv_stride;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      dk[row + tx + 16 * j] = dk_acc[i][j];
      dv[row + tx + 16 * j] = dv_acc[i][j];
    }
  }
}

struct BwdArgs {
  const void *q, *k, *v;
  const int *seg_q, *seg_kv, *q_ranges, *k_ranges;
  const void* dout;
  const float *lse, *delta;
  int batch, sq, skv, hq, hkv, causal, window;
  float cap;
  int q_offset;
  cudaStream_t stream;
  const int* block_ranges;  // the bf16 kernels' ranges of their own 128-row blocks
};

template <int D>
int launch_dq_fma(const BwdArgs& a, void* dq) {
  const size_t smem = 2 * tile_bytes<D>() + 2 * tile_bytes<fma_chunk<D>()>() +
                      kTile * kScoreLd * sizeof(float) + 2 * kTile * sizeof(int);
  auto kernel = flash_dq_fma_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.sq / kTile, a.hq, a.batch);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      (const float*)a.q, (const float*)a.k, (const float*)a.v, a.seg_q, a.seg_kv,
      (const int2*)a.q_ranges, (const int2*)a.k_ranges, (const float*)a.dout, a.lse, a.delta,
      (float*)dq, a.sq, a.skv, a.hq, a.hkv, a.causal, a.window, a.cap, a.q_offset);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_fma(const BwdArgs& a, void* dk, void* dv) {
  const size_t smem = 2 * tile_bytes<D>() + 2 * tile_bytes<fma_chunk<D>()>() +
                      2 * kTile * kScoreLd * sizeof(float) + 4 * kTile * sizeof(int);
  auto kernel = flash_dkv_fma_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.skv / kTile, a.hkv, a.batch);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      (const float*)a.q, (const float*)a.k, (const float*)a.v, a.seg_q, a.seg_kv,
      (const int2*)a.q_ranges, (const int2*)a.k_ranges, (const float*)a.dout, a.lse, a.delta,
      (float*)dk, (float*)dv, a.sq, a.skv, a.hq, a.hkv, a.causal, a.window, a.cap, a.q_offset);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------ the bf16 kernels

using bf16 = __nv_bfloat16;

// P = exp(c - LSE) and dS = P (dP - delta) d c / d s of one score s, with c
// the soft-capped score and lse2 = LSE log2(e)
template <bool kCapped>
__device__ __forceinline__ void score_grad(float s, float dp, float lse2, float delta,
                                           SoftCap cap, float& p, float& ds) {
  float c = s, slope = 1.f;
  if (kCapped) {
    const float t = fast_tanh(s * cap.inverse);
    c = cap.cap * t;
    slope = 1.f - t * t;
  }
  p = fast_exp2(fmaf(c, kLog2e, -lse2));
  ds = p * (dp - delta);
  if (kCapped) ds *= slope;
}

// dQ's arithmetic on one 64 x 64 tile in a lane's registers: scores s and dP
// in, dS out in s. A lane holds rows r = 0, 1 (q rows) and columns
// 8 j + 2 t, + 1 (kv rows k0 + column). kMasked false: every element visible.
template <bool kMasked, bool kCapped>
__device__ __forceinline__ void dq_tile_math(float (&s)[32], const float (&dp)[32],
                                             const int* kseg, int k0, int t,
                                             const int (&q_pos)[2], const int (&q_id)[2],
                                             const float (&row_lse2)[2],
                                             const float (&row_delta)[2], int causal, int window,
                                             SoftCap cap) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + 2 * t;
    int2 col_id = make_int2(0, 0);
    if (kMasked) col_id = *reinterpret_cast<const int2*>(kseg + col);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1, odd = e & 1;
      float p, ds;
      score_grad<kCapped>(s[4 * j + e], dp[4 * j + e], row_lse2[r], row_delta[r], cap, p, ds);
      if (kMasked && !visible(q_pos[r], k0 + col + odd, q_id[r], odd ? col_id.y : col_id.x,
                              causal, window))
        ds = 0.f;
      s[4 * j + e] = ds;
    }
  }
}

// dK/dV's arithmetic on one 64 x 64 transposed tile in a lane's registers:
// S^T in st (and dP^T in dpt) in; P^T (kValues) or dS^T out in st. A lane
// holds rows r = 0, 1 (kv rows) and columns 8 j + 2 t, + 1 (q rows q_lo +
// column, whose LSE, delta and ids are at lse_s, delta_s and qseg).
template <bool kValues, bool kMasked, bool kCapped>
__device__ __forceinline__ void dkv_tile_math(float (&st)[32], const float (&dpt)[32],
                                              const float* lse_s, const float* delta_s,
                                              const int* qseg, int q_lo, int t,
                                              const int (&k_pos)[2], const int (&k_id)[2],
                                              int causal, int window, SoftCap cap) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + 2 * t;
    const float2 col_lse = *reinterpret_cast<const float2*>(lse_s + col);
    float2 col_delta = make_float2(0.f, 0.f);
    if (!kValues) col_delta = *reinterpret_cast<const float2*>(delta_s + col);
    int2 col_id = make_int2(0, 0);
    if (kMasked) col_id = *reinterpret_cast<const int2*>(qseg + col);
    const float lse2[2] = {col_lse.x * kLog2e, col_lse.y * kLog2e};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1, odd = e & 1;
      float p, ds;
      score_grad<kCapped>(st[4 * j + e], kValues ? 0.f : dpt[4 * j + e], lse2[odd],
                          odd ? col_delta.y : col_delta.x, cap, p, ds);
      float result = kValues ? p : ds;
      if (kMasked && !visible(q_lo + col + odd, k_pos[r], odd ? col_id.y : col_id.x, k_id[r],
                              causal, window))
        result = 0.f;
      st[4 * j + e] = result;
    }
  }
}

// the mask and the soft cap chosen once per tile (both the same in a warp)
template <bool kValues>
__device__ __forceinline__ void dkv_tile_math(bool open, float (&st)[32], const float (&dpt)[32],
                                              const float* lse_s, const float* delta_s,
                                              const int* qseg, int q_lo, int t,
                                              const int (&k_pos)[2], const int (&k_id)[2],
                                              int causal, int window, SoftCap cap) {
  if (open) {
    if (cap.cap > 0.f)
      dkv_tile_math<kValues, false, true>(st, dpt, lse_s, delta_s, qseg, q_lo, t, k_pos, k_id,
                                          causal, window, cap);
    else
      dkv_tile_math<kValues, false, false>(st, dpt, lse_s, delta_s, qseg, q_lo, t, k_pos, k_id,
                                           causal, window, cap);
  } else {
    if (cap.cap > 0.f)
      dkv_tile_math<kValues, true, true>(st, dpt, lse_s, delta_s, qseg, q_lo, t, k_pos, k_id,
                                         causal, window, cap);
    else
      dkv_tile_math<kValues, true, false>(st, dpt, lse_s, delta_s, qseg, q_lo, t, k_pos, k_id,
                                          causal, window, cap);
  }
}

// kValues: dV of the block's rows (P^T dO); else their dK (dS^T Q).
template <int D, bool kValues>
__global__ void __launch_bounds__(kBlockThreads, 1)
flash_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const __grid_constant__ CUtensorMap map_do,
                       const int* __restrict__ seg_q, const int* __restrict__ seg_kv,
                       const int2* __restrict__ q_ranges, const int2* __restrict__ k_ranges,
                       const int2* __restrict__ k_block_ranges, const float* __restrict__ lse,
                       const float* __restrict__ delta, bf16* __restrict__ out, int sq, int skv,
                       int hq, int hkv, int causal, int window, SoftCap cap, int q_offset) {
  using P = BwdPlan<D>;
  using Split = OutSplit<D>;
  using Ring = RingOf<P::kRingStages>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t base = smem_u32(smem);
  const uint32_t bars = base + P::kBarriersAt;
  const int* kseg = reinterpret_cast<const int*>(smem + P::kBlockSegAt);
  int2* q_range_of = reinterpret_cast<int2*>(smem + P::kRangesAt);

  // low kv tiles first; the halves of a head's output (D 256) neighbour
  const int hk = blockIdx.x / Split::kParts, part = blockIdx.x % Split::kParts;
  const int kt = blockIdx.y, b = blockIdx.z;
  const int nq = sq / kTile;
  const int group = hq / hkv;
  const int k0 = kt * kBlockRows;
  for (int i = threadIdx.x; i < nq; i += kBlockThreads) q_range_of[i] = q_ranges[(size_t)b * nq + i];
  if (threadIdx.x == 0) init_barriers(bars);
  __syncthreads();
  const int2 block_range = k_block_ranges[(size_t)b * (skv / kBlockRows) + kt];
  // under a causal mask no q tile before the one that holds row k0 sees the block
  const int first_qt = causal ? max(0, (k0 - q_offset) / kTile) : 0;
  // the warp index by a shuffle: the compiler then knows it is the same in
  // every lane and keeps what follows from it in uniform registers
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0), lane = threadIdx.x & 31;

  if (warp >= kConsumers * 4) {
    // ---- the producer warpgroup: one lane starts every copy
    set_max_registers_down<kProducerRegs>();
    if (threadIdx.x != kConsumers * 128) return;
    // dV needs neither V nor delta: they stay where they are
    const uint32_t resident = resident_barrier(bars);
    mbar_expect_tx(resident, (kValues ? 1 : 2) * P::kResident + kBlockRows * 4);
#pragma unroll
    for (int box = 0; box < P::kBoxes; ++box) {
      tma_load_4d(base + box * kResidentBox, &map_k, resident, 64 * box, hk, k0, b);
      if (!kValues)
        tma_load_4d(base + P::kResident + box * kResidentBox, &map_v, resident, 64 * box, hk, k0,
                    b);
    }
    bulk_load(base + P::kBlockSegAt, seg_kv + (size_t)b * skv + k0, kBlockRows * 4, resident);
    Ring at;
    for (int gi = 0; gi < group; ++gi) {
      const int h = hk * group + gi;
      for (int qt = first_qt; qt < nq; ++qt) {
        const int q0 = qt * kTile;
        if (!span_visible(q0 + q_offset, kTile, k0, kBlockRows, causal, window, q_range_of[qt],
                          block_range))
          continue;
        const uint32_t stage = base + P::kStagesAt + at.stage * P::kStage;
        const uint32_t full = full_barrier(bars, at.stage);
        mbar_wait(empty_barrier(bars, at.stage), at.phase ^ 1);
        mbar_expect_tx(full, 2 * P::kStreamed + (kValues ? 2 : 3) * kVectorBytes);
#pragma unroll
        for (int box = 0; box < P::kBoxes; ++box) {
          tma_load_4d(stage + box * kStreamBox, &map_q, full, 64 * box, h, q0, b);
          tma_load_4d(stage + P::kStreamed + box * kStreamBox, &map_do, full, 64 * box, h, q0, b);
        }
        const size_t row = ((size_t)b * hq + h) * sq + q0;
        bulk_load(stage + P::kVectors, lse + row, kVectorBytes, full);
        if (!kValues)
          bulk_load(stage + P::kVectors + kVectorBytes, delta + row, kVectorBytes, full);
        bulk_load(stage + P::kVectors + 2 * kVectorBytes, seg_q + (size_t)b * sq + q0,
                  kVectorBytes, full);
        at.advance();
      }
    }
  } else {
    // ---- a consumer warpgroup: 64 kv rows of the block
    set_max_registers_up<kConsumerRegs>();
    const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
    const int row0 = kTile * wg + 16 * (warp & 3) + g;  // this lane's rows: row0, row0 + 8
    const int2 half_range = k_ranges[(size_t)b * (skv / kTile) + kConsumers * kt + wg];
    mbar_wait(resident_barrier(bars), 0);
    int k_pos[2], k_id[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      k_pos[r] = k0 + row0 + 8 * r;
      k_id[r] = kseg[row0 + 8 * r];
    }
    const uint64_t k_desc = k_major_descriptor(base + wg * kTile * kRowBytes);
    const uint64_t v_desc = k_major_descriptor(base + P::kResident + wg * kTile * kRowBytes);
    Ring at;
    float acc[Split::kDim / 2];
    zero(acc);
    for (int gi = 0; gi < group; ++gi) {
      for (int qt = first_qt; qt < nq; ++qt) {
        const int q0 = qt * kTile;
        const int2 q_range = q_range_of[qt];
        if (!span_visible(q0 + q_offset, kTile, k0, kBlockRows, causal, window, q_range,
                          block_range))
          continue;
        const int stage_at = P::kStagesAt + at.stage * P::kStage;
        const uint32_t stage = base + stage_at;
        mbar_wait(full_barrier(bars, at.stage), at.phase);
        if (span_visible(q0 + q_offset, kTile, k0 + kTile * wg, kTile, causal, window, q_range,
                         half_range)) {
          // transposed tiles: the warpgroup's rows are kv rows, its columns q rows
          float st[32], dpt[32];
          overwritten(st);
          if (!kValues) overwritten(dpt);
          wgmma_fence();
          product_over_d<D, kTile>(st, k_desc, stage);
          if (!kValues) product_over_d<D, kTile>(dpt, v_desc, stage + P::kStreamed);
          wgmma_commit();
          wgmma_wait<0>();
          fence_registers(st);
          if (!kValues) fence_registers(dpt);
          const float* lse_s = reinterpret_cast<const float*>(smem + stage_at + P::kVectors);
          const float* delta_s = lse_s + kTile;
          const int* qseg = reinterpret_cast<const int*>(delta_s + kTile);
          // no mask where the q tile is one document, this lane's kv rows are
          // of it, and position lets every pair through (the same in a warp)
          const int q_lo = q0 + q_offset;
          bool open = one_document<kTile>(qseg, lane);
#pragma unroll
          for (int r = 0; r < 2; ++r)
            open = open && k_id[r] == qseg[0] && (!causal || k_pos[r] <= q_lo) &&
                   (window <= 0 || q_lo + kTile - 1 - k_pos[r] < window);
          open = __all_sync(0xffffffffu, open);
          dkv_tile_math<kValues>(open, st, dpt, lse_s, delta_s, qseg, q_lo, t, k_pos, k_id, causal,
                                 window, cap);
          uint32_t a[4][4];
          accumulator_as_a<kTile>(a, st);
          fence_registers(acc);
          wgmma_fence();
          // dV += P^T dO, or dK += dS^T Q, over this block's columns
          product_over_rows<Split::kDim, kTile>(
              acc, a, (kValues ? stage + P::kStreamed : stage) + part * Split::kBoxes * kStreamBox);
          wgmma_commit();
          wgmma_wait<0>();
          fence_registers(acc);
        }
        mbar_arrive(empty_barrier(bars, at.stage));
        at.advance();
      }
    }
    const size_t kv_stride = (size_t)hkv * D;
    store_rows<Split::kDim>(
        out + ((size_t)b * skv + k0) * kv_stride + (size_t)hk * D + part * Split::kDim, kv_stride,
        acc, row0, t);
  }
}

template <int D>
__global__ void __launch_bounds__(kBlockThreads, 1)
flash_dq_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      const __grid_constant__ CUtensorMap map_do,
                      const int* __restrict__ seg_q, const int* __restrict__ seg_kv,
                      const int2* __restrict__ q_ranges, const int2* __restrict__ k_ranges,
                      const int2* __restrict__ q_block_ranges, const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ dq, int sq, int skv,
                      int hq, int hkv, int causal, int window, SoftCap cap, int q_offset) {
  using P = BwdPlan<D>;
  using Split = OutSplit<D>;
  using Ring = RingOf<P::kRingStages>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t base = smem_u32(smem);
  const uint32_t bars = base + P::kBarriersAt;
  int2* k_range_of = reinterpret_cast<int2*>(smem + P::kRangesAt);

  // high q tiles first: under a causal mask they see the most kv tiles;
  // the halves of a head's dQ (D 256) neighbour
  const int h = blockIdx.x / Split::kParts, part = blockIdx.x % Split::kParts;
  const int qt = gridDim.y - 1 - blockIdx.y, b = blockIdx.z;
  const int nk = skv / kTile;
  const int hk = h / (hq / hkv);
  const int q0 = qt * kBlockRows;
  for (int i = threadIdx.x; i < nk; i += kBlockThreads) k_range_of[i] = k_ranges[(size_t)b * nk + i];
  if (threadIdx.x == 0) init_barriers(bars);
  __syncthreads();
  const int2 block_range = q_block_ranges[(size_t)b * (sq / kBlockRows) + qt];
  // under a causal mask no kv tile after the block's last row is seen
  const int end_kt = causal ? min(nk, (q0 + kBlockRows - 1 + q_offset) / kTile + 1) : nk;
  // the warp index by a shuffle: the compiler then knows it is the same in
  // every lane and keeps what follows from it in uniform registers
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0), lane = threadIdx.x & 31;

  if (warp >= kConsumers * 4) {
    // ---- the producer warpgroup: one lane starts every copy
    set_max_registers_down<kProducerRegs>();
    if (threadIdx.x != kConsumers * 128) return;
    const uint32_t resident = resident_barrier(bars);
    mbar_expect_tx(resident, 2 * P::kResident);
#pragma unroll
    for (int box = 0; box < P::kBoxes; ++box) {
      tma_load_4d(base + box * kResidentBox, &map_q, resident, 64 * box, h, q0, b);
      tma_load_4d(base + P::kResident + box * kResidentBox, &map_do, resident, 64 * box, h, q0, b);
    }
    Ring at;
    for (int kt = 0; kt < end_kt; ++kt) {
      const int k0 = kt * kTile;
      if (!span_visible(q0 + q_offset, kBlockRows, k0, kTile, causal, window, block_range,
                        k_range_of[kt]))
        continue;
      const uint32_t stage = base + P::kStagesAt + at.stage * P::kStage;
      const uint32_t full = full_barrier(bars, at.stage);
      mbar_wait(empty_barrier(bars, at.stage), at.phase ^ 1);
      mbar_expect_tx(full, 2 * P::kStreamed + kVectorBytes);
#pragma unroll
      for (int box = 0; box < P::kBoxes; ++box) {
        tma_load_4d(stage + box * kStreamBox, &map_k, full, 64 * box, hk, k0, b);
        tma_load_4d(stage + P::kStreamed + box * kStreamBox, &map_v, full, 64 * box, hk, k0, b);
      }
      bulk_load(stage + P::kVectors, seg_kv + (size_t)b * skv + k0, kVectorBytes, full);
      at.advance();
    }
  } else {
    // ---- a consumer warpgroup: 64 q rows of the block
    set_max_registers_up<kConsumerRegs>();
    const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
    const int row0 = kTile * wg + 16 * (warp & 3) + g;  // this lane's rows: row0, row0 + 8
    const int2 half_range = q_ranges[(size_t)b * (sq / kTile) + kConsumers * qt + wg];
    int q_pos[2], q_id[2];
    float row_lse2[2], row_delta[2];  // LSE log2(e): P = exp2(c log2(e) - that)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + row0 + 8 * r;
      q_pos[r] = row + q_offset;
      q_id[r] = seg_q[(size_t)b * sq + row];
      row_lse2[r] = lse[((size_t)b * hq + h) * sq + row] * kLog2e;
      row_delta[r] = delta[((size_t)b * hq + h) * sq + row];
    }
    float acc[Split::kDim / 2];
    zero(acc);
    mbar_wait(resident_barrier(bars), 0);
    const uint64_t q_desc = k_major_descriptor(base + wg * kTile * kRowBytes);
    const uint64_t do_desc = k_major_descriptor(base + P::kResident + wg * kTile * kRowBytes);
    Ring at;
    for (int kt = 0; kt < end_kt; ++kt) {
      const int k0 = kt * kTile;
      const int2 k_range = k_range_of[kt];
      if (!span_visible(q0 + q_offset, kBlockRows, k0, kTile, causal, window, block_range, k_range))
        continue;
      const int stage_at = P::kStagesAt + at.stage * P::kStage;
      const uint32_t stage = base + stage_at;
      mbar_wait(full_barrier(bars, at.stage), at.phase);
      if (span_visible(q0 + kTile * wg + q_offset, kTile, k0, kTile, causal, window, half_range,
                       k_range)) {
        float s[32], dp[32];
        overwritten(s);
        overwritten(dp);
        wgmma_fence();
        product_over_d<D, kTile>(s, q_desc, stage);
        product_over_d<D, kTile>(dp, do_desc, stage + P::kStreamed);
        wgmma_commit();
        wgmma_wait<0>();
        fence_registers(s);
        fence_registers(dp);
        const int* kseg = reinterpret_cast<const int*>(smem + stage_at + P::kVectors);
        // no mask where the kv tile is one document, this lane's q rows are of
        // it, and position lets every pair through (the same in a warp)
        bool open = one_document<kTile>(kseg, lane);
#pragma unroll
        for (int r = 0; r < 2; ++r)
          open = open && q_id[r] == kseg[0] && (!causal || k0 + kTile - 1 <= q_pos[r]) &&
                 (window <= 0 || q_pos[r] - k0 < window);
        open = __all_sync(0xffffffffu, open);
        if (open) {
          if (cap.cap > 0.f)
            dq_tile_math<false, true>(s, dp, kseg, k0, t, q_pos, q_id, row_lse2, row_delta, causal,
                                      window, cap);
          else
            dq_tile_math<false, false>(s, dp, kseg, k0, t, q_pos, q_id, row_lse2, row_delta,
                                       causal, window, cap);
        } else {
          if (cap.cap > 0.f)
            dq_tile_math<true, true>(s, dp, kseg, k0, t, q_pos, q_id, row_lse2, row_delta, causal,
                                     window, cap);
          else
            dq_tile_math<true, false>(s, dp, kseg, k0, t, q_pos, q_id, row_lse2, row_delta, causal,
                                      window, cap);
        }
        uint32_t dsa[4][4];
        accumulator_as_a<kTile>(dsa, s);
        fence_registers(acc);
        wgmma_fence();
        // dQ += dS K over this block's columns of K
        product_over_rows<Split::kDim, kTile>(acc, dsa, stage + part * Split::kBoxes * kStreamBox);
        wgmma_commit();
        wgmma_wait<0>();
        fence_registers(acc);
      }
      mbar_arrive(empty_barrier(bars, at.stage));
      at.advance();
    }
    const size_t q_stride = (size_t)hq * D;
    store_rows<Split::kDim>(
        dq + ((size_t)b * sq + q0) * q_stride + (size_t)h * D + part * Split::kDim, q_stride, acc,
        row0, t);
  }
}

// what the bulk copies of the vectors and the 128-row blocks need
bool valid_wgmma(const BwdArgs& a, int sq_multiple, int skv_multiple) {
  return a.sq % sq_multiple == 0 && a.skv % skv_multiple == 0 && a.block_ranges != nullptr &&
         aligned16(a.lse) && aligned16(a.delta) && aligned16(a.seg_q) && aligned16(a.seg_kv);
}

template <int D>
int encode_bwd_maps(const BwdArgs& a, TileMaps* maps, int q_rows, int kv_rows) {
  return encode_maps<D>(maps, a.q, a.k, a.v, a.dout, a.batch, a.sq, a.skv, a.hq, a.hkv, q_rows,
                        kv_rows);
}

template <int D>
int launch_dq_wgmma(const BwdArgs& a, void* dq) {
  if (!valid_wgmma(a, kBlockRows, kTile)) return (int)cudaErrorInvalidValue;
  const size_t smem = BwdPlan<D>::kFixedBytes + (size_t)(a.skv / kTile) * sizeof(int2);
  if (smem > kMaxBlockSmem) return (int)cudaErrorInvalidValue;
  TileMaps maps;
  if (const int err = encode_bwd_maps<D>(a, &maps, kBlockRows, kTile)) return err;
  auto kernel = flash_dq_wgmma_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.hq * OutSplit<D>::kParts, a.sq / kBlockRows, a.batch);
  kernel<<<grid, kBlockThreads, smem, a.stream>>>(
      maps.q, maps.k, maps.v, maps.dout, a.seg_q, a.seg_kv, (const int2*)a.q_ranges,
      (const int2*)a.k_ranges, (const int2*)a.block_ranges, a.lse, a.delta, (bf16*)dq, a.sq, a.skv,
      a.hq, a.hkv, a.causal, a.window, soft_cap_of(a.cap), a.q_offset);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_wgmma(const BwdArgs& a, void* dk, void* dv) {
  if (!valid_wgmma(a, kTile, kBlockRows)) return (int)cudaErrorInvalidValue;
  const size_t smem = BwdPlan<D>::kFixedBytes + (size_t)(a.sq / kTile) * sizeof(int2);
  if (smem > kMaxBlockSmem) return (int)cudaErrorInvalidValue;
  TileMaps maps;
  if (const int err = encode_bwd_maps<D>(a, &maps, kTile, kBlockRows)) return err;
  const dim3 grid(a.hkv * OutSplit<D>::kParts, a.skv / kBlockRows, a.batch);
  // one launch for dV, one for dK (flash_dkv_wgmma_kernel)
  auto values = flash_dkv_wgmma_kernel<D, true>;
  auto keys = flash_dkv_wgmma_kernel<D, false>;
  cudaError_t err =
      cudaFuncSetAttribute(values, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(keys, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  values<<<grid, kBlockThreads, smem, a.stream>>>(
      maps.q, maps.k, maps.v, maps.dout, a.seg_q, a.seg_kv, (const int2*)a.q_ranges,
      (const int2*)a.k_ranges, (const int2*)a.block_ranges, a.lse, a.delta, (bf16*)dv, a.sq, a.skv,
      a.hq, a.hkv, a.causal, a.window, soft_cap_of(a.cap), a.q_offset);
  keys<<<grid, kBlockThreads, smem, a.stream>>>(
      maps.q, maps.k, maps.v, maps.dout, a.seg_q, a.seg_kv, (const int2*)a.q_ranges,
      (const int2*)a.k_ranges, (const int2*)a.block_ranges, a.lse, a.delta, (bf16*)dk, a.sq, a.skv,
      a.hq, a.hkv, a.causal, a.window, soft_cap_of(a.cap), a.q_offset);
  return (int)cudaGetLastError();
}

bool valid(const BwdArgs& a) {
  return a.sq % kTile == 0 && a.skv % kTile == 0 && a.hkv >= 1 && a.hq % a.hkv == 0 &&
         a.q_offset >= 0;
}

}  // namespace

// Arguments as flash_fwd_launch's, plus dout (the input type, q's layout)
// and lse, delta ([B, Hq, Sq] fp32). dq has q's layout; dk and dv k's. The
// bf16 kernels also take the segment-id ranges of their own 128-row blocks
// ([B, Sq / 128, 2] for dq, [B, Skv / 128, 2] for dk/dv; unused in fp32) and
// want that sequence a multiple of 128. Each returns a cudaError_t (0 on
// success) read right after the launch.
extern "C" int flash_dq_launch(int dtype, int head_dim, const void* q, const void* k,
                               const void* v, const int* seg_q, const int* seg_kv,
                               const int* q_ranges, const int* k_ranges,
                               const int* q_block_ranges, const void* dout, const float* lse,
                               const float* delta, void* dq, int batch, int sq, int skv, int hq,
                               int hkv, int causal, int window, float cap, int q_offset,
                               void* stream) {
  const BwdArgs a{q, k, v, seg_q, seg_kv, q_ranges, k_ranges, dout, lse, delta, batch, sq, skv,
                  hq, hkv, causal, window, cap, q_offset, (cudaStream_t)stream, q_block_ranges};
  if (!valid(a)) return (int)cudaErrorInvalidValue;
  if (batch == 0 || sq == 0) return 0;
  if (dtype == 0 && head_dim == 64) return launch_dq_fma<64>(a, dq);
  if (dtype == 0 && head_dim == 128) return launch_dq_fma<128>(a, dq);
  if (dtype == 1 && head_dim == 64) return launch_dq_wgmma<64>(a, dq);
  if (dtype == 1 && head_dim == 128) return launch_dq_wgmma<128>(a, dq);
  if (dtype == 0 && head_dim == 256) return launch_dq_fma<256>(a, dq);
  if (dtype == 1 && head_dim == 256) return launch_dq_wgmma<256>(a, dq);
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_dkv_launch(int dtype, int head_dim, const void* q, const void* k,
                                const void* v, const int* seg_q, const int* seg_kv,
                                const int* q_ranges, const int* k_ranges,
                                const int* k_block_ranges, const void* dout, const float* lse,
                                const float* delta, void* dk, void* dv, int batch, int sq, int skv,
                                int hq, int hkv, int causal, int window, float cap, int q_offset,
                                void* stream) {
  const BwdArgs a{q, k, v, seg_q, seg_kv, q_ranges, k_ranges, dout, lse, delta, batch, sq, skv,
                  hq, hkv, causal, window, cap, q_offset, (cudaStream_t)stream, k_block_ranges};
  if (!valid(a)) return (int)cudaErrorInvalidValue;
  if (batch == 0 || skv == 0) return 0;
  if (dtype == 0 && head_dim == 64) return launch_dkv_fma<64>(a, dk, dv);
  if (dtype == 0 && head_dim == 128) return launch_dkv_fma<128>(a, dk, dv);
  if (dtype == 1 && head_dim == 64) return launch_dkv_wgmma<64>(a, dk, dv);
  if (dtype == 1 && head_dim == 128) return launch_dkv_wgmma<128>(a, dk, dv);
  if (dtype == 0 && head_dim == 256) return launch_dkv_fma<256>(a, dk, dv);
  if (dtype == 1 && head_dim == 256) return launch_dkv_wgmma<256>(a, dk, dv);
  return (int)cudaErrorInvalidValue;
}
