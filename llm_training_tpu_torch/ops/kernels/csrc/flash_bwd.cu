// Flash-attention backward for Hopper (sm_90a): dQ, and dK/dV.
//
// Replace the Pallas TPU kernels `_dq_kernel` and `_dkv_kernel` in
// llm_training_tpu/ops/pallas/flash_attention.py (the two pallas_calls of
// `flash_bwd_flat`). Both recompute P = exp(S - LSE) from q, k and the
// forward's row logsumexp (which already holds the sink mass), and form
// dS = P * (dP - delta) with dP = dO V^T, delta = rowsum(dO * O) and the
// soft-cap chain rule. LSE and delta come in from outside, as ring
// attention needs. Fully masked rows have P = 0: they contribute nothing.
//
// Design. The TPU's dq grid carried dQ in VMEM across the kv axis; here one
// block owns (batch, q head, 64-row q tile), keeps Q, dO, LSE and delta of
// its rows on chip and loops over the visible kv tiles: dQ += dS K. The
// TPU's dkv grid (kv batch-head, kv block, GQA member, q block) carried dK
// and dV across its last two axes; here one block owns (batch, kv head,
// 64-row kv tile), keeps K and V on chip, and loops over the G q heads of
// its group and their visible q tiles: dV += P^T dO, dK += dS^T Q. It
// computes S^T and dP^T directly (kv rows as the block's rows), so no
// tile is transposed. Each block writes its own rows once: no atomics, the
// same result on every run, as in JAX. dq and dkv stay separate kernels.
//
// Two kernels each. bf16 (the training path): 4 warps on tensor cores
// (flash_mma.cuh), P and dS rounded to bf16 in registers before the next
// product, as the Pallas kernels round them for the MXU. fp32: 256 threads
// of fp32 FMA from shared memory, P and dS kept in fp32.
//
// Bound. Per visible (q, k) pair per q head, dQ does 6 D flops (S, dP,
// dS K) and dK/dV 8 D (S, dP, P^T dO, dS^T Q): bound by operations. The
// bf16 kernels reach about a tenth of the tensor-core rate (PERF.md): one
// shared-memory stage, fragments loaded with 32-bit and 16-bit loads,
// 240-255 registers a thread. ldmatrix, a second stage and wgmma are next.

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace {

using namespace flash;

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
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* dos = reinterpret_cast<float*>(smem + tile_bytes<D>());
  float* ks = reinterpret_cast<float*>(smem + 2 * tile_bytes<D>());
  float* vs = reinterpret_cast<float*>(smem + 3 * tile_bytes<D>());
  float* dss = reinterpret_cast<float*>(smem + 4 * tile_bytes<D>());
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
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  }

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    if (!tile_visible(q0 + q_offset, k0, causal, window, q_range, k_ranges[(size_t)b * nk + kt]))
      continue;  // uniform across the block
    __syncthreads();  // the previous tile's readers are done with ks, vs, dss
    load_tile<D>(ks, k + ((size_t)b * skv + k0) * kv_stride + (size_t)hk * D, kv_stride);
    load_tile<D>(vs, v + ((size_t)b * skv + k0) * kv_stride + (size_t)hk * D, kv_stride);
    if (tid < kTile) kseg[tid] = seg_kv[(size_t)b * skv + k0 + tid];
    __syncthreads();

    float s[4][4], dp[4][4];
    gemm_abt<D>(qs, ks, ty, tx, s);
    gemm_abt<D>(dos, vs, ty, tx, dp);
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
    gemm_pv<D>(dss, ks, ty, tx, acc);
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
  extern __shared__ __align__(16) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = reinterpret_cast<float*>(smem + tile_bytes<D>());
  float* qs = reinterpret_cast<float*>(smem + 2 * tile_bytes<D>());
  float* dos = reinterpret_cast<float*>(smem + 3 * tile_bytes<D>());
  float* pts = reinterpret_cast<float*>(smem + 4 * tile_bytes<D>());
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
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    for (int qt = 0; qt < nq; ++qt) {
      const int q0 = qt * kTile;
      if (!tile_visible(q0 + q_offset, k0, causal, window, q_ranges[(size_t)b * nq + qt], k_range))
        continue;  // uniform across the block
      __syncthreads();  // the previous tile's readers are done with qs, dos, pts, dsts
      const size_t q_head = ((size_t)b * sq + q0) * q_stride + (size_t)h * D;
      load_tile<D>(qs, q + q_head, q_stride);
      load_tile<D>(dos, dout + q_head, q_stride);
      if (tid < kTile) {
        qseg[tid] = seg_q[(size_t)b * sq + q0 + tid];
      } else if (tid < 2 * kTile) {
        const size_t r = ((size_t)b * hq + h) * sq + q0 + tid - kTile;
        lse_s[tid - kTile] = lse[r];
        delta_s[tid - kTile] = delta[r];
      }
      __syncthreads();

      // transposed tiles: the block's rows are kv rows, its columns q rows
      float st[4][4], dpt[4][4];
      gemm_abt<D>(ks, qs, ty, tx, st);
      gemm_abt<D>(vs, dos, ty, tx, dpt);
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
      gemm_pv<D>(pts, dos, ty, tx, dv_acc);
      gemm_pv<D>(dsts, qs, ty, tx, dk_acc);
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
};

template <int D>
int launch_dq_fma(const BwdArgs& a, void* dq) {
  const size_t smem = 4 * tile_bytes<D>() + kTile * kScoreLd * sizeof(float) +
                      2 * kTile * sizeof(int);
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
  const size_t smem = 4 * tile_bytes<D>() + 2 * kTile * kScoreLd * sizeof(float) +
                      4 * kTile * sizeof(int);
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

// The bf16 kernels: the same algorithms on tensor cores (flash_mma.cuh),
// 4 warps of 16 rows each. dQ: a warp's rows are q rows; S = Q K^T and
// dP = dO V^T come from shared Q, dO, K and V tiles, and dS, rounded to
// bf16 in registers, multiplies the K tile. dK/dV: a warp's rows are kv
// rows; S^T = K Q^T and dP^T = V dO^T, then P^T and dS^T, rounded to bf16
// in registers, multiply the dO and Q tiles.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_dq_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const int* __restrict__ seg_q,
                    const int* __restrict__ seg_kv, const int2* __restrict__ q_ranges,
                    const int2* __restrict__ k_ranges, const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int sq, int skv, int hq, int hkv, int causal,
                    int window, float cap, int q_offset) {
  constexpr int kN = D / 8;
  constexpr int kK = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* dos = reinterpret_cast<__nv_bfloat16*>(smem + mma_tile_bytes<D>());
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem + 2 * mma_tile_bytes<D>());
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem + 3 * mma_tile_bytes<D>());
  int* qseg = reinterpret_cast<int*>(smem + 4 * mma_tile_bytes<D>());
  int* kseg = qseg + kTile;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nq = sq / kTile, nk = skv / kTile;
  const int hk = h / (hq / hkv);
  const int warp = threadIdx.x >> 5, g = (threadIdx.x >> 2) & 7, t = threadIdx.x & 3;
  const int q0 = qt * kTile;
  const size_t q_stride = (size_t)hq * D, kv_stride = (size_t)hkv * D;
  const size_t q_head = ((size_t)b * sq + q0) * q_stride + (size_t)h * D;

  load_tile_mma<D>(qs, q + q_head, q_stride);
  load_tile_mma<D>(dos, dout + q_head, q_stride);
  if (threadIdx.x < kTile) qseg[threadIdx.x] = seg_q[(size_t)b * sq + q0 + threadIdx.x];
  const int2 q_range = q_ranges[(size_t)b * nq + qt];
  int row[2], q_pos[2], q_id[2];
  float row_lse[2], row_delta[2];
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row[r] = 16 * warp + g + 8 * r;
    q_pos[r] = q0 + row[r] + q_offset;
    q_id[r] = qseg[row[r]];
    const size_t at = ((size_t)b * hq + h) * sq + q0 + row[r];
    row_lse[r] = lse[at];
    row_delta[r] = delta[at];
  }
  float acc[kN][4];
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

    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
      uint32_t qa[4], da[4];
      load_a<D>(qa, qs, 16 * warp, 16 * kk, g, t);
      load_a<D>(da, dos, 16 * warp, 16 * kk, g, t);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t bk[2], bv[2];
        load_b_t<D>(bk, ks, 8 * j, 16 * kk, g, t);
        load_b_t<D>(bv, vs, 8 * j, 16 * kk, g, t);
        mma_bf16(s[j], qa, bk);
        mma_bf16(dp[j], da, bv);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, col = 8 * j + 2 * t + (e & 1);
        float ds = 0.f;
        if (visible(q_pos[r], k0 + col, q_id[r], kseg[col], causal, window)) {
          const float c = soft_cap(s[j][e], cap);
          ds = expf(c - row_lse[r]) * (dp[j][e] - row_delta[r]) * soft_cap_grad(c, cap);
        }
        s[j][e] = ds;
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t dsa[4];
      scores_as_a(dsa, s, kk);
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        uint32_t bk[2];
        load_b<D>(bk, ks, 16 * kk, 8 * n, g, t);
        mma_bf16(acc[n], dsa, bk);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    __nv_bfloat16* out_row = dq + q_head + (size_t)row[r] * q_stride + 2 * t;
#pragma unroll
    for (int n = 0; n < kN; ++n)
      *reinterpret_cast<__nv_bfloat162*>(out_row + 8 * n) =
          __floats2bfloat162_rn(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const int* __restrict__ seg_q,
                     const int* __restrict__ seg_kv, const int2* __restrict__ q_ranges,
                     const int2* __restrict__ k_ranges, const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int sq,
                     int skv, int hq, int hkv, int causal, int window, float cap, int q_offset) {
  constexpr int kN = D / 8;
  constexpr int kK = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem + mma_tile_bytes<D>());
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + 2 * mma_tile_bytes<D>());
  __nv_bfloat16* dos = reinterpret_cast<__nv_bfloat16*>(smem + 3 * mma_tile_bytes<D>());
  int* kseg = reinterpret_cast<int*>(smem + 4 * mma_tile_bytes<D>());
  int* qseg = kseg + kTile;
  float* lse_s = reinterpret_cast<float*>(qseg + kTile);
  float* delta_s = lse_s + kTile;

  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int nq = sq / kTile, nk = skv / kTile;
  const int group = hq / hkv;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x >> 2) & 7, t = threadIdx.x & 3;
  const int k0 = kt * kTile;
  const size_t q_stride = (size_t)hq * D, kv_stride = (size_t)hkv * D;
  const size_t kv_head = ((size_t)b * skv + k0) * kv_stride + (size_t)hk * D;

  load_tile_mma<D>(ks, k + kv_head, kv_stride);
  load_tile_mma<D>(vs, v + kv_head, kv_stride);
  if (threadIdx.x < kTile) kseg[threadIdx.x] = seg_kv[(size_t)b * skv + k0 + threadIdx.x];
  const int2 k_range = k_ranges[(size_t)b * nk + kt];
  float dk_acc[kN][4], dv_acc[kN][4];
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
  // this lane's kv rows g and g + 8 of the warp's 16
  const int key[2] = {16 * warp + g, 16 * warp + g + 8};

  for (int gi = 0; gi < group; ++gi) {
    const int h = hk * group + gi;
    for (int qt = 0; qt < nq; ++qt) {
      const int q0 = qt * kTile;
      if (!tile_visible(q0 + q_offset, k0, causal, window, q_ranges[(size_t)b * nq + qt], k_range))
        continue;  // uniform across the block
      __syncthreads();  // every warp is done with the previous qs, dos, lse_s, delta_s
      const size_t q_head = ((size_t)b * sq + q0) * q_stride + (size_t)h * D;
      load_tile_mma<D>(qs, q + q_head, q_stride);
      load_tile_mma<D>(dos, dout + q_head, q_stride);
      if (threadIdx.x < kTile) {
        const size_t at = ((size_t)b * hq + h) * sq + q0 + threadIdx.x;
        qseg[threadIdx.x] = seg_q[(size_t)b * sq + q0 + threadIdx.x];
        lse_s[threadIdx.x] = lse[at];
        delta_s[threadIdx.x] = delta[at];
      }
      __syncthreads();

      float st[8][4], dpt[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kK; ++kk) {
        uint32_t ka[4], va[4];
        load_a<D>(ka, ks, 16 * warp, 16 * kk, g, t);
        load_a<D>(va, vs, 16 * warp, 16 * kk, g, t);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          uint32_t bq[2], bd[2];
          load_b_t<D>(bq, qs, 8 * j, 16 * kk, g, t);
          load_b_t<D>(bd, dos, 8 * j, 16 * kk, g, t);
          mma_bf16(st[j], ka, bq);
          mma_bf16(dpt[j], va, bd);
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, col = 8 * j + 2 * t + (e & 1);
          float p = 0.f, ds = 0.f;
          if (visible(q0 + col + q_offset, k0 + key[r], qseg[col], kseg[key[r]], causal, window)) {
            const float c = soft_cap(st[j][e], cap);
            p = expf(c - lse_s[col]);
            ds = p * (dpt[j][e] - delta_s[col]) * soft_cap_grad(c, cap);
          }
          st[j][e] = p;
          dpt[j][e] = ds;
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t pa[4], dsa[4];
        scores_as_a(pa, st, kk);
        scores_as_a(dsa, dpt, kk);
#pragma unroll
        for (int n = 0; n < kN; ++n) {
          uint32_t bd[2], bq[2];
          load_b<D>(bd, dos, 16 * kk, 8 * n, g, t);
          load_b<D>(bq, qs, 16 * kk, 8 * n, g, t);
          mma_bf16(dv_acc[n], pa, bd);
          mma_bf16(dk_acc[n], dsa, bq);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t at = kv_head + (size_t)key[r] * kv_stride + 2 * t;
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dk + at + 8 * n) =
          __floats2bfloat162_rn(dk_acc[n][2 * r], dk_acc[n][2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + at + 8 * n) =
          __floats2bfloat162_rn(dv_acc[n][2 * r], dv_acc[n][2 * r + 1]);
    }
  }
}

template <int D>
int launch_dq_mma(const BwdArgs& a, void* dq) {
  const size_t smem = 4 * mma_tile_bytes<D>() + 2 * kTile * sizeof(int);
  auto kernel = flash_dq_mma_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.sq / kTile, a.hq, a.batch);
  kernel<<<grid, kMmaThreads, smem, a.stream>>>(
      (const __nv_bfloat16*)a.q, (const __nv_bfloat16*)a.k, (const __nv_bfloat16*)a.v, a.seg_q,
      a.seg_kv, (const int2*)a.q_ranges, (const int2*)a.k_ranges, (const __nv_bfloat16*)a.dout,
      a.lse, a.delta, (__nv_bfloat16*)dq, a.sq, a.skv, a.hq, a.hkv, a.causal, a.window, a.cap,
      a.q_offset);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_mma(const BwdArgs& a, void* dk, void* dv) {
  const size_t smem = 4 * mma_tile_bytes<D>() + 4 * kTile * sizeof(int);
  auto kernel = flash_dkv_mma_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.skv / kTile, a.hkv, a.batch);
  kernel<<<grid, kMmaThreads, smem, a.stream>>>(
      (const __nv_bfloat16*)a.q, (const __nv_bfloat16*)a.k, (const __nv_bfloat16*)a.v, a.seg_q,
      a.seg_kv, (const int2*)a.q_ranges, (const int2*)a.k_ranges, (const __nv_bfloat16*)a.dout,
      a.lse, a.delta, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, a.sq, a.skv, a.hq, a.hkv, a.causal,
      a.window, a.cap, a.q_offset);
  return (int)cudaGetLastError();
}

bool valid(const BwdArgs& a) {
  return a.sq % kTile == 0 && a.skv % kTile == 0 && a.hkv >= 1 && a.hq % a.hkv == 0 &&
         a.q_offset >= 0;
}

}  // namespace

// Arguments as flash_fwd_launch's, plus dout (the input type, q's layout)
// and lse, delta ([B, Hq, Sq] fp32). dq has q's layout; dk and dv k's.
// Each returns a cudaError_t (0 on success) read right after the launch.
extern "C" int flash_dq_launch(int dtype, int head_dim, const void* q, const void* k,
                               const void* v, const int* seg_q, const int* seg_kv,
                               const int* q_ranges, const int* k_ranges, const void* dout,
                               const float* lse, const float* delta, void* dq, int batch,
                               int sq, int skv, int hq, int hkv, int causal, int window,
                               float cap, int q_offset, void* stream) {
  const BwdArgs a{q, k, v, seg_q, seg_kv, q_ranges, k_ranges, dout, lse, delta, batch, sq, skv,
                  hq, hkv, causal, window, cap, q_offset, (cudaStream_t)stream};
  if (!valid(a)) return (int)cudaErrorInvalidValue;
  if (batch == 0 || sq == 0) return 0;
  if (dtype == 0 && head_dim == 64) return launch_dq_fma<64>(a, dq);
  if (dtype == 0 && head_dim == 128) return launch_dq_fma<128>(a, dq);
  if (dtype == 1 && head_dim == 64) return launch_dq_mma<64>(a, dq);
  if (dtype == 1 && head_dim == 128) return launch_dq_mma<128>(a, dq);
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_dkv_launch(int dtype, int head_dim, const void* q, const void* k,
                                const void* v, const int* seg_q, const int* seg_kv,
                                const int* q_ranges, const int* k_ranges, const void* dout,
                                const float* lse, const float* delta, void* dk, void* dv,
                                int batch, int sq, int skv, int hq, int hkv, int causal,
                                int window, float cap, int q_offset, void* stream) {
  const BwdArgs a{q, k, v, seg_q, seg_kv, q_ranges, k_ranges, dout, lse, delta, batch, sq, skv,
                  hq, hkv, causal, window, cap, q_offset, (cudaStream_t)stream};
  if (!valid(a)) return (int)cudaErrorInvalidValue;
  if (batch == 0 || skv == 0) return 0;
  if (dtype == 0 && head_dim == 64) return launch_dkv_fma<64>(a, dk, dv);
  if (dtype == 0 && head_dim == 128) return launch_dkv_fma<128>(a, dk, dv);
  if (dtype == 1 && head_dim == 64) return launch_dkv_mma<64>(a, dk, dv);
  if (dtype == 1 && head_dim == 128) return launch_dkv_mma<128>(a, dk, dv);
  return (int)cudaErrorInvalidValue;
}
