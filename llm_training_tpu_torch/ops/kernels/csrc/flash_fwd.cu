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
// their DMA. Here a block owns (batch, q head, q rows), keeps the q rows on
// chip and their (m, l, acc) in registers, and loops over the kv tiles
// itself; a tile that position or segment ranges rule out is never loaded
// (the loop bound replaces `_kv_clamp` and `_segment_block_bounds`). Per kv
// tile: S = Q K^T, soft cap, then the mask BEFORE the row max, the usual
// rescale, and acc += P V.
//
// Bound. At the training shape the kernel does 4 D flops per visible
// (q, k) pair per q head and moves only q, k, v, out and lse once: it is
// bound by operations, at the bf16 tensor-core rate (PERF.md has its time
// beside the bound).
//
// The bf16 kernel (the training path) is built for this card the way the
// backward kernels are (flash_wgmma.cuh; flash_dq_wgmma_kernel in
// flash_bwd.cu is its twin): a block owns 128 q rows of one head and is
// two consumer warpgroups of 64 rows each plus a producer warpgroup.
//  - The producer (registers cut with setmaxnreg, the consumers' raised)
//    loads the block's Q once as 128-row TMA boxes, then streams the
//    visible 128-row K and V tiles through a ring of two stages of
//    128-byte-swizzled boxes, the tile's kv segment ids riding on the
//    stage's full barrier as a bulk copy. Tile skipping lives in the
//    producer (span_visible over the block's and the tile's ranges); a
//    consumer whose 64 rows cannot see a loaded tile releases the stage.
//  - A consumer computes S = Q K^T with wgmma m64n128k16 from shared
//    memory (both operands K-major), masks, caps and exponentiates in
//    registers (ex2.approx on scores scaled by log2(e); the row max and the
//    row sum over the 4 lanes of a row), rescales O in registers where a
//    row's max moved, rounds P to bf16 as the register-A operand (the
//    Pallas kernel rounds P for the MXU), and adds P V with the V tile read
//    MN-major through the transpose bit. Tiles whose ids and positions let
//    every pair through skip the element mask. A masked score is -inf in
//    the row max, so it leaves the max unchanged and its p is exactly 0; m
//    starts at kMaskValue (or the sink), so a row that sees nothing keeps m
//    finite and ends with l = 0.
//  - Blocks run heaviest first under a causal mask (high q blocks first).
//  - Every block writes its own rows once: the same bits on every run.
//  - At D 256 (Gemma) a head's O is two 128-wide halves, each a block that
//    computes S over the whole D and streams 64-row kv tiles
//    (flash_wgmma.cuh, `OutSplit`); both halves write the same LSE, the
//    first stores it.
// The fp32 kernel (parity and the CPU tests' type, not the training path)
// is 256 threads of fp32 FMA from shared memory over 64-row tiles
// (flash_common.cuh), P kept in fp32; at D 256 its three 64 x 256 tiles
// and the score tile take 210 KB.

#include "flash_common.cuh"
#include "flash_wgmma.cuh"

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

// ------------------------------------------------------ the bf16 kernel

using bf16 = __nv_bfloat16;

// kv rows a streamed tile holds: 128 up to D 128, where the backward
// kernels stream 64. Each tile pays the same waits and hand-offs whatever
// its width, and at 64 rows those weighed as much as the products
// (PERF.md: 0.61 ms at 64 rows, 0.54 at 128). Two stages of 128-row K and V
// tiles (130 KB) fit beside the resident Q (32 KB); a third does not. At D
// 256 Q alone is 64 KB: two stages of 64-row tiles (130 KB) fit beside it.
template <int D>
__host__ __device__ constexpr int fwd_kv_rows() {
  return D > 128 ? kTile : 2 * kTile;
}
constexpr int kFwdRing = 2;

template <int D>
using FwdPlan = BlockPlan<D, 1, fwd_kv_rows<D>(), kFwdRing>;

// the segment-id range of kRows-row kv tile kt from the 64-row tiles' ranges
template <int kRows>
__device__ __forceinline__ int2 kv_tile_range(const int2* range_of, int kt) {
  int2 range = range_of[kRows / kTile * kt];
#pragma unroll
  for (int i = 1; i < kRows / kTile; ++i) {
    const int2 other = range_of[kRows / kTile * kt + i];
    range = make_int2(min(range.x, other.x), max(range.y, other.y));
  }
  return range;
}

// O *= alpha by row (lane rows r = 0, 1), skipped where every row of the
// warp keeps its max (alpha exactly 1)
template <int D>
__device__ __forceinline__ void rescale(float (&acc)[D / 2], const float (&alpha)[2]) {
  if (!__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) return;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
}

// The online softmax on one 64 x kRows score tile in a lane's registers:
// scores s in, P out as the bf16 register-A fragments of P V (each pair of
// probabilities rounded as it is made, so the fp32 ones never all live at
// once); m (the row max, natural units), m2 (the same times log2(e), never
// below kMaskValue) and l (this lane's share of the row sum, of the fp32
// probabilities) updated, alpha the factor that rescales the row's earlier
// sums. A lane holds rows r = 0, 1 and columns 8 j + 2 t, + 1 (kv rows
// k0 + column). kMasked false: every element visible.
template <int kRows, bool kMasked, bool kCapped>
__device__ __forceinline__ void fwd_tile_math(float (&s)[kRows / 2],
                                              uint32_t (&pa)[kRows / 16][4], const int* kseg,
                                              int k0, int t, const int (&q_pos)[2],
                                              const int (&q_id)[2], int causal, int window,
                                              SoftCap cap, float (&m)[2], float (&m2)[2],
                                              float (&l)[2], float (&alpha)[2]) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < kRows / 8; ++j) {
    const int col = 8 * j + 2 * t;
    int2 col_id = make_int2(0, 0);
    if (kMasked) col_id = *reinterpret_cast<const int2*>(kseg + col);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1, odd = e & 1;
      float c = s[4 * j + e];
      if (kCapped) c = cap.cap * fast_tanh(c * cap.inverse);
      if (kMasked && !visible(q_pos[r], k0 + col + odd, q_id[r], odd ? col_id.y : col_id.x,
                              causal, window))
        c = -INFINITY;
      s[4 * j + e] = c;
      mx[r] = fmaxf(mx[r], c);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], quad_max(mx[r]));
    const float m2_new = fmaxf(m_new * kLog2e, kMaskValue);
    alpha[r] = fast_exp2(m2[r] - m2_new);
    m[r] = m_new;
    m2[r] = m2_new;
    l[r] *= alpha[r];
  }
  // chunks j = 2 kk and 2 kk + 1 are k step kk of P V: a[i] holds the
  // pair of elements 8 kk + 2 i, + 1 of the accumulator layout
#pragma unroll
  for (int kk = 0; kk < kRows / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float p[2];
#pragma unroll
      for (int odd = 0; odd < 2; ++odd) {
        const int e = 8 * kk + 2 * i + odd, r = (e >> 1) & 1;
        p[odd] = fast_exp2(fmaf(s[e], kLog2e, -m2[r]));  // 0 for -inf
        l[r] += p[odd];
      }
      pa[kk][i] = pack_pair(p[0], p[1]);
    }
}

// the mask and the soft cap chosen once per tile (both the same in a warp)
template <int kRows>
__device__ __forceinline__ void fwd_tile_math(bool open, float (&s)[kRows / 2],
                                              uint32_t (&pa)[kRows / 16][4], const int* kseg,
                                              int k0, int t, const int (&q_pos)[2],
                                              const int (&q_id)[2], int causal, int window,
                                              SoftCap cap, float (&m)[2], float (&m2)[2],
                                              float (&l)[2], float (&alpha)[2]) {
#define FWD_TILE_MATH_ARGS s, pa, kseg, k0, t, q_pos, q_id, causal, window, cap, m, m2, l, alpha
  if (open) {
    if (cap.cap > 0.f)
      fwd_tile_math<kRows, false, true>(FWD_TILE_MATH_ARGS);
    else
      fwd_tile_math<kRows, false, false>(FWD_TILE_MATH_ARGS);
  } else {
    if (cap.cap > 0.f)
      fwd_tile_math<kRows, true, true>(FWD_TILE_MATH_ARGS);
    else
      fwd_tile_math<kRows, true, false>(FWD_TILE_MATH_ARGS);
  }
#undef FWD_TILE_MATH_ARGS
}

template <int D, typename OutT>
__global__ void __launch_bounds__(kBlockThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const int* __restrict__ seg_q, const int* __restrict__ seg_kv,
                       const int2* __restrict__ q_ranges, const int2* __restrict__ k_ranges,
                       const int2* __restrict__ q_block_ranges, const float* __restrict__ sinks,
                       OutT* __restrict__ out, float* __restrict__ lse, int sq, int skv, int hq,
                       int hkv, int causal, int window, SoftCap cap, int q_offset) {
  using P = FwdPlan<D>;
  using Split = OutSplit<D>;
  constexpr int kKvRows = fwd_kv_rows<D>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t base = smem_u32(smem);
  const uint32_t bars = base + P::kBarriersAt;
  int2* k_range_of = reinterpret_cast<int2*>(smem + P::kRangesAt);  // per 64 kv rows

  // high q blocks first: under a causal mask they see the most kv tiles;
  // the halves of a head's O (at D 256) are neighbouring blocks
  const int h = blockIdx.x / Split::kParts, part = blockIdx.x % Split::kParts;
  const int qt = gridDim.y - 1 - blockIdx.y, b = blockIdx.z;
  const int nk = skv / kKvRows;
  const int hk = h / (hq / hkv);
  const int q0 = qt * kBlockRows;
  for (int i = threadIdx.x; i < skv / kTile; i += kBlockThreads)
    k_range_of[i] = k_ranges[(size_t)b * (skv / kTile) + i];
  if (threadIdx.x == 0) init_barriers(bars);
  __syncthreads();
  const int2 block_range = q_block_ranges[(size_t)b * (sq / kBlockRows) + qt];
  // under a causal mask no kv tile after the block's last row is seen
  const int end_kt = causal ? min(nk, (q0 + kBlockRows - 1 + q_offset) / kKvRows + 1) : nk;
  // the warp index by a shuffle: the compiler then knows it is the same in
  // every lane and keeps what follows from it in uniform registers
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0), lane = threadIdx.x & 31;

  if (warp >= kConsumers * 4) {
    // ---- the producer warpgroup: one lane starts every copy
    set_max_registers_down<kProducerRegs>();
    if (threadIdx.x != kConsumers * 128) return;
    const uint32_t resident = resident_barrier(bars);
    mbar_expect_tx(resident, P::kResident);
#pragma unroll
    for (int box = 0; box < P::kBoxes; ++box)
      tma_load_4d(base + box * kResidentBox, &map_q, resident, 64 * box, h, q0, b);
    RingOf<kFwdRing> at;
    for (int kt = 0; kt < end_kt; ++kt) {
      const int k0 = kt * kKvRows;
      if (!span_visible(q0 + q_offset, kBlockRows, k0, kKvRows, causal, window, block_range,
                        kv_tile_range<kKvRows>(k_range_of, kt)))
        continue;
      const uint32_t stage = base + P::kStagesAt + at.stage * P::kStage;
      const uint32_t full = full_barrier(bars, at.stage);
      mbar_wait(empty_barrier(bars, at.stage), at.phase ^ 1);
      mbar_expect_tx(full, 2 * P::kStreamed + kKvRows * 4);
#pragma unroll
      for (int box = 0; box < P::kBoxes; ++box) {
        tma_load_4d(stage + box * P::kBox, &map_k, full, 64 * box, hk, k0, b);
        tma_load_4d(stage + P::kStreamed + box * P::kBox, &map_v, full, 64 * box, hk, k0, b);
      }
      bulk_load(stage + P::kVectors, seg_kv + (size_t)b * skv + k0, kKvRows * 4, full);
      at.advance();
    }
  } else {
    // ---- a consumer warpgroup: 64 q rows of the block
    set_max_registers_up<kConsumerRegs>();
    const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
    const int row0 = kTile * wg + 16 * (warp & 3) + g;  // this lane's rows: row0, row0 + 8
    const int2 half_range = q_ranges[(size_t)b * (sq / kTile) + kConsumers * qt + wg];
    int q_pos[2], q_id[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + row0 + 8 * r;
      q_pos[r] = row + q_offset;
      q_id[r] = seg_q[(size_t)b * sq + row];
    }
    // m starts at the sink (or kMaskValue) and l at 1 with a sink, counted
    // once per row, by lane t = 0 (l is this lane's share of the row sum)
    const float m_start = sinks != nullptr ? sinks[h] : kMaskValue;
    float m[2] = {m_start, m_start};
    float m2[2] = {fmaxf(m_start * kLog2e, kMaskValue), fmaxf(m_start * kLog2e, kMaskValue)};
    float l[2] = {sinks != nullptr && t == 0 ? 1.f : 0.f, sinks != nullptr && t == 0 ? 1.f : 0.f};
    float acc[Split::kDim / 2];
    zero(acc);
    mbar_wait(resident_barrier(bars), 0);
    const uint64_t q_desc = k_major_descriptor(base + wg * kTile * kRowBytes);
    RingOf<kFwdRing> at;
    for (int kt = 0; kt < end_kt; ++kt) {
      const int k0 = kt * kKvRows;
      const int2 k_range = kv_tile_range<kKvRows>(k_range_of, kt);
      if (!span_visible(q0 + q_offset, kBlockRows, k0, kKvRows, causal, window, block_range,
                        k_range))
        continue;
      const int stage_at = P::kStagesAt + at.stage * P::kStage;
      const uint32_t stage = base + stage_at;
      mbar_wait(full_barrier(bars, at.stage), at.phase);
      if (span_visible(q0 + kTile * wg + q_offset, kTile, k0, kKvRows, causal, window, half_range,
                       k_range)) {
        float s[kKvRows / 2];
        overwritten(s);
        wgmma_fence();
        product_over_d<D, kKvRows, kKvRows>(s, q_desc, stage);  // S = Q K^T
        wgmma_commit();
        wgmma_wait<0>();
        fence_registers(s);
        const int* kseg = reinterpret_cast<const int*>(smem + stage_at + P::kVectors);
        // no mask where the kv tile is one document, this lane's q rows are
        // of it, and position lets every pair through (the same in a warp)
        bool open = one_document<kKvRows>(kseg, lane);
#pragma unroll
        for (int r = 0; r < 2; ++r)
          open = open && q_id[r] == kseg[0] && (!causal || k0 + kKvRows - 1 <= q_pos[r]) &&
                 (window <= 0 || q_pos[r] - k0 < window);
        open = __all_sync(0xffffffffu, open);
        float alpha[2];
        uint32_t pa[kKvRows / 16][4];
        fwd_tile_math<kKvRows>(open, s, pa, kseg, k0, t, q_pos, q_id, causal, window, cap, m, m2,
                               l, alpha);
        rescale<Split::kDim>(acc, alpha);
        fence_registers(acc);
        wgmma_fence();
        // O += P V over this block's columns of V
        product_over_rows<Split::kDim, kKvRows, kKvRows>(
            acc, pa, stage + P::kStreamed + part * Split::kBoxes * P::kBox);
        wgmma_commit();
        wgmma_wait<0>();
        fence_registers(acc);
      }
      mbar_arrive(empty_barrier(bars, at.stage));
      at.advance();
    }
    // O = acc / l, LSE = m + log(l); a row that saw nothing has l = 0:
    // O = 0 and LSE = -inf (with a sink l >= 1 and LSE >= the sink)
    float scale[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float l_row = quad_sum(l[r]);
      scale[r] = l_row > 0.f ? __fdividef(1.f, l_row) : 0.f;
      if (t == 0 && part == 0)
        lse[((size_t)b * hq + h) * sq + q0 + row0 + 8 * r] =
            l_row > 0.f ? m[r] + logf(l_row) : -INFINITY;
    }
#pragma unroll
    for (int i = 0; i < Split::kDim / 2; ++i) acc[i] *= scale[(i >> 1) & 1];
    const size_t q_stride = (size_t)hq * D;
    store_rows<Split::kDim>(
        out + ((size_t)b * sq + q0) * q_stride + (size_t)h * D + part * Split::kDim, q_stride, acc,
        row0, t);
  }
}

template <int D, typename OutT>
int launch_wgmma(const void* q, const void* k, const void* v, const int* seg_q, const int* seg_kv,
                 const int* q_ranges, const int* k_ranges, const int* q_block_ranges,
                 const float* sinks, void* out, float* lse, int batch, int sq, int skv, int hq,
                 int hkv, int causal, int window, float cap, int q_offset, cudaStream_t stream) {
  if (sq % kBlockRows || skv % fwd_kv_rows<D>() || q_block_ranges == nullptr ||
      !aligned16(seg_kv))
    return (int)cudaErrorInvalidValue;
  const size_t smem = FwdPlan<D>::kFixedBytes + (size_t)(skv / kTile) * sizeof(int2);
  if (smem > kMaxBlockSmem) return (int)cudaErrorInvalidValue;
  TileMaps maps;
  if (const int err = encode_maps<D>(&maps, q, k, v, nullptr, batch, sq, skv, hq, hkv,
                                     kBlockRows, fwd_kv_rows<D>()))
    return err;
  auto kernel = flash_fwd_wgmma_kernel<D, OutT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(hq * OutSplit<D>::kParts, sq / kBlockRows, batch);
  kernel<<<grid, kBlockThreads, smem, stream>>>(
      maps.q, maps.k, maps.v, seg_q, seg_kv, (const int2*)q_ranges, (const int2*)k_ranges,
      (const int2*)q_block_ranges, sinks, (OutT*)out, lse, sq, skv, hq, hkv, causal, window,
      soft_cap_of(cap), q_offset);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. q_ranges [B, Sq/64, 2] and k_ranges
// [B, Skv/64, 2] int32 hold each tile's (smallest nonzero, largest) segment
// id; q_block_ranges [B, Sq/128, 2] the same over 128-row blocks (read by
// the bf16 kernel, which wants Sq a multiple of 128; unused in fp32); sinks
// is [Hq] fp32 or null; window <= 0 means none, cap <= 0 means none.
// out_f32 (bf16 only): O written in fp32, unrounded (ring attention merges
// chunk partials before it rounds); an fp32 launch always writes fp32.
// Returns a cudaError_t (0 on success) read right after the launch.
extern "C" int flash_fwd_launch(int dtype, int head_dim, const void* q, const void* k,
                                const void* v, const int* seg_q, const int* seg_kv,
                                const int* q_ranges, const int* k_ranges,
                                const int* q_block_ranges, const float* sinks, void* out,
                                float* lse, int batch, int sq, int skv, int hq, int hkv,
                                int causal, int window, float cap, int q_offset, void* stream,
                                int out_f32) {
  if (sq % kTile || skv % kTile || hkv < 1 || hq % hkv || q_offset < 0)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || sq == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define FLASH_FWD_ARGS                                                                      \
  q, k, v, seg_q, seg_kv, q_ranges, k_ranges, sinks, out, lse, batch, sq, skv, hq, hkv, causal, \
      window, cap, q_offset, s
  if (dtype == 0 && head_dim == 64) return launch_fma<64>(FLASH_FWD_ARGS);
  if (dtype == 0 && head_dim == 128) return launch_fma<128>(FLASH_FWD_ARGS);
  if (dtype == 0 && head_dim == 256) return launch_fma<256>(FLASH_FWD_ARGS);
#undef FLASH_FWD_ARGS
#define FLASH_FWD_ARGS                                                                         \
  q, k, v, seg_q, seg_kv, q_ranges, k_ranges, q_block_ranges, sinks, out, lse, batch, sq, skv, \
      hq, hkv, causal, window, cap, q_offset, s
  if (dtype == 1 && head_dim == 64 && !out_f32) return launch_wgmma<64, bf16>(FLASH_FWD_ARGS);
  if (dtype == 1 && head_dim == 128 && !out_f32) return launch_wgmma<128, bf16>(FLASH_FWD_ARGS);
  if (dtype == 1 && head_dim == 256 && !out_f32) return launch_wgmma<256, bf16>(FLASH_FWD_ARGS);
  if (dtype == 1 && head_dim == 64) return launch_wgmma<64, float>(FLASH_FWD_ARGS);
  if (dtype == 1 && head_dim == 128) return launch_wgmma<128, float>(FLASH_FWD_ARGS);
  if (dtype == 1 && head_dim == 256) return launch_wgmma<256, float>(FLASH_FWD_ARGS);
#undef FLASH_FWD_ARGS
  return (int)cudaErrorInvalidValue;
}
