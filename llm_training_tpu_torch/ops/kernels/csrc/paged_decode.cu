// Ragged paged-decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_decode_kernel` in
// llm_training_tpu/ops/pallas/paged_attention.py: one query token per row
// attends over that row's own cache length, reading K/V pages through its
// block table, with an fp32 online softmax, optional sliding window and
// soft cap, and exactly 0 for a fully masked row.
//
// Bound. The kernel must move each row's first len_b slots of K and V
// once, sum_b len_b * Hkv * D * 2 * bytes_per_elem bytes, plus q, out and
// the ceil(len_b / page) table entries of each row (slots past len_b in a
// row's last page are never loaded). It does ~4 * len * Hq * D flops, far
// below the tensor-core rate: it is bound by HBM bytes, and what it needs
// is enough loads in flight on enough SMs.
//
// The bf16 kernel (bf16 q and pools: what serving runs). The TPU grid
// (batch, kv_heads, pages) carried the running max, denominator and
// accumulator in VMEM across its sequential page axis. Here each (row, kv
// head) is split across the blocks of a thread-block cluster:
//  - The host picks the split count from the table's capacity, B * Hkv
//    and the SM count, so that the grid fills about one wave (planned in
//    ops/kernels/paged_attention.py). Split i of S takes the i-th of S runs
//    of whole 16-slot chunks of the row's visible slots [start, len); a
//    split past the row's end sees nothing.
//  - A block is 4 warps. It loads the row's block table into shared
//    memory once, beside the row's length (so the K and V loads wait for
//    one round trip, not two); each warp takes every fourth 16-slot chunk and
//    streams its K and V rows through a ring of kRing stages of cp.async
//    copies (16 bytes a lane, 16-byte pieces XOR-swizzled by the slot so
//    the reads below hit distinct banks). A slot past the split's end reads
//    its last slot again and is masked.
//  - Scores: one mma.sync m16n8k16 per 16 dims, the 16 slots as rows (A
//    from shared memory by ldmatrix) and up to 8 q heads of the GQA group
//    as columns (B, q in registers, loaded once): bf16 products with an
//    fp32 sum, which is what the Pallas kernel's fp32 dot of these bf16
//    values computes, up to order. A lane holds 2 slots x 2 heads; a
//    head's max over the chunk is 3 shuffles.
//  - P stays fp32: the probabilities go through shared memory and every
//    lane adds p * V for its D / 32 dims of all the group's heads in fp32
//    FMA, as the Pallas kernel and its parity limits want.
//  - The 4 warps' (m, l, acc) merge in shared memory, then the cluster's
//    blocks merge theirs through distributed shared memory in a fixed
//    order, each block writing a slice of the output: one launch, no
//    atomics, no workspace, the same bits on every run. A split or warp
//    that saw nothing has m = -inf and l = 0; a row that saw nothing
//    writes exactly 0.
// Scores are kept in log2 units (scale * log2(e) folded in) for ex2.
//
// head_dim 64, 80, 96, 128 or 256 (80: Phi-2 and Pythia-2.8B; 96: Phi-3;
// 256: Gemma and Pythia-1B). At 96 a K/V row is 192 bytes, 12 16-byte
// pieces: the swizzle keeps a piece inside its aligned group of 4 (see
// `swizzle`), a lane accumulates D / 32 = 3 dims of V, read as three
// 2-byte words because 6 bytes may straddle two pieces, and the stage is
// 6 KB. At 80 a row is 160 bytes, 10 pieces, and 80 / 32 is no whole
// count: the pool stays at 80 a row in HBM and in shared memory, the
// swizzle XORs a piece with bit 2 of the row (inside its aligned pair),
// and a lane accumulates the dim pair 2 lane, + 1 and, in lanes 0-7, the
// pair 64 + 2 lane, + 1 (`SplitDims`). At 256 a lane takes 8 dims (one
// 16-byte read) and the stage is 16 KB. The GQA group picks the
// instantiation: kG 1, 2, 4, 8 or 16 heads as the mma's columns (group 3
// runs kG 4 with one column masked, groups 9-15 run kG 16); above 8 the
// scores are two n8 column tiles over the same ldmatrix'ed K. The mma is
// 8 columns wide, so an MHA model (group 1, Phi-3) uses 1 of its 8
// columns: the scores cost 8x the tensor-core work they need, which is far
// below the HBM bound either way (ROADMAP B).
//
// The other dtype pairs (fp32 q or pools: parity and the CPU tests' types)
// keep the first kernel, in paged_decode_fp32.cuh (one source a pair): one
// block per (row, kv head), 8 warps over 8-slot chunks, a lane per D/32
// dims, a score a warp-shuffle sum.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// the first kernel's launchers, one source a dtype pair
// (paged_decode_fp32.cuh)
#define PAGED_FIRST_PARAMS                                                                   \
  int head_dim, const void *q, const void *k_pool, const void *v_pool, const int *tables,    \
      const int *lens, void *out, int batch, int num_kv_heads, int group, int page,          \
      int pages_per_row, float scale, float cap, int window, cudaStream_t s
int paged_decode_fp32_fp32(PAGED_FIRST_PARAMS);
int paged_decode_fp32_bf16(PAGED_FIRST_PARAMS);
int paged_decode_bf16_fp32(PAGED_FIRST_PARAMS);
#undef PAGED_FIRST_PARAMS

namespace {

constexpr int kMaxGroup = 16;  // q heads per kv head

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int kSplitWarps = 4;
constexpr int kSplitThreads = 32 * kSplitWarps;
constexpr int kChunk = 16;      // kv slots a warp takes at a time: the mma's 16 rows
constexpr int kRing = 3;        // stages of each warp's ring
constexpr int kMaxSplits = 16;  // a cluster of 16 needs the non-portable attribute
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// c (16 x 8 fp32) += a (16 x 16 bf16, row-major) b (16 x 8 bf16, col-major)
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The 16-byte piece of a stage row where piece `piece` of that row's K (or
// V) is stored: swizzled by the row so that ldmatrix's 8 rows of one
// piece land in 8 distinct 16-byte bank groups (offsets mod 128 bytes).
// Rows of 128, 256 or 512 bytes (D 64, 128, 256) XOR the piece with
// row & 7. A 192-byte row (D 96: 12 pieces) already sits 64 bytes further
// mod 128 every other row, so the piece is XORed with (row >> 1) & 3: that
// keeps it inside its aligned group of 4 (inside the row), and with the
// row's own offset gives 8 distinct groups. A 160-byte row (D 80: 10
// pieces) sits 32 bytes further each row, so rows r and r + 4 share an
// offset: the piece is XORed with (row >> 2) & 1, inside its aligned pair.
template <int D>
__device__ __forceinline__ int swizzle(int row, int piece) {
  if constexpr (D == 96)
    return piece ^ ((row >> 1) & 3);
  else if constexpr (D == 80)
    return piece ^ ((row >> 2) & 1);
  else
    return piece ^ (row & 7);
}

// The dims of V a lane of the split kernel accumulates: E = D / 32
// contiguous ones (E lane ..) where 32 divides D; at D 80, E = 4 slots
// for the pair 2 lane, + 1 and, in lanes 0-7, the pair 64 + 2 lane, + 1
// (dim -1: a slot the lane does not hold).
template <int D>
struct SplitDims {
  static constexpr int E = D == 80 ? 4 : D / 32;
  __device__ static __forceinline__ int dim(int lane, int e) {
    if constexpr (D == 80)
      return e < 2 ? 2 * lane + e : (lane < 8 ? 64 + 2 * lane + e - 2 : -1);
    else
      return E * lane + e;
  }
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;  // 0 for -inf
}

// A split's (m, l) per head and its 64 x D accumulator: what a block keeps
// for the cluster to merge (m in log2 units, -inf for a split that saw
// nothing).
template <int D, int kG>
struct SplitState {
  float m[kG], l[kG], acc[kG][D];
};

// weight of a part with max m in a merge whose max is `top` (-inf parts
// weigh 0; `top` is finite)
__device__ __forceinline__ float part_weight(float m, float top) {
  return m == -INFINITY ? 0.f : ex2(m - top);
}

// grid (splits, Hkv, B), a cluster of `splits` blocks along x.
// q, out: [B, Hkv * group, D]; pools: [N, page, Hkv, D]; tables: [B, P];
// lens: [B] tokens written including this step's. scale2 is the softmax
// scale times log2(e); window <= 0 means no window, cap <= 0 no soft cap.
// kG heads (up to 16) are kNT n8 column tiles of the score mma.
template <int D, int kG>
__global__ void __launch_bounds__(kSplitThreads)
paged_decode_split_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k_pool,
                          const bf16* __restrict__ v_pool, const int* __restrict__ tables,
                          const int* __restrict__ lens, bf16* __restrict__ out, int num_kv_heads,
                          int group, int page, int pages_per_row, float scale2, float cap,
                          int window) {
  constexpr int kNT = (kG + 7) / 8;            // n8 column tiles of the scores
  constexpr int kCols = 8 * kNT;               // the heads those tiles hold
  constexpr int kRowBytes = D * 2;             // one slot's K (or V) row of one head
  constexpr int kPieces = kRowBytes / 16;      // its 16-byte pieces
  constexpr int kStageBytes = 2 * kChunk * kRowBytes;  // K rows, then V rows
  using Dims = SplitDims<D>;
  constexpr int E = Dims::E;                   // dims a lane accumulates
  using State = SplitState<D, kG>;
  extern __shared__ __align__(128) unsigned char smem[];
  // the rings; after the loop, the warps' states
  unsigned char* rings = smem;
  float* probs = reinterpret_cast<float*>(smem + kSplitWarps * kRing * kStageBytes);
  // per warp: p of its chunk [kChunk][kCols heads], then alpha [kCols]
  constexpr int kProbFloats = kChunk * kCols + kCols;
  State* block_state = reinterpret_cast<State*>(probs + kSplitWarps * kProbFloats);
  int* table_sh = reinterpret_cast<int*>(block_state + 1);

  cg::cluster_group cluster = cg::this_cluster();
  const int split = blockIdx.x, splits = gridDim.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // the row's whole block table, read beside its length (not after it:
  // the loads of K and V wait for both)
  for (int i = threadIdx.x; i < pages_per_row; i += kSplitThreads)
    table_sh[i] = tables[(size_t)b * pages_per_row + i];
  const int len = lens[b];
  // every slot in [start, len) is visible: slot <= len - 1, and inside the window
  const int start = (window > 0 && len - window > 0) ? len - window : 0;
  const int visible_slots = max(len - start, 0);
  const int per = (visible_slots + splits * kChunk - 1) / (splits * kChunk) * kChunk;
  const int lo = start + split * per;
  const int hi = min(len, lo + per);
  const int n_chunks = hi > lo ? (hi - lo + kChunk - 1) / kChunk : 0;

  // q as the B operand: head 8 nt + g of the group (0 past it), dims
  // 16 kk + 2 t and + 8
  const bf16* q_row = q + ((size_t)b * num_kv_heads + h) * group * D;
  uint32_t qb[kNT][D / 16][2];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const int head = 8 * nt + g;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qb[nt][kk][0] = qb[nt][kk][1] = 0u;
      if (head < group) {
        qb[nt][kk][0] = *reinterpret_cast<const uint32_t*>(q_row + head * D + 16 * kk + 2 * t);
        qb[nt][kk][1] = *reinterpret_cast<const uint32_t*>(q_row + head * D + 16 * kk + 2 * t + 8);
      }
    }
  }
  __syncthreads();  // the table

  // this warp's chunks: warp, warp + kSplitWarps, ...
  const int mine = n_chunks > warp ? (n_chunks - warp + kSplitWarps - 1) / kSplitWarps : 0;
  unsigned char* ring = rings + warp * kRing * kStageBytes;
  const size_t slot_stride = (size_t)num_kv_heads * D;  // one pool slot, all heads
  const bf16* k_head = k_pool + (size_t)h * D;
  const bf16* v_head = v_pool + (size_t)h * D;

  auto issue = [&](int i) {
    const int s0 = lo + (warp + i * kSplitWarps) * kChunk;
    const uint32_t stage = smem_addr(ring + (i % kRing) * kStageBytes);
#pragma unroll
    for (int p = lane; p < kChunk * kPieces; p += 32) {
      const int row = p / kPieces, piece = p % kPieces;
      const int pos = min(s0 + row, hi - 1);
      const int pg = table_sh[min(pos / page, pages_per_row - 1)];
      const size_t src = ((size_t)pg * page + pos % page) * slot_stride + piece * 8;
      const uint32_t dst = row * kRowBytes + (swizzle<D>(row, piece) << 4);
      cp_async16(stage + dst, k_head + src);
      cp_async16(stage + kChunk * kRowBytes + dst, v_head + src);
    }
  };

  // a lane's state: heads 8 nt + 2 t and + 1 (m in log2 units, l its share
  // over its slots), and acc for its dims (SplitDims) of every head
  float m[kNT][2], l[kNT][2];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    m[nt][0] = m[nt][1] = -1e30f;
    l[nt][0] = l[nt][1] = 0.f;
  }
  float acc[kG][E];
#pragma unroll
  for (int hh = 0; hh < kG; ++hh)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[hh][e] = 0.f;
  float* p_sh = probs + warp * kProbFloats;
  float* alpha_sh = p_sh + kChunk * kCols;
  // the soft cap in log2 units: cap2 tanh(x / cap2) with cap2 = cap log2(e)
  const float cap2 = cap * kLog2e, inverse_cap2 = cap > 0.f ? 1.f / cap2 : 0.f;

#pragma unroll
  for (int i = 0; i < kRing - 1; ++i) {
    if (i < mine) issue(i);
    cp_async_commit();
  }
  for (int i = 0; i < mine; ++i) {
    if (i + kRing - 1 < mine) issue(i + kRing - 1);
    cp_async_commit();
    cp_async_wait<kRing - 1>();
    __syncwarp();  // every lane's copies of chunk i have landed
    const unsigned char* stage = ring + (i % kRing) * kStageBytes;
    const int s0 = lo + (warp + i * kSplitWarps) * kChunk;

    // scores of slots s0 + g, s0 + g + 8 for heads 8 nt + 2 t, + 1
    float c[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
    const int a_row = lane & 15;
    const uint32_t a_base = smem_addr(stage) + a_row * kRowBytes;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, a_base + (swizzle<D>(a_row, 2 * kk + (lane >> 4)) << 4));
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) mma_16816(c[nt], a, qb[nt][kk]);
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = c[nt][e] * scale2;
        if (cap > 0.f) x = cap2 * tanhf(x * inverse_cap2);
        if (s0 + g + 8 * (e >> 1) >= hi) x = -INFINITY;
        c[nt][e] = x;
        mx[e & 1] = fmaxf(mx[e & 1], x);
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], o));
        const float m_new = fmaxf(m[nt][r], mx[r]);  // finite: m starts finite
        alpha[r] = ex2(m[nt][r] - m_new);
        m[nt][r] = m_new;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) c[nt][e] = ex2(c[nt][e] - m[nt][e & 1]);
      l[nt][0] = l[nt][0] * alpha[0] + c[nt][0] + c[nt][2];
      l[nt][1] = l[nt][1] * alpha[1] + c[nt][1] + c[nt][3];
      const int col = 8 * nt + 2 * t;
      if (col < kG) {
        *reinterpret_cast<float2*>(p_sh + g * kCols + col) = make_float2(c[nt][0], c[nt][1]);
        *reinterpret_cast<float2*>(p_sh + (g + 8) * kCols + col) = make_float2(c[nt][2], c[nt][3]);
        if (g == 0) *reinterpret_cast<float2*>(alpha_sh + col) = make_float2(alpha[0], alpha[1]);
      }
    }
    __syncwarp();

    // acc = alpha acc + sum over the chunk's slots of p V, in fp32
#pragma unroll
    for (int hh = 0; hh < kG; ++hh) {
      const float a_h = alpha_sh[hh];
#pragma unroll
      for (int e = 0; e < E; ++e) acc[hh][e] *= a_h;
    }
    const int v_byte = lane * E * 2;
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const unsigned char* v_stage = stage + kChunk * kRowBytes + j * kRowBytes;
      // the address of byte `byte` of V row j
      auto v_at = [&](int byte) { return v_stage + (swizzle<D>(j, byte >> 4) << 4) + (byte & 15); };
      float v[E];
      if constexpr (D == 80) {
        // the pair 2 lane, + 1, and in lanes 0-7 the pair 64 + 2 lane, + 1:
        // 4-byte reads, each inside one piece
        const __nv_bfloat162 w = *reinterpret_cast<const __nv_bfloat162*>(v_at(4 * lane));
        v[0] = __low2float(w);
        v[1] = __high2float(w);
        v[2] = v[3] = 0.f;
        if (lane < 8) {
          const __nv_bfloat162 w2 = *reinterpret_cast<const __nv_bfloat162*>(v_at(128 + 4 * lane));
          v[2] = __low2float(w2);
          v[3] = __high2float(w2);
        }
      } else if constexpr (E == 3) {
        // a lane's 3 dims (6 bytes) may straddle two swizzled pieces: one
        // 2-byte read each
#pragma unroll
        for (int e = 0; e < 3; ++e)
          v[e] = __bfloat162float(*reinterpret_cast<const bf16*>(v_at(v_byte + 2 * e)));
      } else if constexpr (E == 8) {
        // a lane's 8 dims are one whole piece
        const uint4 w = *reinterpret_cast<const uint4*>(v_at(v_byte));
        const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i2 = 0; i2 < 4; ++i2) {
          const __nv_bfloat162 pair = *reinterpret_cast<const __nv_bfloat162*>(&words[i2]);
          v[2 * i2] = __low2float(pair);
          v[2 * i2 + 1] = __high2float(pair);
        }
      } else if constexpr (E == 4) {
        const uint2 w = *reinterpret_cast<const uint2*>(v_at(v_byte));
        const __nv_bfloat162 lo2 = *reinterpret_cast<const __nv_bfloat162*>(&w.x);
        const __nv_bfloat162 hi2 = *reinterpret_cast<const __nv_bfloat162*>(&w.y);
        v[0] = __low2float(lo2);
        v[1] = __high2float(lo2);
        v[2] = __low2float(hi2);
        v[3] = __high2float(hi2);
      } else {
        const __nv_bfloat162 w = *reinterpret_cast<const __nv_bfloat162*>(v_at(v_byte));
        v[0] = __low2float(w);
        v[1] = __high2float(w);
      }
      float p[kG];
      if constexpr (kG >= 4) {
#pragma unroll
        for (int q4 = 0; q4 < kG / 4; ++q4) {
          const float4 w = *reinterpret_cast<const float4*>(p_sh + j * kCols + 4 * q4);
          p[4 * q4] = w.x;
          p[4 * q4 + 1] = w.y;
          p[4 * q4 + 2] = w.z;
          p[4 * q4 + 3] = w.w;
        }
      } else {
#pragma unroll
        for (int hh = 0; hh < kG; ++hh) p[hh] = p_sh[j * kCols + hh];
      }
#pragma unroll
      for (int hh = 0; hh < kG; ++hh)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[hh][e] = fmaf(p[hh], v[e], acc[hh][e]);
    }
    __syncwarp();  // done with the stage and the probabilities before they are refilled
  }
  cp_async_wait<0>();

  // a warp's l per head: its lanes' shares over g
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) l[nt][r] += __shfl_xor_sync(0xffffffffu, l[nt][r], o);
  __syncthreads();  // every warp is done with its ring: the states go there
  State* warp_state = reinterpret_cast<State*>(rings);
  State& mine_state = warp_state[warp];
  if (g == 0) {
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int head = 8 * nt + 2 * t + r;
        if (head < kG) {
          mine_state.m[head] = l[nt][r] > 0.f ? m[nt][r] : -INFINITY;
          mine_state.l[head] = l[nt][r];
        }
      }
  }
#pragma unroll
  for (int hh = 0; hh < kG; ++hh)
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int d = Dims::dim(lane, e);
      if (d >= 0) mine_state.acc[hh][d] = acc[hh][e];
    }
  __syncthreads();

  // the block's state: its warps merged in order
  for (int i = threadIdx.x; i < kG * D; i += kSplitThreads) {
    const int hh = i / D, d = i % D;
    float top = -INFINITY;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) top = fmaxf(top, warp_state[w].m[hh]);
    float l_sum = 0.f, a_sum = 0.f;
    if (top != -INFINITY) {
#pragma unroll
      for (int w = 0; w < kSplitWarps; ++w) {
        const float wt = part_weight(warp_state[w].m[hh], top);
        l_sum += wt * warp_state[w].l[hh];
        a_sum += wt * warp_state[w].acc[hh][d];
      }
    }
    block_state->acc[hh][d] = a_sum;
    if (d == 0) {
      block_state->m[hh] = top;
      block_state->l[hh] = l_sum;
    }
  }
  cluster.sync();  // every block's state is ready

  // the cluster's blocks merged in order, each block writing a slice
  bf16* out_row = out + ((size_t)b * num_kv_heads + h) * group * D;
  for (int i = split * kSplitThreads + threadIdx.x; i < group * D; i += splits * kSplitThreads) {
    const int hh = i / D, d = i % D;
    float top = -INFINITY;
    for (int j = 0; j < splits; ++j)
      top = fmaxf(top, cluster.map_shared_rank(block_state, j)->m[hh]);
    float l_sum = 0.f, a_sum = 0.f;
    if (top != -INFINITY) {
      for (int j = 0; j < splits; ++j) {
        const State* other = cluster.map_shared_rank(block_state, j);
        const float wt = part_weight(other->m[hh], top);
        l_sum += wt * other->l[hh];
        a_sum += wt * other->acc[hh][d];
      }
    }
    out_row[i] = __float2bfloat16(l_sum > 0.f ? a_sum / l_sum : 0.f);
  }
  cluster.sync();  // no block leaves while another still reads its state
}

template <int D, int kG>
int launch_split_typed(const void* q, const void* k_pool, const void* v_pool, const int* tables,
                       const int* lens, void* out, int batch, int num_kv_heads, int group,
                       int page, int pages_per_row, float scale, float cap, int window,
                       int splits, cudaStream_t stream) {
  constexpr int kStageBytes = 2 * kChunk * D * 2;
  constexpr int kCols = 8 * ((kG + 7) / 8);
  const size_t rings = (size_t)kSplitWarps * kRing * kStageBytes;
  static_assert(kSplitWarps * sizeof(SplitState<D, kG>) <= kSplitWarps * kRing * kStageBytes,
                "the warps' states must fit where their rings were");
  const size_t smem = rings + kSplitWarps * (kChunk * kCols + kCols) * sizeof(float) +
                      sizeof(SplitState<D, kG>) + (size_t)pages_per_row * sizeof(int);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  auto kernel = paged_decode_split_kernel<D, kG>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && splits > 8)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(splits, num_kv_heads, batch);
  config.blockDim = dim3(kSplitThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attribute[1];
  attribute[0].id = cudaLaunchAttributeClusterDimension;
  attribute[0].val.clusterDim.x = splits;
  attribute[0].val.clusterDim.y = 1;
  attribute[0].val.clusterDim.z = 1;
  config.attrs = attribute;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, kernel, (const bf16*)q, (const bf16*)k_pool,
                           (const bf16*)v_pool, tables, lens, (bf16*)out, num_kv_heads, group,
                           page, pages_per_row, scale * kLog2e, cap, window);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int D>
int launch_split(const void* q, const void* k_pool, const void* v_pool, const int* tables,
                 const int* lens, void* out, int batch, int num_kv_heads, int group, int page,
                 int pages_per_row, float scale, float cap, int window, int splits,
                 cudaStream_t stream) {
#define PAGED_SPLIT_ARGS                                                                       \
  q, k_pool, v_pool, tables, lens, out, batch, num_kv_heads, group, page, pages_per_row, scale, \
      cap, window, splits, stream
  if (group == 1) return launch_split_typed<D, 1>(PAGED_SPLIT_ARGS);
  if (group == 2) return launch_split_typed<D, 2>(PAGED_SPLIT_ARGS);
  if (group <= 4) return launch_split_typed<D, 4>(PAGED_SPLIT_ARGS);
  if (group <= 8) return launch_split_typed<D, 8>(PAGED_SPLIT_ARGS);
  return launch_split_typed<D, 16>(PAGED_SPLIT_ARGS);
#undef PAGED_SPLIT_ARGS
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16. bf16 q with bf16 pools runs the split
// kernel over `splits` blocks per (row, kv head), 1 to 16; the other pairs
// run the first kernel and take splits = 1 only. Returns a cudaError_t
// (0 on success) read right after the launch.
extern "C" int paged_decode_launch(int q_dtype, int kv_dtype, int head_dim, const void* q,
                                   const void* k_pool, const void* v_pool,
                                   const int* tables, const int* lens, void* out,
                                   int batch, int num_kv_heads, int group, int page,
                                   int pages_per_row, float scale, float cap, int window,
                                   int splits, void* stream) {
  if (group < 1 || group > kMaxGroup || page < 1 || pages_per_row < 1 || splits < 1 ||
      splits > kMaxSplits)
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (q_dtype == 1 && kv_dtype == 1) {
#define PAGED_SPLIT_ARGS                                                                       \
  q, k_pool, v_pool, tables, lens, out, batch, num_kv_heads, group, page, pages_per_row, scale, \
      cap, window, splits, s
    if (head_dim == 64) return launch_split<64>(PAGED_SPLIT_ARGS);
    if (head_dim == 80) return launch_split<80>(PAGED_SPLIT_ARGS);
    if (head_dim == 96) return launch_split<96>(PAGED_SPLIT_ARGS);
    if (head_dim == 128) return launch_split<128>(PAGED_SPLIT_ARGS);
    if (head_dim == 256) return launch_split<256>(PAGED_SPLIT_ARGS);
#undef PAGED_SPLIT_ARGS
    return (int)cudaErrorInvalidValue;
  }
  if (splits != 1) return (int)cudaErrorInvalidValue;
#define PAGED_FIRST_ARGS                                                                        \
  head_dim, q, k_pool, v_pool, tables, lens, out, batch, num_kv_heads, group, page, pages_per_row, \
      scale, cap, window, s
  if (q_dtype == 0 && kv_dtype == 0) return paged_decode_fp32_fp32(PAGED_FIRST_ARGS);
  if (q_dtype == 0 && kv_dtype == 1) return paged_decode_fp32_bf16(PAGED_FIRST_ARGS);
  if (q_dtype == 1 && kv_dtype == 0) return paged_decode_bf16_fp32(PAGED_FIRST_ARGS);
#undef PAGED_FIRST_ARGS
  return (int)cudaErrorInvalidValue;
}

// The error string of a code that a launch function of this library returned
// (every kernel module of the port reads it through `build.check_launch`).
extern "C" const char* port_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
