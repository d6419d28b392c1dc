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
// head_dim 64, 96 or 128 (96: Phi-3). At 96 a K/V row is 192
// bytes, 12 16-byte pieces: the swizzle keeps a piece inside its aligned
// group of 4 (see `swizzle`), a lane accumulates D / 32 = 3 dims of V, read
// as three 2-byte words because 6 bytes may straddle two pieces, and the
// stage is 6 KB. The GQA group picks the instantiation: kG 1, 2, 4 or 8
// heads as the mma's columns (group 3 runs kG 4 with one column masked).
// The mma is 8 columns wide, so an MHA model (group 1, Phi-3) uses 1 of its
// 8 columns: the scores cost 8x the tensor-core work they need, which
// is far below the HBM bound either way (ROADMAP B).
//
// The other dtype pairs (fp32 q or pools: parity and the CPU tests' types)
// keep the first kernel below: one block per (row, kv head), 8 warps over
// 8-slot chunks, a lane per D/32 dims, a score a warp-shuffle sum.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxGroup = 8;   // q heads per kv head

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// the largest power of two that divides `bytes`
constexpr int pow2_divisor(int bytes) { return bytes & -bytes; }

// E contiguous elements, loaded or stored as one vector: aligned to its
// size when that is a power of two, else to the largest power of two
// dividing it (D 96: 3 elements a lane, 12 or 6 bytes, loaded as 3 words)
template <typename T, int E>
struct alignas(pow2_divisor(sizeof(T) * E)) Vec {
  T v[E];
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Start the loads of the K and V rows of slots c0 .. c0+T-1 of one row
// (this lane's E dims). Slots at or past `len` read slot len-1 again: a
// real slot, so every load is unconditional, and the caller masks them.
template <typename TKV, int E, int T>
__device__ __forceinline__ void load_chunk(const TKV* k_head, const TKV* v_head,
                                           const int* table_row, int c0, int len, int page,
                                           int pages_per_row, size_t row_stride,
                                           Vec<TKV, E> (&k)[T], Vec<TKV, E> (&v)[T]) {
  size_t slot[T];
#pragma unroll
  for (int u = 0; u < T; ++u) {
    const int pos = min(c0 + u, len - 1);
    slot[u] = (size_t)table_row[min(pos / page, pages_per_row - 1)] * page + pos % page;
  }
#pragma unroll
  for (int u = 0; u < T; ++u) {
    k[u] = *reinterpret_cast<const Vec<TKV, E>*>(k_head + slot[u] * row_stride);
    v[u] = *reinterpret_cast<const Vec<TKV, E>*>(v_head + slot[u] * row_stride);
  }
}

// grid (num_kv_heads, batch), kThreads threads.
// q, out: [B, Hkv * group, D]; pools: [N, page, Hkv, D]; tables: [B, P];
// lens: [B] tokens written including this step's. window <= 0 means no
// window, cap <= 0 means no soft cap.
template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_pool,
                    const TKV* __restrict__ v_pool, const int* __restrict__ tables,
                    const int* __restrict__ lens, TQ* __restrict__ out,
                    int num_kv_heads, int group, int page, int pages_per_row,
                    float scale, float cap, int window) {
  constexpr int E = D / 32;                      // dims per lane
  constexpr int T = 64 / (E * (int)sizeof(TKV));  // kv slots per warp chunk
  constexpr int kStride = kWarps * T;             // slots between a warp's chunks
  using KV = Vec<TKV, E>;
  __shared__ float m_sh[kWarps][kMaxGroup];
  __shared__ float l_sh[kWarps][kMaxGroup];
  __shared__ float acc_sh[kWarps][kMaxGroup][D];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int len = lens[b];
  const int q_pos = len - 1;
  const size_t row_stride = (size_t)num_kv_heads * D;  // one pool slot, all heads

  const TQ* q_row = q + ((size_t)b * num_kv_heads + h) * group * D;
  float qf[kMaxGroup][E];
  float m[kMaxGroup], l[kMaxGroup], acc[kMaxGroup][E];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      qf[g][e] = 0.f;
      acc[g][e] = 0.f;
    }
    if (g < group) {
      const Vec<TQ, E> qv = *reinterpret_cast<const Vec<TQ, E>*>(q_row + g * D + lane * E);
#pragma unroll
      for (int e = 0; e < E; ++e) qf[g][e] = to_float(qv.v[e]);
    }
  }

  // every slot in [start, len) is visible: slot <= q_pos, and inside the window
  const int start = (window > 0 && q_pos - window + 1 > 0) ? q_pos - window + 1 : 0;
  const int* table_row = tables + (size_t)b * pages_per_row;
  const TKV* k_head = k_pool + (size_t)h * D + lane * E;
  const TKV* v_head = v_pool + (size_t)h * D + lane * E;

  KV kv[T], vv[T];  // this chunk's rows
  int c0 = start + warp * T;
  if (c0 < len)
    load_chunk<TKV, E, T>(k_head, v_head, table_row, c0, len, page, pages_per_row, row_stride,
                          kv, vv);
  for (; c0 < len; c0 += kStride) {
    KV kn[T], vn[T];  // the next chunk's rows, in flight during this one's arithmetic
    const bool more = c0 + kStride < len;
    if (more)
      load_chunk<TKV, E, T>(k_head, v_head, table_row, c0 + kStride, len, page, pages_per_row,
                            row_stride, kn, vn);
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      if (g >= group) break;
      float s[T];
      float s_max = -INFINITY;
#pragma unroll
      for (int u = 0; u < T; ++u) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) dot += qf[g][e] * to_float(kv[u].v[e]);
        float sc = warp_sum(dot) * scale;
        if (cap > 0.f) sc = cap * tanhf(sc / cap);
        s[u] = c0 + u < len ? sc : -INFINITY;
        s_max = fmaxf(s_max, s[u]);
      }
      // slot c0 < len is visible, so s_max and m_new are finite
      const float m_new = fmaxf(m[g], s_max);
      const float alpha = expf(m[g] - m_new);  // 0 while m[g] is -inf
      float p_sum = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] *= alpha;
#pragma unroll
      for (int u = 0; u < T; ++u) {
        const float p = expf(s[u] - m_new);  // 0 for a masked slot
        p_sum += p;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] += p * to_float(vv[u].v[e]);
      }
      l[g] = l[g] * alpha + p_sum;
      m[g] = m_new;
    }
    if (more) {
#pragma unroll
      for (int u = 0; u < T; ++u) {
        kv[u] = kn[u];
        vv[u] = vn[u];
      }
    }
  }

#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    if (g >= group) break;
    if (lane == 0) {
      m_sh[warp][g] = m[g];
      l_sh[warp][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < E; ++e) acc_sh[warp][g][lane * E + e] = acc[g][e];
  }
  __syncthreads();

  TQ* out_row = out + ((size_t)b * num_kv_heads + h) * group * D;
  for (int i = tid; i < group * D; i += kThreads) {
    const int g = i / D;
    const int d = i % D;
    float m_all = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m_all = fmaxf(m_all, m_sh[w][g]);
    float l_all = 0.f, o = 0.f;
    if (m_all != -INFINITY) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float wt = expf(m_sh[w][g] - m_all);  // 0 for a warp that saw nothing
        l_all += l_sh[w][g] * wt;
        o += acc_sh[w][g][d] * wt;
      }
    }
    out_row[i] = from_float<TQ>(l_all == 0.f ? 0.f : o / l_all);
  }
}

template <typename TQ, typename TKV>
int launch_typed(int head_dim, const void* q, const void* k_pool, const void* v_pool,
                 const int* tables, const int* lens, void* out, int batch,
                 int num_kv_heads, int group, int page, int pages_per_row, float scale,
                 float cap, int window, cudaStream_t stream) {
  const dim3 grid(num_kv_heads, batch);
  if (head_dim == 64) {
    paged_decode_kernel<TQ, TKV, 64><<<grid, kThreads, 0, stream>>>(
        (const TQ*)q, (const TKV*)k_pool, (const TKV*)v_pool, tables, lens, (TQ*)out,
        num_kv_heads, group, page, pages_per_row, scale, cap, window);
  } else if (head_dim == 96) {
    paged_decode_kernel<TQ, TKV, 96><<<grid, kThreads, 0, stream>>>(
        (const TQ*)q, (const TKV*)k_pool, (const TKV*)v_pool, tables, lens, (TQ*)out,
        num_kv_heads, group, page, pages_per_row, scale, cap, window);
  } else if (head_dim == 128) {
    paged_decode_kernel<TQ, TKV, 128><<<grid, kThreads, 0, stream>>>(
        (const TQ*)q, (const TKV*)k_pool, (const TKV*)v_pool, tables, lens, (TQ*)out,
        num_kv_heads, group, page, pages_per_row, scale, cap, window);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename TQ>
int launch_kv(int kv_dtype, int head_dim, const void* q, const void* k_pool,
              const void* v_pool, const int* tables, const int* lens, void* out, int batch,
              int num_kv_heads, int group, int page, int pages_per_row, float scale,
              float cap, int window, cudaStream_t stream) {
  switch (kv_dtype) {
    case 0:
      return launch_typed<TQ, float>(head_dim, q, k_pool, v_pool, tables, lens, out, batch,
                                     num_kv_heads, group, page, pages_per_row, scale, cap,
                                     window, stream);
    case 1:
      // bf16 q with bf16 pools is the split kernel's
      if constexpr (!std::is_same_v<TQ, __nv_bfloat16>)
        return launch_typed<TQ, __nv_bfloat16>(head_dim, q, k_pool, v_pool, tables, lens, out,
                                               batch, num_kv_heads, group, page, pages_per_row,
                                               scale, cap, window, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// --------------------------------------------------- the bf16 split kernel

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
// Rows of 128 or 256 bytes (D 64, 128) XOR the piece with row & 7. A
// 192-byte row (D 96: 12 pieces) already sits 64 bytes further mod 128
// every other row, so the piece is XORed with (row >> 1) & 3: that keeps
// it inside its aligned group of 4 (inside the row), and with the row's
// own offset gives 8 distinct groups.
template <int D>
__device__ __forceinline__ int swizzle(int row, int piece) {
  if constexpr (D == 96)
    return piece ^ ((row >> 1) & 3);
  else
    return piece ^ (row & 7);
}

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
template <int D, int kG>
__global__ void __launch_bounds__(kSplitThreads)
paged_decode_split_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k_pool,
                          const bf16* __restrict__ v_pool, const int* __restrict__ tables,
                          const int* __restrict__ lens, bf16* __restrict__ out, int num_kv_heads,
                          int group, int page, int pages_per_row, float scale2, float cap,
                          int window) {
  constexpr int kRowBytes = D * 2;             // one slot's K (or V) row of one head
  constexpr int kPieces = kRowBytes / 16;      // its 16-byte pieces
  constexpr int kStageBytes = 2 * kChunk * kRowBytes;  // K rows, then V rows
  constexpr int E = D / 32;                    // dims a lane accumulates
  using State = SplitState<D, kG>;
  extern __shared__ __align__(128) unsigned char smem[];
  // the rings; after the loop, the warps' states
  unsigned char* rings = smem;
  float* probs = reinterpret_cast<float*>(smem + kSplitWarps * kRing * kStageBytes);
  // per warp: p of its chunk [kChunk][8 heads], then alpha [8]
  constexpr int kProbFloats = kChunk * 8 + 8;
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

  // q as the B operand: head g of the group (0 past it), dims 16 kk + 2 t
  // and + 8
  const bf16* q_row = q + ((size_t)b * num_kv_heads + h) * group * D;
  uint32_t qb[D / 16][2];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    qb[kk][0] = qb[kk][1] = 0u;
    if (g < group) {
      qb[kk][0] = *reinterpret_cast<const uint32_t*>(q_row + g * D + 16 * kk + 2 * t);
      qb[kk][1] = *reinterpret_cast<const uint32_t*>(q_row + g * D + 16 * kk + 2 * t + 8);
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

  // a lane's state: heads 2 t and 2 t + 1 (m in log2 units, l its share
  // over its slots), and acc for dims E lane .. of every head
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};
  float acc[kG][E];
#pragma unroll
  for (int hh = 0; hh < kG; ++hh)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[hh][e] = 0.f;
  float* p_sh = probs + warp * kProbFloats;
  float* alpha_sh = p_sh + kChunk * 8;
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

    // scores of slots s0 + g, s0 + g + 8 for heads 2 t, 2 t + 1
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    const int a_row = lane & 15;
    const uint32_t a_base = smem_addr(stage) + a_row * kRowBytes;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, a_base + (swizzle<D>(a_row, 2 * kk + (lane >> 4)) << 4));
      mma_16816(c, a, qb[kk]);
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = c[e] * scale2;
      if (cap > 0.f) x = cap2 * tanhf(x * inverse_cap2);
      if (s0 + g + 8 * (e >> 1) >= hi) x = -INFINITY;
      c[e] = x;
      mx[e & 1] = fmaxf(mx[e & 1], x);
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], o));
      const float m_new = fmaxf(m[r], mx[r]);  // finite: m starts finite
      alpha[r] = ex2(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) c[e] = ex2(c[e] - m[e & 1]);
    l[0] = l[0] * alpha[0] + c[0] + c[2];
    l[1] = l[1] * alpha[1] + c[1] + c[3];
    if (2 * t < kG) {
      *reinterpret_cast<float2*>(p_sh + g * 8 + 2 * t) = make_float2(c[0], c[1]);
      *reinterpret_cast<float2*>(p_sh + (g + 8) * 8 + 2 * t) = make_float2(c[2], c[3]);
      if (g == 0) *reinterpret_cast<float2*>(alpha_sh + 2 * t) = make_float2(alpha[0], alpha[1]);
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
      if constexpr (E == 3) {
        // a lane's 3 dims (6 bytes) may straddle two swizzled pieces: one
        // 2-byte read each
#pragma unroll
        for (int e = 0; e < 3; ++e)
          v[e] = __bfloat162float(*reinterpret_cast<const bf16*>(v_at(v_byte + 2 * e)));
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
          const float4 w = *reinterpret_cast<const float4*>(p_sh + j * 8 + 4 * q4);
          p[4 * q4] = w.x;
          p[4 * q4 + 1] = w.y;
          p[4 * q4 + 2] = w.z;
          p[4 * q4 + 3] = w.w;
        }
      } else {
#pragma unroll
        for (int hh = 0; hh < kG; ++hh) p[hh] = p_sh[j * 8 + hh];
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
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) l[r] += __shfl_xor_sync(0xffffffffu, l[r], o);
  __syncthreads();  // every warp is done with its ring: the states go there
  State* warp_state = reinterpret_cast<State*>(rings);
  State& mine_state = warp_state[warp];
  if (g == 0 && 2 * t < kG) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (2 * t + r < kG) {
        mine_state.m[2 * t + r] = l[r] > 0.f ? m[r] : -INFINITY;
        mine_state.l[2 * t + r] = l[r];
      }
    }
  }
#pragma unroll
  for (int hh = 0; hh < kG; ++hh)
#pragma unroll
    for (int e = 0; e < E; ++e) mine_state.acc[hh][E * lane + e] = acc[hh][e];
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
  const size_t rings = (size_t)kSplitWarps * kRing * kStageBytes;
  static_assert(kSplitWarps * sizeof(SplitState<D, kG>) <= kSplitWarps * kRing * kStageBytes,
                "the warps' states must fit where their rings were");
  const size_t smem = rings + kSplitWarps * (kChunk * 8 + 8) * sizeof(float) +
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
  return launch_split_typed<D, 8>(PAGED_SPLIT_ARGS);
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
    if (head_dim == 96) return launch_split<96>(PAGED_SPLIT_ARGS);
    if (head_dim == 128) return launch_split<128>(PAGED_SPLIT_ARGS);
#undef PAGED_SPLIT_ARGS
    return (int)cudaErrorInvalidValue;
  }
  if (splits != 1) return (int)cudaErrorInvalidValue;
  switch (q_dtype) {
    case 0:
      return launch_kv<float>(kv_dtype, head_dim, q, k_pool, v_pool, tables, lens, out,
                              batch, num_kv_heads, group, page, pages_per_row, scale, cap,
                              window, s);
    case 1:
      return launch_kv<__nv_bfloat16>(kv_dtype, head_dim, q, k_pool, v_pool, tables, lens,
                                      out, batch, num_kv_heads, group, page, pages_per_row,
                                      scale, cap, window, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The error string of a code that a launch function of this library returned
// (every kernel module of the port reads it through `build.check_launch`).
extern "C" const char* port_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
