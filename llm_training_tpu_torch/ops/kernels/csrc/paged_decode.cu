// Ragged paged-decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_decode_kernel` in
// llm_training_tpu/ops/pallas/paged_attention.py: one query token per row
// attends over that row's own cache length, reading K/V pages through its
// block table, with an fp32 online softmax, optional sliding window and
// soft cap, and exactly 0 for a fully masked row.
//
// Design. The TPU grid (batch, kv_heads, pages) carried the running max,
// denominator and accumulator in VMEM across its sequential page axis. On
// the GPU blocks run in no order, so one thread block owns one (row, kv
// head) pair and walks the row's cache itself. Its 8 warps take chunks of
// T consecutive kv slots in turn (warp w: chunks w, w + 8, ...) and each
// keeps its own online-softmax state for the GQA group (q heads
// h*G .. h*G+G-1 are kv-major, as in _xla_attention):
//   - a lane holds D/32 contiguous dims of q, K, V and the accumulator, so
//     a K or V row is one coalesced, vectorised load by the warp and a
//     score is a warp-shuffle sum;
//   - T is set so that a chunk's K and V rows are 64 bytes a lane; the
//     loads are unconditional (a slot past the row reads the row's last
//     slot again and is masked), and the next chunk's loads start
//     before this chunk's arithmetic, so they are in flight while it runs;
//   - each slot's page comes from the block table, read by the block
//     itself (the TPU used scalar prefetch);
//   - scores get scale, then soft cap, then the position and window masks
//     (slots before the window are never visited: a masked slot leaves
//     the state unchanged, so skipping it gives the same result).
// At the end the 8 warp states are merged through shared memory (the
// flash-decoding combine, inside one block), and a row with no visible
// slot (l == 0) writes exactly 0.
//
// Bound. The kernel must move each row's first len_b slots of K and V
// once, sum_b len_b * Hkv * D * 2 * bytes_per_elem bytes, plus q, out and
// the ceil(len_b / page) table entries of each row (slots past len_b in a
// row's last page are never loaded). It
// does ~4 * len * Hq * D flops, far below the tensor-core rate: it is bound
// by HBM bytes. It reads each byte once and keeps every intermediate on
// chip; what it leaves is parallelism: one block per (row, kv head) is 64
// blocks at batch 8 on 132 SMs, and on those the per-score shuffle sums
// and exps, which grow with the GQA group, take longer than the loads.
// Splitting a row's cache across blocks (flash-decoding across SMs) and
// TMA pipelining are left for later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// E contiguous elements, loaded or stored as one aligned vector
template <typename T, int E>
struct __align__(sizeof(T) * E) Vec {
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
      return launch_typed<TQ, __nv_bfloat16>(head_dim, q, k_pool, v_pool, tables, lens, out,
                                             batch, num_kv_heads, group, page, pages_per_row,
                                             scale, cap, window, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16. Returns a cudaError_t
// (0 on success) read right after the launch.
extern "C" int paged_decode_launch(int q_dtype, int kv_dtype, int head_dim, const void* q,
                                   const void* k_pool, const void* v_pool,
                                   const int* tables, const int* lens, void* out,
                                   int batch, int num_kv_heads, int group, int page,
                                   int pages_per_row, float scale, float cap, int window,
                                   void* stream) {
  if (group < 1 || group > kMaxGroup || page < 1 || pages_per_row < 1)
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
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

extern "C" const char* paged_decode_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
