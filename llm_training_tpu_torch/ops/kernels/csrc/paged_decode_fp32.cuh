// Ragged paged-decode attention for Hopper (sm_90a): the kernel of the
// dtype pairs other than bf16 q with bf16 pools (fp32 q or pools: parity
// and the CPU tests' types). paged_decode.cu holds the bf16 split kernel
// (what serving runs), the notes both share and the one entry point,
// `paged_decode_launch`, which calls the pair's own launcher for these
// pairs: `paged_decode_<q>_<pools>` in paged_decode_{fp32_fp32, fp32_bf16,
// bf16_fp32}.cu, one source a pair so that their instantiations (5 head
// dims x 2 group bounds each) compile in parallel beside the split
// kernel's.
//
// One block per (row, kv head), 8 warps over 8-slot chunks, a lane per
// D/32 dims (at D 80, dims lane + 32 e), a score a warp-shuffle sum, the
// warps' states merged in dynamic shared memory. A launch takes up to kG
// = 8 q heads of a kv head's group; a group of 9-16 is two launches (heads
// 0-7, then the rest), each reading the rows' K and V: the fp32 parity
// path trades those bytes for a build without a 16-head instantiation.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kG = 8;  // q heads a launch takes

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

// The dims a lane of the first kernel holds: E = D / 32 contiguous ones
// (dims E lane .. E lane + E - 1) where 32 divides D; at D 80 the strided
// dims lane + 32 e (e < 3), of which lanes 16-31 hold two.
template <int D>
struct LaneDims {
  static constexpr bool kStrided = D % 32 != 0;
  static constexpr int E = (D + 31) / 32;
  __device__ static __forceinline__ int dim(int lane, int e) {
    return kStrided ? lane + 32 * e : lane * E + e;
  }
  __device__ static __forceinline__ bool valid(int lane, int e) {
    return !kStrided || lane + 32 * e < D;
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Start the loads of the K and V rows of slots c0 .. c0+T-1 of one row
// (this lane's E dims; `k_head` and `v_head` point at the head's dim 0).
// Slots at or past `len` read slot len-1 again: a real slot, so every load
// is unconditional, and the caller masks them. A strided lane's dims past
// D read 0.
template <typename TKV, int D, int T>
__device__ __forceinline__ void load_chunk(const TKV* k_head, const TKV* v_head,
                                           const int* table_row, int c0, int len, int page,
                                           int pages_per_row, size_t row_stride, int lane,
                                           Vec<TKV, LaneDims<D>::E> (&k)[T],
                                           Vec<TKV, LaneDims<D>::E> (&v)[T]) {
  using L = LaneDims<D>;
  size_t slot[T];
#pragma unroll
  for (int u = 0; u < T; ++u) {
    const int pos = min(c0 + u, len - 1);
    slot[u] = (size_t)table_row[min(pos / page, pages_per_row - 1)] * page + pos % page;
  }
#pragma unroll
  for (int u = 0; u < T; ++u) {
    if constexpr (L::kStrided) {
#pragma unroll
      for (int e = 0; e < L::E; ++e) {
        const bool ok = L::valid(lane, e);
        const size_t at = slot[u] * row_stride + (ok ? L::dim(lane, e) : 0);
        k[u].v[e] = ok ? k_head[at] : TKV(0.f);
        v[u].v[e] = ok ? v_head[at] : TKV(0.f);
      }
    } else {
      k[u] = *reinterpret_cast<const Vec<TKV, L::E>*>(k_head + slot[u] * row_stride + lane * L::E);
      v[u] = *reinterpret_cast<const Vec<TKV, L::E>*>(v_head + slot[u] * row_stride + lane * L::E);
    }
  }
}

// grid (num_kv_heads, batch), kThreads threads, dynamic shared memory for
// the warps' states. The launch takes q heads g0 .. g0 + kG - 1 of each
// group (those below `group`).
// q, out: [B, Hkv * group, D]; pools: [N, page, Hkv, D]; tables: [B, P];
// lens: [B] tokens written including this step's. window <= 0 means no
// window, cap <= 0 means no soft cap.
template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_pool,
                    const TKV* __restrict__ v_pool, const int* __restrict__ tables,
                    const int* __restrict__ lens, TQ* __restrict__ out,
                    int num_kv_heads, int group, int g0, int page, int pages_per_row,
                    float scale, float cap, int window) {
  using L = LaneDims<D>;
  constexpr int E = L::E;                         // dims per lane
  constexpr int T = L::kStrided ? 2 : 64 / (E * (int)sizeof(TKV));  // kv slots per warp chunk
  constexpr int kStride = kWarps * T;             // slots between a warp's chunks
  using KV = Vec<TKV, E>;
  extern __shared__ float first_smem[];
  float* m_sh = first_smem;                 // [kWarps][kG]
  float* l_sh = m_sh + kWarps * kG;         // [kWarps][kG]
  float* acc_sh = l_sh + kWarps * kG;       // [kWarps][kG][D]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int len = lens[b];
  const int q_pos = len - 1;
  const size_t row_stride = (size_t)num_kv_heads * D;  // one pool slot, all heads

  const int heads = min(kG, group - g0);  // this launch's
  const TQ* q_row = q + (((size_t)b * num_kv_heads + h) * group + g0) * D;
  float qf[kG][E];
  float m[kG], l[kG], acc[kG][E];
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      qf[g][e] = 0.f;
      acc[g][e] = 0.f;
    }
    if (g < heads) {
      if constexpr (L::kStrided) {
#pragma unroll
        for (int e = 0; e < E; ++e)
          if (L::valid(lane, e)) qf[g][e] = to_float(q_row[g * D + L::dim(lane, e)]);
      } else {
        const Vec<TQ, E> qv = *reinterpret_cast<const Vec<TQ, E>*>(q_row + g * D + lane * E);
#pragma unroll
        for (int e = 0; e < E; ++e) qf[g][e] = to_float(qv.v[e]);
      }
    }
  }

  // every slot in [start, len) is visible: slot <= q_pos, and inside the window
  const int start = (window > 0 && q_pos - window + 1 > 0) ? q_pos - window + 1 : 0;
  const int* table_row = tables + (size_t)b * pages_per_row;
  const TKV* k_head = k_pool + (size_t)h * D;
  const TKV* v_head = v_pool + (size_t)h * D;

  KV kv[T], vv[T];  // this chunk's rows
  int c0 = start + warp * T;
  if (c0 < len)
    load_chunk<TKV, D, T>(k_head, v_head, table_row, c0, len, page, pages_per_row, row_stride,
                          lane, kv, vv);
  for (; c0 < len; c0 += kStride) {
    KV kn[T], vn[T];  // the next chunk's rows, in flight during this one's arithmetic
    const bool more = c0 + kStride < len;
    if (more)
      load_chunk<TKV, D, T>(k_head, v_head, table_row, c0 + kStride, len, page, pages_per_row,
                            row_stride, lane, kn, vn);
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      if (g >= heads) break;
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
  for (int g = 0; g < kG; ++g) {
    if (g >= heads) break;
    if (lane == 0) {
      m_sh[warp * kG + g] = m[g];
      l_sh[warp * kG + g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (L::valid(lane, e)) acc_sh[(warp * kG + g) * D + L::dim(lane, e)] = acc[g][e];
  }
  __syncthreads();

  TQ* out_row = out + (((size_t)b * num_kv_heads + h) * group + g0) * D;
  for (int i = tid; i < heads * D; i += kThreads) {
    const int g = i / D;
    const int d = i % D;
    float m_all = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m_all = fmaxf(m_all, m_sh[w * kG + g]);
    float l_all = 0.f, o = 0.f;
    if (m_all != -INFINITY) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float wt = expf(m_sh[w * kG + g] - m_all);  // 0 for a warp that saw nothing
        l_all += l_sh[w * kG + g] * wt;
        o += acc_sh[(w * kG + g) * D + d] * wt;
      }
    }
    out_row[i] = from_float<TQ>(l_all == 0.f ? 0.f : o / l_all);
  }
}

template <typename TQ, typename TKV, int D>
int launch_first(const void* q, const void* k_pool, const void* v_pool, const int* tables,
                 const int* lens, void* out, int batch, int num_kv_heads, int group, int page,
                 int pages_per_row, float scale, float cap, int window, cudaStream_t stream) {
  const size_t smem = (size_t)kWarps * kG * (2 + D) * sizeof(float);
  auto kernel = paged_decode_kernel<TQ, TKV, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  for (int g0 = 0; g0 < group; g0 += kG) {
    kernel<<<dim3(num_kv_heads, batch), kThreads, smem, stream>>>(
        (const TQ*)q, (const TKV*)k_pool, (const TKV*)v_pool, tables, lens, (TQ*)out,
        num_kv_heads, group, g0, page, pages_per_row, scale, cap, window);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

template <typename TQ, typename TKV>
int launch_typed(int head_dim, const void* q, const void* k_pool, const void* v_pool,
                 const int* tables, const int* lens, void* out, int batch,
                 int num_kv_heads, int group, int page, int pages_per_row, float scale,
                 float cap, int window, cudaStream_t stream) {
#define PAGED_FIRST_ARGS                                                                   \
  q, k_pool, v_pool, tables, lens, out, batch, num_kv_heads, group, page, pages_per_row, \
      scale, cap, window, stream
  switch (head_dim) {
    case 64: return launch_first<TQ, TKV, 64>(PAGED_FIRST_ARGS);
    case 80: return launch_first<TQ, TKV, 80>(PAGED_FIRST_ARGS);
    case 96: return launch_first<TQ, TKV, 96>(PAGED_FIRST_ARGS);
    case 128: return launch_first<TQ, TKV, 128>(PAGED_FIRST_ARGS);
    case 256: return launch_first<TQ, TKV, 256>(PAGED_FIRST_ARGS);
  }
#undef PAGED_FIRST_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace
