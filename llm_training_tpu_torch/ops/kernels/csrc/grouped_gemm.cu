// Grouped matrix products over rows sorted by group (G1): the port's
// counterpart of `jax.lax.ragged_dot` in the MoE block
// (llm_training_tpu/models/moe.py:429-431). Not a TPU kernel: XLA lowers
// ragged_dot itself. Three entry points, each one launch:
//
//   fwd    y[r]    = x[r] @ w[g]        x [M, K], w [G, K, N] -> y [M, N]
//   dgrad  dx[r]   = dy[r] @ w[g]^T     dy [M, N], w          -> dx [M, K]
//   wgrad  dw[g]   = x_g^T @ dy_g       x, dy                 -> dw [G, K, N]
//
// where rows offsets[g] .. offsets[g+1] of x / dy belong to group g. The
// offsets ([G+1] int32, offsets[0] = 0, offsets[G] = M, non-decreasing) are
// read on the device only: nothing syncs with the host.
//
// - Work: fwd and dgrad tile each group's rows by kBM; a block finds its
//   (group, row tile) from the offsets by a warp-wide prefix sum of the
//   per-group tile counts (the grid holds ceil(M / kBM) + G row-tile slots,
//   the upper bound; the rest exit at once), so no tile crosses a group's
//   edge and a group with no rows has no tile: its weights are never read.
//   Blocks run in bands of kBand row tiles, the row varying fastest inside
//   a band, so a band's activations and weight tiles are read from device
//   memory about once (column tiles first would stream the activations
//   once a column tile; row tiles first, the weights once a row tile).
//   wgrad gives each (group, output tile) one block that reduces all of the
//   group's rows in order; a group with no rows writes zeros.
// - Determinism: no atomics, every output element is summed by one thread
//   in one fixed order, so two launches give the same bits.
// - bf16 (tensor cores, fp32 accumulation): 128 x 128 tiles, 8 warps of
//   64 x 32, mma.sync m16n8k16 fed by ldmatrix from a ring of three
//   cp.async stages of 64-deep slices (dynamic shared memory, 104-111 KB
//   a block, two blocks an SM). Each operand's slice lies in shared memory
//   as it lies in device memory (its contiguous dim contiguous, rows padded
//   by 16 bytes so that ldmatrix's 8 rows hit 8 distinct bank groups); an
//   operand whose
//   contraction dim is not the contiguous one is read with ldmatrix.trans.
//   The contiguous dims (K and N) must be multiples of 8 (16-byte copies).
// - fp32 (FMA): 64 x 64 tiles, 16 x 16 threads of 4 x 4 outputs, one
//   16-deep slice at a time.
//
// What bounds it on an H100 (989 TFLOP/s bf16, 3.35 TB/s): at Qwen3-30B-A3B's
// training shape (M 32768 rows over 128 experts, K/N 2048/768) a projection
// reads 0.40 GB of weights and 0.18 GB of activations against 0.10 ms of
// FLOPs: bytes (0.17 ms). At its decode shape (64 rows over 128 experts)
// only the touched experts' weights are read (42 of 128 in the timed
// draw): bytes. At Mixtral-8x7B's
// (M 8192 over 8 experts, K/N 4096/14336) the FLOPs (0.96 TFLOP) bound it.
// The design keeps two 64-deep slices in flight behind the one being
// consumed, and orders the blocks in bands so that activations and weight
// tiles come from device memory about once; wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kBand = 8;  // row-tile slots a band of blocks shares (L2 reuse)

// ------------------------------------------------------------ scheduling

// One (group, row tile) for row-tile slot `tile`, found by warp 0: info =
// {group or -1, first row, end row}.
__device__ void locate_row_tile(const int* __restrict__ offsets, int groups, int rows_total,
                                int bm, int tile, int* info) {
  const int lane = threadIdx.x;
  const int per = (groups + 31) / 32;
  const int lo = min(lane * per, groups), hi = min(lo + per, groups);
  auto bound = [&](int g) { return min(max(offsets[g], 0), rows_total); };
  int count = 0;
  for (int g = lo; g < hi; ++g) count += (max(bound(g + 1) - bound(g), 0) + bm - 1) / bm;
  int inclusive = count;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, inclusive, d);
    if (lane >= d) inclusive += v;
  }
  const int exclusive = inclusive - count;
  const int total = __shfl_sync(0xffffffffu, inclusive, 31);
  if (lane == 0 && tile >= total) info[0] = -1;
  if (tile >= exclusive && tile < inclusive) {
    int t = tile - exclusive;
    for (int g = lo; g < hi; ++g) {
      const int start = bound(g), end = max(bound(g + 1), start);
      const int n = (end - start + bm - 1) / bm;
      if (t < n) {
        info[0] = g;
        info[1] = start + t * bm;
        info[2] = end;
        break;
      }
      t -= n;
    }
  }
}

// An operand of C[i, j] = sum_k A[i, k] B[k, j], with o the operand's
// output index (i for A, j for B): element (o, k) sits at base + o*ld + k
// when the contraction dim is the contiguous one (k-major), else at
// base + k*ld + o. Valid where o < o_end and k_begin <= k < k_end.
struct View {
  const void* base;
  long ld;
  int o_end;
  int k_end;
};

struct Out {
  void* base;
  long ld;
  int i_end;
  int j_end;
};

// ------------------------------------------------------------ bf16 tiles

constexpr int kBM = 128, kBN = 128, kBK = 64, kPad = 8;
constexpr int kStages = 3;  // slices in flight: kStages - 1 loading while one is consumed

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int bytes = valid ? 16 : 0;  // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <bool kTrans>
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  if constexpr (kTrans)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

// c (16 x 8 fp32) += a (16 x 16 bf16, row-major) b (16 x 8 bf16, col-major)
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One operand's 64-deep slice in shared memory: k-major [R][kBK + kPad]
// (rows of 144 bytes), else [kBK][R + kPad] (rows of 272 bytes).
template <bool kKMajor, int R>
struct Slice {
  static constexpr int rows = kKMajor ? R : kBK;
  static constexpr int cols = kKMajor ? kBK + kPad : R + kPad;
  static constexpr int elems = rows * cols;

  // copy the slice at (o0, k0) of `v` into `tile`, zero where invalid
  __device__ static void load(bf16* tile, const View& v, int o0, int k0) {
    const bf16* base = static_cast<const bf16*>(v.base);
    constexpr int per_row = kKMajor ? kBK / 8 : R / 8;
    constexpr int chunks = rows * per_row;
    for (int c = threadIdx.x; c < chunks; c += kThreads) {
      const int r = c / per_row, piece = (c % per_row) * 8;
      const int o = kKMajor ? o0 + r : o0 + piece;
      const int k = kKMajor ? k0 + piece : k0 + r;
      const bool valid = o < v.o_end && k < v.k_end;
      const bf16* src = valid ? (kKMajor ? base + (long)o * v.ld + k : base + (long)k * v.ld + o)
                              : base;
      cp_async16(smem_addr(tile + r * cols + piece), src, valid);
    }
  }
};

// A's fragment of m-tile rows [m0, m0 + 16) and k-step [k0, k0 + 16)
template <bool kKMajor>
__device__ __forceinline__ void a_fragment(uint32_t (&a)[4], const bf16* tile, int m0, int k0) {
  const int lane = threadIdx.x & 31, q = lane >> 3;
  if constexpr (kKMajor) {
    using S = Slice<true, kBM>;
    const int row = m0 + (lane & 7) + 8 * (q & 1), col = k0 + 8 * (q >> 1);
    ldmatrix_x4<false>(a, smem_addr(tile + row * S::cols + col));
  } else {
    using S = Slice<false, kBM>;
    const int k = k0 + (lane & 7) + 8 * (q >> 1), m = m0 + 8 * (q & 1);
    ldmatrix_x4<true>(a, smem_addr(tile + k * S::cols + m));
  }
}

// B's fragments of the n8 tiles at n0 and n0 + 8, k-step [k0, k0 + 16):
// b = {b0 of n0, b1 of n0, b0 of n0 + 8, b1 of n0 + 8}
template <bool kKMajor>
__device__ __forceinline__ void b_fragments(uint32_t (&b)[4], const bf16* tile, int n0, int k0) {
  const int lane = threadIdx.x & 31, q = lane >> 3;
  if constexpr (kKMajor) {
    using S = Slice<true, kBN>;
    const int n = n0 + (lane & 7) + 8 * (q >> 1), k = k0 + 8 * (q & 1);
    ldmatrix_x4<false>(b, smem_addr(tile + n * S::cols + k));
  } else {
    using S = Slice<false, kBN>;
    const int k = k0 + (lane & 7) + 8 * (q & 1), n = n0 + 8 * (q >> 1);
    ldmatrix_x4<true>(b, smem_addr(tile + k * S::cols + n));
  }
}

// The dynamic shared memory of `tile_product_bf16`: kStages slices of A
// and of B.
template <bool kAMajor, bool kBMajor>
constexpr int smem_bytes_bf16() {
  return kStages * (Slice<kAMajor, kBM>::elems + Slice<kBMajor, kBN>::elems) * 2;
}

// C[i0 .. i0 + kBM, j0 .. j0 + kBN) = sum over k in [k_begin, b.k_end) of
// A B, written to `out` in bf16 where i < out.i_end and j < out.j_end.
// Slices stream through a ring of kStages buffers (dynamic shared memory):
// slice s is consumed while slices s + 1 .. s + kStages - 1 load.
template <bool kAMajor, bool kBMajor>
__device__ void tile_product_bf16(const View& a, const View& b, int i0, int j0, int k_begin,
                                  const Out& out) {
  using SA = Slice<kAMajor, kBM>;
  using SB = Slice<kBMajor, kBN>;
  extern __shared__ __align__(16) unsigned char dynamic_smem[];
  bf16* smem = reinterpret_cast<bf16*>(dynamic_smem);
  // stage st's slices: A at smem + st * SA::elems, B after every A stage
  auto tile_a = [&](int st) { return smem + st * SA::elems; };
  auto tile_b = [&](int st) { return smem + kStages * SA::elems + st * SB::elems; };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  const int k_end = b.k_end;
  const int slices = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;
  auto load = [&](int slice) {
    if (slice < slices) {
      SA::load(tile_a(slice % kStages), a, i0, k_begin + slice * kBK);
      SB::load(tile_b(slice % kStages), b, j0, k_begin + slice * kBK);
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) load(st);
  for (int s = 0; s < slices; ++s) {
    cp_async_wait<kStages - 2>();  // slice s has landed
    // every thread's copies are visible, and every warp is done with
    // slice s - 1, whose buffer the next load overwrites
    __syncthreads();
    load(s + kStages - 1);
    const bf16* ta = tile_a(s % kStages);
    const bf16* tb = tile_b(s % kStages);
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      uint32_t fa[4][4], fb[2][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) a_fragment<kAMajor>(fa[mt], ta, wm + 16 * mt, ks);
#pragma unroll
      for (int np = 0; np < 2; ++np) b_fragments<kBMajor>(fb[np], tb, wn + 16 * np, ks);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_16816(acc[mt][nt], fa[mt], fb[nt >> 1][2 * (nt & 1)], fb[nt >> 1][2 * (nt & 1) + 1]);
    }
  }
  cp_async_wait<0>();

  bf16* dst = static_cast<bf16*>(out.base);
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = i0 + wm + 16 * mt + (lane >> 2) + 8 * half;
      if (i >= out.i_end) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int j = j0 + wn + 8 * nt + 2 * (lane & 3);
        if (j >= out.j_end) continue;  // j_end is even: the pair is whole
        const __nv_bfloat162 pair =
            __floats2bfloat162_rn(acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dst + (long)i * out.ld + j) = pair;
      }
    }
}

// ------------------------------------------------------------ fp32 tiles

constexpr int kFM = 64, kFN = 64, kFK = 16;

template <bool kKMajor, int R>
__device__ __forceinline__ void load_f32(float (*tile)[R], const View& v, int o0, int k0) {
  const float* base = static_cast<const float*>(v.base);
  for (int e = threadIdx.x; e < R * kFK; e += kThreads) {
    // neighbouring threads on the operand's contiguous dim
    const int k = kKMajor ? e % kFK : e / R;
    const int o = kKMajor ? e / kFK : e % R;
    const int go = o0 + o, gk = k0 + k;
    float value = 0.f;
    if (go < v.o_end && gk < v.k_end)
      value = kKMajor ? base[(long)go * v.ld + gk] : base[(long)gk * v.ld + go];
    tile[k][o] = value;
  }
}

template <bool kAMajor, bool kBMajor>
__device__ void tile_product_f32(const View& a, const View& b, int i0, int j0, int k_begin,
                                 const Out& out) {
  __shared__ float ta[kFK][kFM];
  __shared__ float tb[kFK][kFN];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[4][4] = {};
  for (int k0 = k_begin; k0 < b.k_end; k0 += kFK) {
    load_f32<kAMajor, kFM>(ta, a, i0, k0);
    load_f32<kBMajor, kFN>(tb, b, j0, k0);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kFK; ++k) {
      float ra[4], rb[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) ra[r] = ta[k][ty + 16 * r];
#pragma unroll
      for (int c = 0; c < 4; ++c) rb[c] = tb[k][tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(ra[r], rb[c], acc[r][c]);
    }
    __syncthreads();
  }
  float* dst = static_cast<float*>(out.base);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty + 16 * r;
    if (i >= out.i_end) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + tx + 16 * c;
      if (j < out.j_end) dst[(long)i * out.ld + j] = acc[r][c];
    }
  }
}

// ------------------------------------------------------------ the three products

template <typename T>
struct Tile;
template <>
struct Tile<bf16> {
  static constexpr int m = kBM, n = kBN;
};
template <>
struct Tile<float> {
  static constexpr int m = kFM, n = kFN;
};

template <typename T, bool kAMajor, bool kBMajor>
__device__ __forceinline__ void tile_product(const View& a, const View& b, int i0, int j0,
                                             int k_begin, const Out& out) {
  if constexpr (sizeof(T) == 2)
    tile_product_bf16<kAMajor, kBMajor>(a, b, i0, j0, k_begin, out);
  else
    tile_product_f32<kAMajor, kBMajor>(a, b, i0, j0, k_begin, out);
}

// fwd (kDgrad false): y = x @ w[g]; dgrad: dx = dy @ w[g]^T. `a` is x or dy.
template <typename T, bool kDgrad>
__global__ void __launch_bounds__(kThreads)
    row_tiled_kernel(const T* __restrict__ a, const T* __restrict__ w,
                     const int* __restrict__ offsets, T* __restrict__ out, int rows, int k, int n,
                     int groups) {
  // blocks in bands of kBand row-tile slots: inside a band the row tile
  // varies fastest, then the column tile, so a band's activation rows and
  // the weight tiles its groups read stay in L2 while it runs
  const int col_tiles = ((kDgrad ? k : n) + Tile<T>::n - 1) / Tile<T>::n;
  const int slots = gridDim.x / col_tiles;
  const int band = blockIdx.x / (kBand * col_tiles), local = blockIdx.x % (kBand * col_tiles);
  const int band_rows = min(kBand, slots - band * kBand);
  const int slot = band * kBand + local % band_rows, j0 = (local / band_rows) * Tile<T>::n;
  __shared__ int info[3];
  if (threadIdx.x < 32) locate_row_tile(offsets, groups, rows, Tile<T>::m, slot, info);
  __syncthreads();
  const int g = info[0];
  if (g < 0) return;
  const int row0 = info[1], row_end = info[2];
  const T* wg = w + (long)g * k * n;
  if constexpr (!kDgrad) {
    // A = x [rows, k] (k-major); B(k, j) = w[g][k][j] (j contiguous)
    const View va{a, k, row_end, k}, vb{wg, n, n, k};
    tile_product<T, true, false>(va, vb, row0, j0, 0, Out{out, n, row_end, n});
  } else {
    // A = dy [rows, n] (k-major over n); B(n, j) = w[g][j][n] (n contiguous)
    const View va{a, n, row_end, n}, vb{wg, n, k, n};
    tile_product<T, true, true>(va, vb, row0, j0, 0, Out{out, k, row_end, k});
  }
}

// wgrad: dw[g] [k, n] = x_g^T @ dy_g, one block a (group, output tile)
template <typename T>
__global__ void __launch_bounds__(kThreads)
    wgrad_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                 const int* __restrict__ offsets, T* __restrict__ dw, int rows, int k, int n) {
  const int g = blockIdx.z;
  const int start = min(max(offsets[g], 0), rows);
  const int end = max(min(max(offsets[g + 1], 0), rows), start);
  // A(i, r) = x[r][i] (i contiguous); B(r, j) = dy[r][j] (j contiguous)
  const View va{x, k, k, end}, vb{dy, n, n, end};
  tile_product<T, false, false>(va, vb, blockIdx.y * Tile<T>::m, blockIdx.x * Tile<T>::n, start,
                                Out{dw + (long)g * k * n, n, k, n});
}

// The dynamic shared memory a kernel takes (0 for fp32's static tiles),
// allowed past 48 KB once per kernel.
template <typename T, bool kAMajor, bool kBMajor, typename Kernel>
int prepare(Kernel kernel) {
  if constexpr (sizeof(T) == 4) {
    return 0;
  } else {
    constexpr int bytes = smem_bytes_bf16<kAMajor, kBMajor>();
    static const cudaError_t set = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    return set == cudaSuccess ? bytes : -(int)set;
  }
}

template <typename T>
int launch(int op, const void* a, const void* b, const int* offsets, void* out, int rows, int k,
           int n, int groups, cudaStream_t s) {
  constexpr int bm = Tile<T>::m, bn = Tile<T>::n;
  if (op == 2) {
    const int smem = prepare<T, false, false>(wgrad_kernel<T>);
    if (smem < 0) return -smem;
    const dim3 grid((n + bn - 1) / bn, (k + bm - 1) / bm, groups);
    wgrad_kernel<T><<<grid, kThreads, smem, s>>>(static_cast<const T*>(a),
                                                  static_cast<const T*>(b), offsets,
                                                  static_cast<T*>(out), rows, k, n);
    return (int)cudaGetLastError();
  }
  if (rows == 0) return 0;
  const int out_cols = op == 0 ? n : k;
  // row-tile slots (the upper bound of the groups' tiles) x column tiles,
  // one dimension: the kernel orders them in bands
  const long blocks = (long)((rows + bm - 1) / bm + groups) * ((out_cols + bn - 1) / bn);
  if (blocks >= (1L << 31)) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks);
  if (op == 0) {
    const int smem = prepare<T, true, false>(row_tiled_kernel<T, false>);
    if (smem < 0) return -smem;
    row_tiled_kernel<T, false><<<grid, kThreads, smem, s>>>(
        static_cast<const T*>(a), static_cast<const T*>(b), offsets, static_cast<T*>(out), rows,
        k, n, groups);
  } else {
    const int smem = prepare<T, true, true>(row_tiled_kernel<T, true>);
    if (smem < 0) return -smem;
    row_tiled_kernel<T, true><<<grid, kThreads, smem, s>>>(
        static_cast<const T*>(a), static_cast<const T*>(b), offsets, static_cast<T*>(out), rows,
        k, n, groups);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// op 0 fwd (a = x, b = w, out = y), 1 dgrad (a = dy, b = w, out = dx), 2
// wgrad (a = x, b = dy, out = dw); dtype 0 fp32, 1 bf16. rows = M.
extern "C" int grouped_gemm_launch(int op, int dtype, const void* a, const void* b,
                                   const int* offsets, void* out, int rows, int k, int n,
                                   int groups, void* stream) {
  if (op < 0 || op > 2 || rows < 0 || k < 1 || n < 1 || groups < 1 || groups > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(op, a, b, offsets, out, rows, k, n, groups, s);
  if (dtype == 1) {
    if (k % 8 || n % 8) return (int)cudaErrorInvalidValue;
    return launch<bf16>(op, a, b, offsets, out, rows, k, n, groups, s);
  }
  return (int)cudaErrorInvalidValue;
}
