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
// What bounds it on an H100 (989 TFLOP/s bf16, 3.35 TB/s): at Qwen3-30B-A3B's
// training shape (M 32768 rows over 128 experts, K/N 2048/768) a projection
// reads 0.40 GB of weights and 0.18 GB of activations against 0.10 ms of
// FLOPs: bytes (0.17 ms). At its decode shape (64 rows over 128 experts)
// only the touched experts' weights are read (42 of 128 in the timed
// draw): bytes. At Mixtral-8x7B's (M 8192 over 8 experts, K/N 4096/14336)
// the FLOPs (0.96 TFLOP) bound it.
//
// bf16: the Hopper path (wgmma, TMA, a persistent tile scheduler).
// - Tiles of 128 x kBN outputs, the contraction in 64-deep slices. A block
//   is a producer warpgroup (one lane issues every copy) and two consumer
//   warpgroups of 64 output rows each (setmaxnreg moves the producer's
//   registers to them, as K1-K3 do). Slices stream through a ring of
//   192 KB (six 32 KB stages at kBN 128, four 48 KB at 256) guarded by
//   full / empty mbarriers; each copy is a TMA box into 128-byte-swizzled
//   shared memory (tensor maps encoded on the host, passed as
//   __grid_constant__ parameters); each product is wgmma m64nNk16 (N =
//   kBN) with fp32 accumulation, one slice's products kept in flight while
//   the next slice's wait.
// - The width. Every slice moves (128 + kBN) x 64 bf16 from L2 into shared
//   memory for 128 x kBN x 64 products: at 128 that is ~15 TB/s at the
//   tensor cores' peak, beyond what L2 gives. So kBN is 256 where the output
//   is at least 256 wide and the rows at least kWideRows (the training and
//   Mixtral shapes: a quarter fewer bytes a product), and 128 elsewhere
//   (decode's few rows fill few tiles). The ring's depth in time matters as
//   much (a copy from L2 under load takes ~1 us): the epilogue stages its
//   rows in the tile's last stage, not in memory of its own, which leaves
//   the ring 192 KB.
// - Operand majors (C[i, j] = sum_k A[i, k] B[k, j]): fwd A = x K-major,
//   B = w[g] MN-major (the transpose-B bit); dgrad A = dy K-major, B =
//   w[g]^T K-major (w's rows are its columns); wgrad A = x_g^T MN-major
//   (the transpose-A bit), B = dy_g MN-major. K and N tails arrive as
//   TMA's out-of-bounds zeros.
// - Scheduler: one block an SM, each walking tiles blockIdx.x,
//   blockIdx.x + gridDim.x, ... fwd and dgrad tile each group's rows by
//   128 from the group's first row, whatever its alignment; a block finds
//   a tile's (group, row tile) by a binary search of the groups' tile
//   counts, prefix-summed in shared memory by each block at its start, so
//   no tile crosses a group's edge and a group with no rows has no tile:
//   its weights are never read. Tiles go in bands of kBand row tiles, the
//   row varying fastest inside a band, so a band's activations and weight
//   tiles come from device memory about once. wgrad walks one group's
//   output tiles in a row (x_g and dy_g stay in L2); a group with no rows
//   writes zeros. The producer runs into the next tile's slices while the
//   consumers finish this tile's epilogue, which keeps wgrad's short
//   contractions fed.
// - Ragged edges: fwd and dgrad compute the rows past a group's end (the
//   next group's, or TMA's zeros past M) and never store them: the
//   epilogue stages each warpgroup's 64 rounded rows, 128 columns a pass,
//   in shared memory and stores only rows below the group's end, 16 bytes
//   a thread.
//   In wgrad those rows are part of the contraction: each consumer
//   warpgroup zeroes the rows past the group's end of a group's last
//   slice in its own box of x_g (A) in shared memory before its products,
//   so they add nothing. (Zeroing dy_g's rows too, which both warpgroups
//   read, cost 13% of the training shape's wgrad; only a non-finite dy
//   row of the next group, 0 x inf, would tell the two apart.)
// - Determinism: no atomics, every output element is summed by one thread
//   in one fixed order, so two launches give the same bits.
// - K and N must be multiples of 8 (16-byte rows for TMA), at most
//   kMaxGroups groups for fwd and dgrad (the shared prefix).
//
// fp32 (FMA): 64 x 64 tiles, 16 x 16 threads of 4 x 4 outputs, one 16-deep
// slice at a time, blocks over row-tile slots in bands as above; wgrad one
// block a (group, output tile). It serves parity and the CPU tests' dtype.

#include <cuda.h>  // CUtensorMap and its enums only: libcuda is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBand = 8;  // row tiles a band of tiles shares (L2 reuse)

__device__ __forceinline__ int row_bound(const int* __restrict__ offsets, int g, int rows) {
  return min(max(offsets[g], 0), rows);
}

// ------------------------------------------------------------ fp32 tiles

constexpr int kThreads = 256;
constexpr int kFM = 64, kFN = 64, kFK = 16;

// One (group, row tile) for row-tile slot `tile`, found by warp 0: info =
// {group or -1, first row, end row}.
__device__ void locate_row_tile(const int* __restrict__ offsets, int groups, int rows_total,
                                int bm, int tile, int* info) {
  const int lane = threadIdx.x;
  const int per = (groups + 31) / 32;
  const int lo = min(lane * per, groups), hi = min(lo + per, groups);
  auto bound = [&](int g) { return row_bound(offsets, g, rows_total); };
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
  const float* base;
  long ld;
  int o_end;
  int k_end;
};

struct Out {
  float* base;
  long ld;
  int i_end;
  int j_end;
};

template <bool kKMajor, int R>
__device__ __forceinline__ void load_f32(float (*tile)[R], const View& v, int o0, int k0) {
  for (int e = threadIdx.x; e < R * kFK; e += kThreads) {
    // neighbouring threads on the operand's contiguous dim
    const int k = kKMajor ? e % kFK : e / R;
    const int o = kKMajor ? e / kFK : e % R;
    const int go = o0 + o, gk = k0 + k;
    float value = 0.f;
    if (go < v.o_end && gk < v.k_end)
      value = kKMajor ? v.base[(long)go * v.ld + gk] : v.base[(long)gk * v.ld + go];
    tile[k][o] = value;
  }
}

// C[i0 .. i0 + kFM, j0 .. j0 + kFN) = sum over k in [k_begin, b.k_end) of
// A B, written to `out` where i < out.i_end and j < out.j_end
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
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty + 16 * r;
    if (i >= out.i_end) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + tx + 16 * c;
      if (j < out.j_end) out.base[(long)i * out.ld + j] = acc[r][c];
    }
  }
}

// fwd (kDgrad false): y = x @ w[g]; dgrad: dx = dy @ w[g]^T. `a` is x or dy.
template <bool kDgrad>
__global__ void __launch_bounds__(kThreads)
    row_tiled_f32_kernel(const float* __restrict__ a, const float* __restrict__ w,
                         const int* __restrict__ offsets, float* __restrict__ out, int rows, int k,
                         int n, int groups) {
  // blocks in bands of kBand row-tile slots, the row tile fastest
  const int col_tiles = ((kDgrad ? k : n) + kFN - 1) / kFN;
  const int slots = gridDim.x / col_tiles;
  const int band = blockIdx.x / (kBand * col_tiles), local = blockIdx.x % (kBand * col_tiles);
  const int band_rows = min(kBand, slots - band * kBand);
  const int slot = band * kBand + local % band_rows, j0 = (local / band_rows) * kFN;
  __shared__ int info[3];
  if (threadIdx.x < 32) locate_row_tile(offsets, groups, rows, kFM, slot, info);
  __syncthreads();
  const int g = info[0];
  if (g < 0) return;
  const int row0 = info[1], row_end = info[2];
  const float* wg = w + (long)g * k * n;
  if constexpr (!kDgrad) {
    // A = x [rows, k] (k-major); B(k, j) = w[g][k][j] (j contiguous)
    const View va{a, k, row_end, k}, vb{wg, n, n, k};
    tile_product_f32<true, false>(va, vb, row0, j0, 0, Out{out, n, row_end, n});
  } else {
    // A = dy [rows, n] (k-major over n); B(n, j) = w[g][j][n] (n contiguous)
    const View va{a, n, row_end, n}, vb{wg, n, k, n};
    tile_product_f32<true, true>(va, vb, row0, j0, 0, Out{out, k, row_end, k});
  }
}

// wgrad: dw[g] [k, n] = x_g^T @ dy_g, one block a (group, output tile)
__global__ void __launch_bounds__(kThreads)
    wgrad_f32_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                     const int* __restrict__ offsets, float* __restrict__ dw, int rows, int k,
                     int n) {
  const int g = blockIdx.z;
  const int start = row_bound(offsets, g, rows);
  const int end = max(row_bound(offsets, g + 1, rows), start);
  // A(i, r) = x[r][i] (i contiguous); B(r, j) = dy[r][j] (j contiguous)
  const View va{x, k, k, end}, vb{dy, n, n, end};
  tile_product_f32<false, false>(va, vb, blockIdx.y * kFM, blockIdx.x * kFN, start,
                                 Out{dw + (long)g * k * n, n, k, n});
}

int launch_f32(int op, const float* a, const float* b, const int* offsets, float* out, int rows,
               int k, int n, int groups, cudaStream_t s) {
  if (op == 2) {
    const dim3 grid((n + kFN - 1) / kFN, (k + kFM - 1) / kFM, groups);
    wgrad_f32_kernel<<<grid, kThreads, 0, s>>>(a, b, offsets, out, rows, k, n);
    return (int)cudaGetLastError();
  }
  if (rows == 0) return 0;
  const int out_cols = op == 0 ? n : k;
  // row-tile slots (the upper bound of the groups' tiles) x column tiles
  const long blocks = (long)((rows + kFM - 1) / kFM + groups) * ((out_cols + kFN - 1) / kFN);
  if (blocks >= (1L << 31)) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks);
  if (op == 0)
    row_tiled_f32_kernel<false><<<grid, kThreads, 0, s>>>(a, b, offsets, out, rows, k, n, groups);
  else
    row_tiled_f32_kernel<true><<<grid, kThreads, 0, s>>>(a, b, offsets, out, rows, k, n, groups);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ bf16 on Hopper

using flash::fence_registers;
using flash::kConsumerRegs;
using flash::kProducerRegs;
using flash::mbar_arrive;
using flash::mbar_expect_tx;
using flash::mbar_init;
using flash::mbar_wait;
using flash::smem_u32;

constexpr int kOpFwd = 0, kOpDgrad = 1, kOpWgrad = 2;
constexpr int kBM = 128, kBK = 64;             // a tile's rows, a slice's depth
constexpr int kConsumerThreads = 256;          // two warpgroups of 64 rows
constexpr int kBlockThreads = kConsumerThreads + 128;  // and the producer's warpgroup
constexpr int kBox = 64 * 128;                 // 64 rows of one 128-byte swizzle atom: 8 KB
constexpr int kABytes = 2 * kBox;              // A's share of a stage: 16 KB
constexpr int kMaxGroups = 2048;
constexpr int kWideRows = 4096;  // rows from which a wide output takes 256-column tiles

// The block's plan for tiles kBN columns wide (128, or 256 where the
// tensor cores' operand traffic from L2 bounds the shape): B's share of a
// stage, the stages of the ring (192 KB either way), the barriers, the
// groups' tile prefix. The epilogue stages its rounded rows in the tile's
// last stage (`kStagingBytes` a consumer warpgroup: 64 rows of 128
// columns, a pass; 16-byte chunks XOR-ed with the row modulo 8, so
// neither the accumulator's writes nor the 16-byte reads conflict).
template <int kBN>
struct Plan {
  static constexpr int kBBytes = kBN * kBK * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kRing = kBN == 128 ? 6 : 4;
  static constexpr int kStagingBytes = 64 * 128 * 2;
  static constexpr int kBarriersAt = kRing * kStageBytes;
  static constexpr int kPrefixAt = kBarriersAt + 16 * kRing;
  // dynamic shared memory of a block with `groups` groups (1024 to align)
  static constexpr int smem_bytes(int groups) { return 1024 + kPrefixAt + 4 * (groups + 1); }
  static_assert(kStageBytes % 1024 == 0, "each TMA box starts on a 1024-byte boundary");
  static_assert(smem_bytes(kMaxGroups) <= (int)flash::kMaxBlockSmem, "shared memory");
};

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// generic-proxy writes to shared memory made visible to wgmma's reads
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (64 x N fp32) = or += A (shared) x B (shared), k 16, N 128 or 256;
// kTransA: A is MN-major, kTransB: B is MN-major (else each is K-major)
template <int kN, int kTransA, int kTransB>
__device__ __forceinline__ void wgmma(float (&d)[kN / 2], uint64_t a, uint64_t b,
                                      int accumulate) {
  if constexpr (kN == 128) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, %67, %68;\n"
        "}\n"
        : FLASH_ACC32(d, 0), FLASH_ACC32(d, 32)
        : "l"(a), "l"(b), "r"(accumulate), "n"(kTransA), "n"(kTransB));
  } else {
    static_assert(kN == 256, "wgmma widths 128 and 256");
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127}, "
        "%128, %129, p, 1, 1, %131, %132;\n"
        "}\n"
        : FLASH_ACC32(d, 0), FLASH_ACC32(d, 32), FLASH_ACC32(d, 64), FLASH_ACC32(d, 96)
        : "l"(a), "l"(b), "r"(accumulate), "n"(kTransA), "n"(kTransB));
  }
}

struct Problem {
  const int* offsets;
  bf16* out;
  int rows, k, n, groups;
  int row_tiles;  // wgrad: output row tiles a group (over K)
  int col_tiles;  // output column tiles
};

// One tile: group g; i0, the first output row (fwd, dgrad: a row of x or
// dy; wgrad: a row of dw[g]); j0, the first output column; i_end, where
// rows stop being stored (the group's end; wgrad: K); k_first, the
// contraction's first row (wgrad: the group's first row), k_end its end;
// slices, the 64-deep slices of the contraction.
struct TileAt {
  int g, i0, j0, i_end, k_first, k_end, slices;
};

template <int kOp, int kBN>
__device__ __forceinline__ TileAt locate(const Problem& p, const int* prefix, int tile) {
  TileAt at;
  if constexpr (kOp == kOpWgrad) {
    const int per_group = p.row_tiles * p.col_tiles;
    at.g = tile / per_group;
    const int r = tile - at.g * per_group;
    at.i0 = (r / p.col_tiles) * kBM;
    at.j0 = (r % p.col_tiles) * kBN;
    at.i_end = p.k;
    at.k_first = row_bound(p.offsets, at.g, p.rows);
    at.k_end = max(row_bound(p.offsets, at.g + 1, p.rows), at.k_first);
    at.slices = (at.k_end - at.k_first + kBK - 1) / kBK;
  } else {
    // bands of kBand row tiles, the row tile fastest inside a band
    const int row_tiles = prefix[p.groups];
    const int band_size = kBand * p.col_tiles;
    const int band = tile / band_size, local = tile - band * band_size;
    const int band_rows = min(kBand, row_tiles - band * kBand);
    const int rt = band * kBand + local % band_rows;
    at.j0 = (local / band_rows) * kBN;
    // the last group whose first tile is at or before rt (an empty group's
    // first tile is its successor's)
    int lo = 0, hi = p.groups - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (prefix[mid] <= rt)
        lo = mid;
      else
        hi = mid - 1;
    }
    at.g = lo;
    const int start = row_bound(p.offsets, lo, p.rows);
    at.i0 = start + (rt - prefix[lo]) * kBM;
    at.i_end = max(row_bound(p.offsets, lo + 1, p.rows), start);
    at.k_first = 0;
    at.k_end = kOp == kOpFwd ? p.k : p.n;
    at.slices = (at.k_end + kBK - 1) / kBK;
  }
  return at;
}

// the producer's copies of slice s of a tile into the stage at `stage`:
// A's 16 KB at the stage's start, B's after it
template <int kOp, int kBN>
__device__ __forceinline__ void load_slice(const CUtensorMap* map_a, const CUtensorMap* map_b,
                                           uint32_t stage, uint32_t full, const TileAt& at,
                                           int s) {
  const int k0 = at.k_first + s * kBK;
  const uint32_t b = stage + kABytes;
  if constexpr (kOp == kOpFwd) {
    // x: 128 rows of 64 K; w[g]: 64 K rows of kBN / 64 boxes of 64 columns
    flash::tma_load_4d(stage, map_a, full, k0, at.i0, 0, 0);
#pragma unroll
    for (int box = 0; box < kBN / 64; ++box)
      flash::tma_load_4d(b + box * kBox, map_b, full, at.j0 + 64 * box, k0, at.g, 0);
  } else if constexpr (kOp == kOpDgrad) {
    // dy: 128 rows of 64 N; w[g]: kBN K rows (the output columns) of 64 N
    flash::tma_load_4d(stage, map_a, full, k0, at.i0, 0, 0);
    flash::tma_load_4d(b, map_b, full, k0, at.j0, at.g, 0);
  } else {
    // x_g: 64 rows of two 64-column boxes; dy_g: 64 rows of kBN / 64
    flash::tma_load_4d(stage, map_a, full, at.i0, k0, 0, 0);
    flash::tma_load_4d(stage + kBox, map_a, full, at.i0 + 64, k0, 0, 0);
#pragma unroll
    for (int box = 0; box < kBN / 64; ++box)
      flash::tma_load_4d(b + box * kBox, map_b, full, at.j0 + 64 * box, k0, 0, 0);
  }
}

// consumer warpgroup wg's products over the stage at `stage`: four k steps
// of 16; `first` starts the sum
template <int kOp, int kBN>
__device__ __forceinline__ void slice_products(float (&acc)[kBN / 2], uint32_t stage, int wg,
                                               bool first) {
  const uint32_t b = stage + kABytes;
  if constexpr (kOp == kOpWgrad) {
    // A: this warpgroup's 64 columns of x_g, MN-major; B: dy_g, MN-major
    const uint64_t da = flash::smem_descriptor(stage + wg * kBox, kBox, 8 * flash::kRowBytes);
    const uint64_t db = flash::mn_major_descriptor(b, kBox);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma<kBN, 1, 1>(acc, da + flash::mn_major_step(kk), db + flash::mn_major_step(kk),
                       !first || kk > 0);
  } else {
    // A: this warpgroup's 64 rows of x or dy, K-major
    const uint64_t da = flash::k_major_descriptor(stage + wg * kBox);
    if constexpr (kOp == kOpFwd) {
      const uint64_t db = flash::mn_major_descriptor(b, kBox);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma<kBN, 0, 1>(acc, da + flash::k_major_step(kk, 0), db + flash::mn_major_step(kk),
                         !first || kk > 0);
    } else {
      const uint64_t db = flash::k_major_descriptor(b);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma<kBN, 0, 0>(acc, da + flash::k_major_step(kk, 0), db + flash::k_major_step(kk, 0),
                         !first || kk > 0);
    }
  }
}

// wgrad: zero rows `valid` .. 63 of warpgroup wg's box of x_g (A), which
// only its own products read (every 128-byte row is whole under the
// swizzle); a zero row of A takes the row of dy_g it meets out of the sum
__device__ __forceinline__ void zero_rows_past(unsigned char* stage, int wg, int valid) {
  const int tid = threadIdx.x & 127;
  for (int c = valid * 8 + tid; c < 64 * 8; c += 128)
    *reinterpret_cast<uint4*>(stage + wg * kBox + c * 16) = make_uint4(0, 0, 0, 0);
}

template <int kOp, int kBN>
__global__ void __launch_bounds__(kBlockThreads, 1)
    grouped_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                         const __grid_constant__ CUtensorMap map_b, const Problem p) {
  using P = Plan<kBN>;
  constexpr int kRing = P::kRing;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = flash::aligned_smem(smem_raw);
  const uint32_t base = smem_u32(smem);
  const uint32_t bars = base + P::kBarriersAt;
  auto full_barrier = [&](int stage) { return bars + 8 * stage; };
  auto empty_barrier = [&](int stage) { return bars + 8 * (kRing + stage); };
  int* prefix = reinterpret_cast<int*>(smem + P::kPrefixAt);
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0), lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kRing; ++s) {
      mbar_init(full_barrier(s), 1);                   // the producer's announcement
      mbar_init(empty_barrier(s), kConsumerThreads);  // every consumer thread
    }
    flash::mbar_init_fence();
  }
  if (kOp != kOpWgrad && warp == 0) {
    // prefix[g]: the row tiles of groups before g (a warp-wide scan of
    // each lane's run of groups); prefix[G] all of them
    const int per = (p.groups + 31) / 32;
    const int lo = min(lane * per, p.groups), hi = min(lo + per, p.groups);
    auto tiles_of = [&](int g) {
      const int start = row_bound(p.offsets, g, p.rows);
      return (max(row_bound(p.offsets, g + 1, p.rows) - start, 0) + kBM - 1) / kBM;
    };
    int count = 0;
    for (int g = lo; g < hi; ++g) count += tiles_of(g);
    int inclusive = count;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, inclusive, d);
      if (lane >= d) inclusive += v;
    }
    int running = inclusive - count;
    for (int g = lo; g < hi; ++g) {
      prefix[g] = running;
      running += tiles_of(g);
    }
    if (lane == 31) prefix[p.groups] = inclusive;
  }
  __syncthreads();
  const int tiles = kOp == kOpWgrad ? p.groups * p.row_tiles * p.col_tiles
                                    : prefix[p.groups] * p.col_tiles;

  if (warp >= kConsumerThreads / 32) {
    // ---- the producer warpgroup: one lane starts every copy
    flash::set_max_registers_down<kProducerRegs>();
    if (threadIdx.x != kConsumerThreads) return;
    flash::RingOf<kRing> ring;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const TileAt at = locate<kOp, kBN>(p, prefix, tile);
      for (int s = 0; s < at.slices; ++s) {
        const uint32_t full = full_barrier(ring.stage);
        mbar_wait(empty_barrier(ring.stage), ring.phase ^ 1);
        mbar_expect_tx(full, P::kStageBytes);
        load_slice<kOp, kBN>(&map_a, &map_b, base + ring.stage * P::kStageBytes, full, at, s);
        ring.advance();
      }
    }
    return;
  }

  // ---- a consumer warpgroup: 64 rows of each tile
  flash::set_max_registers_up<kConsumerRegs>();
  const int wg = warp >> 2, tid = threadIdx.x & 127;
  const int row = 16 * (warp & 3) + (lane >> 2), t = lane & 3;  // this lane's rows: row, row + 8
  const int out_cols = kOp == kOpDgrad ? p.k : p.n;
  const long out_ld = out_cols;
  flash::RingOf<kRing> ring;
  float acc[kBN / 2];
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const TileAt at = locate<kOp, kBN>(p, prefix, tile);
    const int wg_row0 = at.i0 + 64 * wg;
    const bool active = wg_row0 < at.i_end;  // the same in the whole warpgroup
    bf16* out = p.out + (kOp == kOpWgrad ? (long)at.g * p.k * p.n : 0);
    flash::overwritten(acc);
    int prev = 0;
    for (int s = 0; s < at.slices; ++s) {
      mbar_wait(full_barrier(ring.stage), ring.phase);
      const uint32_t stage = base + ring.stage * P::kStageBytes;
      if (kOp == kOpWgrad && s == at.slices - 1 && at.k_first + (s + 1) * kBK > at.k_end) {
        // the group's last slice holds the next group's rows: zero them in
        // this warpgroup's x_g before its products read it
        zero_rows_past(smem + ring.stage * P::kStageBytes, wg, at.k_end - (at.k_first + s * kBK));
        fence_async_proxy();
        named_barrier(2 + wg, 128);
      }
      if (active) {
        flash::wgmma_fence();
        slice_products<kOp, kBN>(acc, stage, wg, s == 0);
        flash::wgmma_commit();
      }
      if (s > 0) {
        // the previous slice's products are done: its stage is free
        if (active) flash::wgmma_wait<1>();
        mbar_arrive(empty_barrier(prev));
      }
      prev = ring.stage;
      ring.advance();
    }
    if (at.slices == 0) {
      // wgrad of a group without rows: zeros, straight to the output
      if (active)
        for (int c = tid; c < 64 * (kBN / 8); c += 128) {
          const int r = c / (kBN / 8), col = at.j0 + 8 * (c % (kBN / 8));
          if (wg_row0 + r < at.i_end && col < out_cols)
            *reinterpret_cast<uint4*>(out + (long)(wg_row0 + r) * out_ld + col) =
                make_uint4(0, 0, 0, 0);
        }
      continue;
    }
    if (active) flash::wgmma_wait<0>();
    // both warpgroups are done with the last stage, which now stages the
    // rounded rows: warpgroup wg's 64 rows at wg * kStagingBytes, 128
    // columns a pass
    named_barrier(1, kConsumerThreads);
    if (active) {
      fence_registers(acc);
      unsigned char* staging = smem + prev * P::kStageBytes + wg * P::kStagingBytes;
#pragma unroll
      for (int pass = 0; pass < kBN / 128; ++pass) {
        if (pass > 0) named_barrier(2 + wg, 128);  // the last pass's stores read the rows
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          unsigned char* staged = staging + (row + 8 * r) * 256 + 4 * t;
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int i = 4 * (16 * pass + j) + 2 * r;
            *reinterpret_cast<__nv_bfloat162*>(staged + 16 * (j ^ ((row + 8 * r) & 7))) =
                __floats2bfloat162_rn(acc[i], acc[i + 1]);
          }
        }
        named_barrier(2 + wg, 128);
        // 16 bytes a thread, a row's 256 bytes by 16 neighbouring threads;
        // only rows below the group's end (fwd, dgrad) or K (wgrad),
        // columns below the output's width
        for (int c = tid; c < 64 * 16; c += 128) {
          const int r = c / 16, chunk = c % 16, col = at.j0 + 128 * pass + 8 * chunk;
          if (wg_row0 + r < at.i_end && col < out_cols)
            *reinterpret_cast<uint4*>(out + (long)(wg_row0 + r) * out_ld + col) =
                *reinterpret_cast<const uint4*>(staging + r * 256 + 16 * (chunk ^ (r & 7)));
        }
      }
    }
    // the stage goes back to the producer, whose copies (the async proxy)
    // come after this thread's reads and writes of it
    fence_async_proxy();
    mbar_arrive(empty_barrier(prev));
  }
}

// A 128-byte-swizzled map over a contiguous bf16 tensor of dims (d0, d1,
// d2) (d0 contiguous) whose box is (box0, box1, 1): a rank-4 map (the last
// dim 1) read by flash::tma_load_4d. Returns a cudaError_t.
int bf16_map(CUtensorMap* map, const void* base, uint64_t d0, uint64_t d1, uint64_t d2,
             uint32_t box0, uint32_t box1) {
  const flash::EncodeTiledFn encode = flash::encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {d0, d1, d2, 1};
  const cuuint64_t strides[3] = {d0 * 2, d0 * d1 * 2, d0 * d1 * d2 * 2};
  const cuuint32_t box[4] = {box0, box1, 1, 1};
  const cuuint32_t element_strides[4] = {1, 1, 1, 1};
  const CUresult result = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
      element_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return result == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

int sm_count() {
  static int counts[64] = {};
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device < 0 || device >= 64) return 0;
  if (counts[device] == 0)
    cudaDeviceGetAttribute(&counts[device], cudaDevAttrMultiProcessorCount, device);
  return counts[device];
}

template <int kOp, int kBN>
int launch_wgmma(const void* a, const void* b, const int* offsets, void* out, int rows, int k,
                 int n, int groups, cudaStream_t s) {
  using P = Plan<kBN>;
  if (kOp != kOpWgrad && groups > kMaxGroups) return (int)cudaErrorInvalidValue;
  CUtensorMap map_a, map_b;
  int err;
  if constexpr (kOp == kOpFwd) {
    err = bf16_map(&map_a, a, k, rows, 1, 64, kBM);  // x
    if (!err) err = bf16_map(&map_b, b, n, k, groups, 64, kBK);  // w
  } else if constexpr (kOp == kOpDgrad) {
    err = bf16_map(&map_a, a, n, rows, 1, 64, kBM);  // dy
    if (!err) err = bf16_map(&map_b, b, n, k, groups, 64, kBN);  // w
  } else {
    // a group without rows reads nothing: with no rows at all the maps
    // point at `out`, one row, and are never read
    const void* x = rows ? a : out;
    const void* dy = rows ? b : out;
    err = bf16_map(&map_a, x, k, rows ? rows : 1, 1, 64, kBK);
    if (!err) err = bf16_map(&map_b, dy, n, rows ? rows : 1, 1, 64, kBK);
  }
  if (err) return err;
  auto kernel = grouped_wgmma_kernel<kOp, kBN>;
  static const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::smem_bytes(kMaxGroups));
  if (set != cudaSuccess) return (int)set;
  Problem p{offsets, static_cast<bf16*>(out), rows, k, n, groups, (k + kBM - 1) / kBM,
            ((kOp == kOpDgrad ? k : n) + kBN - 1) / kBN};
  // the upper bound of the tiles (fwd, dgrad: a group's rows end at most
  // one partial tile) against one block an SM
  const long tiles = kOp == kOpWgrad ? (long)groups * p.row_tiles * p.col_tiles
                                     : (long)((rows + kBM - 1) / kBM + groups) * p.col_tiles;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const int grid = (int)(tiles < sms ? tiles : sms);
  if (grid == 0) return 0;
  kernel<<<grid, kBlockThreads, P::smem_bytes(kOp == kOpWgrad ? 0 : groups), s>>>(map_a, map_b,
                                                                                    p);
  return (int)cudaGetLastError();
}

// The tile width a call takes: 256 where the output is that wide and the
// rows many (the training and Mixtral shapes: each stage feeds the tensor
// cores twice the products of its bytes from L2 at 128), else 128 (the
// decode shape, whose few rows fill few tiles).
template <int kOp>
int launch_wgmma_wide_or_not(const void* a, const void* b, const int* offsets, void* out,
                             int rows, int k, int n, int groups, cudaStream_t s) {
  const int out_cols = kOp == kOpDgrad ? k : n;
  if (out_cols >= 256 && rows >= kWideRows)
    return launch_wgmma<kOp, 256>(a, b, offsets, out, rows, k, n, groups, s);
  return launch_wgmma<kOp, 128>(a, b, offsets, out, rows, k, n, groups, s);
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
  if (dtype == 0)
    return launch_f32(op, static_cast<const float*>(a), static_cast<const float*>(b), offsets,
                      static_cast<float*>(out), rows, k, n, groups, s);
  if (dtype != 1 || k % 8 || n % 8) return (int)cudaErrorInvalidValue;
  if (op == 2) return launch_wgmma_wide_or_not<kOpWgrad>(a, b, offsets, out, rows, k, n, groups, s);
  if (rows == 0) return 0;
  if (op == 0) return launch_wgmma_wide_or_not<kOpFwd>(a, b, offsets, out, rows, k, n, groups, s);
  return launch_wgmma_wide_or_not<kOpDgrad>(a, b, offsets, out, rows, k, n, groups, s);
}
