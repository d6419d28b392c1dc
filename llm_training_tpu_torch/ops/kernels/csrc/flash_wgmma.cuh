// Hopper pieces of the bf16 flash-attention kernels (flash_fwd.cu, K1;
// flash_bwd.cu, K2 and K3): TMA tile loads into 128-byte-swizzled shared
// memory, mbarriers and the ring of stages they guard, the warpgroup matrix
// product (wgmma) with its shared-memory descriptors, the products and the
// arithmetic the kernels share, and the host side that encodes the tensor
// maps.
//
// Tiles. A head's rows in a [B, S, H, D] bf16 tensor are H * D elements
// apart. A 4-D tensor map (D, H, S, B) with a box of (64, 1, rows, 1) copies
// `rows` rows of 64 elements of one head: in shared memory each row is 128
// bytes, one swizzle atom, rows back to back, 16-byte chunks XOR-ed with the
// row index modulo 8 (CU_TENSOR_MAP_SWIZZLE_128B; the box starts on a
// 1024-byte boundary). D = 128 is two such boxes, d 0..63 and d 64..127;
// D = 256 four.
//
// Head_dim 256. An accumulator over D (O, dQ, dK, dV) of 64 x 256 fp32 is
// 128 registers a lane, which with the score tiles beside it does not fit
// what the consumers get (below). So at D 256 a head's output is split in
// two 128-wide halves, each a block of its own (`OutSplit`): both blocks
// compute the scores (and dP) over the whole D from the same tiles and
// accumulate only their half, reading their half of the streamed tile
// MN-major. The scores are computed twice, the output once: 1.5x the
// forward's products and ~1.4x the backward's, on the tensor cores. The
// resident 128-row tensors are 64 KB each at D 256, so the forward streams
// 64-row kv tiles (two stages: 64 + 2 x 65 KB) and the backward, whose two
// resident tensors take 128 KB, keeps one stage of 64-row tiles (65 KB):
// its copies do not overlap its products. A simple design that is right;
// a faster one (a deeper ring of 32-row tiles, or a producer that streams
// only the half a block reads of V, Q or dO) is later work (ROADMAP B).
//
// The same bytes serve both kinds of product:
//  - K-major (the contraction runs along d, as in S = Q K^T): descriptor
//    with a 1024-byte stride between 8-row groups; a k step of 16 elements
//    moves the start address by 32 bytes inside the atom, and to the next
//    box after four steps.
//  - MN-major (the contraction runs along the rows, as in O = P V or
//    dQ = dS K, where the tile lies [k, n] with n contiguous): the
//    instruction's transpose-B bit, 128 bytes between k rows inside an
//    8-row group, 1024 bytes (the stride offset) between groups, and the
//    leading offset is the distance between the boxes that hold n 0..63 and
//    n 64..127; a k step of 16 rows moves the start address by 2048 bytes.
//
// Registers. The m64nN fp32 accumulator of a warpgroup gives warp w rows
// 16 w .. 16 w + 15; lane 4 g + t holds, of each 8-column chunk j, rows g
// and g + 8 and columns 8 j + 2 t, 8 j + 2 t + 1 as d[4 j .. 4 j + 3]. Two
// adjacent chunks, rounded to bf16, are the register-A fragment of a
// m64k16 step, so P and dS go from one product into the next in registers.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: libcuda is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace flash {

constexpr int kBlockRows = 128;                      // rows a block owns
constexpr int kConsumers = kBlockRows / kTile;       // consumer warpgroups, 64 rows each
constexpr int kBlockThreads = (kConsumers + 1) * 128;  // and the producer's warpgroup
constexpr int kStages = 3;                           // ring of streamed tiles
constexpr int kRowBytes = 128;                       // 64 bf16: one swizzle atom
constexpr int kStreamBox = kTile * kRowBytes;        // a 64-row box
constexpr int kResidentBox = kBlockRows * kRowBytes; // a 128-row box
constexpr int kVectorBytes = kTile * 4;              // 64 fp32 or int32 of a streamed tile
// Registers. An SM's register file is four parts of 16,384, one per warp
// scheduler, and a block's warps go round them in turn, so a ninth warp
// beside eight consumer warps puts three warps on one part and caps every
// thread at 170 registers ("too many resources requested for launch" above
// that; ptxas compiles __launch_bounds__(288, 1) at 168, as for 384
// threads). setmaxnreg evens that out after the launch: it moves registers
// inside the block's own pool (384 threads x 168 registers = 2 x 128 x 208
// + 128 x 88), which is why the producer is a whole warpgroup, though one
// lane of its first warp starts the copies. With CUDA 12.8 ptxas gave the
// code after `setmaxnreg.inc` 188 registers whatever count it named (208 to
// 248 tried), so the consumers are written to fit that, 64 x D of
// accumulator at a time (flash_bwd.cu), and the producer keeps the rest: at
// 40 registers its pointers and tensor-map addresses spilled.
constexpr int kConsumerRegs = 208;
constexpr int kProducerRegs = 88;

constexpr size_t kMaxBlockSmem = 232448;  // what a block may use on sm_90

// Shared-memory plan of a block for head_dim D, from a 1024-byte boundary:
// kResidentTensors resident 128-row tensors (Q for the forward; K and V, or
// Q and dO, for the backward), kRing stages of two streamed tensors of
// kStreamRows rows (K and V, or Q and dO) and up to three vectors of
// kStreamRows 4-byte values (segment ids, LSE, delta), the resident rows'
// segment ids, the barriers, then the other side's per-tile segment-id
// ranges (one per 64 rows).
template <int D, int kResidentTensors, int kStreamRows = kTile, int kRing = kStages>
struct BlockPlan {
  static constexpr int kBoxes = D / 64;
  static constexpr int kBox = kStreamRows * kRowBytes;  // one streamed box
  static constexpr int kResident = kBoxes * kResidentBox;
  static constexpr int kStreamed = kBoxes * kBox;
  static constexpr int kStage = 2 * kStreamed + 1024;
  static constexpr int kVectors = 2 * kStreamed;  // offset inside a stage
  static constexpr int kStagesAt = kResidentTensors * kResident;
  static constexpr int kBlockSegAt = kStagesAt + kRing * kStage;
  static constexpr int kBarriersAt = kBlockSegAt + kBlockRows * 4;
  static constexpr int kRangesAt = kBarriersAt + 64;
  // plus 1024 to reach the boundary and 8 bytes per range
  static constexpr int kFixedBytes = kRangesAt + 1024;
  static constexpr int kRingStages = kRing;
};

// at D 256 the backward's two resident tensors leave room for one stage
template <int D>
using BwdPlan = BlockPlan<D, 2, kTile, (D > 128 ? 1 : kStages)>;

// The head_dim a block's accumulator covers (kDim) and the blocks a head's
// output is split across (kParts): D itself up to 128; at 256 two halves
// of 128. Part `part` of a head writes columns part * kDim .., and reads
// them from a streamed tile kDim / 64 boxes after its start.
template <int D>
struct OutSplit {
  static constexpr int kDim = D > 128 ? 128 : D;
  static constexpr int kParts = D / kDim;
  static constexpr int kBoxes = kDim / 64;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------- mbarriers

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// one arrival that also announces `bytes` of asynchronous copies
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the barrier's phase of this parity has completed. A wait of
// seconds means a lost arrival or a copy that never came: trap, so that the
// launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - start > 8000000000LL) __trap();
}

// ------------------------------------------------------------------- TMA

// one box of a (D, H, S, B) map at (d0, head, row, batch) into shared memory
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int d0, int head, int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d0), "r"(head), "r"(row), "r"(batch)
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16, both sides 16-byte aligned)
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// ----------------------------------------------------------------- wgmma

template <int N>
__device__ __forceinline__ void set_max_registers_up() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void set_max_registers_down() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving or copying registers that an asynchronous
// product still reads or writes across this point
template <int N>
__device__ __forceinline__ void fence_registers(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t smem_descriptor(uint32_t addr, uint32_t leading_bytes,
                                                    uint32_t stride_bytes) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(leading_bytes >> 4) << 16) |
         ((uint64_t)(stride_bytes >> 4) << 32) | ((uint64_t)1 << 62);
}

// K-major operand (rows 128 bytes apart, the contraction along a row); the
// leading offset is not used by a swizzled K-major layout
__device__ __forceinline__ uint64_t k_major_descriptor(uint32_t addr) {
  return smem_descriptor(addr, 16, 8 * kRowBytes);
}

// descriptor units to add for k step kk (16 elements) of a K-major operand
// whose boxes are `box_bytes` apart
__device__ __forceinline__ uint64_t k_major_step(int kk, int box_bytes) {
  return (uint64_t)(((kk >> 2) * box_bytes + (kk & 3) * 32) >> 4);
}

// MN-major B operand: a streamed tile read with the contraction along its
// rows; n 64..127 lies one box (`box_bytes`) further
__device__ __forceinline__ uint64_t mn_major_descriptor(uint32_t addr, uint32_t box_bytes) {
  return smem_descriptor(addr, box_bytes, 8 * kRowBytes);
}

// descriptor units to add for k step kk (16 rows) of an MN-major operand
__device__ __forceinline__ uint64_t mn_major_step(int kk) {
  return (uint64_t)((kk * 16 * kRowBytes) >> 4);
}

#define FLASH_ACC8(d, i)                                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define FLASH_ACC32(d, i) \
  FLASH_ACC8(d, i), FLASH_ACC8(d, i + 8), FLASH_ACC8(d, i + 16), FLASH_ACC8(d, i + 24)

#define FLASH_ACC16(d, i) FLASH_ACC8(d, i), FLASH_ACC8(d, i + 8)

// d (64 x 32 fp32) = or += A (shared, K-major) x B^T (shared, K-major), k 16
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : FLASH_ACC16(d, 0)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64 fp32) = or += A (shared, K-major) x B^T (shared, K-major), k 16
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : FLASH_ACC32(d, 0)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64 fp32) += A (registers, bf16) x B (shared, MN-major), k 16
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : FLASH_ACC32(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 128 fp32) += A (registers, bf16) x B (shared, MN-major), k 16
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : FLASH_ACC32(d, 0), FLASH_ACC32(d, 32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 128 fp32) = or += A (shared, K-major) x B^T (shared, K-major), k 16
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b,
                                              int accumulate) {
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
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : FLASH_ACC32(d, 0), FLASH_ACC32(d, 32)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x N) = or += A (shared) x B^T (shared), both K-major, N 32, 64 or 128
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b,
                                         int accumulate) {
  if constexpr (N == 32) {
    wgmma_ss_n32(d, a, b, accumulate);
  } else if constexpr (N == 64) {
    wgmma_ss_n64(d, a, b, accumulate);
  } else {
    wgmma_ss_n128(d, a, b, accumulate);
  }
}

// acc (64 x D) += A (registers) x the streamed tile at `b` read MN-major
template <int D>
__device__ __forceinline__ void wgmma_rs(float (&acc)[D / 2], const uint32_t (&a)[4],
                                         uint64_t b) {
  if constexpr (D == 64) {
    wgmma_rs_n64(acc, a, b);
  } else {
    wgmma_rs_n128(acc, a, b);
  }
}

__device__ __forceinline__ uint32_t pack_pair(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The register-A fragments of a 64 x N accumulator, rounded to bf16: N / 16
// k steps of 16 columns
template <int N>
__device__ __forceinline__ void accumulator_as_a(uint32_t (&a)[N / 16][4],
                                                 const float (&s)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[kk][i] = pack_pair(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
}

// tile_visible of flash_common.cuh for spans of any height: q rows
// q_lo .. q_lo + q_rows - 1 (q_offset included) against kv rows
// k_lo .. k_lo + k_rows - 1, by position and by the spans' segment-id ranges
__device__ __forceinline__ bool span_visible(int q_lo, int q_rows, int k_lo, int k_rows,
                                             int causal, int window, int2 q_range,
                                             int2 k_range) {
  if (causal && k_lo > q_lo + q_rows - 1) return false;
  if (window > 0 && q_lo - (k_lo + k_rows - 1) >= window) return false;
  return q_range.y > 0 && q_range.x <= k_range.y && k_range.x <= q_range.y;
}

// ------------------------------------------------ the ring and the block

// dynamic shared memory from the next 1024-byte boundary (what the swizzle
// of the TMA boxes and of the wgmma descriptors is anchored to)
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

// The barriers at `bars` (shared address): full[s] at 8 s, empty[s] at
// 8 (kStages + s), the resident tiles' at 16 kStages.
__device__ __forceinline__ uint32_t full_barrier(uint32_t bars, int stage) {
  return bars + 8 * stage;
}

__device__ __forceinline__ uint32_t empty_barrier(uint32_t bars, int stage) {
  return bars + 8 * (kStages + stage);
}

__device__ __forceinline__ uint32_t resident_barrier(uint32_t bars) {
  return bars + 16 * kStages;
}

// one thread, before the block's __syncthreads
__device__ __forceinline__ void init_barriers(uint32_t bars) {
  for (int s = 0; s < kStages; ++s) {
    mbar_init(full_barrier(bars, s), 1);                  // the producer's announcement
    mbar_init(empty_barrier(bars, s), kConsumers * 128);  // every consumer thread
  }
  mbar_init(resident_barrier(bars), 1);
  mbar_init_fence();
}

// where a role stands in a ring of kRing stages (at most kStages); the
// producer waits for `empty` with the opposite parity, so its first round
// passes on fresh barriers
template <int kRing>
struct RingOf {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void advance() {
    if (++stage == kRing) {
      stage = 0;
      phase ^= 1;
    }
  }
};

template <int N>
__device__ __forceinline__ void zero(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = 0.f;
}

// registers that the next product overwrites (its first step does not
// accumulate): defined for the compiler at no instruction
template <int N>
__device__ __forceinline__ void overwritten(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "=f"(x[i]));
}

// out (64 x N) = A (64 rows of a resident tensor, K-major) x B^T (N rows of
// a streamed tile of kStreamRows rows from shared address `rows`, K-major),
// over head_dim D
template <int D, int N, int kStreamRows = kTile>
__device__ __forceinline__ void product_over_d(float (&out)[N / 2], uint64_t resident_desc,
                                               uint32_t rows) {
  const uint64_t streamed_desc = k_major_descriptor(rows);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<N>(out, resident_desc + k_major_step(kk, kResidentBox),
                streamed_desc + k_major_step(kk, kStreamRows * kRowBytes), kk > 0);
}

// acc (64 x D) += A (a 64 x N tile as register fragments) x N rows of a
// streamed tile of kStreamRows rows from shared address `rows`, read MN-major
template <int D, int N, int kStreamRows = kTile>
__device__ __forceinline__ void product_over_rows(float (&acc)[D / 2],
                                                  const uint32_t (&a)[N / 16][4], uint32_t rows) {
  const uint64_t desc = mn_major_descriptor(rows, kStreamRows * kRowBytes);
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) wgmma_rs<D>(acc, a[kk], desc + mn_major_step(kk));
}

// ------------------------------------------------------------ arithmetic

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// tanh from one ex2 and one approximate division, no subroutine call (the
// library's tanhf and a full-precision division bring calls whose register
// needs, beside the accumulators', made the compiler spill): (1 - e) /
// (1 + e) with e = exp(-2 |x|). Absolute
// error ~1e-7, so relative error ~1e-7 / |x| for small x: the capped score
// is off by ~1e-7 cap, far under its bf16 inputs' rounding.
__device__ __forceinline__ float fast_tanh(float x) {
  const float e = fast_exp2(-2.f * kLog2e * fabsf(x));
  return copysignf(__fdividef(1.f - e, 1.f + e), x);
}

// The soft cap as a pair (cap, 1 / cap), the reciprocal taken on the host;
// cap 0 means none.
struct SoftCap {
  float cap, inverse;
};

inline SoftCap soft_cap_of(float cap) { return SoftCap{cap, cap > 0.f ? 1.f / cap : 0.f}; }

// Whether the kRows ids at `ids` (shared memory) are one document's: all
// equal and not padding. The same answer in every lane of the warp.
template <int kRows>
__device__ __forceinline__ bool one_document(const int* ids, int lane) {
  static_assert(kRows % 32 == 0, "one_document reads whole warps of ids");
  const int first = ids[0];
  bool same = first > 0;
#pragma unroll
  for (int i = 0; i < kRows / 32; ++i) same = same && ids[lane + 32 * i] == first;
  return __all_sync(0xffffffffu, same);
}

// max / sum over the 4 lanes (t) that hold one row's columns of an
// accumulator
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// a lane's rows of a 64 x D accumulator to global memory as bf16; `out`
// points at row 0, column 0 of the lane's warpgroup tile
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* __restrict__ out, size_t row_stride,
                                           const float (&acc)[D / 2], int row0, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    __nv_bfloat16* row = out + (size_t)(row0 + 8 * r) * row_stride + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
}

// the same rows in fp32, unrounded (K1's output for ring attention, whose
// chunk partials merge before the one rounding to bf16)
template <int D>
__device__ __forceinline__ void store_rows(float* __restrict__ out, size_t row_stride,
                                           const float (&acc)[D / 2], int row0, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float* row = out + (size_t)(row0 + 8 * r) * row_stride + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(row + 8 * j) = make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
}

// ------------------------------------------------------------- host side

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, which lives in libcuda: the library links no
// -lcuda, so the runtime hands out its address; null when there is none
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* entry = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &entry, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      entry = nullptr;
    return reinterpret_cast<EncodeTiledFn>(entry);
  }();
  return fn;
}

// The map of a contiguous [batch, seq, heads, head_dim] bf16 tensor whose box
// is `rows` rows of 64 elements of one head, 128-byte swizzled. A map holds
// the pointer and the shape, so the launch functions encode theirs per call
// (host work of a few microseconds). Returns a cudaError_t.
inline int head_tile_map(CUtensorMap* map, const void* base, int batch, int seq, int heads,
                         int head_dim, int rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)head_dim, (cuuint64_t)heads, (cuuint64_t)seq,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)head_dim * 2, (cuuint64_t)heads * head_dim * 2,
                                 (cuuint64_t)seq * heads * head_dim * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t element_strides[4] = {1, 1, 1, 1};
  const CUresult result = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
      element_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return result == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// the tile maps of a launch: `q_rows`-row boxes of q (and dout, when
// given) and `kv_rows`-row boxes of k and v, for whichever side a block
// keeps (128 rows) or streams (64)
struct TileMaps {
  CUtensorMap q, k, v, dout;
};

template <int D>
int encode_maps(TileMaps* maps, const void* q, const void* k, const void* v, const void* dout,
                int batch, int sq, int skv, int hq, int hkv, int q_rows, int kv_rows) {
  int err = head_tile_map(&maps->q, q, batch, sq, hq, D, q_rows);
  if (!err && dout != nullptr) err = head_tile_map(&maps->dout, dout, batch, sq, hq, D, q_rows);
  if (!err) err = head_tile_map(&maps->k, k, batch, skv, hkv, D, kv_rows);
  if (!err) err = head_tile_map(&maps->v, v, batch, skv, hkv, D, kv_rows);
  return err;
}

// what the bulk copies of 256-byte vectors take: 16-byte aligned sources
inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace flash
