// The first paged-decode kernel for bf16 q and fp32 pools (paged_decode_fp32.cuh);
// the entry point is paged_decode.cu's `paged_decode_launch`.

#include "paged_decode_fp32.cuh"

int paged_decode_bf16_fp32(int head_dim, const void* q, const void* k_pool, const void* v_pool,
                           const int* tables, const int* lens, void* out, int batch,
                           int num_kv_heads, int group, int page, int pages_per_row, float scale,
                           float cap, int window, cudaStream_t s) {
  return launch_typed<__nv_bfloat16, float>(head_dim, q, k_pool, v_pool, tables, lens, out, batch,
                                            num_kv_heads, group, page, pages_per_row, scale, cap, window,
                                            s);
}
