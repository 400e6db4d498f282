// PASA flash-decode over a paged KV pool, for Hopper (sm_90a): fp8
// e4m3 pools (codes with per-page sidecars).
//
// Replaces the TPU kernel repro/kernels/pasa_paged_decode.py
// (_paged_decode_kernel, launched by paged_decode_kernel_call through
// pl.pallas_call) for those pools; the kernel, its design and what
// bounds it are pasa_paged_decode.cuh's and pasa_decode_split.cuh's.
// One source a pool type, so that the four compile in parallel: 36
// instances each (two block tiles x three head widths x three policy
// modes x two group layouts).

#include "pasa_paged_decode.cuh"

// Plain C entry point (bound with ctypes): pasa::paged_decode_entry's
// arguments.
extern "C" int pasa_paged_decode_fp8_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* k_shift, const void* v_scale,
    const void* v_shift, const void* page_table, const void* kv_len, void* out,
    void* workspace, void* tickets, int batch, int kv_heads, int group,
    int head_dim, int page, int max_pages, int block, int pool_kind,
    float beta, float inva, float shift_scale, float post_scale,
    int stat_half, int acc_half, int score_half, int op_bf16, void* stream) {
  return pasa::paged_decode_entry<__nv_fp8_e4m3>(
      q, k_pages, v_pages, k_scale, k_shift, v_scale, v_shift, page_table,
      kv_len, out, workspace, tickets, batch, kv_heads, group, head_dim, page,
      max_pages, block, pool_kind, beta, inva, shift_scale, post_scale,
      stat_half, acc_half, score_half, op_bf16, stream);
}

// The instance a call at these arguments launches (bound with ctypes):
// pasa::decode_occupancy_entry's.
extern "C" int pasa_paged_decode_fp8_occupancy(
    int head_dim, int group, int page, int block, int score_half, int op_bf16,
    int* out) {
  return pasa::decode_occupancy_entry<__nv_fp8_e4m3>(
      head_dim, group, page, block, score_half, op_bf16, out);
}
