// PASA chunked prefill over a paged KV pool, for Hopper (sm_90a): pages
// of 129 to 256 rows.
//
// Replaces the TPU kernel repro/kernels/pasa_paged_prefill.py
// (_paged_prefill_kernel, launched by paged_prefill_kernel_call through
// pl.pallas_call) at those pages: one page is one PASA block of up to 256
// rows, wider than a ring stage of the 128-row tile.  The kernel is
// pasa_paged_prefill.cuh's at BKV 256 (its note: one 256-row stage, the
// scores in two halves of 128 columns, the second pass recomputing them
// at the page's maxima), here over int8 and fp8 e4m3 pools.  A source of
// its own so that its 24 instances (four wgmma kinds x three head widths
// x two pools) compile beside the other prefill sources.

#include "pasa_paged_prefill.cuh"

// Plain C entry point (bound with ctypes): pasa::prefill_entry's
// arguments, page 129 to 256, 8-bit pools.
extern "C" int pasa_paged_prefill_wide_q8_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* k_shift, const void* v_scale,
    const void* v_shift, const void* page_table, const void* chunk_start,
    const void* kv_len, void* out, int batch, int heads, int kv_heads,
    int head_dim, int chunk, int page, int max_pages, int num_pages,
    int pool_kind, float beta, float inva, float shift_scale,
    float post_scale, int stat_half, int acc_half, int score_half,
    int op_bf16, void* stream) {
  return pasa::prefill_entry<true, false, true>(
      q, k_pages, v_pages, k_scale, k_shift, v_scale, v_shift, page_table,
      chunk_start, kv_len, out, batch, heads, kv_heads, head_dim, chunk, page,
      max_pages, num_pages, pool_kind, beta, inva, shift_scale, post_scale,
      stat_half, acc_half, score_half, op_bf16, stream);
}
