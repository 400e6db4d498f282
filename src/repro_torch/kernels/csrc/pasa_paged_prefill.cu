// PASA chunked prefill over a paged KV pool, for Hopper (sm_90a): pages
// of 1 to 128 rows of bf16 and fp16 pools.
//
// Replaces the TPU kernel repro/kernels/pasa_paged_prefill.py
// (_paged_prefill_kernel, launched by paged_prefill_kernel_call through
// pl.pallas_call) at those pages; the kernel, its design and what bounds
// it are pasa_paged_prefill.cuh's.  Its instances: the 128-row page
// tile in two modes (several pages a stage up to 32 rows a page, one page
// a stage over 32) x four wgmma kinds x three head widths x two pools
// (48);
// 8-bit pools build in pasa_paged_prefill_q8.cu, pages of 129 to 256
// rows in pasa_paged_prefill_wide.cu and pasa_paged_prefill_wide_q8.cu,
// all in parallel.

#include "pasa_paged_prefill.cuh"

// Plain C entry point (bound with ctypes): pasa::prefill_entry's
// arguments, page 1 to 128, bf16 or fp16 pools.
extern "C" int pasa_paged_prefill_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* k_shift, const void* v_scale,
    const void* v_shift, const void* page_table, const void* chunk_start,
    const void* kv_len, void* out, int batch, int heads, int kv_heads,
    int head_dim, int chunk, int page, int max_pages, int num_pages,
    int pool_kind, float beta, float inva, float shift_scale,
    float post_scale, int stat_half, int acc_half, int score_half,
    int op_bf16, void* stream) {
  return pasa::prefill_entry<false, true, false>(
      q, k_pages, v_pages, k_scale, k_shift, v_scale, v_shift, page_table,
      chunk_start, kv_len, out, batch, heads, kv_heads, head_dim, chunk, page,
      max_pages, num_pages, pool_kind, beta, inva, shift_scale, post_scale,
      stat_half, acc_half, score_half, op_bf16, stream);
}

#ifdef PASA_PREFILL_SPANS
// The kernel's cycle spans (pasa_paged_prefill.cuh, 2 x 16 counters)
// copied to `host`, then zeroed; launch/prefill_spans.py reads them.
extern "C" int pasa_paged_prefill_spans(unsigned long long* host) {
  cudaError_t err = cudaMemcpyFromSymbol(host, pasa::pasa_prefill_spans,
                                         sizeof(pasa::pasa_prefill_spans));
  if (err != cudaSuccess) return (int)err;
  static const unsigned long long zero[2][16] = {};
  return (int)cudaMemcpyToSymbol(pasa::pasa_prefill_spans, zero, sizeof zero);
}
#endif
