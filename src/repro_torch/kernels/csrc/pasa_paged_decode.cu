// PASA flash-decode over a paged KV pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/pasa_paged_decode.py
// (_paged_decode_kernel, launched by paged_decode_kernel_call through
// pl.pallas_call), in both of its modes: raw pools (bf16, fp16) and
// quantized pools (int8 or fp8 e4m3 codes with per-page sidecars).
//
// What it computes: one new token per sequence; the GQA group's G query
// heads are the rows; each page is one PASA block (page_size == block_kv).
// Policies: fp16 and fp16_fp32, fp32 (fp32 scores) and bf16_fp32 (bf16
// operands and output, fp32 scores), each an instance of the template
// (pasa_common.cuh Mode); pages convert or dequantize once to the input
// dtype.  Head widths 32, 64 and 128, each an instance too (D threads per
// CTA, one per head-dim column: pasa_decode_block.cuh).
//
// Design: the cluster kernel of pasa_decode_cluster.cuh with block j =
// page table[b, j] (PagedBlocks): the pages of a (sequence, kv-head) are
// spread over a cluster of 8 CTAs, reduced to per-page partials in
// parallel (the next page's bytes and sidecars arrive by cp.async behind
// the current page's math) and folded exactly in page order.  The
// contiguous decode kernel (pasa_decode.cu) instantiates the same
// template over a strided cache, and its sequential walk is the on-card
// oracle of both, bit for bit.  One launch per call.
//
// What bounds it on an H100: latency.  The bytes (each live K/V row once,
// 2 x D x 2 bytes per kv-head and position for bf16, half that for 8-bit
// codes) take ~1-2 us at 3.35 TB/s; the block math is G dot products of D
// for each of its page / D key rows and G sums of `page` products per
// thread out of shared memory, ~2,000 dependent-chain FMAs per thread per
// page at either width.  The cluster
// cuts the pages a CTA walks by 8 (a 1,000-token sequence: one page per
// CTA), and B x KVH x 8 CTAs fill the SMs (128 at the serve's batch 4).
// What remains is one page's latency, the fold's n_live dependent
// row_update steps and the barrier.

#include "pasa_decode_cluster.cuh"

namespace pasa {

template <typename PoolT, int D>
static int launch_at(const void* q, const void* k_pages, const void* v_pages,
                     const SidecarPtrs& sc, const void* page_table,
                     const void* kv_len, void* out, void* workspace, int batch,
                     int kv_heads, int G, int page, int max_pages, int mode,
                     const Policy& P, cudaStream_t stream) {
  PagedBlocks<PoolT, D> A;
  A.k = static_cast<const PoolT*>(k_pages);
  A.v = static_cast<const PoolT*>(v_pages);
  A.sc = sc;
  A.table = static_cast<const int*>(page_table);
  A.block = page;
  A.max_blocks = max_pages;
  A.kv_heads = kv_heads;
  return launch_cluster(q, A, kv_len, out, workspace, batch, kv_heads, G,
                        mode, P, stream);
}

template <typename PoolT>
static int launch(const void* q, const void* k_pages, const void* v_pages,
                  const SidecarPtrs& sc, const void* page_table,
                  const void* kv_len, void* out, void* workspace, int batch,
                  int kv_heads, int G, int head_dim, int page, int max_pages,
                  int mode, const Policy& P, cudaStream_t stream) {
#define PASA_PAGED_AT(D)                                                     \
  launch_at<PoolT, D>(q, k_pages, v_pages, sc, page_table, kv_len, out,      \
                      workspace, batch, kv_heads, G, page, max_pages, mode, \
                      P, stream)
  switch (head_dim) {
    case 32: return PASA_PAGED_AT(32);
    case 64: return PASA_PAGED_AT(64);
    default: return PASA_PAGED_AT(128);
  }
#undef PASA_PAGED_AT
}

}  // namespace pasa

// Plain C entry point (bound with ctypes).  head_dim is 32, 64 or 128.  The
// four sidecar pointers are read only for an 8-bit pool_kind (PoolKind).
// q and out are at the policy's input dtype (bf16 if op_bf16, else fp16),
// scores at fp16 if score_half (else fp32).  `workspace` holds
// batch * kv_heads * max_pages * group * (head_dim + 3) floats (the
// pages' partials).  Returns the cudaError_t of the launch; 0 means it
// was queued on `stream`.
extern "C" int pasa_paged_decode_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* k_shift, const void* v_scale,
    const void* v_shift, const void* page_table, const void* kv_len, void* out,
    void* workspace, int batch, int kv_heads, int group, int head_dim,
    int page, int max_pages, int pool_kind, float beta, float inva,
    float shift_scale, float post_scale, int stat_half, int acc_half,
    int score_half, int op_bf16, void* stream) {
  using namespace pasa;
  const int mode = mode_id(score_half, op_bf16);
  if (group < 1 || group > DEC_MAX_G || page < 1 || page > DEC_PAGE_ROWS ||
      batch < 1 || batch > 65535 || kv_heads < 1 || kv_heads > 65535 ||
      max_pages < 1 || !workspace || mode < 0 || !head_dim_built(head_dim))
    return (int)cudaErrorInvalidValue;
  const bool quant = pool_kind == POOL_INT8 || pool_kind == POOL_FP8;
  if (quant && !(k_scale && k_shift && v_scale && v_shift))
    return (int)cudaErrorInvalidValue;
  const Policy P = make_policy(beta, inva, shift_scale, post_scale, stat_half, acc_half);
  const SidecarPtrs sc = {
      {static_cast<const float*>(k_scale), static_cast<const float*>(v_scale)},
      {static_cast<const float*>(k_shift), static_cast<const float*>(v_shift)}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (pool_kind) {
    case POOL_FP16:
      return launch<__half>(q, k_pages, v_pages, sc, page_table, kv_len, out,
                            workspace, batch, kv_heads, group, head_dim,
                            page, max_pages, mode, P, s);
    case POOL_BF16:
      return launch<__nv_bfloat16>(q, k_pages, v_pages, sc, page_table, kv_len,
                                   out, workspace, batch, kv_heads, group,
                                   head_dim, page, max_pages, mode, P, s);
    case POOL_INT8:
      return launch<int8_t>(q, k_pages, v_pages, sc, page_table, kv_len, out,
                            workspace, batch, kv_heads, group, head_dim,
                            page, max_pages, mode, P, s);
    case POOL_FP8:
      return launch<__nv_fp8_e4m3>(q, k_pages, v_pages, sc, page_table, kv_len,
                                   out, workspace, batch, kv_heads, group,
                                   head_dim, page, max_pages, mode, P, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
