// PASA flash-decode over a paged KV pool, for Hopper (sm_90a): the
// launch helpers and entry body, shared by one source a pool type so that
// they compile in parallel - pasa_paged_decode.cu (bf16 pools),
// pasa_paged_decode_fp16.cu, pasa_paged_decode_int8.cu and
// pasa_paged_decode_fp8.cu (8-bit codes with sidecars).
//
// Replaces the TPU kernel repro/kernels/pasa_paged_decode.py
// (_paged_decode_kernel, launched by paged_decode_kernel_call through
// pl.pallas_call), in both of its modes: raw pools (bf16, fp16) and
// quantized pools (int8 or fp8 e4m3 codes with per-page sidecars).
//
// What it computes: one new token per sequence; the GQA group's G query
// heads are the rows; the PASA blocks are `block` rows (a multiple of 16
// up to 256) of the sequence's page-table view, whatever the page size, as
// the reference's served decode shifts in blocks of block_kv over the
// gathered pages; a page is any size of 1 row or more.
// Policies: fp16 and fp16_fp32, fp32 (fp32 scores) and bf16_fp32 (bf16
// operands and output, fp32 scores), each an instance of the template
// (pasa_common.cuh Mode); pages convert or dequantize once to the input
// dtype.  Head widths 32, 64 and 128, each an instance too (D threads per
// CTA, one per head-dim column: pasa_decode_block.cuh).
//
// Design: the cluster kernel of pasa_decode_cluster.cuh with block j =
// view rows [j * block, (j + 1) * block) (PagedBlocks: each row read from
// its own page, an 8-bit row dequantized with its own page's sidecars):
// the blocks of a (sequence, kv-head) are spread over a cluster of 8
// CTAs, reduced to per-block partials in parallel (the next piece's bytes
// and sidecars arrive by cp.async behind the current block's math) and
// folded exactly in block order.  The contiguous decode kernel
// (pasa_decode.cu) instantiates the same template over a strided cache,
// so paged decode at (page p, block b) equals contiguous decode at block
// b on the same rows bit for bit for every p, and the sequential walk is
// the on-card oracle of both.  One launch per call.
//
// What bounds it on an H100: latency.  The bytes (each live K/V row once,
// 2 x D x 2 bytes per kv-head and position for bf16, half that for 8-bit
// codes, and the sidecars of each page) take ~1-2 us at 3.35 TB/s; the
// block math is G dot products of D for each of its block / D key rows
// and G sums of `block` products per thread out of shared memory, ~2,000
// dependent-chain FMAs per thread per 128-row block at either width.  The
// cluster cuts the blocks a CTA walks by 8 (a 1,000-token sequence at
// block 128: one block per CTA), and B x KVH x 8 CTAs fill the SMs (128 at
// the serve's batch 4).  What remains is one block's latency, the fold's
// n_live dependent row_update steps and the barrier.  A page smaller than
// the block costs more addresses (one page id per page, staged once a
// piece), not more bytes; an 8-bit pool's small pages cost a sidecar set
// a page, and pages under 4 rows shorter pieces.

#pragma once

#include "pasa_decode_cluster.cuh"

namespace pasa {

template <typename PoolT, int D, int MAXB>
static int launch_tile(const void* q, const void* k_pages,
                       const void* v_pages, const SidecarPtrs& sc,
                       const void* page_table, const void* kv_len, void* out,
                       void* workspace, int batch, int kv_heads, int G,
                       int page, int max_pages, int block, int mode,
                       const Policy& P, cudaStream_t stream) {
  PagedBlocks<PoolT, D, MAXB> A;
  A.k = static_cast<const PoolT*>(k_pages);
  A.v = static_cast<const PoolT*>(v_pages);
  A.sc = sc;
  A.table = static_cast<const int*>(page_table);
  A.block = block;
  A.page = page;
  A.max_pages = max_pages;
  A.max_blocks = (int)(((long long)max_pages * page + block - 1) / block);
  A.kv_heads = kv_heads;
  return launch_cluster(q, A, kv_len, out, workspace, batch, kv_heads, G,
                        mode, P, stream);
}

// Blocks of up to 128 rows in the 128-row tile - for an 8-bit pool only
// where every block lies inside one page (its one staged sidecar set) -
// the rest in the 256-row tile (pasa_decode_cluster.cuh's note).
template <typename PoolT, int D>
static int launch_at(const void* q, const void* k_pages, const void* v_pages,
                     const SidecarPtrs& sc, const void* page_table,
                     const void* kv_len, void* out, void* workspace, int batch,
                     int kv_heads, int G, int page, int max_pages, int block,
                     int mode, const Policy& P, cudaStream_t stream) {
#define PASA_PAGED_TILE(MAXB)                                                \
  launch_tile<PoolT, D, MAXB>(q, k_pages, v_pages, sc, page_table, kv_len,   \
                              out, workspace, batch, kv_heads, G, page,      \
                              max_pages, block, mode, P, stream)
  const bool narrow =
      block <= DEC_PAGE_ROWS && (!kIsCode<PoolT> || page % block == 0);
  return narrow ? PASA_PAGED_TILE(DEC_PAGE_ROWS)
                : PASA_PAGED_TILE(DEC_MAX_BLOCK);
#undef PASA_PAGED_TILE
}

template <typename PoolT>
static int launch(const void* q, const void* k_pages, const void* v_pages,
                  const SidecarPtrs& sc, const void* page_table,
                  const void* kv_len, void* out, void* workspace, int batch,
                  int kv_heads, int G, int head_dim, int page, int max_pages,
                  int block, int mode, const Policy& P, cudaStream_t stream) {
#define PASA_PAGED_AT(D)                                                     \
  launch_at<PoolT, D>(q, k_pages, v_pages, sc, page_table, kv_len, out,      \
                      workspace, batch, kv_heads, G, page, max_pages, block, \
                      mode, P, stream)
  switch (head_dim) {
    case 32: return PASA_PAGED_AT(32);
    case 64: return PASA_PAGED_AT(64);
    default: return PASA_PAGED_AT(128);
  }
#undef PASA_PAGED_AT
}

// The body of the C entry points (bound with ctypes), one a pool type
// PoolT (pool_kind must name it).  head_dim is 32, 64 or 128.  The four
// sidecar pointers are read only for an 8-bit pool.  q and out are at the
// policy's input dtype (bf16 if op_bf16, else fp16), scores at fp16 if
// score_half (else fp32).  `block` (1 to 256) is the PASA block in rows
// of the page-table view, `page` (1 or more) the rows of a page.
// `workspace` holds batch * kv_heads * ceil(max_pages * page / block) *
// group * (head_dim + 3) floats (the blocks' partials).  Returns the
// cudaError_t of the launch; 0 means it was queued on `stream`.
template <typename PoolT>
static int paged_decode_entry(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* k_shift, const void* v_scale,
    const void* v_shift, const void* page_table, const void* kv_len, void* out,
    void* workspace, int batch, int kv_heads, int group, int head_dim,
    int page, int max_pages, int block, int pool_kind, float beta, float inva,
    float shift_scale, float post_scale, int stat_half, int acc_half,
    int score_half, int op_bf16, void* stream) {
  const int mode = mode_id(score_half, op_bf16);
  constexpr int kind = kIsCode<PoolT>
                           ? (std::is_same<PoolT, int8_t>::value ? POOL_INT8
                                                                 : POOL_FP8)
                           : (std::is_same<PoolT, __half>::value ? POOL_FP16
                                                                 : POOL_BF16);
  if (pool_kind != kind || group < 1 || group > DEC_MAX_G || page < 1 ||
      max_pages < 1 || (long long)max_pages * page > 0x7fffffff ||
      block < 1 || block > DEC_MAX_BLOCK || batch < 1 || batch > 65535 ||
      kv_heads < 1 || kv_heads > 65535 || !workspace || mode < 0 ||
      !head_dim_built(head_dim))
    return (int)cudaErrorInvalidValue;
  if (kIsCode<PoolT> && !(k_scale && k_shift && v_scale && v_shift))
    return (int)cudaErrorInvalidValue;
  const Policy P = make_policy(beta, inva, shift_scale, post_scale, stat_half,
                               acc_half);
  const SidecarPtrs sc = {
      {static_cast<const float*>(k_scale), static_cast<const float*>(v_scale)},
      {static_cast<const float*>(k_shift), static_cast<const float*>(v_shift)}};
  return launch<PoolT>(q, k_pages, v_pages, sc, page_table, kv_len, out,
                       workspace, batch, kv_heads, group, head_dim, page,
                       max_pages, block, mode, P,
                       static_cast<cudaStream_t>(stream));
}

}  // namespace pasa
