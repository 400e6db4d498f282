// PASA flash-decode over a paged KV pool or a contiguous cache, for
// Hopper (sm_90a): the launch helpers and entry bodies, shared by one
// source a pool type so that they compile in parallel -
// pasa_paged_decode.cu (bf16 pools and caches), pasa_paged_decode_fp16.cu
// (fp16 pools and caches), pasa_paged_decode_int8.cu and
// pasa_paged_decode_fp8.cu (8-bit codes with sidecars).
//
// Replaces two TPU kernels: repro/kernels/pasa_paged_decode.py
// (_paged_decode_kernel, launched by paged_decode_kernel_call through
// pl.pallas_call), in both of its modes - raw pools (bf16, fp16) and
// quantized pools (int8 or fp8 e4m3 codes with per-page sidecars) - and
// repro/kernels/pasa_decode.py (_decode_kernel / masked_block_update,
// launched by decode_kernel_call through pl.pallas_call) over a contiguous
// cache.
//
// What it computes: one new token per sequence; the GQA group's G query
// heads are the rows; the PASA blocks are `block` rows (a multiple of 16
// up to 256) of the sequence's page-table view, whatever the page size, as
// the reference's served decode shifts in blocks of block_kv over the
// gathered pages; a page is any size of 1 row or more.  Contiguous decode
// cuts its cache into the same blocks up to kv_len (the reference's
// default block is 256) and reads it in its stored layout and dtype (the
// dense route's (B, S2, KVH, D) bf16 cache, seen as (B, KVH, S2, D)
// through strides), converted to the policy's input dtype on chip: no
// per-step transpose, cast or pad copy.  Convention (shift_mask_valid):
// the algebraic valid-column shift with the ideal invariance beta / (1 -
// beta); rows at or past kv_len are never read, so stale or non-finite
// bytes there are inert.
// Policies: fp16 and fp16_fp32, fp32 (fp32 scores) and bf16_fp32 (bf16
// operands and output, fp32 scores), each an instance of the template
// (pasa_common.cuh Mode); pages convert or dequantize once to the input
// dtype.  Head widths 32, 64 and 128, each an instance too (D threads per
// CTA, one per head-dim column: pasa_decode_block.cuh).
//
// Design: the split kernel of pasa_decode_split.cuh over DecodeBlocks
// (block j = view rows [j * block, (j + 1) * block), each row read from
// its own page, an 8-bit row dequantized with its own page's sidecars):
// each live block of a (sequence, kv-head) is reduced to its partials by a
// CTA of its own, several CTAs an SM, and the last of the pair's CTAs to
// finish folds them exactly in block order.  Contiguous decode is the
// same instances over a strided cache seen as one page a sequence
// (contiguous_decode_entry below; its C entries pasa_decode_launch in
// pasa_paged_decode.cu for bf16 caches, pasa_decode_fp16_launch in
// pasa_paged_decode_fp16.cu for fp16), so paged decode at (page p, block
// b) equals contiguous decode at block b on the same rows bit for bit for
// every p, and the sequential walk (pasa_decode_walk.cu) is the on-card
// oracle of both.  One launch per call.
//
// What bounds it on an H100: latency.  The bytes (each live K/V row once,
// 2 x D x 2 bytes per kv-head and position for bf16, half that for 8-bit
// codes, and the sidecars of each page) take ~1-2 us at 3.35 TB/s; the
// block math is G dot products of D for each of its block / D key rows
// and G sums of `block` products per thread out of shared memory.  With
// a CTA a live block, a call's critical path is one block's load and
// math, the ticket, and the fold's n_live dependent row_update steps; the
// CTAs of a call at many kv heads and small groups (the hybrid's 128
// pairs of one block, olmoe's 64 pairs) fit the card's 2 (D 128) or 3-4
// (D 64) CTAs an SM in one or two waves.  A page smaller than the block
// costs more addresses (one page id per page, staged once a piece), not
// more bytes; an 8-bit pool's small pages cost a sidecar set a page, and
// pages under 4 rows shorter pieces.

#pragma once

#include "pasa_decode_split.cuh"

namespace pasa {

// Blocks of up to 128 rows in the 128-row tile - for an 8-bit pool only
// where every block lies inside one page (its one staged sidecar set) -
// the rest in the 256-row tile (pasa_decode_split.cuh's note).
template <typename PoolT, int D>
static int launch_at(DecodeView<PoolT, D> view, const DecodeCall& c) {
  view.max_blocks = (int)(((long long)view.max_pages * view.page +
                           view.block - 1) / view.block);
  const bool narrow = view.block <= DEC_PAGE_ROWS &&
                      (!kIsCode<PoolT> || view.page % view.block == 0);
  if (narrow) {
    DecodeBlocks<PoolT, D, DEC_PAGE_ROWS> A;
    static_cast<DecodeView<PoolT, D>&>(A) = view;
    return launch_decode(A, c);
  }
  DecodeBlocks<PoolT, D, DEC_MAX_BLOCK> A;
  static_cast<DecodeView<PoolT, D>&>(A) = view;
  return launch_decode(A, c);
}

// The view at head width `head_dim` (32, 64 or 128): element c of row r
// of page id p, kv-head h at p * ps + r * rs + h * hs + c; `table` null
// reads page b for sequence b.
template <typename PoolT>
static int launch(const void* k, const void* v, const SidecarPtrs& sc,
                  const void* table, long long ps, long long rs, long long hs,
                  int head_dim, int page, int max_pages, int block,
                  const DecodeCall& c) {
  auto at = [&](auto view) {
    view.k = static_cast<const PoolT*>(k);
    view.v = static_cast<const PoolT*>(v);
    view.sc = sc;
    view.table = static_cast<const int*>(table);
    view.ps = ps;
    view.rs = rs;
    view.hs = hs;
    view.block = block;
    view.page = page;
    view.max_pages = max_pages;
    view.kv_heads = c.kv_heads;
    return launch_at(view, c);
  };
  switch (head_dim) {
    case 32: return at(DecodeView<PoolT, 32>{});
    case 64: return at(DecodeView<PoolT, 64>{});
    default: return at(DecodeView<PoolT, 128>{});
  }
}

static DecodeCall decode_call(const void* q, const void* kv_len, void* out,
                              void* workspace, void* tickets, int batch,
                              int kv_heads, int group, int mode,
                              const Policy& P, void* stream) {
  DecodeCall c;
  c.q = q;
  c.kv_len = kv_len;
  c.out = out;
  c.workspace = workspace;
  c.tickets = static_cast<int*>(tickets);
  c.batch = batch;
  c.kv_heads = kv_heads;
  c.G = group;
  c.mode = mode;
  c.P = P;
  c.stream = static_cast<cudaStream_t>(stream);
  c.query = nullptr;
  return c;
}

// The body of the paged C entry points (bound with ctypes), one a pool
// type PoolT (pool_kind must name it).  head_dim is 32, 64 or 128.  The
// four sidecar pointers are read only for an 8-bit pool.  q and out are
// at the policy's input dtype (bf16 if op_bf16, else fp16), scores at
// fp16 if score_half (else fp32).  `block` (1 to 256) is the PASA block in
// rows of the page-table view, `page` (1 or more) the rows of a page.
// `workspace` holds batch * kv_heads * ceil(max_pages * page / block) *
// group * (head_dim + 3) floats (the blocks' partials), `tickets` batch *
// kv_heads int32 that are 0 (every launch leaves them so; calls that may
// run at once need buffers of their own).  Returns the cudaError_t of the
// launch; 0 means it was queued on `stream`.
template <typename PoolT>
static int paged_decode_entry(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* k_shift, const void* v_scale,
    const void* v_shift, const void* page_table, const void* kv_len, void* out,
    void* workspace, void* tickets, int batch, int kv_heads, int group,
    int head_dim, int page, int max_pages, int block, int pool_kind,
    float beta, float inva, float shift_scale, float post_scale,
    int stat_half, int acc_half, int score_half, int op_bf16, void* stream) {
  const int mode = mode_id(score_half, op_bf16);
  constexpr int kind = kIsCode<PoolT>
                           ? (std::is_same<PoolT, int8_t>::value ? POOL_INT8
                                                                 : POOL_FP8)
                           : (std::is_same<PoolT, __half>::value ? POOL_FP16
                                                                 : POOL_BF16);
  if (pool_kind != kind || group < 1 || group > DEC_MAX_G || page < 1 ||
      max_pages < 1 || (long long)max_pages * page > 0x7fffffff ||
      block < 1 || block > DEC_MAX_BLOCK || batch < 1 || batch > 65535 ||
      kv_heads < 1 || kv_heads > 65535 || !workspace || !tickets ||
      mode < 0 || !head_dim_built(head_dim))
    return (int)cudaErrorInvalidValue;
  if (kIsCode<PoolT> && !(k_scale && k_shift && v_scale && v_shift))
    return (int)cudaErrorInvalidValue;
  const Policy P = make_policy(beta, inva, shift_scale, post_scale, stat_half,
                               acc_half);
  const SidecarPtrs sc = {
      {static_cast<const float*>(k_scale), static_cast<const float*>(v_scale)},
      {static_cast<const float*>(k_shift), static_cast<const float*>(v_shift)}};
  const long long rs = (long long)kv_heads * head_dim;
  return launch<PoolT>(k_pages, v_pages, sc, page_table, page * rs, rs,
                       head_dim, head_dim, page, max_pages, block,
                       decode_call(q, kv_len, out, workspace, tickets, batch,
                                   kv_heads, group, mode, P, stream));
}

// The body of the contiguous C entry points: one new token a sequence
// against its (B, KVH, S2, D) cache of CacheT (bf16 if cache_is_bf16, else
// fp16; cache_is_bf16 must name CacheT), read through the element strides
// sb, sh, ss of its (batch, kv-head, row) dims, shared by k and v.  The
// rest as paged_decode_entry; `workspace` holds batch * kv_heads *
// ceil(s2 / block) * group * (head_dim + 3) floats.
template <typename CacheT>
static int contiguous_decode_entry(
    const void* q, const void* k, const void* v, const void* kv_len,
    void* out, void* workspace, void* tickets, int batch, int kv_heads,
    int group, int head_dim, int s2, int block, long long sb, long long sh,
    long long ss, int cache_is_bf16, float beta, float inva,
    float shift_scale, float post_scale, int stat_half, int acc_half,
    int score_half, int op_bf16, void* stream) {
  const int mode = mode_id(score_half, op_bf16);
  if (cache_is_bf16 != (int)std::is_same<CacheT, __nv_bfloat16>::value ||
      group < 1 || group > DEC_MAX_G || block < 1 || block > DEC_MAX_BLOCK ||
      batch < 1 || batch > 65535 || kv_heads < 1 || kv_heads > 65535 ||
      s2 < 1 || !workspace || !tickets || mode < 0 ||
      !head_dim_built(head_dim))
    return (int)cudaErrorInvalidValue;
  const Policy P = make_policy(beta, inva, shift_scale, post_scale, stat_half,
                               acc_half);
  const SidecarPtrs none = {{nullptr, nullptr}, {nullptr, nullptr}};
  return launch<CacheT>(k, v, none, nullptr, sb, ss, sh, head_dim, s2, 1,
                        block,
                        decode_call(q, kv_len, out, workspace, tickets, batch,
                                    kv_heads, group, mode, P, stream));
}

// The instance a paged call of this pool type (or a contiguous call from
// a cache of it) at (head_dim, group, page, block) and the policy mode
// (score_half, op_bf16) launches: out[0] its dynamic shared-memory bytes,
// out[1] its resident CTAs an SM on the current device.  Sets the
// instance's attributes as its first launch would; launches nothing.
template <typename PoolT>
static int decode_occupancy_entry(int head_dim, int group, int page,
                                  int block, int score_half, int op_bf16,
                                  int* out) {
  const int mode = mode_id(score_half, op_bf16);
  if (!out || group < 1 || group > DEC_MAX_G || page < 1 || block < 1 ||
      block > DEC_MAX_BLOCK || mode < 0 || !head_dim_built(head_dim))
    return (int)cudaErrorInvalidValue;
  DecodeCall c = decode_call(nullptr, nullptr, nullptr, nullptr, nullptr, 1,
                             1, group, mode, Policy{}, nullptr);
  c.query = out;
  const SidecarPtrs none = {{nullptr, nullptr}, {nullptr, nullptr}};
  return launch<PoolT>(nullptr, nullptr, none, nullptr, 0, 0, 0, head_dim,
                       page, 1, block, c);
}

}  // namespace pasa
