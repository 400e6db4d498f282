// PASA flash-decode over a CONTIGUOUS KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/pasa_decode.py (_decode_kernel /
// masked_block_update, launched by decode_kernel_call through
// pl.pallas_call).
//
// What it computes: one new token per sequence against its dense cache;
// the GQA group's G query heads are the rows; the cache is cut into
// blocks of `block` rows up to kv_len, a multiple of 16 up to 256 (the
// reference's default block is 256; a block of more than 128 rows
// reaches the cluster kernel's shared memory in pieces of 128, and its
// math runs once over all its rows).  Convention (shift_mask_valid): the
// algebraic valid-column shift with the ideal invariance beta / (1 -
// beta).
//
// The cache is read in its stored layout and dtype (the dense route's
// (B, S2, KVH, D) bf16 cache, seen as (B, KVH, S2, D) through strides)
// and converted to the policy's input dtype on chip (fp16; none for a bf16
// cache under bf16_fp32): no per-step transpose, cast or pad copy.
//
// Policies: fp16 and fp16_fp32 (fp16 operands and scores), fp32 (fp16
// operands, fp32 scores) and bf16_fp32 (bf16 operands and output, fp32
// scores); statistics and accumulator at fp16 or fp32 - each policy mode
// an instance of the template (pasa_common.cuh Mode).
// Rows at or past kv_len are never read (their K and V enter shared
// memory as zeros), so stale or non-finite bytes there are inert and a
// cache whose length is not a multiple of the block needs no pad.
//
// The entry point, pasa_decode_launch: the cluster kernel of
// pasa_decode_cluster.cuh with block j = rows [j * block, (j + 1) * block)
// of the strided cache (StridedBlocks) - a cluster of 8 CTAs per
// (sequence, kv-head) reduces the blocks to partials in parallel and
// folds them exactly in order; the paged decode kernel is the same
// template over a page pool.  Its on-card oracle, the sequential walk, is
// a source of its own (pasa_decode_walk.cu): both cluster kernels equal
// it bit for bit.
//
// Head widths 32, 64 and 128, each an instance of the templates (the D of
// pasa_decode_block.cuh: D threads per CTA, one per head-dim column).
//
// What bounds it on an H100: latency.  Each live K and V row is read once
// (2 x D x 2 bytes per kv-head and position, ~1 us at 3.35 TB/s for a
// 1,000-token batch of 4 at D 128, KVH 4), but a walk's B x KVH CTAs (16
// at batch 4, KVH 4) would fold their blocks one after another, each
// block a few thousand dependent shared-memory loads and FMAs per thread;
// the cluster runs 8 times as many CTAs, each on 1/8 of the blocks, and
// leaves the fold's n_blocks dependent row_update steps.

#include "pasa_decode_cluster.cuh"

namespace pasa {

template <typename CacheT, int D>
static int cluster(const void* q, const void* k, const void* v,
                   const void* kv_len, void* out, void* workspace, int batch,
                   int kv_heads, int G, int s2, int block, long long sb,
                   long long sh, long long ss, int mode, const Policy& P,
                   cudaStream_t stream) {
  StridedBlocks<CacheT, D> A;
  A.k = static_cast<const CacheT*>(k);
  A.v = static_cast<const CacheT*>(v);
  A.sb = sb;
  A.sh = sh;
  A.ss = ss;
  A.block = block;
  A.max_blocks = (s2 + block - 1) / block;
  A.s2 = s2;
  return launch_cluster(q, A, kv_len, out, workspace, batch, kv_heads, G,
                        mode, P, stream);
}

}  // namespace pasa

// Plain C entry point (bound with ctypes).  head_dim is 32, 64 or 128.
// Strides are in elements, for the (batch, kv-head, row) dims shared by k
// and v; q and out are at the policy's input dtype (bf16 if op_bf16, else
// fp16), scores at fp16 if score_half (else fp32).  Returns the
// cudaError_t of the launch (0: queued on `stream`).  `workspace` holds
// batch * kv_heads * ceil(s2 / block) * group * (head_dim + 3) floats (the
// blocks' partials).
extern "C" int pasa_decode_launch(
    const void* q, const void* k, const void* v, const void* kv_len,
    void* out, void* workspace, int batch, int kv_heads, int group,
    int head_dim, int s2, int block, long long sb, long long sh, long long ss,
    int cache_is_bf16, float beta, float inva, float shift_scale,
    float post_scale, int stat_half, int acc_half, int score_half,
    int op_bf16, void* stream) {
  using namespace pasa;
  const int mode = mode_id(score_half, op_bf16);
  if (group < 1 || group > DEC_MAX_G || block < 1 || block > DEC_MAX_BLOCK ||
      batch < 1 || batch > 65535 || kv_heads < 1 || kv_heads > 65535 ||
      s2 < 1 || !workspace || mode < 0 || !head_dim_built(head_dim))
    return (int)cudaErrorInvalidValue;
  const Policy P = make_policy(beta, inva, shift_scale, post_scale, stat_half,
                               acc_half);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PASA_CLUSTER(T, D)                                                   \
  cluster<T, D>(q, k, v, kv_len, out, workspace, batch, kv_heads, group, s2, \
                block, sb, sh, ss, mode, P, s)
  if (cache_is_bf16)
    return head_dim == 32   ? PASA_CLUSTER(__nv_bfloat16, 32)
           : head_dim == 64 ? PASA_CLUSTER(__nv_bfloat16, 64)
                            : PASA_CLUSTER(__nv_bfloat16, 128);
  return head_dim == 32   ? PASA_CLUSTER(__half, 32)
         : head_dim == 64 ? PASA_CLUSTER(__half, 64)
                          : PASA_CLUSTER(__half, 128);
#undef PASA_CLUSTER
}
