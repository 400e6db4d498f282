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
// Two entry points:
//  * pasa_decode_launch, the main path: the cluster kernel of
//    pasa_decode_cluster.cuh with block j = rows [j * block, (j + 1) *
//    block) of the strided cache (StridedBlocks) - a cluster of 8 CTAs per
//    (sequence, kv-head) reduces the blocks to partials in parallel and
//    folds them exactly in order; the paged decode kernel is the same
//    template over a page pool.
//  * pasa_decode_walk_launch, the on-card oracle only (tests and
//    chip_smoke.py; no wrapper calls it): one CTA per (sequence,
//    kv-head) walks the blocks in order through decode_block_update.
//    Both cluster kernels equal it bit for bit.
//
// Head widths 64 and 128, each an instance of the templates (the D of
// pasa_decode_block.cuh: D threads per CTA, one per head-dim column).
//
// What bounds it on an H100: latency.  Each live K and V row is read once
// (2 x D x 2 bytes per kv-head and position, ~1 us at 3.35 TB/s for a
// 1,000-token batch of 4 at D 128, KVH 4), but the walk's B x KVH CTAs
// (16 at batch 4, KVH 4) fold their blocks one after another, each
// block a few thousand dependent shared-memory loads and FMAs per thread;
// the cluster runs 8 times as many CTAs, each on 1/8 of the blocks, and
// leaves the fold's n_blocks dependent row_update steps.

#include "pasa_decode_cluster.cuh"

namespace pasa {

template <typename CacheT, int NG, typename M, int D>
__global__ void __launch_bounds__(D, 1)
contiguous_decode_kernel(const typename M::Op* __restrict__ q,  // (B,KVH,G,D)
                         const CacheT* __restrict__ k,    // (B, KVH, S2, D)
                         const CacheT* __restrict__ v,    //   strided
                         const int* __restrict__ kv_len,  // (B,)
                         typename M::Op* __restrict__ out,  // (B, KVH, G, D)
                         int kv_heads, int G, int s2, int block,
                         long long sb, long long sh, long long ss, Policy P) {
  using OpT = typename M::Op;
  using Smem = DecodeSmem<OpT, DEC_MAX_BLOCK, D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& S = *reinterpret_cast<Smem*>(smem_raw);
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int t = threadIdx.x;

  const OpT* qbh = q + ((size_t)b * kv_heads + h) * G * D;
  for (int g = 0; g < G; ++g) S.q[g][t] = qbh[g * D + t];
  float acc[NG];
  decode_state_init<NG>(S, acc);

  const int L = max(0, min(kv_len[b], s2));
  const int n_blocks = (L + block - 1) / block;
  const CacheT* kbh = k + b * sb + h * sh;
  const CacheT* vbh = v + b * sb + h * sh;
  // 16-byte loads: thread t moves 8 elements of row t / (D / 8) + 8i.
  constexpr int C8 = D / 8;
  const int r0 = t / C8;
  const int c8 = (t % C8) * 8;
  for (int j = 0; j < n_blocks; ++j) {
    const int valid = min(block, L - j * block);
    __syncthreads();  // the previous block is fully consumed
    for (int r = r0; r < block; r += D / C8) {
      uint4 kk = make_uint4(0u, 0u, 0u, 0u);   // rows past kv_len: zeros
      uint4 vv = make_uint4(0u, 0u, 0u, 0u);
      if (r < valid) {
        const long long off = (long long)(j * block + r) * ss + c8;
        kk = load8_op<OpT>(kbh + off);
        vv = load8_op<OpT>(vbh + off);
      }
      const uint32_t* k2 = reinterpret_cast<const uint32_t*>(&kk);
      uint32_t* kd = reinterpret_cast<uint32_t*>(&S.k[r][c8]);
#pragma unroll
      for (int i = 0; i < 4; ++i) kd[i] = k2[i];
      *reinterpret_cast<uint4*>(&S.v[r][c8]) = vv;
    }
    __syncthreads();
    decode_block_update<NG, M>(S, valid, block, G, j, P, acc);
  }
  __syncthreads();

  OpT* obh = out + ((size_t)b * kv_heads + h) * G * D;
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    if (g < G) {
      // O = acc / l at the accumulator dtype, stored at the output dtype
      obh[g * D + t] =
          from_float<OpT>(rnd(__fdiv_rn(acc[g], S.l[g]), P.acc_half));
    }
  }
}

template <typename CacheT, int NG, typename M, int D>
static int walk_rows(const void* q, const void* k, const void* v,
                     const void* kv_len, void* out, int batch, int kv_heads,
                     int G, int s2, int block, long long sb, long long sh,
                     long long ss, const Policy& P, cudaStream_t stream) {
  using OpT = typename M::Op;
  const size_t smem = sizeof(DecodeSmem<OpT, DEC_MAX_BLOCK, D>);
  cudaError_t err = cudaFuncSetAttribute(
      contiguous_decode_kernel<CacheT, NG, M, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(batch, kv_heads);
  contiguous_decode_kernel<CacheT, NG, M, D><<<grid, D, smem, stream>>>(
      static_cast<const OpT*>(q), static_cast<const CacheT*>(k),
      static_cast<const CacheT*>(v), static_cast<const int*>(kv_len),
      static_cast<OpT*>(out), kv_heads, G, s2, block, sb, sh, ss, P);
  return (int)cudaGetLastError();
}

template <typename CacheT, typename M, int D>
static int walk_mode(const void* q, const void* k, const void* v,
                     const void* kv_len, void* out, int batch, int kv_heads,
                     int G, int s2, int block, long long sb, long long sh,
                     long long ss, const Policy& P, cudaStream_t stream) {
  if (G <= dec_rows(1))
    return walk_rows<CacheT, dec_rows(1), M, D>(q, k, v, kv_len, out, batch,
                                                kv_heads, G, s2, block, sb, sh,
                                                ss, P, stream);
  return walk_rows<CacheT, DEC_MAX_G, M, D>(q, k, v, kv_len, out, batch,
                                            kv_heads, G, s2, block, sb, sh, ss,
                                            P, stream);
}

template <typename CacheT, int D>
static int walk(const void* q, const void* k, const void* v,
                const void* kv_len, void* out, int batch, int kv_heads,
                int G, int s2, int block, long long sb, long long sh,
                long long ss, int mode, const Policy& P, cudaStream_t stream) {
#define PASA_WALK(M)                                                          \
  walk_mode<CacheT, M, D>(q, k, v, kv_len, out, batch, kv_heads, G, s2, block, \
                          sb, sh, ss, P, stream)
  switch (mode) {
    case MODE_F16: return PASA_WALK(ModeF16);
    case MODE_F32: return PASA_WALK(ModeF32);
    case MODE_BF16: return PASA_WALK(ModeBF16);
    default: return (int)cudaErrorInvalidValue;
  }
#undef PASA_WALK
}

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

// Plain C entry points (bound with ctypes).  head_dim is 64 or 128.
// Strides are in elements, for the (batch, kv-head, row) dims shared by k
// and v; q and out are at the policy's input dtype (bf16 if op_bf16, else
// fp16), scores at fp16 if score_half (else fp32).  Each returns the
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
      s2 < 1 || !workspace || mode < 0 || (head_dim != 64 && head_dim != 128))
    return (int)cudaErrorInvalidValue;
  const Policy P = make_policy(beta, inva, shift_scale, post_scale, stat_half,
                               acc_half);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PASA_CLUSTER(T, D)                                                   \
  cluster<T, D>(q, k, v, kv_len, out, workspace, batch, kv_heads, group, s2, \
                block, sb, sh, ss, mode, P, s)
  if (cache_is_bf16)
    return head_dim == 64 ? PASA_CLUSTER(__nv_bfloat16, 64)
                          : PASA_CLUSTER(__nv_bfloat16, 128);
  return head_dim == 64 ? PASA_CLUSTER(__half, 64) : PASA_CLUSTER(__half, 128);
#undef PASA_CLUSTER
}

// The sequential walk, the oracle of the cluster kernels on the card: the
// arguments of pasa_decode_launch without the workspace.
extern "C" int pasa_decode_walk_launch(
    const void* q, const void* k, const void* v, const void* kv_len,
    void* out, int batch, int kv_heads, int group, int head_dim, int s2,
    int block, long long sb, long long sh, long long ss, int cache_is_bf16,
    float beta, float inva, float shift_scale, float post_scale,
    int stat_half, int acc_half, int score_half, int op_bf16, void* stream) {
  using namespace pasa;
  const int mode = mode_id(score_half, op_bf16);
  if (group < 1 || group > DEC_MAX_G || block < 1 || block > DEC_MAX_BLOCK ||
      batch < 1 || kv_heads < 1 || s2 < 1 || mode < 0 ||
      (head_dim != 64 && head_dim != 128))
    return (int)cudaErrorInvalidValue;
  const Policy P = make_policy(beta, inva, shift_scale, post_scale, stat_half,
                               acc_half);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PASA_WALK_AT(T, D)                                                  \
  walk<T, D>(q, k, v, kv_len, out, batch, kv_heads, group, s2, block, sb, sh, \
             ss, mode, P, s)
  if (cache_is_bf16)
    return head_dim == 64 ? PASA_WALK_AT(__nv_bfloat16, 64)
                          : PASA_WALK_AT(__nv_bfloat16, 128);
  return head_dim == 64 ? PASA_WALK_AT(__half, 64) : PASA_WALK_AT(__half, 128);
#undef PASA_WALK_AT
}
