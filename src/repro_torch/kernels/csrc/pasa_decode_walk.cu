// The sequential walk of PASA flash-decode over a CONTIGUOUS KV cache,
// for Hopper (sm_90a): the on-card oracle of both decode ops' split kernel
// (pasa_decode_split.cuh, over a strided cache or a page pool), which
// equals it bit for bit.  Only the card tests and
// chip_smoke.py reach it (kernels.pasa_decode._walk_call); no wrapper
// calls it or falls back to it.  It replaces no TPU kernel of its own: it
// is the reference's sequential grid over the blocks (repro/kernels/
// pasa_decode.py, _decode_kernel), kept to hold the split over blocks, and
// sits in a source of its own so that its instances build beside the
// main path's, not after them.
//
// One CTA per (sequence, kv-head) walks the blocks of `block` rows up to
// kv_len in order through decode_block_update (pasa_decode_block.cuh):
// the block's partials, then the fold.  Inputs, policies, head widths
// (32, 64 and 128: D threads per CTA) and rules (rows at or past kv_len
// never read) are contiguous decode's (pasa_paged_decode.cuh).

#include "pasa_decode_block.cuh"

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
  using Smem = DecodeSmem<OpT, DEC_MAX_BLOCK, D, NG>;
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
  const size_t smem = sizeof(DecodeSmem<OpT, DEC_MAX_BLOCK, D, NG>);
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

}  // namespace pasa

// Plain C entry point (bound with ctypes): the arguments of
// pasa_decode_launch (pasa_paged_decode.cu) without the workspace and the
// tickets.  Returns the
// cudaError_t of the launch (0: queued on `stream`).
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
      !head_dim_built(head_dim))
    return (int)cudaErrorInvalidValue;
  const Policy P = make_policy(beta, inva, shift_scale, post_scale, stat_half,
                               acc_half);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PASA_WALK_AT(T, D)                                                  \
  walk<T, D>(q, k, v, kv_len, out, batch, kv_heads, group, s2, block, sb, sh, \
             ss, mode, P, s)
  if (cache_is_bf16)
    return head_dim == 32   ? PASA_WALK_AT(__nv_bfloat16, 32)
           : head_dim == 64 ? PASA_WALK_AT(__nv_bfloat16, 64)
                            : PASA_WALK_AT(__nv_bfloat16, 128);
  return head_dim == 32   ? PASA_WALK_AT(__half, 32)
         : head_dim == 64 ? PASA_WALK_AT(__half, 64)
                          : PASA_WALK_AT(__half, 128);
#undef PASA_WALK_AT
}
