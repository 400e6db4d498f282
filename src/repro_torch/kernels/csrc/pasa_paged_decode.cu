// PASA flash-decode over a paged KV pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/pasa_paged_decode.py
// (_paged_decode_kernel, launched by paged_decode_kernel_call through
// pl.pallas_call), raw pools only.
//
// What it computes: one new token per sequence; the GQA group's G query
// heads are the rows.  One CTA per (sequence, kv-head) walks that
// sequence's live pages IN ORDER through the page table: the F-bar
// recurrence of PASA is order-dependent, so a split-KV combine would
// change the result (it would be a new convention).  Each page is one
// PASA block (page_size == block_kv), folded by decode_block_update, the
// function the contiguous decode kernel shares.  Pages past kv_len are
// skipped.
//
// What bounds it on an H100: bytes.  Each live page is read once (K and V,
// 2 x page x 128 x 2 bytes per kv-head); the arithmetic is ~4 G flops per
// byte read, far below the card's ~295 flops/byte ridge.  The design reads
// the pool at its own dtype (bf16) with 16-byte loads and converts to fp16
// in registers, instead of casting the whole pool layer per call as the
// reference's ops.py does, so the pool is read once and never copied.  It
// is the simple version: B x KVH CTAs (16 at batch 4) leave most SMs idle
// and the scores use scalar fp32 FMAs; a faster version would split heads
// or pages across more CTAs without reordering the F-bar recurrence.

#include "pasa_decode_block.cuh"

namespace pasa {

template <typename PoolT>
__global__ void __launch_bounds__(DEC_THREADS)
paged_decode_kernel(const __half* __restrict__ q,       // (B, KVH, G, D)
                    const PoolT* __restrict__ k_pages,  // (P, page, KVH, D)
                    const PoolT* __restrict__ v_pages,
                    const int* __restrict__ page_table, // (B, max_pages)
                    const int* __restrict__ kv_len,     // (B,)
                    __half* __restrict__ out,           // (B, KVH, G, D)
                    int kv_heads, int G, int page, int max_pages, Policy P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DecodeSmem& S = *reinterpret_cast<DecodeSmem*>(smem_raw);
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int t = threadIdx.x;

  const __half* qbh = q + ((size_t)b * kv_heads + h) * G * HEAD_DIM;
  for (int g = 0; g < G; ++g) S.q[g][t] = qbh[g * HEAD_DIM + t];
  float acc[DEC_MAX_G];
  decode_state_init(S, acc);

  const int L = kv_len[b];
  const int n_live = L > 0 ? min(max_pages, (L + page - 1) / page) : 0;
  // 16-byte loads: thread t moves 8 elements of row (t / 16) + 8i.
  const int r0 = t >> 4;
  const int c8 = (t & 15) * 8;
  for (int j = 0; j < n_live; ++j) {
    const int pid = page_table[b * max_pages + j];
    const int valid = min(page, L - j * page);
    __syncthreads();  // the previous page is fully consumed
    for (int r = r0; r < page; r += DEC_THREADS / 16) {
      const size_t off = (((size_t)pid * page + r) * kv_heads + h) * HEAD_DIM + c8;
      const uint4 kk = load8_half(k_pages + off);
      const __half2* k2 = reinterpret_cast<const __half2*>(&kk);
      __half2* kd = reinterpret_cast<__half2*>(&S.k[r][c8]);
#pragma unroll
      for (int i = 0; i < 4; ++i) kd[i] = k2[i];
      uint4 vv = make_uint4(0u, 0u, 0u, 0u);  // rows past kv_len: zeros
      if (r < valid) vv = load8_half(v_pages + off);
      *reinterpret_cast<uint4*>(&S.v[r][c8]) = vv;
    }
    __syncthreads();
    decode_block_update(S, valid, page, G, j, P, acc);
  }
  __syncthreads();

  __half* obh = out + ((size_t)b * kv_heads + h) * G * HEAD_DIM;
#pragma unroll
  for (int g = 0; g < DEC_MAX_G; ++g) {
    if (g < G) {
      // O = acc / l at the accumulator dtype, stored at fp16
      obh[g * HEAD_DIM + t] =
          __float2half_rn(rnd(__fdiv_rn(acc[g], S.l[g]), P.acc_half));
    }
  }
}

template <typename PoolT>
static int launch(const void* q, const void* k_pages, const void* v_pages,
                  const void* page_table, const void* kv_len, void* out,
                  int batch, int kv_heads, int G, int page, int max_pages,
                  const Policy& P, cudaStream_t stream) {
  const size_t smem = sizeof(DecodeSmem);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<PoolT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(batch, kv_heads);
  paged_decode_kernel<PoolT><<<grid, DEC_THREADS, smem, stream>>>(
      static_cast<const __half*>(q), static_cast<const PoolT*>(k_pages),
      static_cast<const PoolT*>(v_pages), static_cast<const int*>(page_table),
      static_cast<const int*>(kv_len), static_cast<__half*>(out), kv_heads, G,
      page, max_pages, P);
  return (int)cudaGetLastError();
}

}  // namespace pasa

// Plain C entry point (bound with ctypes).  Returns the cudaError_t of the
// launch; 0 means it was queued on `stream`.
extern "C" int pasa_paged_decode_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_table, const void* kv_len, void* out, int batch,
    int kv_heads, int group, int page, int max_pages, int pool_is_bf16,
    float beta, float inva, float shift_scale, float post_scale, int stat_half,
    int acc_half, void* stream) {
  using namespace pasa;
  if (group < 1 || group > DEC_MAX_G || page < 1 || page > DEC_MAX_BLOCK ||
      batch < 1 || kv_heads < 1 || max_pages < 1)
    return (int)cudaErrorInvalidValue;
  const Policy P = make_policy(beta, inva, shift_scale, post_scale, stat_half, acc_half);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pool_is_bf16)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, page_table, kv_len, out,
                                 batch, kv_heads, group, page, max_pages, P, s);
  return launch<__half>(q, k_pages, v_pages, page_table, kv_len, out, batch,
                        kv_heads, group, page, max_pages, P, s);
}
