// PASA chunked prefill over a paged KV pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/pasa_paged_prefill.py
// (_paged_prefill_kernel / _chunk_block_update, launched by
// paged_prefill_kernel_call through pl.pallas_call), raw pools only.
//
// What it computes: one prompt chunk of full-head queries (B, H, CS, D)
// against paged K/V under the chunk-exact convention (see
// pasa_chunk_block.cuh).  Each of the B rows carries its own chunk start,
// valid length and page-table row, so one call advances chunks of several
// requests; a pad row with kv_len == 0 folds no page and emits zeros.
// One CTA per (b * H + head, 64-row query tile) walks the pages the tile
// can see in order - pages past kv_len or wholly in the tile's causal
// future are skipped - with the running state in shared memory and
// registers.
//
// What bounds it on an H100: operations.  A tile of 64 rows re-reads each
// visible page once, so for a 512-token chunk the bytes are a few MB per
// layer while the two GEMMs are ~4 x rows x cols x 128 flops; the tensor
// cores do both GEMMs (WMMA, fp16 in, fp32 sum), and the per-row softmax
// steps that the fp16 policy must round one by one run on the CUDA cores,
// one warp per row.  It is the simple version: no TMA, no pipelining of
// the next page's loads behind the current page's math, and one CTA per
// SM at ~140 KB of shared memory.

#include "pasa_chunk_block.cuh"

namespace pasa {

template <typename PoolT>
__global__ void __launch_bounds__(PF_THREADS)
paged_prefill_kernel(const __half* __restrict__ q,        // (B, H, CS, D)
                     const PoolT* __restrict__ k_pages,   // (P, page, KVH, D)
                     const PoolT* __restrict__ v_pages,
                     const int* __restrict__ page_table,  // (B, max_pages)
                     const int* __restrict__ chunk_start, // (B,)
                     const int* __restrict__ kv_len,      // (B,)
                     __half* __restrict__ out,            // (B, H, CS, D)
                     int heads, int kv_heads, int chunk, int page,
                     int max_pages, Policy P) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  ChunkSmem& S = *reinterpret_cast<ChunkSmem*>(smem_raw);
  const int bh = blockIdx.x;
  const int tile = blockIdx.y;
  const int b = bh / heads;
  const int kvh = (bh % heads) / (heads / kv_heads);
  const int t = threadIdx.x;
  const int start = chunk_start[b];
  const int L = kv_len[b];
  const int row0 = start + tile * PF_BQ;

  // query tile -> shared memory (rows past the chunk are zeros)
  const __half* qb = q + ((size_t)bh * chunk + (size_t)tile * PF_BQ) * HEAD_DIM;
  const int r0 = t >> 4;
  const int c8 = (t & 15) * 8;
  for (int r = r0; r < PF_BQ; r += PF_THREADS / 16) {
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (tile * PF_BQ + r < chunk) v = load8_half(qb + (size_t)r * HEAD_DIM + c8);
    *reinterpret_cast<uint4*>(&S.q[r][c8]) = v;
  }
  float acc[PF_ACC];
  chunk_state_init(S, acc);

  // pages the tile can see: below kv_len and not wholly after its last row
  const int row_last = row0 + PF_BQ - 1;
  const int see = min(L, row_last + 1);
  const int n_live = see > 0 ? min(max_pages, (see + page - 1) / page) : 0;
  for (int j = 0; j < n_live; ++j) {
    const int pid = page_table[b * max_pages + j];
    const int col0 = j * page;
    const int valid = min(page, L - col0);
    __syncthreads();  // the previous page is fully consumed
    for (int r = r0; r < page; r += PF_THREADS / 16) {
      const size_t off = (((size_t)pid * page + r) * kv_heads + kvh) * HEAD_DIM + c8;
      *reinterpret_cast<uint4*>(&S.k[r][c8]) = load8_half(k_pages + off);
      uint4 vv = make_uint4(0u, 0u, 0u, 0u);  // rows past kv_len: zeros
      if (r < valid) vv = load8_half(v_pages + off);
      *reinterpret_cast<uint4*>(&S.v[r][c8]) = vv;
    }
    __syncthreads();
    chunk_block_update(S, row0, col0, valid, page, P, acc);
  }
  __syncthreads();

  // O = acc / l at the accumulator dtype; rows that folded nothing (l == 0)
  // emit 0, not 0/0.
  __half* ob = out + ((size_t)bh * chunk + (size_t)tile * PF_BQ) * HEAD_DIM;
#pragma unroll
  for (int i = 0; i < PF_ACC; ++i) {
    const int e = t + PF_THREADS * i;
    const int row = e / HEAD_DIM, col = e % HEAD_DIM;
    if (tile * PF_BQ + row < chunk) {
      const float l = S.l[row] > 0.0f ? S.l[row] : 1.0f;
      ob[(size_t)row * HEAD_DIM + col] =
          __float2half_rn(rnd(__fdiv_rn(acc[i], l), P.acc_half));
    }
  }
}

template <typename PoolT>
static int launch(const void* q, const void* k_pages, const void* v_pages,
                  const void* page_table, const void* chunk_start,
                  const void* kv_len, void* out, int batch, int heads,
                  int kv_heads, int chunk, int page, int max_pages,
                  const Policy& P, cudaStream_t stream) {
  const size_t smem = sizeof(ChunkSmem);
  cudaError_t err = cudaFuncSetAttribute(
      paged_prefill_kernel<PoolT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(batch * heads, (chunk + PF_BQ - 1) / PF_BQ);
  paged_prefill_kernel<PoolT><<<grid, PF_THREADS, smem, stream>>>(
      static_cast<const __half*>(q), static_cast<const PoolT*>(k_pages),
      static_cast<const PoolT*>(v_pages), static_cast<const int*>(page_table),
      static_cast<const int*>(chunk_start), static_cast<const int*>(kv_len),
      static_cast<__half*>(out), heads, kv_heads, chunk, page, max_pages, P);
  return (int)cudaGetLastError();
}

}  // namespace pasa

// Plain C entry point (bound with ctypes).  Returns the cudaError_t of the
// launch; 0 means it was queued on `stream`.
extern "C" int pasa_paged_prefill_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_table, const void* chunk_start, const void* kv_len,
    void* out, int batch, int heads, int kv_heads, int chunk, int page,
    int max_pages, int pool_is_bf16, float beta, float inva, float shift_scale,
    float post_scale, int stat_half, int acc_half, void* stream) {
  using namespace pasa;
  if (batch < 1 || heads < 1 || kv_heads < 1 || heads % kv_heads ||
      chunk < 1 || page < 16 || page > PF_MAX_PAGE || page % 16 ||
      max_pages < 1)
    return (int)cudaErrorInvalidValue;
  const Policy P = make_policy(beta, inva, shift_scale, post_scale, stat_half, acc_half);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pool_is_bf16)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, page_table, chunk_start,
                                 kv_len, out, batch, heads, kv_heads, chunk,
                                 page, max_pages, P, s);
  return launch<__half>(q, k_pages, v_pages, page_table, chunk_start, kv_len,
                        out, batch, heads, kv_heads, chunk, page, max_pages, P,
                        s);
}
