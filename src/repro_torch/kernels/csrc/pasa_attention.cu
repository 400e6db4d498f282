// Fused PASA attention over pre-shifted keys (Algorithm 1 lines 8-23), and
// the FlashAttention-2 baseline on the same tiling, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/pasa_attention.py (_attn_kernel,
// launched by attention_kernel_call through pl.pallas_call).
//
// What it computes: full-head queries q (B, H, S1, 128) against keys
// K' = M K already shifted and scaled by the shift kernel (B, KVH, S2,
// 128) and values v (B, KVH, S2, 128), all fp16 and read through their
// strides; GQA maps query head h to kv head h / (H / KVH), so K'/V are
// never expanded.  One CTA per (b * H + h, query tile of block_q rows)
// walks the key tiles IN ORDER - the F-bar recurrence is order-dependent
// - keeping m, l, F-bar and the accumulator at the policy's dtypes and
// ONE block count for the whole tile.  Per key tile:
//   1. S = Q K'^T on the tensor cores, stored at fp16 (the paper's
//      overflow point); at beta = 0 the 1/sqrt(d) scale follows the store
//      (FlashAttention-2, Eq. 2), so raw fp16 overflow is reproduced;
//   2. the row pseudo-average over ALL block_kv columns (the shift used
//      them all), an fp32 sum rounded once to the statistic dtype;
//   3. only then the causal mask; a tile wholly above the diagonal
//      ((i+1) * block_q - 1 < j * block_kv) is skipped and not counted;
//   4. the online recovery (row_update of pasa_common.cuh) and P V on the
//      tensor cores folded into the accumulator.
// With inva = 0 and beta = 0 it is the FlashAttention-2 baseline.
//
// What bounds it on an H100: operations.  The two GEMMs are 4 x S1 x S2 x
// 128 flops per head (halved by the causal skip) against q, K', V and O
// read or written once - at S = 1024 that is ~250 flops per byte on
// bytes that fit in L2.  The tensor cores (WMMA m16n16k16, fp16 in, fp32
// sum) do both GEMMs; the per-row softmax steps, which the fp16 policy
// must round one at a time, run on the CUDA cores, one warp per row.  It
// is the simple version: no TMA or wgmma, no pipelining of the next key
// tile behind the current tile's math, one CTA per SM at ~205 KB of
// shared memory.

#include <mma.h>

#include "pasa_common.cuh"

namespace pasa {

constexpr int AT_MAX_BQ = 128;
constexpr int AT_MAX_BKV = 128;
constexpr int AT_THREADS = 256;                 // 8 warps
constexpr int AT_WARPS = AT_THREADS / 32;
constexpr int AT_LDH = HEAD_DIM + 8;            // fp16 row stride (272 B)
constexpr int AT_LDF = HEAD_DIM + 4;            // fp32 row stride
constexpr int AT_ACC = AT_MAX_BQ * HEAD_DIM / AT_THREADS;  // acc per thread

struct AttnSmem {
  __half q[AT_MAX_BQ][AT_LDH];
  __half k[AT_MAX_BKV][AT_LDH];
  __half v[AT_MAX_BKV][AT_LDH];
  __half p[AT_MAX_BQ][AT_LDH];     // probabilities at fp16 (block_kv used)
  float s[AT_MAX_BQ][AT_LDF];      // fp32 GEMM results (scores, then PV)
  float m[AT_MAX_BQ], l[AT_MAX_BQ], f[AT_MAX_BQ];
  float e_prev[AT_MAX_BQ], e_cur[AT_MAX_BQ];
};

// rows x 128 fp16 tile from global (row stride `ld` elements) to shared.
__device__ __forceinline__ void load_tile(__half (*dst)[AT_LDH],
                                          const __half* src, long long ld,
                                          int rows) {
  for (int e = threadIdx.x; e < rows * (HEAD_DIM / 8); e += AT_THREADS) {
    const int r = e / (HEAD_DIM / 8), c8 = (e % (HEAD_DIM / 8)) * 8;
    *reinterpret_cast<uint4*>(&dst[r][c8]) =
        *reinterpret_cast<const uint4*>(src + r * ld + c8);
  }
}

__global__ void __launch_bounds__(AT_THREADS)
pasa_attention_kernel(const __half* __restrict__ q,   // (B, H, S1, D)
                      const __half* __restrict__ k,   // (B, KVH, S2, D) K'
                      const __half* __restrict__ v,   // (B, KVH, S2, D)
                      __half* __restrict__ out,       // (B, H, S1, D)
                      int heads, int kv_heads, int s1, int s2, int bq,
                      int bkv, int causal, long long qsb, long long qsh,
                      long long qss, long long ksb, long long ksh,
                      long long kss, long long vsb, long long vsh,
                      long long vss, Policy P) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  AttnSmem& S = *reinterpret_cast<AttnSmem*>(smem_raw);
  const int bh = blockIdx.x;
  const int i = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const int kh = h / (heads / kv_heads);
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const bool sh = P.stat_half;

  load_tile(S.q, q + b * qsb + h * qsh + (long long)i * bq * qss, qss, bq);
  if (t < AT_MAX_BQ) {
    S.m[t] = NEG_BIG;
    S.l[t] = 0.0f;
    S.f[t] = 0.0f;
  }
  float acc[AT_ACC];
#pragma unroll
  for (int e = 0; e < AT_ACC; ++e) acc[e] = 0.0f;

  const int n_kv = s2 / bkv;
  const int row_last = (i + 1) * bq - 1;
  const int n_live = causal ? min(n_kv, row_last / bkv + 1) : n_kv;
  const __half* kbase = k + b * ksb + kh * ksh;
  const __half* vbase = v + b * vsb + kh * vsh;
  for (int j = 0; j < n_live; ++j) {
    __syncthreads();   // the previous tile is fully consumed
    load_tile(S.k, kbase + (long long)j * bkv * kss, kss, bkv);
    load_tile(S.v, vbase + (long long)j * bkv * vss, vss, bkv);
    __syncthreads();

    // 1. S = Q K'^T: (bq x 128) x (128 x bkv), fp32 sums
    {
      const int ntn = bkv / 16;
      for (int tile = warp; tile < (bq / 16) * ntn; tile += AT_WARPS) {
        const int tm = tile / ntn, tn = tile % ntn;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
        wmma::fill_fragment(c, 0.0f);
#pragma unroll
        for (int k0 = 0; k0 < HEAD_DIM; k0 += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __half, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __half, wmma::col_major> bk;
          wmma::load_matrix_sync(a, &S.q[tm * 16][k0], AT_LDH);
          wmma::load_matrix_sync(bk, &S.k[tn * 16][k0], AT_LDH);
          wmma::mma_sync(c, a, bk, c);
        }
        wmma::store_matrix_sync(&S.s[tm * 16][tn * 16], c, AT_LDF,
                                wmma::mem_row_major);
      }
    }
    __syncthreads();

    // 2-4. per row: score store, full-tile pseudo-average, causal mask,
    // local softmax, online recovery.  Warp w owns rows w, w + 8, ...
    const int col0 = j * bkv;
    for (int rr = warp; rr < bq; rr += AT_WARPS) {
      const int row = i * bq + rr;
      float ssum = 0.0f, mx = -INFINITY;
      for (int c = lane; c < bkv; c += 32) {
        float s = store_score(S.s[rr][c], P);
        ssum += s;                                   // all columns, pre-mask
        if (causal && col0 + c > row) s = NEG_BIG;   // then the mask
        S.s[rr][c] = s;
        mx = fmaxf(mx, s);
      }
      ssum = warp_sum(ssum);
      mx = warp_max(mx);
      float lsum = 0.0f;
      for (int c = lane; c < bkv; c += 32) {
        const float p = h2f(__float2half_rn(
            rnd(expf(rnd(__fsub_rn(S.s[rr][c], mx), sh)), sh)));
        S.p[rr][c] = __float2half_rn(p);
        lsum += p;
      }
      lsum = warp_sum(lsum);
      if (lane == 0) {
        const float sbar = rnd(__fdiv_rn(ssum, (float)bkv), sh);
        const RowStep r = row_update(S.m[rr], S.l[rr], S.f[rr], j, sbar, mx,
                                     rnd(lsum, sh), P);
        S.m[rr] = r.m;
        S.l[rr] = r.l;
        S.f[rr] = r.f;
        S.e_prev[rr] = r.e_prev;
        S.e_cur[rr] = r.e_cur;
      }
    }
    __syncthreads();

    // 5. PV = P V: (bq x bkv) x (bkv x 128) -> S.s
    {
      constexpr int NTN = HEAD_DIM / 16;
      for (int tile = warp; tile < (bq / 16) * NTN; tile += AT_WARPS) {
        const int tm = tile / NTN, tn = tile % NTN;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
        wmma::fill_fragment(c, 0.0f);
        for (int k0 = 0; k0 < bkv; k0 += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __half, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __half, wmma::row_major> bv;
          wmma::load_matrix_sync(a, &S.p[tm * 16][k0], AT_LDH);
          wmma::load_matrix_sync(bv, &S.v[k0][tn * 16], AT_LDH);
          wmma::mma_sync(c, a, bv, c);
        }
        wmma::store_matrix_sync(&S.s[tm * 16][tn * 16], c, AT_LDF,
                                wmma::mem_row_major);
      }
    }
    __syncthreads();

    // 6. acc <- e_prev * acc + e_cur * pv at the accumulator dtype
#pragma unroll
    for (int e = 0; e < AT_ACC; ++e) {
      const int idx = t + AT_THREADS * e;
      const int row = idx / HEAD_DIM, col = idx % HEAD_DIM;
      if (row < bq)
        acc[e] = acc_update(acc[e], rnd(S.s[row][col], P.acc_half),
                            S.e_prev[row], S.e_cur[row], P.acc_half);
    }
  }
  __syncthreads();

  // O = acc / l at the accumulator dtype, stored at fp16 (contiguous)
  __half* ob = out + ((size_t)bh * s1 + (size_t)i * bq) * HEAD_DIM;
#pragma unroll
  for (int e = 0; e < AT_ACC; ++e) {
    const int idx = t + AT_THREADS * e;
    const int row = idx / HEAD_DIM, col = idx % HEAD_DIM;
    if (row < bq) {
      const float l = rnd(S.l[row], P.acc_half);
      ob[(size_t)row * HEAD_DIM + col] =
          __float2half_rn(rnd(__fdiv_rn(acc[e], l), P.acc_half));
    }
  }
}

}  // namespace pasa

// Plain C entry point (bound with ctypes).  Strides are in elements, for
// the (batch, head, row) dims of q, K' and v; returns the cudaError_t of
// the launch (0: queued on `stream`).
extern "C" int pasa_attention_launch(
    const void* q, const void* k, const void* v, void* out, int batch,
    int heads, int kv_heads, int s1, int s2, int block_q, int block_kv,
    int causal, long long qsb, long long qsh, long long qss, long long ksb,
    long long ksh, long long kss, long long vsb, long long vsh, long long vss,
    float beta, float inva, float shift_scale, float post_scale,
    int stat_half, int acc_half, void* stream) {
  using namespace pasa;
  if (batch < 1 || heads < 1 || kv_heads < 1 || heads % kv_heads ||
      block_q < 16 || block_q > AT_MAX_BQ || block_q % 16 ||
      block_kv < 16 || block_kv > AT_MAX_BKV || block_kv % 16 ||
      s1 < block_q || s1 % block_q || s2 < block_kv || s2 % block_kv)
    return (int)cudaErrorInvalidValue;
  const Policy P = make_policy(beta, inva, shift_scale, post_scale, stat_half,
                               acc_half);
  const size_t smem = sizeof(AttnSmem);
  cudaError_t err = cudaFuncSetAttribute(
      pasa_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(batch * heads, s1 / block_q);
  pasa_attention_kernel<<<grid, AT_THREADS, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __half*>(q), static_cast<const __half*>(k),
      static_cast<const __half*>(v), static_cast<__half*>(out), heads,
      kv_heads, s1, s2, block_q, block_kv, causal, qsb, qsh, qss, ksb, ksh,
      kss, vsb, vsh, vss, P);
  return (int)cudaGetLastError();
}
