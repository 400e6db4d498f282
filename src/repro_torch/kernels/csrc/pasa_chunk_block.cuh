// One page folded into the running PASA state of a tile of query rows
// under the chunk-exact convention (chunked paged prefill):
//  * the key mean and the row pseudo-average are over the page's valid
//    (col < kv_len) columns - one column set for every row, so the
//    recovery identity (Eq. 14) stays exact;
//  * the causal mask (row position >= column position) is applied after
//    the pseudo-average;
//  * a row with no causally visible valid column in the page keeps its
//    state bit-unchanged and does not count the page, so a row's output
//    depends only on its own live pages and is invariant to the chunk
//    schedule (the reference's update_state(dead_rows_noop=True)).
// Tensor cores (WMMA m16n16k16, fp16 in, fp32 sum) compute Q K'^T and P V;
// the per-row softmax steps run one warp per row.
#pragma once

#include <mma.h>

#include "pasa_common.cuh"

namespace pasa {

constexpr int PF_BQ = 64;                  // query rows per CTA
constexpr int PF_THREADS = 256;            // 8 warps
constexpr int PF_WARPS = PF_THREADS / 32;
constexpr int PF_MAX_PAGE = 128;
constexpr int PF_LDH = HEAD_DIM + 8;       // fp16 row stride: 272 B rows
constexpr int PF_LDF = HEAD_DIM + 4;       // fp32 row stride
constexpr int PF_ACC = PF_BQ * HEAD_DIM / PF_THREADS;  // acc elements/thread

struct ChunkSmem {
  __half q[PF_BQ][PF_LDH];
  __half k[PF_MAX_PAGE][PF_LDH];   // raw K on entry, shifted K after
  __half v[PF_MAX_PAGE][PF_LDH];   // rows >= valid zeroed by the caller
  __half p[PF_BQ][PF_LDH];         // probabilities at fp16
  float s[PF_BQ][PF_LDF];          // fp32 GEMM results (scores, then PV)
  float km[HEAD_DIM];
  float m[PF_BQ], l[PF_BQ], f[PF_BQ];
  float e_prev[PF_BQ], e_cur[PF_BQ];
  int cnt[PF_BQ];
  int live[PF_BQ];
};

__device__ __forceinline__ void chunk_state_init(ChunkSmem& S, float* acc) {
  const int t = threadIdx.x;
  if (t < PF_BQ) {
    S.m[t] = NEG_BIG;
    S.l[t] = 0.0f;
    S.f[t] = 0.0f;
    S.cnt[t] = 0;
  }
#pragma unroll
  for (int i = 0; i < PF_ACC; ++i) acc[i] = 0.0f;
}

// Fold the page in S.k/S.v into the tile's state.  row0: absolute position
// of tile row 0; col0: absolute position of page row 0; valid: live page
// rows (>= 1); page: rows in the page (a multiple of 16).  Thread t owns
// accumulator elements e = t + PF_THREADS * i (row e / D, column e % D).
__device__ __forceinline__ void chunk_block_update(ChunkSmem& S, int row0,
                                                   int col0, int valid,
                                                   int page, const Policy& P,
                                                   float* acc) {
  using namespace nvcuda;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;

  // 1. masked key mean + algebraic shift (rows past `valid` -> zero keys)
  if (P.beta > 0.0f) {
    if (t < HEAD_DIM) {
      float sum = 0.0f;
      for (int r = 0; r < valid; ++r) sum += h2f(S.k[r][t]);
      S.km[t] = __fdiv_rn(sum, (float)valid);
    }
    __syncthreads();
    const int d = t % HEAD_DIM;
    const float km = S.km[d];
    for (int r = t / HEAD_DIM; r < page; r += PF_THREADS / HEAD_DIM)
      S.k[r][d] = r < valid ? shift_key(h2f(S.k[r][d]), km, P) : __float2half_rn(0.0f);
  } else {
    const int d = t % HEAD_DIM;
    for (int r = valid + t / HEAD_DIM; r < page; r += PF_THREADS / HEAD_DIM)
      S.k[r][d] = __float2half_rn(0.0f);
  }
  __syncthreads();

  // 2. S = Q K'^T on tensor cores: (BQ x D) x (D x page), fp32 sums.
  {
    const int ntn = page / 16;
    for (int tile = warp; tile < (PF_BQ / 16) * ntn; tile += PF_WARPS) {
      const int tm = tile / ntn, tn = tile % ntn;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::fill_fragment(c, 0.0f);
#pragma unroll
      for (int k0 = 0; k0 < HEAD_DIM; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __half, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __half, wmma::col_major> bk;
        wmma::load_matrix_sync(a, &S.q[tm * 16][k0], PF_LDH);
        wmma::load_matrix_sync(bk, &S.k[tn * 16][k0], PF_LDH);
        wmma::mma_sync(c, a, bk, c);
      }
      wmma::store_matrix_sync(&S.s[tm * 16][tn * 16], c, PF_LDF, wmma::mem_row_major);
    }
  }
  __syncthreads();

  // 3. per-row softmax statistics and the online recovery; warp w owns
  //    rows w * 8 .. w * 8 + 7, lanes stride the columns.
  const bool sh = P.stat_half;
  for (int rr = warp * (PF_BQ / PF_WARPS); rr < (warp + 1) * (PF_BQ / PF_WARPS); ++rr) {
    const int rowpos = row0 + rr;
    float ssum = 0.0f, mx = -INFINITY;   // masked columns enter as NEG_BIG
    for (int c = lane; c < page; c += 32) {
      const float s = store_score(S.s[rr][c], P);
      S.s[rr][c] = s;
      if (c < valid) ssum += s;   // pseudo-average: valid columns, pre-causal
      const bool mask = c < valid && col0 + c <= rowpos;
      mx = fmaxf(mx, mask ? s : NEG_BIG);
    }
    ssum = warp_sum(ssum);
    mx = warp_max(mx);
    float lsum = 0.0f;
    for (int c = lane; c < page; c += 32) {
      const bool mask = c < valid && col0 + c <= rowpos;
      float p = 0.0f;
      if (mask)
        p = h2f(__float2half_rn(rnd(expf(rnd(__fsub_rn(S.s[rr][c], mx), sh)), sh)));
      S.p[rr][c] = __float2half_rn(p);
      lsum += p;
    }
    lsum = warp_sum(lsum);
    if (lane == 0) {
      const bool live = rowpos >= col0;   // some causally visible valid column
      S.live[rr] = live;
      if (live) {
        const float sbar = rnd(__fdiv_rn(ssum, (float)valid), sh);
        const RowStep r = row_update(S.m[rr], S.l[rr], S.f[rr], S.cnt[rr], sbar,
                                     mx, rnd(lsum, sh), P);
        S.m[rr] = r.m;
        S.l[rr] = r.l;
        S.f[rr] = r.f;
        S.cnt[rr] += 1;
        S.e_prev[rr] = r.e_prev;
        S.e_cur[rr] = r.e_cur;
      }
    }
  }
  __syncthreads();

  // 4. PV = P V on tensor cores: (BQ x page) x (page x D) -> S.s.
  {
    constexpr int NTN = HEAD_DIM / 16;
    for (int tile = warp; tile < (PF_BQ / 16) * NTN; tile += PF_WARPS) {
      const int tm = tile / NTN, tn = tile % NTN;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::fill_fragment(c, 0.0f);
      for (int k0 = 0; k0 < page; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __half, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __half, wmma::row_major> bv;
        wmma::load_matrix_sync(a, &S.p[tm * 16][k0], PF_LDH);
        wmma::load_matrix_sync(bv, &S.v[k0][tn * 16], PF_LDH);
        wmma::mma_sync(c, a, bv, c);
      }
      wmma::store_matrix_sync(&S.s[tm * 16][tn * 16], c, PF_LDF, wmma::mem_row_major);
    }
  }
  __syncthreads();

  // 5. acc <- e_prev * acc + e_cur * pv on live rows; dead rows untouched.
#pragma unroll
  for (int i = 0; i < PF_ACC; ++i) {
    const int e = t + PF_THREADS * i;
    const int row = e / HEAD_DIM, col = e % HEAD_DIM;
    if (S.live[row])
      acc[i] = acc_update(acc[i], rnd(S.s[row][col], P.acc_half), S.e_prev[row],
                          S.e_cur[row], P.acc_half);
  }
}

}  // namespace pasa
