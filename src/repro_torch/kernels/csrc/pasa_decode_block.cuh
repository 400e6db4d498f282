// One KV block folded into the running PASA decode state of one
// (sequence, kv-head): the GQA group's G query rows against one block of
// keys/values already in shared memory.  The paged decode kernel calls it
// once per live page; the contiguous decode kernel (repro's
// kernels/pasa_decode.py, a later slice of the port) must call the same
// function per block, so that paged == contiguous holds bit for bit, as
// the reference's shared masked_block_update makes it hold there.
//
// Convention (shift_mask_valid): the key mean and the row pseudo-average
// are over the block's `valid` leading columns; keys are shifted to
// (k - beta * km) / sqrt(d); masked scores are NEG_BIG and masked
// probabilities exact zeros; V rows past `valid` must be zero on entry, so
// stale NaN/Inf bytes of recycled pages never enter the PV product.
#pragma once

#include "pasa_common.cuh"

namespace pasa {

constexpr int DEC_THREADS = HEAD_DIM;  // one thread per head-dim column
constexpr int DEC_WARPS = DEC_THREADS / 32;
constexpr int DEC_MAX_G = 16;
constexpr int DEC_MAX_BLOCK = 128;
// K row stride in halves: 65 words, so thread c reading row c walks
// distinct banks across a warp.
constexpr int DEC_K_LD = HEAD_DIM + 2;

struct DecodeSmem {
  __half q[DEC_MAX_G][HEAD_DIM];
  __half k[DEC_MAX_BLOCK][DEC_K_LD];  // raw K on entry, shifted K after
  __half v[DEC_MAX_BLOCK][HEAD_DIM];  // rows >= valid zeroed by the caller
  __half s[DEC_MAX_G][DEC_MAX_BLOCK]; // scores at fp16 (masked: NEG_BIG)
  __half p[DEC_MAX_G][DEC_MAX_BLOCK]; // probabilities at fp16
  float km[HEAD_DIM];
  float m[DEC_MAX_G], l[DEC_MAX_G], f[DEC_MAX_G];
  float e_prev[DEC_MAX_G], e_cur[DEC_MAX_G];
};

// Reset the running state (thread-cooperative; callers sync after).
__device__ __forceinline__ void decode_state_init(DecodeSmem& S, float* acc) {
  const int t = threadIdx.x;
  if (t < DEC_MAX_G) {
    S.m[t] = NEG_BIG;
    S.l[t] = 0.0f;
    S.f[t] = 0.0f;
  }
#pragma unroll
  for (int g = 0; g < DEC_MAX_G; ++g) acc[g] = 0.0f;
}

// Fold the block in S.k/S.v (`block` rows, the first `valid` >= 1 of them
// live) into the state after `cnt` folded blocks.  Thread t owns head-dim
// column t of the accumulator: acc[g] for the G rows.
__device__ __forceinline__ void decode_block_update(DecodeSmem& S, int valid,
                                                    int block, int G, int cnt,
                                                    const Policy& P,
                                                    float* acc) {
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;

  // 1. masked key mean over the valid rows, then the algebraic shift;
  //    rows past `valid` become zero keys (their scores are masked).
  if (P.beta > 0.0f) {
    float sum = 0.0f;
    for (int r = 0; r < valid; ++r) sum += h2f(S.k[r][t]);
    const float km = __fdiv_rn(sum, (float)valid);
    for (int r = 0; r < block; ++r)
      S.k[r][t] = r < valid ? shift_key(h2f(S.k[r][t]), km, P) : __float2half_rn(0.0f);
  } else {
    for (int r = valid; r < block; ++r) S.k[r][t] = __float2half_rn(0.0f);
  }
  __syncthreads();

  // 2. scores: thread c computes column c for all G rows (fp32 sum of
  //    exact fp16 products, stored at fp16).
  if (t < block) {
    const __half2* krow = reinterpret_cast<const __half2*>(&S.k[t][0]);
    for (int g = 0; g < G; ++g) {
      const __half2* qrow = reinterpret_cast<const __half2*>(&S.q[g][0]);
      float dot = 0.0f;
#pragma unroll 8
      for (int d2 = 0; d2 < HEAD_DIM / 2; ++d2) {
        const float2 a = __half22float2(qrow[d2]);
        const float2 b = __half22float2(krow[d2]);
        dot = fmaf(a.x, b.x, dot);
        dot = fmaf(a.y, b.y, dot);
      }
      S.s[g][t] = __float2half_rn(t < valid ? store_score(dot, P) : NEG_BIG);
    }
  }
  __syncthreads();

  // 3. per-row statistics: warp w owns rows w, w + 4, ...; lanes stride
  //    the columns.  Lane 0 then runs the online recovery for the row.
  const bool sh = P.stat_half;
  for (int g = warp; g < G; g += DEC_WARPS) {
    float ssum = 0.0f, mx = -INFINITY;   // masked columns hold NEG_BIG
    for (int c = lane; c < block; c += 32) {
      const float s = h2f(S.s[g][c]);
      if (c < valid) ssum += s;
      mx = fmaxf(mx, s);
    }
    ssum = warp_sum(ssum);
    mx = warp_max(mx);
    float lsum = 0.0f;
    for (int c = lane; c < block; c += 32) {
      float p = 0.0f;
      if (c < valid)
        p = h2f(__float2half_rn(
            rnd(expf(rnd(__fsub_rn(h2f(S.s[g][c]), mx), sh)), sh)));
      S.p[g][c] = __float2half_rn(p);
      lsum += p;
    }
    lsum = warp_sum(lsum);
    if (lane == 0) {
      const float sbar = rnd(__fdiv_rn(ssum, (float)valid), sh);
      const RowStep r = row_update(S.m[g], S.l[g], S.f[g], cnt, sbar, mx,
                                   rnd(lsum, sh), P);
      S.m[g] = r.m;
      S.l[g] = r.l;
      S.f[g] = r.f;
      S.e_prev[g] = r.e_prev;
      S.e_cur[g] = r.e_cur;
    }
  }
  __syncthreads();

  // 4. PV: thread t = head-dim column t; acc <- e_prev*acc + e_cur*pv.
  // (static trip count so acc[] stays in registers)
#pragma unroll
  for (int g = 0; g < DEC_MAX_G; ++g) {
    if (g < G) {
      float pv = 0.0f;
      for (int c = 0; c < block; ++c) pv = fmaf(h2f(S.p[g][c]), h2f(S.v[c][t]), pv);
      acc[g] = acc_update(acc[g], rnd(pv, P.acc_half), S.e_prev[g], S.e_cur[g],
                          P.acc_half);
    }
  }
}

}  // namespace pasa
