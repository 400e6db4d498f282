// One KV block of PASA decode for one (sequence, kv-head): the GQA group's
// G query rows against one block of keys/values already in shared memory,
// in two parts.
//
//  * decode_block_partials: what the block contributes before the running
//    state is read - the masked key mean and shift, the scores at the
//    score dtype, the row pseudo-average s-bar, the local max and sum
//    (Algorithm 1 lines 11-13) and P V rounded to the accumulator dtype.  None of it depends
//    on earlier blocks, so blocks can be reduced to partials in parallel.
//  * the fold: row_update (the order-dependent F-bar recurrence) and
//    acc_update of pasa_common.cuh, block after block in order.
//
// decode_block_update is the two in sequence.  The contiguous decode
// kernel walks its blocks through it; the paged decode kernel spreads the
// pages of a sequence over a CTA cluster, reduces each to its partials and
// folds them in page order with decode_fold_step (the same row_update and
// acc_update calls on the same values), so paged == contiguous holds bit
// for bit, as the reference's shared masked_block_update makes it hold
// there.  What bounds a block on an H100 is latency, not bytes: per block
// each thread runs G dot products of D for each of its block / D key rows
// and G sums of `block` products out of shared memory, plus the barriers
// between the steps; the loops below run every row of the group in one
// pass over the key row (scores) or value column (P V), so the G chains
// are independent and each shared load is used G times - each chain keeps
// its own order of operations.
//
// The head width D (64 or 128) is a template parameter of the block tile
// (DecodeSmem): a block runs D threads, one per head-dim column, so D 64
// runs two warps where D 128 runs four.  Per block a thread at D 64 owns
// the same number of score products as at D 128 (twice the key rows, dot
// products half as long) and the same P V column sum, so a block's
// latency changes little (two warps hide less of it than four) while its
// bytes halve.  Keeping 128 threads at D 64, two per column, would split
// each P V sum and change its order of operations between the widths;
// one thread per column keeps one code path.
//
// Convention (shift_mask_valid): the key mean and the row pseudo-average
// are over the block's `valid` leading columns; keys are shifted to
// (k - beta * km) / sqrt(d); masked scores are NEG_BIG and masked
// probabilities exact zeros; V rows past `valid` must be zero on entry, so
// stale NaN/Inf bytes of recycled pages never enter the PV product.
//
// The policy's mode (pasa_common.cuh Mode) fixes the types: q, K and V
// are held at the operand type (fp16, or bf16 under bf16_fp32); scores
// and probabilities at fp16 (fp16, fp16_fp32) or fp32 (fp32, bf16_fp32).
// Products are summed in fp32 on the CUDA cores, so P V takes the fp32
// probabilities as they are.
#pragma once

#include "pasa_common.cuh"

namespace pasa {

constexpr int DEC_MAX_G = 16;
constexpr int DEC_PAGE_ROWS = 128;   // rows of a page (and of a staged load)
constexpr int DEC_MAX_BLOCK = 256;   // rows of a contiguous-cache block

// One block of up to MAXB rows of head width D at operand type OpT (fp16
// or bf16, both two bytes): at D 128 78,848 bytes at 128 rows (pages) and
// 153,088 at 256 (the contiguous cache's default block); at D 64 44,032
// and 85,504; in every mode.  The block runs kThreads = D threads.
template <typename OpT, int MAXB, int D>
struct DecodeSmem {
  static_assert(D == 64 || D == 128, "decode head width");
  static constexpr int kRows = MAXB;
  static constexpr int kD = D;
  static constexpr int kThreads = D;          // one per head-dim column
  static constexpr int kWarps = D / 32;
  // K row stride in halves: D / 2 + 1 words (65 at D 128, 33 at D 64), an
  // odd count, so thread c reading word w of row c hits bank (c + w) mod
  // 32: distinct across a warp.
  static constexpr int kLd = D + 2;
  OpT q[DEC_MAX_G][D];
  OpT k[MAXB][kLd];                   // raw K on entry, shifted K after
  OpT v[MAXB][D];                     // rows >= valid zeroed by the caller
  // the rows' scores (masked: NEG_BIG) and probabilities: at fp16 two
  // arrays; at fp32 one, each probability overwriting its score in place
  // (the same bytes, so a 256-row block still fits beside the staging
  // buffer)
  union {
    struct {
      __half s[DEC_MAX_G][MAXB];
      __half p[DEC_MAX_G][MAXB];
    } h;
    float f[DEC_MAX_G][MAXB];
  } sc;
  float m[DEC_MAX_G], l[DEC_MAX_G], f[DEC_MAX_G];
  float e_prev[DEC_MAX_G], e_cur[DEC_MAX_G];
  // the block's partials per row: s-bar, local max, local sum (each at
  // the statistic dtype)
  float sbar[DEC_MAX_G], m_loc[DEC_MAX_G], l_loc[DEC_MAX_G];
};

// Row capacity of a launch: the group padded to 8 or 16 rows, a
// compile-time bound for the per-thread register arrays (acc, pv, dot).
__host__ __device__ constexpr int dec_rows(int G) { return G <= 8 ? 8 : DEC_MAX_G; }

// Reset the running state (thread-cooperative; callers sync after).
template <int NG, typename Smem>
__device__ __forceinline__ void decode_state_init(Smem& S, float* acc) {
  const int t = threadIdx.x;
  if (t < DEC_MAX_G) {
    S.m[t] = NEG_BIG;
    S.l[t] = 0.0f;
    S.f[t] = 0.0f;
  }
#pragma unroll
  for (int g = 0; g < NG; ++g) acc[g] = 0.0f;
}

// Partials of the block in S.k/S.v (`block` rows, the first `valid` >= 1
// of them live): S.sbar/S.m_loc/S.l_loc[g] (written by lane 0 of the warp
// that owns row g: warp w owns rows w, w + kWarps, ...) and, in registers,
// pv[g] = P V of row g at head-dim column t (thread t), rounded to the
// accumulator dtype (G <= NG).  The last step reads S.v and the
// probabilities after the last barrier: the caller syncs before it
// overwrites them.
template <int NG, typename M, typename Smem>
__device__ __forceinline__ void decode_block_partials(Smem& S, int valid,
                                                      int block, int G,
                                                      const Policy& P,
                                                      float* pv) {
  using OpT = typename M::Op;
  constexpr bool SH = M::kScoreHalf;
  constexpr int D = Smem::kD;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;

  // 1. masked key mean over the valid rows, then the algebraic shift;
  //    rows past `valid` become zero keys (their scores are masked).
  if (P.beta > 0.0f) {
    float sum = 0.0f;
    for (int r = 0; r < valid; ++r) sum += to_float(S.k[r][t]);
    const float km = __fdiv_rn(sum, (float)valid);
    for (int r = 0; r < block; ++r)
      S.k[r][t] = r < valid ? shift_key<OpT>(to_float(S.k[r][t]), km, P)
                            : from_float<OpT>(0.0f);
  } else {
    for (int r = valid; r < block; ++r) S.k[r][t] = from_float<OpT>(0.0f);
  }
  __syncthreads();

  // 2. scores: thread t computes columns c = t, t + D, ... (those below
  //    `block`) for all G rows in one pass over each key row (per row: an
  //    fp32 sum of exact products in d order, stored at the score dtype).
#pragma unroll
  for (int c0 = 0; c0 < Smem::kRows; c0 += Smem::kThreads) {
    const int c = c0 + t;
    if (c >= block) break;
    const uint32_t* krow = reinterpret_cast<const uint32_t*>(&S.k[c][0]);
    float dot[NG];
#pragma unroll
    for (int g = 0; g < NG; ++g) dot[g] = 0.0f;
#pragma unroll 4
    for (int d2 = 0; d2 < D / 2; ++d2) {
      const float2 b = unpack2<OpT>(krow[d2]);
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        if (g < G) {
          const float2 a = unpack2<OpT>(
              reinterpret_cast<const uint32_t*>(&S.q[g][0])[d2]);
          dot[g] = fmaf(a.x, b.x, dot[g]);
          dot[g] = fmaf(a.y, b.y, dot[g]);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      if (g < G) {
        const float sc = c < valid ? store_score<SH>(dot[g], P) : NEG_BIG;
        if constexpr (SH) S.sc.h.s[g][c] = __float2half_rn(sc);
        else S.sc.f[g][c] = sc;
      }
    }
  }
  __syncthreads();

  // 3. per-row statistics: warp w owns rows w, w + kWarps, ...; lanes
  //    stride the columns; at fp32 scores each probability replaces its
  //    score, read by the same lane.
  const bool sh = P.stat_half;
  for (int g = warp; g < G; g += Smem::kWarps) {
    float ssum = 0.0f, mx = -INFINITY;   // masked columns hold NEG_BIG
    for (int c = lane; c < block; c += 32) {
      const float s = SH ? h2f(S.sc.h.s[g][c]) : S.sc.f[g][c];
      if (c < valid) ssum += s;
      mx = fmaxf(mx, s);
    }
    ssum = warp_sum(ssum);
    mx = warp_max(mx);
    float lsum = 0.0f;
    for (int c = lane; c < block; c += 32) {
      float p = 0.0f;
      if constexpr (SH) {
        if (c < valid)
          p = h2f(__float2half_rn(
              rnd(expf(rnd(__fsub_rn(h2f(S.sc.h.s[g][c]), mx), sh)), sh)));
        S.sc.h.p[g][c] = __float2half_rn(p);
      } else {
        if (c < valid) p = rnd(expf(rnd(__fsub_rn(S.sc.f[g][c], mx), sh)), sh);
        S.sc.f[g][c] = p;
      }
      lsum += p;
    }
    lsum = warp_sum(lsum);
    if (lane == 0) {
      S.sbar[g] = rnd(__fdiv_rn(ssum, (float)valid), sh);
      S.m_loc[g] = mx;
      S.l_loc[g] = rnd(lsum, sh);
    }
  }
  __syncthreads();

  // 4. PV: thread t = head-dim column t, all G rows in one pass over the
  //    value column (per row: products summed in c order).
#pragma unroll
  for (int g = 0; g < NG; ++g) pv[g] = 0.0f;
  for (int c = 0; c < block; ++c) {
    const float vv = to_float(S.v[c][t]);
#pragma unroll
    for (int g = 0; g < NG; ++g)
      if (g < G)
        pv[g] = fmaf(SH ? h2f(S.sc.h.p[g][c]) : S.sc.f[g][c], vv, pv[g]);
  }
#pragma unroll
  for (int g = 0; g < NG; ++g) pv[g] = rnd(pv[g], P.acc_half);
}

// The running state of one query row at one head-dim column, as one
// thread folds it.
struct FoldState {
  float m, l, f, acc;
};

__device__ __forceinline__ FoldState fold_state_init() {
  FoldState st;
  st.m = NEG_BIG;
  st.l = 0.0f;
  st.f = 0.0f;
  st.acc = 0.0f;
  return st;
}

// Fold one block's partials of the row (after `cnt` folded blocks) into
// the state: row_update, then acc_update - the calls decode_block_update
// makes, on the same values.
__device__ __forceinline__ void decode_fold_step(FoldState& st, int cnt,
                                                 float sbar, float m_loc,
                                                 float l_loc, float pv,
                                                 const Policy& P) {
  const RowStep r = row_update(st.m, st.l, st.f, cnt, sbar, m_loc, l_loc, P);
  st.acc = acc_update(st.acc, pv, r.e_prev, r.e_cur, P.acc_half);
  st.m = r.m;
  st.l = r.l;
  st.f = r.f;
}

// Fold the block in S.k/S.v into the state after `cnt` folded blocks
// (the sequential walk): partials, then row_update per row (lane 0 of the
// row's warp, state in S.m/S.l/S.f) and acc_update per column.  Thread t
// owns head-dim column t of the accumulator: acc[g] for the G rows.
template <int NG, typename M, typename Smem>
__device__ __forceinline__ void decode_block_update(Smem& S, int valid,
                                                    int block, int G, int cnt,
                                                    const Policy& P,
                                                    float* acc) {
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  float pv[NG];
  decode_block_partials<NG, M>(S, valid, block, G, P, pv);

  if (lane == 0) {
    for (int g = warp; g < G; g += Smem::kWarps) {
      const RowStep r = row_update(S.m[g], S.l[g], S.f[g], cnt, S.sbar[g],
                                   S.m_loc[g], S.l_loc[g], P);
      S.m[g] = r.m;
      S.l[g] = r.l;
      S.f[g] = r.f;
      S.e_prev[g] = r.e_prev;
      S.e_cur[g] = r.e_cur;
    }
  }
  __syncthreads();

  // acc <- e_prev*acc + e_cur*pv (static trip count: acc[] in registers)
#pragma unroll
  for (int g = 0; g < NG; ++g)
    if (g < G)
      acc[g] = acc_update(acc[g], pv[g], S.e_prev[g], S.e_cur[g], P.acc_half);
}

}  // namespace pasa
