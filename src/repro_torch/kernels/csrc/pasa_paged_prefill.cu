// PASA chunked prefill over a paged KV pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/pasa_paged_prefill.py
// (_paged_prefill_kernel / _chunk_block_update, launched by
// paged_prefill_kernel_call through pl.pallas_call), in both of its modes:
// raw pools (bf16, fp16) and quantized pools (int8 or fp8 e4m3 codes with
// per-page sidecars).
//
// What it computes: one prompt chunk of full-head queries (B, H, CS, D)
// against paged K/V under the chunk-exact convention.  Each of the B rows
// carries its own chunk start, valid length and page-table row, so one
// call advances chunks of several requests; a pad row with kv_len == 0
// folds no page and emits zeros.  Per page (one PASA block):
//  * the key mean km and the row pseudo-average are over the page's
//    valid (col < kv_len) columns - one column set for every row, so the
//    recovery identity (Eq. 14) stays exact; keys are shifted to
//    (k - beta * km) / sqrt(d), rows past `valid` become zero keys and
//    zero values (stale bytes of recycled pages are never read);
//  * the causal mask (row position >= column position) comes after the
//    pseudo-average;
//  * a row with no causally visible valid column in the page keeps its
//    state bit-unchanged and does not count the page, so a row's output
//    depends only on its own live pages and is invariant to the chunk
//    schedule (the reference's update_state(dead_rows_noop=True)).
//
// What bounds it on an H100: operations.  A tile of 128 query rows reads
// each visible page once, so for a 512-token chunk the bytes are a few
// MB per layer while the two GEMMs are ~4 x rows x cols x 128 flops.
// The design is the attention kernel's Hopper shape (pasa_attention.cu),
// with a conversion stage in front of the GEMMs:
//  * a CTA is one converter warpgroup and two consumer warpgroups of 64
//    query rows each (setmaxnreg moves registers to the consumers); one
//    (b, head, 128-row tile) per CTA, the longest causal tiles first;
//  * the converter's thread 0 loads Q once, and each visible page's raw
//    K and V (one kv head) by TMA from a 4-D map of the pool with the
//    page id as a coordinate.  2-byte values land straight in a ring of
//    three operand stages, already in the 128-byte-swizzled layout the
//    wgmma descriptors read, and are converted in place (each element
//    keeps its address): one stage is computed, one converted, one
//    loading, so a page's bytes arrive behind two pages of math.  8-bit
//    codes land row by row in a buffer of their own, with the page's two
//    shift sidecars by bulk copy, and are dequantized into two operand
//    stages; the next page's codes are requested as soon as the current
//    page is converted;
//  * the converter warpgroup turns the raw page into the operands at the
//    policy's input dtype (fp16, or bf16 under bf16_fp32): km per column
//    in row order (an fp32 sum rounded once), then K' = (K - beta km) /
//    sqrt(d) and V at the input dtype (shift_key's arithmetic), rows past
//    `valid` zeroed; for 8-bit pools the dequantization is load_pool8's
//    (code * scale + shift in fp32, one rounding to the input dtype);
//    it runs a page ahead of the consumers, so the conversion overlaps
//    the previous page's GEMMs;
//  * both GEMMs are wgmma (m64n{64|128}k16 for S from shared memory,
//    m64n128k16 for P V with P as the register operand and V read
//    MN-major): pages of up to 64 rows run at N = 64, larger ones at
//    N = 128, the surplus columns masked like columns past `valid`.  S
//    stays in registers and is stored at the score dtype before anything
//    reads it (fp16, or the fp32 wgmma sum itself under fp32 and
//    bf16_fp32; there P enters the P V wgmma rounded once to the operand
//    type, fp16 or bf16, while l sums the fp32 P - a deviation from the
//    reference's fp32 P V held to its prefill bar (atol 1e-2, rtol
//    3e-2); the attention kernel's two-term bf16 P (pasa_attention.cu)
//    costs 32 registers the consumers here do not have: ptxas spills at
//    224, and the converter at 40);
//    each row's statistics are reduced over the 4 threads that hold it,
//    each row keeps its own block count and live flag; under the
//    all-fp16 policy the per-element softmax and accumulator steps run on
//    fp16 pairs with the same bits (hopper.cuh).

#include <type_traits>

#include "hopper.cuh"

namespace pasa {

constexpr int PF_NWG = 2;                       // consumer warpgroups
constexpr int PF_BQ = 64 * PF_NWG;              // query rows per CTA
constexpr int PF_THREADS = 128 * (PF_NWG + 1);
constexpr int PF_HALF = 64 * 2;                 // a 64-column half-row (2 B)
constexpr int PF_MAX_PAGE = 128;

template <typename PoolT, int BKV>
struct PrefillLayout {
  static constexpr bool CODE = kIsCode<PoolT>;
  // 2-byte values land by TMA in an operand stage and are converted in
  // place (three stages: one computed, one converted, one loading);
  // 8-bit codes land in a buffer of their own (two operand stages)
  static constexpr int STAGES = CODE ? 2 : 3;
  static constexpr int Q_BYTES = PF_BQ * HEAD_DIM * 2;   // two 64-col halves
  static constexpr int OP_BYTES = BKV * HEAD_DIM * 2;    // one K' or V tile
  static constexpr int CODE_BYTES = BKV * HEAD_DIM;      // one K or V page
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + Q_BYTES;               // + stage
  static constexpr int V_OFF = K_OFF + STAGES * OP_BYTES;     // + stage
  static constexpr int CODE_OFF = V_OFF + STAGES * OP_BYTES;  // K then V codes
  static constexpr int SHIFT_OFF = CODE_OFF + (CODE ? 2 * CODE_BYTES : 0);
  static constexpr int KM_OFF = SHIFT_OFF + (CODE ? 2 * HEAD_DIM * 4 : 0);
  static constexpr int BAR_OFF = KM_OFF + HEAD_DIM * 4;
  // barriers: Q full; raw page full (per stage, or the code buffer's);
  // operands full and empty per stage
  static constexpr int N_RAW = CODE ? 1 : STAGES;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + N_RAW + 2 * STAGES);
};

// Byte offset of the 16-byte chunk of columns [c8, c8 + 8) of row r in a
// [rows][128] fp16 (or bf16) tile of BKV-row 64-column halves, 128-byte
// swizzle: the layout TMA writes and the wgmma descriptors read.
template <int BKV>
__device__ __forceinline__ uint32_t swz(int r, int c8) {
  return (c8 >> 6) * BKV * PF_HALF + r * PF_HALF +
         ((((c8 & 63) >> 3) ^ (r & 7)) << 4);
}

// Raw element (r, c) of a staged K or V page (`tile`: 2-byte values in
// the operand layout, or codes [BKV][128]) at the operand type OpT
// (returned widened): the value load_pool8 gives it.
template <typename OpT, typename PoolT, int BKV>
__device__ __forceinline__ float raw_elem(const unsigned char* tile, int r,
                                          int c, float scale,
                                          const float* shift) {
  if constexpr (kIsCode<PoolT>) {
    const PoolT code = reinterpret_cast<const PoolT*>(tile)[r * HEAD_DIM + c];
    return to_float(from_float<OpT>(
        __fadd_rn(__fmul_rn(code_to_float(code), scale), shift[c])));
  } else {
    return to_float(to_op<OpT>(*reinterpret_cast<const PoolT*>(
        tile + swz<BKV>(r, c & ~7) + (c & 7) * 2)));
  }
}

// Raw elements (r, c8 .. c8 + 7) of a staged page as eight OpT values.
template <typename OpT, typename PoolT, int BKV>
__device__ __forceinline__ uint4 raw_chunk(const unsigned char* tile, int r,
                                           int c8, float scale,
                                           const float* shift) {
  if constexpr (kIsCode<PoolT>) {
    return load8_dequant<OpT>(
        reinterpret_cast<const PoolT*>(tile + r * HEAD_DIM + c8), scale,
        shift + c8);
  } else {
    return load8_op<OpT>(reinterpret_cast<const PoolT*>(tile + swz<BKV>(r, c8)));
  }
}

// Scores of one page as the policy stores them (at fp16 if SH), with the
// row sums over the valid columns (before the causal mask) and the row
// maxima after it
// (masked columns enter as NEG_BIG).  Masked scores become -inf, so their
// probabilities are exact zeros.  s[4 g + e] holds row e >> 1 (of the
// thread's two) at page column lc0 + 8 g + (e & 1); without MASK every
// column is valid and visible to every row.
template <int NS, bool MASK, bool SH>
__device__ __forceinline__ void page_scores(float* s, float* ssum, float* mx,
                                            int lc0, int valid, int col0,
                                            const int* rowpos,
                                            const Policy& P) {
#pragma unroll
  for (int e = 0; e < NS; ++e) {
    const int r = (e >> 1) & 1;
    const float v = store_score<SH>(s[e], P);
    if constexpr (MASK) {
      const int lc = lc0 + 8 * (e >> 2) + (e & 1);
      if (lc < valid) ssum[r] += v;
      const bool vis = lc < valid && col0 + lc <= rowpos[r];
      mx[r] = fmaxf(mx[r], vis ? v : NEG_BIG);
      s[e] = vis ? v : -INFINITY;
    } else {
      ssum[r] += v;
      mx[r] = fmaxf(mx[r], v);
      s[e] = v;
    }
  }
}

// M: the policy's mode (operand type, score store).  H16 (only with
// ModeF16): statistics and accumulator at fp16 (the paper's policy): the
// softmax and accumulator steps run on fp16 pairs.
template <typename PoolT, int BKV, bool H16, typename M>
__global__ void __launch_bounds__(PF_THREADS, 1)
paged_prefill_kernel(const __grid_constant__ CUtensorMap tq,  // (B,H,CS,D)
                     const __grid_constant__ CUtensorMap tk,  // (P,page,KVH,D)
                     const __grid_constant__ CUtensorMap tv,
                     SidecarPtrs sc,                      // 8-bit pools only
                     const int* __restrict__ page_table,  // (B, max_pages)
                     const int* __restrict__ chunk_start, // (B,)
                     const int* __restrict__ kv_len,      // (B,)
                     typename M::Op* __restrict__ out,    // (B, H, CS, D)
                     int heads, int kv_heads, int chunk, int page,
                     int max_pages, Policy P) {
  static_assert(!H16 || M::kScoreHalf, "the fp16 pair steps need fp16 scores");
  using OpT = typename M::Op;
  using L = PrefillLayout<PoolT, BKV>;
  constexpr int NS = BKV / 2;            // score registers per thread
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzled tiles want 1024-byte aligned bases
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t s_base = smem_u32(sm);
  constexpr int NST = L::STAGES;
  const uint32_t bar_q = s_base + L::BAR_OFF;
  const uint32_t bar_raw = bar_q + 8;                  // + 8 * raw buffer
  const uint32_t bar_f = bar_raw + 8 * L::N_RAW;       // + 8 * stage
  const uint32_t bar_e = bar_f + 8 * NST;

  const int bh = blockIdx.x;
  const int n_tiles = (chunk + PF_BQ - 1) / PF_BQ;
  const int tile = n_tiles - 1 - blockIdx.y;   // longest causal tiles first
  const int b = bh / heads;
  const int kvh = (bh % heads) / (heads / kv_heads);
  const int start = chunk_start[b];
  const int L_kv = kv_len[b];
  const int* table = page_table + (size_t)b * max_pages;
  // pages the tile's rows can see: below kv_len, not past its last row
  const int rows = min(PF_BQ, chunk - tile * PF_BQ);
  const int see = min(L_kv, start + tile * PF_BQ + rows);
  const int n_live = see > 0 ? min(max_pages, (see + page - 1) / page) : 0;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int i = 0; i < L::N_RAW; ++i) mbar_init(bar_raw + 8 * i, 1);
    for (int st = 0; st < NST; ++st) {
      mbar_init(bar_f + 8 * st, 128);          // every converter thread
      mbar_init(bar_e + 8 * st, 4 * PF_NWG);   // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- converter warpgroup (its thread 0 issues every load) ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    const int ct = threadIdx.x;
    const float* shift = reinterpret_cast<const float*>(sm + L::SHIFT_OFF);
    float* km_s = reinterpret_cast<float*>(sm + L::KM_OFF);
    const uint32_t page_bytes =
        L::CODE ? 2 * page * HEAD_DIM + 2 * HEAD_DIM * 4 : 2 * 2 * page * PF_HALF;
    // request page j's raw K and V of kv head kvh: 2-byte values into
    // operand stage j % NST, codes (and the sidecar shifts) into the code
    // buffer
    const CUtensorMap* mk = &tk;
    const CUtensorMap* mv = &tv;
    auto issue = [&](int j) {
      const int pid = table[j];
      if constexpr (L::CODE) {
        const uint32_t dst = s_base + L::CODE_OFF;
        mbar_expect_tx(bar_raw, page_bytes);
        tma_load_4d(dst, mk, bar_raw, 0, kvh, 0, pid);
        tma_load_4d(dst + L::CODE_BYTES, mv, bar_raw, 0, kvh, 0, pid);
        const size_t ph = ((size_t)pid * kv_heads + kvh) * HEAD_DIM;
        bulk_load(s_base + L::SHIFT_OFF, sc.shift[0] + ph, HEAD_DIM * 4, bar_raw);
        bulk_load(s_base + L::SHIFT_OFF + HEAD_DIM * 4, sc.shift[1] + ph,
                  HEAD_DIM * 4, bar_raw);
      } else {
        const int st = j % NST;
        const uint32_t bar = bar_raw + 8 * st;
        mbar_expect_tx(bar, page_bytes);
        for (int half = 0; half < 2; ++half) {
          tma_load_4d(s_base + L::K_OFF + st * L::OP_BYTES + half * BKV * PF_HALF,
                      mk, bar, 64 * half, kvh, 0, pid);
          tma_load_4d(s_base + L::V_OFF + st * L::OP_BYTES + half * BKV * PF_HALF,
                      mv, bar, 64 * half, kvh, 0, pid);
        }
      }
    };
    if (ct == 0 && n_live > 0) {
      mbar_expect_tx(bar_q, L::Q_BYTES);
      for (int half = 0; half < 2; ++half)
        tma_load_4d(s_base + L::Q_OFF + half * PF_BQ * PF_HALF, &tq, bar_q,
                    64 * half, tile * PF_BQ, bh % heads, b);
      // in place: pages 0 .. NST - 2 ahead; codes: one page
      for (int p = 0; p < min(n_live, L::CODE ? 1 : NST - 1); ++p) issue(p);
    }
    // 8-bit pools: the page's two scales, loaded one page ahead (live
    // pages only: a dead page's sidecars may be NaN)
    float sck = 0.0f, scv = 0.0f;
    if constexpr (L::CODE) {
      if (n_live > 0) {
        const size_t ph = (size_t)table[0] * kv_heads + kvh;
        sck = __ldg(sc.scale[0] + ph);
        scv = __ldg(sc.scale[1] + ph);
      }
    }
    const int c8 = (ct & 15) * 8;             // this thread's 8 columns
    for (int j = 0; j < n_live; ++j) {
      const int valid = min(page, L_kv - j * page);
      const int st = j % NST;
      float sck_n = 0.0f, scv_n = 0.0f;
      if constexpr (L::CODE) {
        if (j + 1 < n_live) {
          const size_t ph = (size_t)table[j + 1] * kv_heads + kvh;
          sck_n = __ldg(sc.scale[0] + ph);
          scv_n = __ldg(sc.scale[1] + ph);
        }
      }
      unsigned char* opk = sm + L::K_OFF + st * L::OP_BYTES;
      unsigned char* opv = sm + L::V_OFF + st * L::OP_BYTES;
      const unsigned char* rk = L::CODE ? sm + L::CODE_OFF : opk;
      const unsigned char* rv = L::CODE ? sm + L::CODE_OFF + L::CODE_BYTES : opv;
      if constexpr (L::CODE)
        mbar_wait(bar_raw, j & 1);
      else
        mbar_wait(bar_raw + 8 * st, (j / NST) & 1);
      // 1. km of column ct over the valid rows, an fp32 sum in row order
      if (P.beta > 0.0f) {
        float sum = 0.0f;
        for (int r = 0; r < valid; ++r)
          sum += raw_elem<OpT, PoolT, BKV>(rk, r, ct, sck, shift);
        km_s[ct] = __fdiv_rn(sum, (float)valid);
      }
      named_sync(1, 128);
      // beta * km of this thread's columns (shift_key's first product)
      float bkm[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        bkm[e] = P.beta > 0.0f ? __fmul_rn(P.beta, km_s[c8 + e]) : 0.0f;
      // 2. K' = (K - beta km) / sqrt(d) and V at the operand type into
      //    stage st (in place for 2-byte pools; for codes once the
      //    consumers release the stage); rows past `valid` (and past the
      //    page) become zeros
      //    (one row per step: the converter runs at 56 registers, and
      //    unrolled steps spill)
      if constexpr (L::CODE) mbar_wait(bar_e + 8 * st, ((j / NST) & 1) ^ 1);
#pragma unroll 1
      for (int r = ct >> 4; r < BKV; r += 128 / 16) {
        uint4 kk = make_uint4(0u, 0u, 0u, 0u), vv = kk;
        if (r < valid) {
          kk = raw_chunk<OpT, PoolT, BKV>(rk, r, c8, sck, shift);
          vv = raw_chunk<OpT, PoolT, BKV>(rv, r, c8, scv, shift + HEAD_DIM);
          if (P.beta > 0.0f) {
            OpT* kh = reinterpret_cast<OpT*>(&kk);
#pragma unroll
            for (int e = 0; e < 8; ++e)
              kh[e] = from_float<OpT>(__fmul_rn(
                  __fsub_rn(to_float(kh[e]), bkm[e]), P.shift_scale));
          }
        }
        *reinterpret_cast<uint4*>(opk + swz<BKV>(r, c8)) = kk;
        *reinterpret_cast<uint4*>(opv + swz<BKV>(r, c8)) = vv;
      }
      fence_proxy_async();            // the operands are for wgmma
      mbar_arrive(bar_f + 8 * st);
      named_sync(1, 128);             // the raw page and km are consumed
      if (ct == 0) {
        if constexpr (L::CODE) {
          if (j + 1 < n_live) issue(j + 1);
        } else if (j + NST - 1 < n_live) {
          // stage (j - 1) % NST, once the consumers release page j - 1
          if (j >= 1) mbar_wait(bar_e + 8 * ((j - 1) % NST), ((j - 1) / NST) & 1);
          issue(j + NST - 1);
        }
      }
      sck = sck_n;
      scv = scv_n;
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
    const int t = threadIdx.x - 128;
    const int cw = t >> 7;                 // consumer warpgroup
    const int lane = t & 31;
    const int quad = lane & 3;
    // this thread's two rows (local to the CTA tile) and their positions
    const int r_lo = 64 * cw + 16 * ((t >> 5) & 3) + (lane >> 2);
    const int rl[2] = {r_lo, r_lo + 8};
    const int rowpos[2] = {start + tile * PF_BQ + rl[0],
                           start + tile * PF_BQ + rl[1]};
    // the warpgroup's rows inside the chunk: [wg_first, wg_last]
    const int wg_first = start + tile * PF_BQ + 64 * cw;
    const int wg_last = start + tile * PF_BQ + min(64 * cw + 63, rows - 1);
    const bool sh = P.stat_half, ah = P.acc_half;

    float m[2] = {NEG_BIG, NEG_BIG}, l[2] = {0.0f, 0.0f}, f[2] = {0.0f, 0.0f};
    int cnt[2] = {0, 0};
    // the accumulator: s[]'s layout over the 128 head-dim columns, as
    // fp32 values or (H16) fp16 pairs (acc2[2 g + r] = the pair acc[4 g +
    // 2 r], acc[4 g + 2 r + 1])
    float acc[H16 ? 1 : 64];
    uint32_t acc2[H16 ? 32 : 1];
#pragma unroll
    for (int e = 0; e < (H16 ? 1 : 64); ++e) acc[e] = 0.0f;
#pragma unroll
    for (int e = 0; e < (H16 ? 32 : 1); ++e) acc2[e] = 0u;

    const uint32_t q_addr = s_base + L::Q_OFF + cw * 64 * PF_HALF;
    if (n_live > 0) mbar_wait(bar_q, 0);
    for (int j = 0; j < n_live; ++j) {
      const int st = j % NST;
      const int col0 = j * page;
      const int valid = min(page, L_kv - col0);
      mbar_wait(bar_f + 8 * st, (j / NST) & 1);
      // a page wholly in the future of the warpgroup's rows (or a
      // warpgroup past the chunk) changes none of its rows
      if (wg_first <= wg_last && col0 <= wg_last) {
        const uint32_t k_addr = s_base + L::K_OFF + st * L::OP_BYTES;
        const uint32_t v_addr = s_base + L::V_OFF + st * L::OP_BYTES;

        // 1. S = Q K'^T (8 steps of k16 over the two 64-column halves)
        float s[NS];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HEAD_DIM / 16; ++kk) {
          const uint32_t off = (kk >> 2), in = (kk & 3) * 32;
          wgmma_scores<BKV, M::kBF16>(
              s, gmma_desc(q_addr + off * PF_BQ * PF_HALF + in, 16, 1024),
              gmma_desc(k_addr + off * BKV * PF_HALF + in, 16, 1024), kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs<NS>(s);

        // 2-3. score store, pseudo-average over the valid columns, then
        // the causal mask and the local max (masks only where a column
        // is invalid or in some row's future)
        float ssum[2] = {0.0f, 0.0f}, mx[2] = {-INFINITY, -INFINITY};
        if (valid < BKV || col0 + valid - 1 > wg_first)
          page_scores<NS, true, M::kScoreHalf>(s, ssum, mx, 2 * quad, valid,
                                               col0, rowpos, P);
        else
          page_scores<NS, false, M::kScoreHalf>(s, ssum, mx, 2 * quad, valid,
                                                col0, rowpos, P);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
          for (int o = 1; o <= 2; o <<= 1) {
            ssum[r] += __shfl_xor_sync(0xffffffffu, ssum[r], o);
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], o));
          }
        }
        // 4. local softmax at the statistic dtype, P at the score dtype,
        // then at the operand type packed as the A fragments of the P V
        // product (k16 step kk: pa[4 kk ..])
        float lsum[2] = {0.0f, 0.0f};
        uint32_t pa[NS / 2];
        if constexpr (H16) {
          const uint32_t mx2[2] = {h2_splat(mx[0]), h2_splat(mx[1])};
#pragma unroll
          for (int e = 0; e < NS; e += 2) {
            const int r = (e >> 1) & 1;
            const float2 d = __half22float2(h2_of(
                h2_sub(h2_bits(__floats2half2_rn(s[e], s[e + 1])), mx2[r])));
            const __half2 pp = __floats2half2_rn(expf(d.x), expf(d.y));
            lsum[r] += __low2float(pp);
            lsum[r] += __high2float(pp);
            pa[e / 2] = h2_bits(pp);
          }
        } else {
#pragma unroll
          for (int e = 0; e < NS; e += 2) {
            const int r = (e >> 1) & 1;
            float p0 = rnd(expf(rnd(__fsub_rn(s[e], mx[r]), sh)), sh);
            float p1 = rnd(expf(rnd(__fsub_rn(s[e + 1], mx[r]), sh)), sh);
            if constexpr (M::kScoreHalf) {   // P stored at fp16
              const __half h0 = __float2half_rn(p0), h1 = __float2half_rn(p1);
              lsum[r] += h2f(h0);
              lsum[r] += h2f(h1);
              pa[e / 2] = h2_bits(__halves2half2(h0, h1));
            } else {
              lsum[r] += p0;
              lsum[r] += p1;
              pa[e / 2] = pack2<OpT>(p0, p1);
            }
          }
        }

        // 5. P V into a fresh fp32 sum (V MN-major: its two 64-column
        // halves are the descriptor's leading-dimension step), issued
        // before the rows' recovery so that the two overlap
        float pv[64];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk)
          wgmma_rs_n128<M::kBF16>(pv, &pa[4 * kk],
                        gmma_desc(v_addr + kk * 16 * PF_HALF, BKV * PF_HALF,
                                  1024),
                        kk > 0);
        wgmma_commit();

#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
          for (int o = 1; o <= 2; o <<= 1)
            lsum[r] += __shfl_xor_sync(0xffffffffu, lsum[r], o);
        }
        // a row is live on the page iff the page's first (valid) column
        // is visible to it; dead rows keep their state and count
        bool live[2];
        RowStep rs[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          live[r] = rowpos[r] >= col0;
          const float sbar = rnd(__fdiv_rn(ssum[r], (float)valid), sh);
          rs[r] = row_update(m[r], l[r], f[r], cnt[r], sbar, mx[r],
                             rnd(lsum[r], sh), P);
          if (live[r]) {
            m[r] = rs[r].m;
            l[r] = rs[r].l;
            f[r] = rs[r].f;
            cnt[r] += 1;
          }
        }

        wgmma_wait_all();
        fence_regs<64>(pv);
        fence_regs<NS / 2>(pa);
        if (lane == 0) mbar_arrive(bar_e + 8 * st);   // the stage is consumed

        // 6. acc <- e_prev * acc + e_cur * pv at the accumulator dtype,
        // on live rows only
        if constexpr (H16) {
          const uint32_t ep[2] = {h2_splat(rs[0].e_prev), h2_splat(rs[1].e_prev)};
          const uint32_t ec[2] = {h2_splat(rs[0].e_cur), h2_splat(rs[1].e_cur)};
#pragma unroll
          for (int i2 = 0; i2 < 32; ++i2) {
            const int r = i2 & 1;
            const uint32_t pv2 =
                h2_bits(__floats2half2_rn(pv[2 * i2], pv[2 * i2 + 1]));
            const uint32_t nw = h2_add(h2_mul(ep[r], acc2[i2]), h2_mul(ec[r], pv2));
            acc2[i2] = live[r] ? nw : acc2[i2];
          }
        } else {
#pragma unroll
          for (int e = 0; e < 64; ++e) {
            const int r = (e >> 1) & 1;
            if (live[r])
              acc[e] = acc_update(acc[e], rnd(pv[e], ah), rs[r].e_prev,
                                  rs[r].e_cur, ah);
          }
        }
      } else if (lane == 0) {
        mbar_arrive(bar_e + 8 * st);
      }
    }

    // O = acc / l at the accumulator dtype, stored at the output dtype
    // (contiguous); rows that folded nothing (l == 0) emit 0, not 0/0
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (tile * PF_BQ + rl[r] >= chunk) continue;
      const float lr = l[r] > 0.0f ? l[r] : 1.0f;
      OpT* orow =
          out + ((size_t)bh * chunk + tile * PF_BQ + rl[r]) * HEAD_DIM + 2 * quad;
#pragma unroll
      for (int g = 0; g < 16; ++g) {
        float a0, a1;
        if constexpr (H16) {
          const float2 a = __half22float2(h2_of(acc2[2 * g + r]));
          a0 = a.x;
          a1 = a.y;
        } else {
          a0 = acc[4 * g + 2 * r];
          a1 = acc[4 * g + 2 * r + 1];
        }
        const float o0 = rnd(__fdiv_rn(a0, lr), ah);
        const float o1 = rnd(__fdiv_rn(a1, lr), ah);
        *reinterpret_cast<uint32_t*>(orow + 8 * g) = pack2<OpT>(o0, o1);
      }
    }
  }
}

// ---- host side ----------------------------------------------------------

template <typename PoolT>
constexpr CUtensorMapDataType kMapType =
    kIsCode<PoolT> ? CU_TENSOR_MAP_DATA_TYPE_UINT8
    : std::is_same<PoolT, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;

// Rank-4 map of a contiguous (P, page, KVH, 128) pool, innermost first:
// boxes of one kv head's `page` rows of one page, 64 columns with the
// 128-byte swizzle for 2-byte values, all 128 unswizzled for 8-bit codes.
template <typename PoolT>
static bool make_pool_map(CUtensorMap* map, const void* pool, int num_pages,
                          int page, int kv_heads) {
  constexpr int ES = sizeof(PoolT);
  const cuuint64_t dims[4] = {(cuuint64_t)HEAD_DIM, (cuuint64_t)kv_heads,
                              (cuuint64_t)page, (cuuint64_t)num_pages};
  const cuuint64_t row = (cuuint64_t)HEAD_DIM * ES;
  const cuuint64_t strides[3] = {row, row * kv_heads, row * kv_heads * page};
  const cuuint32_t box[4] = {(cuuint32_t)(ES == 1 ? HEAD_DIM : 64), 1,
                             (cuuint32_t)page, 1};
  return encode_map(map, kMapType<PoolT>, pool, dims, strides, box,
                    ES == 1 ? CU_TENSOR_MAP_SWIZZLE_NONE
                            : CU_TENSOR_MAP_SWIZZLE_128B);
}

template <typename PoolT, int BKV, bool H16, typename M>
static int launch(const void* q, const void* k_pages, const void* v_pages,
                  const SidecarPtrs& sc, const void* page_table,
                  const void* chunk_start, const void* kv_len, void* out,
                  int batch, int heads, int kv_heads, int chunk, int page,
                  int max_pages, int num_pages, const Policy& P,
                  cudaStream_t stream) {
  using L = PrefillLayout<PoolT, BKV>;
  using OpT = typename M::Op;
  CUtensorMap tq, tk, tv;
  const long long sh = (long long)chunk * HEAD_DIM;
  if (!make_map(&tq, q, batch, heads, chunk, heads * sh, sh, HEAD_DIM, PF_BQ,
                tma_dtype<OpT>()) ||
      !make_pool_map<PoolT>(&tk, k_pages, num_pages, page, kv_heads) ||
      !make_pool_map<PoolT>(&tv, v_pages, num_pages, page, kv_heads))
    return (int)cudaErrorInvalidValue;
  auto kernel = paged_prefill_kernel<PoolT, BKV, H16, M>;
  const int smem = L::BYTES + 1024;       // + the 1024-byte alignment
  static OncePerDevice ready;             // the attribute, per device
  bool* set = ready.current();
  if (!set) return (int)cudaErrorInvalidDevice;
  if (!*set) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    *set = true;
  }
  dim3 grid(batch * heads, (chunk + PF_BQ - 1) / PF_BQ);
  kernel<<<grid, PF_THREADS, smem, stream>>>(
      tq, tk, tv, sc, static_cast<const int*>(page_table),
      static_cast<const int*>(chunk_start), static_cast<const int*>(kv_len),
      static_cast<OpT*>(out), heads, kv_heads, chunk, page, max_pages, P);
  return (int)cudaGetLastError();
}

template <typename PoolT>
static int launch_pool(const void* q, const void* k_pages, const void* v_pages,
                       const SidecarPtrs& sc, const void* page_table,
                       const void* chunk_start, const void* kv_len, void* out,
                       int batch, int heads, int kv_heads, int chunk, int page,
                       int max_pages, int num_pages, int mode,
                       const Policy& P, cudaStream_t stream) {
  const int cfg = (page > 64) * 4 + wgmma_kind(mode, P);
#define PASA_PREFILL_LAUNCH(BKV, H16, M)                                      \
  launch<PoolT, BKV, H16, M>(q, k_pages, v_pages, sc, page_table, chunk_start, \
                             kv_len, out, batch, heads, kv_heads, chunk, page, \
                             max_pages, num_pages, P, stream)
  switch (cfg) {
    case 0: return PASA_PREFILL_LAUNCH(64, true, ModeF16);
    case 1: return PASA_PREFILL_LAUNCH(64, false, ModeF16);
    case 2: return PASA_PREFILL_LAUNCH(64, false, ModeF32);
    case 3: return PASA_PREFILL_LAUNCH(64, false, ModeBF16);
    case 4: return PASA_PREFILL_LAUNCH(128, true, ModeF16);
    case 5: return PASA_PREFILL_LAUNCH(128, false, ModeF16);
    case 6: return PASA_PREFILL_LAUNCH(128, false, ModeF32);
    default: return PASA_PREFILL_LAUNCH(128, false, ModeBF16);
  }
#undef PASA_PREFILL_LAUNCH
}

}  // namespace pasa

// Plain C entry point (bound with ctypes).  q, the pools and the sidecars
// are contiguous (pools (num_pages, page, kv_heads, 128)); the four
// sidecar pointers are read only for an 8-bit pool_kind (PoolKind).  q
// and out are at the policy's input dtype (bf16 if op_bf16, else fp16),
// scores at fp16 if score_half (else fp32).  Returns the cudaError_t of
// the launch; 0 means it was queued on `stream`.
extern "C" int pasa_paged_prefill_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* k_shift, const void* v_scale,
    const void* v_shift, const void* page_table, const void* chunk_start,
    const void* kv_len, void* out, int batch, int heads, int kv_heads,
    int chunk, int page, int max_pages, int num_pages, int pool_kind,
    float beta, float inva, float shift_scale, float post_scale,
    int stat_half, int acc_half, int score_half, int op_bf16, void* stream) {
  using namespace pasa;
  const int mode = mode_id(score_half, op_bf16);
  if (batch < 1 || heads < 1 || kv_heads < 1 || heads % kv_heads ||
      chunk < 1 || page < 16 || page > PF_MAX_PAGE || page % 16 ||
      max_pages < 1 || num_pages < 1 || (chunk + PF_BQ - 1) / PF_BQ > 65535 ||
      mode < 0)
    return (int)cudaErrorInvalidValue;
  const bool quant = pool_kind == POOL_INT8 || pool_kind == POOL_FP8;
  if (quant && !(k_scale && k_shift && v_scale && v_shift))
    return (int)cudaErrorInvalidValue;
  const Policy P = make_policy(beta, inva, shift_scale, post_scale, stat_half, acc_half);
  const SidecarPtrs sc = {
      {static_cast<const float*>(k_scale), static_cast<const float*>(v_scale)},
      {static_cast<const float*>(k_shift), static_cast<const float*>(v_shift)}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PASA_PREFILL_POOL(T)                                                  \
  launch_pool<T>(q, k_pages, v_pages, sc, page_table, chunk_start, kv_len,    \
                 out, batch, heads, kv_heads, chunk, page, max_pages,         \
                 num_pages, mode, P, s)
  switch (pool_kind) {
    case POOL_FP16: return PASA_PREFILL_POOL(__half);
    case POOL_BF16: return PASA_PREFILL_POOL(__nv_bfloat16);
    case POOL_INT8: return PASA_PREFILL_POOL(int8_t);
    case POOL_FP8: return PASA_PREFILL_POOL(__nv_fp8_e4m3);
    default: return (int)cudaErrorInvalidValue;
  }
#undef PASA_PREFILL_POOL
}
