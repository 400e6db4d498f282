// PASA chunked prefill over a paged KV pool, for Hopper (sm_90a): the
// kernel template, shared by four sources so that they compile in
// parallel - pasa_paged_prefill.cu and pasa_paged_prefill_q8.cu (pages of
// 1 to 128 rows of bf16 / fp16 and of 8-bit pools),
// pasa_paged_prefill_wide.cu and pasa_paged_prefill_wide_q8.cu (129 rows
// or more).
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
// Head widths D 32, 64 and 128, each an instance of the templates: every
// 2-byte tile is tile_width(D) columns of 64-column halves, D 32 in one
// half zero-padded past column 32 (hopper.cuh, "Head widths"); 8-bit
// codes land D bytes a row; the score GEMM runs D / 16 k16 steps, P V
// N = tile_width(D).
//
// What bounds it on an H100: operations.  A tile of 128 query rows reads
// each visible page once, so for a 512-token chunk the bytes are a few
// MB per layer while the two GEMMs are ~4 x rows x cols x D flops.
// The design is the attention kernel's Hopper shape (pasa_attention.cu),
// with a conversion stage in front of the GEMMs:
//  * a CTA is one converter warpgroup and two consumer warpgroups of 64
//    query rows each (setmaxnreg moves registers to the consumers); one
//    (b, head, 128-row tile) per CTA, the longest causal tiles first;
//  * pages of 1 to 128 rows share one tile of 128 key rows: a ring stage
//    holds npt = pages_per_stage(page) pages, page p at rows p * slot
//    (slot = page_slot(page), the page's rows rounded up to 16: whole k16
//    steps of P V, so every page starts 2,048-byte aligned and no step
//    holds two pages' columns) - pages of 1 to 16 rows 8 a stage, 17 to
//    32 rows 4, a page of 33 or more rows alone (two pages of 33 to 64
//    rows a stage ran page 64 3 % slower than one);
//  * the converter's thread 0 loads Q once, and each stage's pages' raw K
//    and V (one kv head) by TMA from a 4-D map of the pool with the page
//    id as a coordinate, one box a page at its slot and one barrier a
//    stage.  2-byte values land straight in a ring of three operand
//    stages, already in the 128-byte-swizzled layout the wgmma
//    descriptors read, and are converted in place (each element keeps its
//    address): one stage is computed, one converted, one loading.  8-bit
//    codes land at their slots in a buffer of their own, each page's two
//    shift sidecars beside them by bulk copy (its scales read a stage
//    ahead), and are dequantized into two operand stages; the next
//    stage's codes are requested as soon as the current one is converted;
//  * the converter warpgroup turns each page of the stage into the
//    operands at the policy's input dtype (fp16, or bf16 under
//    bf16_fp32), page by page: km per column over the page's valid rows
//    in row order (an fp32 sum rounded once; two km buffers, so a page's
//    sum runs while the previous page's rows are converted), then K' = (K
//    - beta km) / sqrt(d) and V at the input dtype (shift_key's
//    arithmetic) at the page's slot, rows past `valid` and past the
//    stage's pages zeroed; for 8-bit pools the dequantization is
//    load_pool8's with the page's own scale and shift (code * scale +
//    shift in fp32, one rounding to the input dtype); one hand-off a
//    stage, a stage ahead of the consumers, so the conversion overlaps
//    the previous stage's GEMMs;
//  * both GEMMs are wgmma (m64n128k16 for S from shared memory,
//    m64n{tile_width(D)}k16 for P V with P as the register operand and V
//    read MN-major).  One score GEMM covers the stage; S stays in
//    registers and is stored at the score dtype before anything reads it
//    (fp16, or the fp32 wgmma sum itself under fp32 and bf16_fp32; there
//    P enters the P V wgmma rounded once to the operand type, fp16 or
//    bf16, while l sums the fp32 P - a deviation from the reference's
//    fp32 P V held to its prefill bar (atol 1e-2, rtol 3e-2); the
//    attention kernel's two-term bf16 P (pasa_attention.cu) costs 32
//    registers the consumers here do not have at D 128: ptxas spills at
//    224, and the converter at 40).  Then, page by page in page order,
//    each its own PASA block: the rows' sums over the page's valid
//    columns and maxima over its visible ones, reduced over the 4 threads
//    that hold each row; P at the page's maxima (in place of its scores,
//    as the P V product's A fragments) and l; P V of the page's columns
//    only into a fresh fp32 sum - the k16 steps of its slot, the V
//    descriptor starting at its first row - issued, then the rows' step
//    (row_update: the page's own count and live flag; the dead-row no-op)
//    and the next page's statistics while it runs; then that sum rounded
//    to the accumulator dtype and folded by acc_update.  No log-sum-exp
//    combine and no single P V over pre-scaled P: each page's P V is
//    rounded on its own, as the fp16 policy's reference rounds it.  A
//    page's columns sit at the same k positions of its k16 steps as in a
//    stage of its own, so every page keeps the bits of a page a stage.
//    Every step of a page is one wgmma call site over the same registers
//    whatever page it serves: a step whose operands were one register set
//    or another (a slot of 8 rows, its step's second half zero) made
//    ptxas serialize every wgmma of the kernel ("insufficient register
//    resources"), the one-page path's too.
//    Registers (224 a consumer thread): the stage's scores stay live over
//    its pages - fp16 pairs under fp16 scores (32 registers), fp32 under
//    fp32 and bf16_fp32 (64) - beside P V's sum and the accumulator; at D
//    128 with fp32 scores P V runs in two 64-column parts, one after the
//    other.  The next page's P V does not overlap this page's fold at any
//    width: the fold waits for the sum it folds, and a second sum does
//    not fit beside the scores at D 128; at 64 and 32 it would, but no
//    served path runs paged prefill there (the head_dim-64 families, the
//    hybrid and Whisper, have no paged interface), so the kernel keeps
//    one order and one instance body for every width.  Each row keeps its
//    own block count and live flag; under the all-fp16 policy the
//    per-element softmax and accumulator steps run on fp16 pairs with the
//    same bits (hopper.cuh).  A page of 33 to 128 rows runs instances of
//    their own (PACK false: the one-page path, converter and consumers as
//    before several pages shared a stage): a page a stage, an 8-bit
//    page's scales read a page ahead before its codes are waited for and
//    its km summed before the operand stage is, the score masks skipped
//    where every column is valid and visible, P V overlapping the rows'
//    step.
//
// Pages of 129 rows or more (BKV 256): one block is wider than a ring
// stage of 128 rows, and its key mean and pseudo-average need all its
// valid rows before its first score is final.  The design is a single
// stage of 256 rows (the converter's TMA for the next hand-off waits for
// the consumers to release the stage: no overlap of a load with the
// previous page's math), the page's scores in quarters of 64 columns, and
// one softmax per page, as the plain version computes it:
//  * a first pass over the quarters takes the rows' sum over the valid
//    columns and their max over the visible ones;
//  * then, per 64-column half of V (one at D 32 and 64, two at 128), each
//    quarter's scores again (the same bits), its P at the page's max, and
//    P V over the half's columns into one fp32 sum over the page; after
//    the first half the rows' step, the dead-row no-op and the block
//    count, once a page; then that half of the accumulator.  A half at a
//    time keeps the consumers' live state at 32 P V sums, 32 scores and 16
//    P fragments beside the accumulator (a whole page's P and P V do not
//    fit the registers beside a second path of that size: ptxas spills).
// A page of at most 256 rows is one hand-off that serves every pass.  A
// wider page (any page: a TMA box holds at most 256 rows) whose valid rows
// span npc > 1 pieces of 256 streams through the stage piece by piece,
// each piece's box at its row offset inside the page (rows past the
// page's end filled with zeros by the map, rows past `valid` zeroed by
// the converter), once for each pass: pass 0, the converter alone (beta >
// 0), takes km as fp32 column sums over the pieces' K in row order,
// rounded once (the bits of one sum over the page); the first pass hands
// over K' alone, each V half's pass K' (the same bits) and V.  An 8-bit
// page's sidecars come once, with its first piece.  K is read 2 + NH times
// a page and query tile, V NH times.  Shared memory at D 128: 165,408
// bytes over a bf16 pool, 231,968 over 8-bit codes (a 256-row code buffer
// beside the two operand tiles); at D 64 and 32 less.

#pragma once

#include <type_traits>

#include "hopper.cuh"

namespace pasa {

constexpr int PF_NWG = 2;                       // consumer warpgroups
constexpr int PF_BQ = 64 * PF_NWG;              // query rows per CTA
constexpr int PF_THREADS = 128 * (PF_NWG + 1);
constexpr int PF_HALF = 64 * 2;                 // a 64-column half-row (2 B)
constexpr int PF_BOX = 256;                     // most rows of a TMA box
constexpr int PF_BN = 128;                      // score columns of one GEMM

// Cycle spans of the 128-row tile's phases (launch/prefill_spans.py builds
// with -DPASA_PREFILL_SPANS; otherwise the marks are empty): the
// converter's thread 0 (who 0) and the first consumer warpgroup's thread
// 0 (who 1) each add the clock64 cycles since their previous mark to
// span k of their row, and PASA_TALLY counts a stage (k 14) or a page (k
// 15).
#ifdef PASA_PREFILL_SPANS
__device__ unsigned long long pasa_prefill_spans[2][16];
#define PASA_SPAN_INIT long long span_t = clock64()
#define PASA_SPAN(who, k)                                                    \
  do {                                                                       \
    if (threadIdx.x == 128 * (who)) {                                        \
      const long long span_now = clock64();                                  \
      atomicAdd(&pasa_prefill_spans[who][k],                                 \
                (unsigned long long)(span_now - span_t));                    \
      span_t = span_now;                                                     \
    }                                                                        \
  } while (0)
#define PASA_TALLY(who, k)                                                   \
  do {                                                                       \
    if (threadIdx.x == 128 * (who)) atomicAdd(&pasa_prefill_spans[who][k], 1ull); \
  } while (0)
#else
#define PASA_SPAN_INIT
#define PASA_SPAN(who, k)
#define PASA_TALLY(who, k)
#endif

// The rows a page takes in a stage of the 128-row tile: its rows rounded
// up to a multiple of 16, whole k16 steps of P V, so that every page
// starts on two 128-byte-swizzle atoms (2,048 bytes; its TMA box lands
// straight at its row offset and its P V descriptor starts there) and no
// k16 step holds two pages' columns.
__host__ __device__ constexpr int page_slot(int page) {
  return (page + 15) & ~15;
}

// The pages a stage of the 128-row tile holds (pages of 1-16 rows: 8,
// 17-32: 4); a page of more than PF_PACK rows takes a stage alone.
constexpr int PF_PACK = 32;
__host__ __device__ constexpr int pages_per_stage(int page) {
  return PF_BN / page_slot(page);
}

template <typename PoolT, int BKV, int D>
struct PrefillLayout {
  static constexpr bool CODE = kIsCode<PoolT>;
  static constexpr int W = tile_width(D);          // 2-byte tile columns
  static constexpr int NH = W / 64;                // 64-column halves
  // 2-byte values land by TMA in an operand stage and are converted in
  // place (three stages: one computed, one converted, one loading);
  // 8-bit codes land in a buffer of their own (two operand stages); a
  // 256-row page has one stage
  static constexpr int STAGES = BKV > PF_BN ? 1 : CODE ? 2 : 3;
  // most pages a stage (8, pages of 1-16 rows)
  static constexpr int NPS = BKV > PF_BN ? 1 : pages_per_stage(1);
  static constexpr int Q_BYTES = PF_BQ * W * 2;          // NH 64-col halves
  static constexpr int OP_BYTES = BKV * W * 2;           // one K' or V tile
  static constexpr int CODE_BYTES = BKV * D;             // a stage's K or V
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + Q_BYTES;               // + stage
  static constexpr int V_OFF = K_OFF + STAGES * OP_BYTES;     // + stage
  static constexpr int CODE_OFF = V_OFF + STAGES * OP_BYTES;  // K then V codes
  // 8-bit pools: per page of the stage its K and V shifts, then its K and
  // V scales
  static constexpr int SHIFT_OFF = CODE_OFF + (CODE ? 2 * CODE_BYTES : 0);
  static constexpr int SCALE_OFF = SHIFT_OFF + (CODE ? NPS * 2 * D * 4 : 0);
  static constexpr int KM_OFF =
      SCALE_OFF + (CODE && BKV <= PF_BN ? NPS * 2 * 4 : 0);
  // km: two buffers in the 128-row tile (page by page), one in the 256
  static constexpr int BAR_OFF = KM_OFF + (BKV > PF_BN ? 1 : 2) * D * 4;
  // barriers: Q full; raw page full (per stage, or the code buffer's);
  // operands full and empty per stage
  static constexpr int N_RAW = CODE ? 1 : STAGES;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + N_RAW + 2 * STAGES);
};

// Byte offset of the 16-byte chunk of columns [c8, c8 + 8) of row r in a
// fp16 (or bf16) tile of BKV-row 64-column halves, 128-byte swizzle: the
// layout TMA writes and the wgmma descriptors read.
template <int BKV>
__device__ __forceinline__ uint32_t swz(int r, int c8) {
  return (c8 >> 6) * BKV * PF_HALF + r * PF_HALF +
         ((((c8 & 63) >> 3) ^ (r & 7)) << 4);
}

// Raw element (r, c) of a staged K or V page (`tile`: 2-byte values in
// the operand layout, or codes [BKV][D]) at the operand type OpT
// (returned widened): the value load_pool8 gives it.
template <typename OpT, typename PoolT, int BKV, int D>
__device__ __forceinline__ float raw_elem(const unsigned char* tile, int r,
                                          int c, float scale,
                                          const float* shift) {
  if constexpr (kIsCode<PoolT>) {
    const PoolT code = reinterpret_cast<const PoolT*>(tile)[r * D + c];
    return to_float(from_float<OpT>(
        __fadd_rn(__fmul_rn(code_to_float(code), scale), shift[c])));
  } else {
    return to_float(to_op<OpT>(*reinterpret_cast<const PoolT*>(
        tile + swz<BKV>(r, c & ~7) + (c & 7) * 2)));
  }
}

// Raw elements (r, c8 .. c8 + 7) of a staged page as eight OpT values.
template <typename OpT, typename PoolT, int BKV, int D>
__device__ __forceinline__ uint4 raw_chunk(const unsigned char* tile, int r,
                                           int c8, float scale,
                                           const float* shift) {
  if constexpr (kIsCode<PoolT>) {
    return load8_dequant<OpT>(
        reinterpret_cast<const PoolT*>(tile + r * D + c8), scale,
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

// S = Q K'^T of a consumer warpgroup's 64 rows against BN key columns
// of the K' tile from k_addr on (D / 16 steps of k16 over the 64-column
// halves, a half of a BKV-row tile BKV * PF_HALF bytes), waited for.
template <int BKV, int BN, int D, bool BF16>
__device__ __forceinline__ void page_gemm_scores(float* s, uint32_t q_addr,
                                                 uint32_t k_addr) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk >> 2), in = (kk & 3) * 32;
    wgmma_scores<BN, BF16>(
        s, gmma_desc(q_addr + off * PF_BQ * PF_HALF + in, 16, 1024),
        gmma_desc(k_addr + off * BKV * PF_HALF + in, 16, 1024), kk > 0);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs<BN / 2>(s);
}

// The local softmax of masked scores s (NS a thread, two rows) at the
// rows' maxima mx, at the statistic dtype: P at the score dtype, then at
// the operand type packed as the A fragments of the P V product (k16 step
// kk: pa[4 kk ..]); lsum[r] gets row r's sum of P.
template <int NS, bool H16, typename M>
__device__ __forceinline__ void page_probs(const float* s, const float* mx,
                                           bool sh, float* lsum,
                                           uint32_t* pa) {
  using OpT = typename M::Op;
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
}

// The rows' sums and maxima over the 4 threads that hold each row.
__device__ __forceinline__ void quad_reduce(float* ssum, float* mx) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      ssum[r] += __shfl_xor_sync(0xffffffffu, ssum[r], o);
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], o));
    }
  }
}

// Step 5 of a page, the rows' part: the sums of P over the 4 threads that
// hold each row, then each row's recovery step (Algorithm 1 lines 14-18)
// at the page's pseudo-average and max.  A row is live on the page iff the
// page's first (valid) column is visible to it; dead rows keep their state
// and count.
__device__ __forceinline__ void page_rows(const float* ssum, const float* mx,
                                          float* lsum, int valid, int col0,
                                          const int* rowpos, float* m, float* l,
                                          float* f, int* cnt, bool* live,
                                          RowStep* rs, const Policy& P) {
  const bool sh = P.stat_half;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1)
      lsum[r] += __shfl_xor_sync(0xffffffffu, lsum[r], o);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    live[r] = rowpos[r] >= col0;
    const float sbar = rnd(__fdiv_rn(ssum[r], (float)valid), sh);
    rs[r] = row_update(m[r], l[r], f[r], cnt[r], sbar, mx[r], rnd(lsum[r], sh),
                       P);
    if (live[r]) {
      m[r] = rs[r].m;
      l[r] = rs[r].l;
      f[r] = rs[r].f;
      cnt[r] += 1;
    }
  }
}

// Step 6 of a page: acc <- e_prev * acc + e_cur * pv at the accumulator
// dtype, on live rows only (H16: on fp16 pairs, acc2), over N of the
// thread's fp32 P V sums (N = D / 2: the whole head; 32: a 64-column half,
// acc and acc2 then pointing at that half's first sum and pair).
template <int N, bool H16>
__device__ __forceinline__ void page_acc(float* acc, uint32_t* acc2,
                                         const float* pv, const bool* live,
                                         const RowStep* rs, bool ah) {
  if constexpr (H16) {
    const uint32_t ep[2] = {h2_splat(rs[0].e_prev), h2_splat(rs[1].e_prev)};
    const uint32_t ec[2] = {h2_splat(rs[0].e_cur), h2_splat(rs[1].e_cur)};
#pragma unroll
    for (int i2 = 0; i2 < N / 2; ++i2) {
      const int r = i2 & 1;
      const uint32_t pv2 =
          h2_bits(__floats2half2_rn(pv[2 * i2], pv[2 * i2 + 1]));
      const uint32_t nw = h2_add(h2_mul(ep[r], acc2[i2]), h2_mul(ec[r], pv2));
      acc2[i2] = live[r] ? nw : acc2[i2];
    }
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const int r = (e >> 1) & 1;
      if (live[r])
        acc[e] = acc_update(acc[e], rnd(pv[e], ah), rs[r].e_prev, rs[r].e_cur,
                            ah);
    }
  }
}

// ---- a stage of several pages (pages of at most PF_PACK rows) -----------
//
// The stage's scores s[NS] (32-bit registers) hold, for each of the
// thread's pairs (8-column group g, row r: columns 8 g + 2 quad, + 1), the
// pair in s[4 g + 2 r] as one fp16 pair (SH) or in s[4 g + 2 r], s[4 g +
// 2 r + 1] as the bits of two fp32 values, and later the pair's P (at the
// operand type) in s[4 g + 2 r]: the P V product's A fragment of group g.
// A page is the groups [g0, g0 + gpp), g0 a runtime value: the switches
// below keep every register index static.

// The scores sf of the score GEMM stored at the score dtype (store_score)
// as s's pairs.
template <int NS, bool SH>
__device__ __forceinline__ void tile_store(const float* sf, uint32_t* s,
                                           const Policy& P) {
#pragma unroll
  for (int e = 0; e < NS; e += 2) {
    const float v0 = store_score<SH>(sf[e], P);
    const float v1 = store_score<SH>(sf[e + 1], P);
    if constexpr (SH) {
      s[e] = h2_bits(__floats2half2_rn(v0, v1));
    } else {
      s[e] = __float_as_uint(v0);
      s[e + 1] = __float_as_uint(v1);
    }
  }
}

template <bool SH>
__device__ __forceinline__ float2 pair_of(const uint32_t* s, int e) {
  if constexpr (SH) return __half22float2(h2_of(s[e]));
  else return make_float2(__uint_as_float(s[e]), __uint_as_float(s[e + 1]));
}

// A page's groups: a switch enters the unrolled groups at g0 and falls
// through to the page's end, so that a page runs only its own groups'
// code, in one straight run (a branch on every group of the stage ran
// page 16 at 1.3x this time).
#define PASA_SLOT_GROUPS(X)                                              \
  X(0) X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12)  \
  X(13) X(14) X(15)

// page_scores over group G of a page (its page columns lc + {0, 1};
// without `mask` every column is valid and visible to every row).
template <int G, bool SH>
__device__ __forceinline__ void group_scores(const uint32_t* s, float* ssum,
                                             float* mx, bool mask, int lc,
                                             int valid, int col0,
                                             const int* rowpos) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float2 v = pair_of<SH>(s, 4 * G + 2 * r);
    if (mask) {
      if (lc < valid) ssum[r] += v.x;
      if (lc + 1 < valid) ssum[r] += v.y;
      const bool vis0 = lc < valid && col0 + lc <= rowpos[r];
      const bool vis1 = lc + 1 < valid && col0 + lc + 1 <= rowpos[r];
      mx[r] = fmaxf(mx[r], vis0 ? v.x : NEG_BIG);
      mx[r] = fmaxf(mx[r], vis1 ? v.y : NEG_BIG);
    } else {
      ssum[r] += v.x;
      ssum[r] += v.y;
      mx[r] = fmaxf(fmaxf(mx[r], v.x), v.y);
    }
  }
}

// page_scores over one page of the stage (lc0: the lanes' first page
// column), then reduced over the 4 threads of each row.  It only reads s:
// it runs while the previous page's P V reads s's registers.
template <bool SH>
__device__ __forceinline__ void slot_scores(const uint32_t* s, float* ssum,
                                            float* mx, int g0, int gpp,
                                            bool mask, int lc0, int valid,
                                            int col0, const int* rowpos) {
  ssum[0] = ssum[1] = 0.0f;
  mx[0] = mx[1] = -INFINITY;
  const int end = g0 + gpp;
  switch (g0) {
#define PASA_SLOT_SCORES(G)                                               \
  case G:                                                                 \
    if (G >= end) break;                                                  \
    group_scores<G, SH>(s, ssum, mx, mask, lc0 + 8 * (G - g0), valid, col0, \
                        rowpos);                                          \
    [[fallthrough]];
    PASA_SLOT_GROUPS(PASA_SLOT_SCORES)
#undef PASA_SLOT_SCORES
    default:
      break;
  }
  quad_reduce(ssum, mx);
}

// page_probs over group G of a page (masked columns, as group_scores
// finds them, get P = 0: page_scores' -inf scores): P in place as the A
// fragments.
template <int G, bool H16, typename M>
__device__ __forceinline__ void group_probs(uint32_t* s, bool mask, int lc,
                                            int valid, int col0,
                                            const int* rowpos,
                                            const float* mx,
                                            const uint32_t* mx2, bool sh,
                                            float* lsum) {
  using OpT = typename M::Op;
  constexpr bool SH = M::kScoreHalf;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int e = 4 * G + 2 * r;
    const bool vis0 = !mask || (lc < valid && col0 + lc <= rowpos[r]);
    const bool vis1 = !mask || (lc + 1 < valid && col0 + lc + 1 <= rowpos[r]);
    if constexpr (H16) {
      const float2 d = __half22float2(h2_of(h2_sub(s[e], mx2[r])));
      const __half2 pp = __floats2half2_rn(vis0 ? expf(d.x) : 0.0f,
                                           vis1 ? expf(d.y) : 0.0f);
      lsum[r] += __low2float(pp);
      lsum[r] += __high2float(pp);
      s[e] = h2_bits(pp);
    } else {
      const float2 v = pair_of<SH>(s, e);
      const float p0 =
          vis0 ? rnd(expf(rnd(__fsub_rn(v.x, mx[r]), sh)), sh) : 0.0f;
      const float p1 =
          vis1 ? rnd(expf(rnd(__fsub_rn(v.y, mx[r]), sh)), sh) : 0.0f;
      if constexpr (SH) {   // P stored at fp16
        const __half h0 = __float2half_rn(p0), h1 = __float2half_rn(p1);
        lsum[r] += h2f(h0);
        lsum[r] += h2f(h1);
        s[e] = h2_bits(__halves2half2(h0, h1));
      } else {
        lsum[r] += p0;
        lsum[r] += p1;
        s[e] = pack2<OpT>(p0, p1);
      }
    }
  }
}

// page_probs over one page of the stage.
template <bool H16, typename M>
__device__ __forceinline__ void slot_probs(uint32_t* s, int g0, int gpp,
                                           bool mask, int lc0, int valid,
                                           int col0, const int* rowpos,
                                           const float* mx, bool sh,
                                           float* lsum) {
  const uint32_t mx2[2] = {H16 ? h2_splat(mx[0]) : 0u,
                           H16 ? h2_splat(mx[1]) : 0u};
  const int end = g0 + gpp;
  switch (g0) {
#define PASA_SLOT_PROBS(G)                                                \
  case G:                                                                 \
    if (G >= end) break;                                                  \
    group_probs<G, H16, M>(s, mask, lc0 + 8 * (G - g0), valid, col0,      \
                           rowpos, mx, mx2, sh, lsum);                    \
    [[fallthrough]];
    PASA_SLOT_GROUPS(PASA_SLOT_PROBS)
#undef PASA_SLOT_PROBS
    default:
      break;
  }
}

// P V of one page of the stage into a fresh fp32 sum, issued (not waited
// for): the k16 steps of its slot (groups g0, g0 + 2, ...; g0 even), V's
// rows from the same row (v_addr: the part's first column; PW columns:
// wgmma_pv).  Each step takes the same registers (s, whatever page it
// belongs to): ptxas serializes every wgmma of a kernel where one step's
// operands could be one register set or another.
template <int PW, int BKV, bool BF16>
__device__ __forceinline__ void slot_pv(float* pv, const uint32_t* s, int g0,
                                        int gpp, uint32_t v_addr) {
  const int end = g0 + gpp;
  switch (g0 >> 1) {
#define PASA_SLOT_PV(I)                                                   \
  case I:                                                                 \
    if (2 * I >= end) break;                                              \
    {                                                                     \
      const uint32_t a[4] = {s[8 * I], s[8 * I + 2], s[8 * I + 4],        \
                             s[8 * I + 6]};                               \
      wgmma_pv<PW, BF16>(                                                 \
          pv, a,                                                          \
          gmma_desc(v_addr + 16 * I * PF_HALF, BKV * PF_HALF, 1024),      \
          2 * I != g0);                                                   \
    }                                                                     \
    [[fallthrough]];
    PASA_SLOT_PV(0) PASA_SLOT_PV(1) PASA_SLOT_PV(2) PASA_SLOT_PV(3)
    PASA_SLOT_PV(4) PASA_SLOT_PV(5) PASA_SLOT_PV(6) PASA_SLOT_PV(7)
#undef PASA_SLOT_PV
    default:
      break;
  }
}
#undef PASA_SLOT_GROUPS

// Keep the A fragments (the even registers of s) unreused until the wait.
template <int NS>
__device__ __forceinline__ void fence_pairs(uint32_t* s) {
#pragma unroll
  for (int e = 0; e < NS; e += 2) asm volatile("" : "+r"(s[e])::"memory");
}

// M: the policy's mode (operand type, score store).  H16 (only with
// ModeF16): statistics and accumulator at fp16 (the paper's policy): the
// softmax and accumulator steps run on fp16 pairs.  D: the head width.
// PACK (the 128-row tile): pages of at most PF_PACK rows, several a stage;
// else one page a stage, its loops known while compiling (with the
// pages a stage a runtime value, pages of 128 rows ran 7 % slower).
template <typename PoolT, int BKV, bool PACK, int D, bool H16, typename M>
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
  using L = PrefillLayout<PoolT, BKV, D>;
  // a stage's scores in one GEMM of BKV columns (the 128-row tile); the
  // 256-row tile's in quarters of 64
  constexpr int NS = BKV > PF_BN ? 32 : BKV / 2;   // score registers a thread
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
    PASA_SPAN_INIT;
    const float* shift = reinterpret_cast<const float*>(sm + L::SHIFT_OFF);
    float* km_s = reinterpret_cast<float*>(sm + L::KM_OFF);
    const CUtensorMap* mk = &tk;
    const CUtensorMap* mv = &tv;
    if (ct == 0 && n_live > 0) {
      mbar_expect_tx(bar_q, L::Q_BYTES);
      for (int half = 0; half < L::NH; ++half)
        tma_load_4d(s_base + L::Q_OFF + half * PF_BQ * PF_HALF, &tq, bar_q,
                    64 * half, tile * PF_BQ, bh % heads, b);
    }
    // this thread's 8 columns: a row is CPR chunks of 8, RPS rows a step
    constexpr int CPR = D / 8, RPS = 128 / CPR;
    const int c8 = (ct % CPR) * 8;
    // 8-bit pools: the page's two scales (live pages only: a dead page's
    // sidecars may be NaN)
    float sck = 0.0f, scv = 0.0f;
    if constexpr (BKV > PF_BN) {
      // ---- the 256-row tile: one stage, a page in pieces of 256 rows ----
      const int box = min(page, BKV);            // rows of a piece's box
      unsigned char* opk = sm + L::K_OFF;
      unsigned char* opv = sm + L::V_OFF;
      const unsigned char* rk = L::CODE ? sm + L::CODE_OFF : opk;
      const unsigned char* rv = L::CODE ? sm + L::CODE_OFF + L::CODE_BYTES : opv;
      int loads = 0, handoffs = 0;
      // rows [row0, row0 + box) of page pid's K (and V) into the stage,
      // once the consumers release it (2-byte values), or into the code
      // buffer (and the page's shift sidecars if `side`); every converter
      // thread is done with the previous load
      auto load = [&](int pid, int row0, bool with_v, bool side) {
        if (ct == 0) {
          if constexpr (L::CODE) {
            mbar_expect_tx(bar_raw, (with_v ? 2 : 1) * box * D +
                                        (side ? 2 * D * 4 : 0));
            tma_load_4d(s_base + L::CODE_OFF, mk, bar_raw, 0, kvh, row0, pid);
            if (with_v)
              tma_load_4d(s_base + L::CODE_OFF + L::CODE_BYTES, mv, bar_raw, 0,
                          kvh, row0, pid);
            if (side) {
              const size_t ph = ((size_t)pid * kv_heads + kvh) * D;
              bulk_load(s_base + L::SHIFT_OFF, sc.shift[0] + ph, D * 4,
                        bar_raw);
              bulk_load(s_base + L::SHIFT_OFF + D * 4, sc.shift[1] + ph,
                        D * 4, bar_raw);
            }
          } else {
            mbar_wait(bar_e, (handoffs & 1) ^ 1);
            mbar_expect_tx(bar_raw, (with_v ? 2 : 1) * L::NH * box * PF_HALF);
            for (int half = 0; half < L::NH; ++half) {
              tma_load_4d(s_base + L::K_OFF + half * BKV * PF_HALF, mk,
                          bar_raw, 64 * half, kvh, row0, pid);
              if (with_v)
                tma_load_4d(s_base + L::V_OFF + half * BKV * PF_HALF, mv,
                            bar_raw, 64 * half, kvh, row0, pid);
            }
          }
        }
        mbar_wait(bar_raw, loads & 1);
        ++loads;
      };
      // the staged rows [0, vp) as operands (K', and V if with_v) at the
      // operand type, zeros past vp (one row per step, as below); then
      // the stage goes to the consumers
      auto hand = [&](int vp, bool with_v) {
        float bkm[8];                  // beta * km of this thread's columns
#pragma unroll
        for (int e = 0; e < 8; ++e)
          bkm[e] = P.beta > 0.0f ? __fmul_rn(P.beta, km_s[c8 + e]) : 0.0f;
        if constexpr (L::CODE) mbar_wait(bar_e, (handoffs & 1) ^ 1);
#pragma unroll 1
        for (int r = ct / CPR; r < BKV; r += RPS) {
          uint4 kk = make_uint4(0u, 0u, 0u, 0u), vv = kk;
          if (r < vp) {
            kk = raw_chunk<OpT, PoolT, BKV, D>(rk, r, c8, sck, shift);
            if (with_v)
              vv = raw_chunk<OpT, PoolT, BKV, D>(rv, r, c8, scv, shift + D);
            if (P.beta > 0.0f) {
              OpT* kh = reinterpret_cast<OpT*>(&kk);
#pragma unroll
              for (int e = 0; e < 8; ++e)
                kh[e] = from_float<OpT>(__fmul_rn(
                    __fsub_rn(to_float(kh[e]), bkm[e]), P.shift_scale));
            }
          }
          *reinterpret_cast<uint4*>(opk + swz<BKV>(r, c8)) = kk;
          if (with_v) *reinterpret_cast<uint4*>(opv + swz<BKV>(r, c8)) = vv;
        }
        fence_proxy_async();            // the operands are for wgmma
        mbar_arrive(bar_f);
        named_sync(1, 128);             // the staged rows are consumed
        ++handoffs;
      };
      for (int j = 0; j < n_live; ++j) {
        const int valid = min(page, L_kv - j * page);
        const int pid = table[j];
        const int npc = (valid + BKV - 1) / BKV;   // pieces with valid rows
        if constexpr (L::CODE) {
          const size_t ph = (size_t)pid * kv_heads + kvh;
          sck = __ldg(sc.scale[0] + ph);
          scv = __ldg(sc.scale[1] + ph);
        }
        // 1. km of column ct over the valid rows, an fp32 sum in row order
        //    (over the pieces: pass 0)
        float sum = 0.0f;
        const int km_loads = npc == 1 ? 1 : P.beta > 0.0f ? npc : 0;
        for (int i = 0; i < km_loads; ++i) {
          load(pid, i * BKV, npc == 1, i == 0);
          if (P.beta > 0.0f && ct < D) {
            for (int r = 0; r < min(BKV, valid - i * BKV); ++r)
              sum += raw_elem<OpT, PoolT, BKV, D>(rk, r, ct, sck, shift);
          }
          if (npc > 1) named_sync(1, 128);   // the piece is summed
        }
        if (P.beta > 0.0f && ct < D) km_s[ct] = __fdiv_rn(sum, (float)valid);
        named_sync(1, 128);
        // 2. the operands: a page of one piece from the load above; a
        //    wider page 1 + NH times over its pieces, K' alone (pass 1),
        //    then K' and V (a pass per 64-column half of V)
        if (npc == 1) {
          hand(valid, true);
        } else {
          for (int pass = 1; pass <= 1 + L::NH; ++pass) {
            for (int i = 0; i < npc; ++i) {
              load(pid, i * BKV, pass > 1,
                   P.beta == 0.0f && pass == 1 && i == 0);
              hand(min(BKV, valid - i * BKV), pass > 1);
            }
          }
        }
      }
    } else if constexpr (!PACK) {
      // ---- pages of 33 to 128 rows: a page a stage ----
      const uint32_t page_bytes =
          L::CODE ? 2 * page * D + 2 * D * 4 : 2 * L::NH * page * PF_HALF;
      // request page j's raw K and V of kv head kvh: 2-byte values into
      // operand stage j % NST, codes (and the sidecar shifts) into the code
      // buffer
      auto issue = [&](int j) {
        const int pid = table[j];
        if constexpr (L::CODE) {
          const uint32_t dst = s_base + L::CODE_OFF;
          mbar_expect_tx(bar_raw, page_bytes);
          tma_load_4d(dst, mk, bar_raw, 0, kvh, 0, pid);
          tma_load_4d(dst + L::CODE_BYTES, mv, bar_raw, 0, kvh, 0, pid);
          const size_t ph = ((size_t)pid * kv_heads + kvh) * D;
          bulk_load(s_base + L::SHIFT_OFF, sc.shift[0] + ph, D * 4, bar_raw);
          bulk_load(s_base + L::SHIFT_OFF + D * 4, sc.shift[1] + ph, D * 4,
                    bar_raw);
        } else {
          const int st = j % NST;
          const uint32_t bar = bar_raw + 8 * st;
          mbar_expect_tx(bar, page_bytes);
          for (int half = 0; half < L::NH; ++half) {
            tma_load_4d(s_base + L::K_OFF + st * L::OP_BYTES + half * BKV * PF_HALF,
                        mk, bar, 64 * half, kvh, 0, pid);
            tma_load_4d(s_base + L::V_OFF + st * L::OP_BYTES + half * BKV * PF_HALF,
                        mv, bar, 64 * half, kvh, 0, pid);
          }
        }
      };
      // in place: pages 0 .. NST - 2 ahead; codes: one page
      if (ct == 0) {
        for (int p = 0; p < min(n_live, L::CODE ? 1 : NST - 1); ++p) issue(p);
      }
      if constexpr (L::CODE) {
        if (n_live > 0) {
          const size_t ph = (size_t)table[0] * kv_heads + kvh;
          sck = __ldg(sc.scale[0] + ph);
          scv = __ldg(sc.scale[1] + ph);
        }
      }
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
        PASA_SPAN(0, 0);                // waiting for the page
        // 1. km of column ct over the valid rows, an fp32 sum in row order
        if (P.beta > 0.0f && ct < D) {
          float sum = 0.0f;
          for (int r = 0; r < valid; ++r)
            sum += raw_elem<OpT, PoolT, BKV, D>(rk, r, ct, sck, shift);
          km_s[ct] = __fdiv_rn(sum, (float)valid);
        }
        named_sync(1, 128);
        PASA_SPAN(0, 1);                // km
        // beta * km of this thread's columns (shift_key's first product)
        float bkm[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          bkm[e] = P.beta > 0.0f ? __fmul_rn(P.beta, km_s[c8 + e]) : 0.0f;
        // 2. K' = (K - beta km) / sqrt(d) and V at the operand type into
        //    stage st (in place for 2-byte pools; for codes once the
        //    consumers release the stage); rows past `valid` (and past the
        //    page) become zeros; at D 32 the padded half's columns are
        //    TMA's zeros (2-byte pools) or left as they are (codes): K's
        //    are past the score GEMM's depth, V's feed only P V columns the
        //    epilogue never reads
        //    (one row per step: the converter runs at 56 registers, and
        //    unrolled steps spill)
        if constexpr (L::CODE) mbar_wait(bar_e + 8 * st, ((j / NST) & 1) ^ 1);
        PASA_SPAN(0, 2);                // waiting for the operand stage
#pragma unroll 1
        for (int r = ct / CPR; r < BKV; r += RPS) {
          uint4 kk = make_uint4(0u, 0u, 0u, 0u), vv = kk;
          if (r < valid) {
            kk = raw_chunk<OpT, PoolT, BKV, D>(rk, r, c8, sck, shift);
            vv = raw_chunk<OpT, PoolT, BKV, D>(rv, r, c8, scv, shift + D);
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
        PASA_SPAN(0, 3);                // K' and V
        fence_proxy_async();            // the operands are for wgmma
        mbar_arrive(bar_f + 8 * st);
        named_sync(1, 128);             // the raw page and km are consumed
        if (ct == 0) {
          if constexpr (L::CODE) {
            if (j + 1 < n_live) issue(j + 1);
          } else {
            // page p into stage p % NST, once the consumers release page
            // p - NST (NST - 1 pages ahead)
            const int p = j + NST - 1;
            if (p < n_live) {
              if (p >= NST) mbar_wait(bar_e + 8 * ((p - NST) % NST), ((p - NST) / NST) & 1);
              issue(p);
            }
          }
        }
        sck = sck_n;
        scv = scv_n;
        PASA_SPAN(0, 4);                // the hand-off
        PASA_TALLY(0, 14);
        PASA_TALLY(0, 15);
      }
    } else {
      // ---- pages of at most PF_PACK rows: a stage of npt pages, page p
      // at rows p * slot ----
      const int slot = page_slot(page);
      const int npt = pages_per_stage(page);
      const int n_st = (n_live + npt - 1) / npt;
      const uint32_t page_bytes =
          L::CODE ? 2 * page * D + 2 * D * 4 : 2 * L::NH * page * PF_HALF;
      float* scale_s = reinterpret_cast<float*>(sm + L::SCALE_OFF);
      // request stage sg's pages of kv head kvh: 2-byte values into
      // operand stage sg % NST, codes (and the sidecar shifts) into the
      // code buffer; one barrier for the stage
      auto issue = [&](int sg) {
        const int n_in = min(npt, n_live - sg * npt);
        const uint32_t bar = L::CODE ? bar_raw : bar_raw + 8 * (sg % NST);
        mbar_expect_tx(bar, n_in * page_bytes);
        for (int p = 0; p < n_in; ++p) {
          const int pid = table[sg * npt + p];
          if constexpr (L::CODE) {
            const uint32_t dst = s_base + L::CODE_OFF + p * slot * D;
            tma_load_4d(dst, mk, bar, 0, kvh, 0, pid);
            tma_load_4d(dst + L::CODE_BYTES, mv, bar, 0, kvh, 0, pid);
            const size_t ph = ((size_t)pid * kv_heads + kvh) * D;
            const uint32_t sd = s_base + L::SHIFT_OFF + p * 2 * D * 4;
            bulk_load(sd, sc.shift[0] + ph, D * 4, bar);
            bulk_load(sd + D * 4, sc.shift[1] + ph, D * 4, bar);
          } else {
            const uint32_t off =
                (sg % NST) * L::OP_BYTES + p * slot * PF_HALF;
            for (int half = 0; half < L::NH; ++half) {
              tma_load_4d(s_base + L::K_OFF + off + half * BKV * PF_HALF, mk,
                          bar, 64 * half, kvh, 0, pid);
              tma_load_4d(s_base + L::V_OFF + off + half * BKV * PF_HALF, mv,
                          bar, 64 * half, kvh, 0, pid);
            }
          }
        }
      };
      // in place: stages 0 .. NST - 2 ahead; codes: one stage
      if (ct == 0) {
        for (int sg = 0; sg < min(n_st, L::CODE ? 1 : NST - 1); ++sg)
          issue(sg);
      }
      // 8-bit pools: the two scales of page ct of stage sg (live pages
      // only: a dead page's sidecars may be NaN)
      auto scales = [&](int sg) {
        if (ct < min(npt, n_live - sg * npt)) {
          const size_t ph = (size_t)table[sg * npt + ct] * kv_heads + kvh;
          sck = __ldg(sc.scale[0] + ph);
          scv = __ldg(sc.scale[1] + ph);
        }
      };
      if constexpr (L::CODE) {
        if (n_st > 0) scales(0);
      }
      for (int sg = 0; sg < n_st; ++sg) {
        const int n_in = min(npt, n_live - sg * npt);
        const int st = sg % NST;
        unsigned char* opk = sm + L::K_OFF + st * L::OP_BYTES;
        unsigned char* opv = sm + L::V_OFF + st * L::OP_BYTES;
        const unsigned char* rk = L::CODE ? sm + L::CODE_OFF : opk;
        const unsigned char* rv = L::CODE ? sm + L::CODE_OFF + L::CODE_BYTES : opv;
        if constexpr (L::CODE) {
          // this stage's scales (read a stage ahead), then the next
          // stage's, read before the codes are waited for
          const float sk = sck, sv = scv;
          if (sg + 1 < n_st) scales(sg + 1);
          mbar_wait(bar_raw, sg & 1);
          if (ct < n_in) {
            scale_s[2 * ct] = sk;
            scale_s[2 * ct + 1] = sv;
          }
          named_sync(1, 128);             // the scales are seen
        } else {
          mbar_wait(bar_raw + 8 * st, (sg / NST) & 1);
        }
        PASA_SPAN(0, 0);                // waiting for the stage's pages
        for (int p = 0; p < n_in; ++p) {
          const int valid = min(page, L_kv - (sg * npt + p) * page);
          const int r0 = p * slot;
          const float* shp = shift + p * 2 * D;
          const float sk_p = L::CODE ? scale_s[2 * p] : 0.0f;
          const float sv_p = L::CODE ? scale_s[2 * p + 1] : 0.0f;
          // 1. km of column ct over the page's valid rows, an fp32 sum in
          //    row order (two buffers: a page's km is written while the
          //    previous page's rows are converted)
          float* km = km_s + (p & 1) * D;
          if (P.beta > 0.0f) {
            if (ct < D) {
              float sum = 0.0f;
              for (int r = r0; r < r0 + valid; ++r)
                sum += raw_elem<OpT, PoolT, BKV, D>(rk, r, ct, sk_p, shp);
              km[ct] = __fdiv_rn(sum, (float)valid);
            }
            named_sync(1, 128);
          }
          PASA_SPAN(0, 1);              // km
          // beta * km of this thread's columns (shift_key's first product)
          float bkm[8];
#pragma unroll
          for (int e = 0; e < 8; ++e)
            bkm[e] = P.beta > 0.0f ? __fmul_rn(P.beta, km[c8 + e]) : 0.0f;
          // 8-bit pools: the consumers release the operand stage (the
          // first page's km was summed meanwhile)
          if constexpr (L::CODE) {
            if (p == 0) mbar_wait(bar_e + 8 * st, ((sg / NST) & 1) ^ 1);
          }
          PASA_SPAN(0, 2);              // waiting for the operand stage
          // 2. K' = (K - beta km) / sqrt(d) and V at the operand type into
          //    the page's slot of stage st (in place for 2-byte pools);
          //    rows past `valid` become zeros (as in a page a stage)
#pragma unroll 1
          for (int r = r0 + ct / CPR; r < r0 + slot; r += RPS) {
            uint4 kk = make_uint4(0u, 0u, 0u, 0u), vv = kk;
            if (r - r0 < valid) {
              kk = raw_chunk<OpT, PoolT, BKV, D>(rk, r, c8, sk_p, shp);
              vv = raw_chunk<OpT, PoolT, BKV, D>(rv, r, c8, sv_p, shp + D);
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
          PASA_SPAN(0, 3);              // K' and V
          PASA_TALLY(0, 15);
        }
        // the stage's rows past its pages: zeros
#pragma unroll 1
        for (int r = n_in * slot + ct / CPR; r < BKV; r += RPS) {
          *reinterpret_cast<uint4*>(opk + swz<BKV>(r, c8)) = make_uint4(0u, 0u, 0u, 0u);
          *reinterpret_cast<uint4*>(opv + swz<BKV>(r, c8)) = make_uint4(0u, 0u, 0u, 0u);
        }
        fence_proxy_async();            // the operands are for wgmma
        mbar_arrive(bar_f + 8 * st);
        named_sync(1, 128);             // the raw pages and km are consumed
        if (ct == 0) {
          if constexpr (L::CODE) {
            if (sg + 1 < n_st) issue(sg + 1);
          } else {
            // stage sp into operand stage sp % NST, once the consumers
            // release stage sp - NST (NST - 1 stages ahead)
            const int sp = sg + NST - 1;
            if (sp < n_st) {
              if (sp >= NST)
                mbar_wait(bar_e + 8 * ((sp - NST) % NST), ((sp - NST) / NST) & 1);
              issue(sp);
            }
          }
        }
        PASA_SPAN(0, 4);                // the hand-off
        PASA_TALLY(0, 14);
      }
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
    // the accumulator: s[]'s layout over the D head-dim columns, as fp32
    // values or (H16) fp16 pairs (acc2[2 g + r] = the pair acc[4 g + 2 r],
    // acc[4 g + 2 r + 1])
    float acc[H16 ? 1 : D / 2];
    uint32_t acc2[H16 ? D / 4 : 1];
#pragma unroll
    for (int e = 0; e < (H16 ? 1 : D / 2); ++e) acc[e] = 0.0f;
#pragma unroll
    for (int e = 0; e < (H16 ? D / 4 : 1); ++e) acc2[e] = 0u;

    const uint32_t q_addr = s_base + L::Q_OFF + cw * 64 * PF_HALF;
    if (n_live > 0) mbar_wait(bar_q, 0);
    PASA_SPAN_INIT;
    bool live[2];
    RowStep rs[2];
    int h = 0;     // stage hand-offs taken
    if constexpr (PACK) {
      // ---- pages of at most PF_PACK rows: npt pages a stage, one score
      // GEMM over the stage, then page by page in page order (the note
      // above)
      constexpr bool SH = M::kScoreHalf;
      // P V in two 64-column parts where fp32 scores leave no room for a
      // 128-column sum beside the tile's scores and an fp32 accumulator
      constexpr int NPV = L::W == 128 && !SH ? 2 : 1;
      constexpr int PW = L::W / NPV;
      const int slot = page_slot(page), gpp = slot / 8;
      const int npt = pages_per_stage(page);
      const int n_st = (n_live + npt - 1) / npt;
      for (int sg = 0; sg < n_st; ++sg) {
        const int st = h % NST;
        mbar_wait(bar_f + 8 * st, (h / NST) & 1);
        ++h;
        PASA_SPAN(1, 0);                // waiting for the stage
        PASA_TALLY(1, 14);
        const int c_first = sg * npt * page;   // the stage's first column
        // the stage's pages that some row of the warpgroup sees (pages
        // wholly in the rows' future, or a warpgroup past the chunk,
        // change none of its rows)
        const int n_act =
            wg_first > wg_last || c_first > wg_last
                ? 0
                : min(min(npt, n_live - sg * npt),
                      (wg_last - c_first) / page + 1);
        if (n_act > 0) {
          const uint32_t k_addr = s_base + L::K_OFF + st * L::OP_BYTES;
          const uint32_t v_addr = s_base + L::V_OFF + st * L::OP_BYTES;
          // 1. S = Q K'^T over the stage, stored at the score dtype
          uint32_t s[NS];
          {
            float sf[NS];
            page_gemm_scores<BKV, BKV, D, M::kBF16>(sf, q_addr, k_addr);
            tile_store<NS, SH>(sf, s, P);
          }
          PASA_SPAN(1, 1);              // the score GEMM
          // 2-3. a page's sums and maxima (masks only where a column is
          // invalid or in some row's future), a page ahead of its P V
          float ssum[2], mx[2];
          int col0 = c_first, valid = min(page, L_kv - col0);
          bool mask = valid < slot || col0 + valid - 1 > wg_first;
          slot_scores<SH>(s, ssum, mx, 0, gpp, mask, 2 * quad, valid,
                              col0, rowpos);
          PASA_SPAN(1, 2);              // sums and maxima
          for (int q = 0; q < n_act; ++q) {
            // the lanes' first column and V's address as values of this
            // page, so that what the unrolled group loops derive from them
            // is computed a page at a time, not held over the stage
            int lc0 = 2 * quad;
            uint32_t va = v_addr;
            asm volatile("" : "+r"(lc0), "+r"(va));
            // 4. the page's P at its maxima, in place
            float lsum[2] = {0.0f, 0.0f};
            slot_probs<H16, M>(s, q * gpp, gpp, mask, lc0, valid, col0,
                                   rowpos, mx, sh, lsum);
            PASA_SPAN(1, 3);            // P
            // 5. P V of the page's columns into a fresh fp32 sum, issued
            // before the rows' recovery and the next page's statistics so
            // that they overlap
            float pv[PW / 2];
            wgmma_fence();
            slot_pv<PW, BKV, M::kBF16>(pv, s, q * gpp, gpp, va);
            wgmma_commit();
            PASA_SPAN(1, 4);            // P V issued
            page_rows(ssum, mx, lsum, valid, col0, rowpos, m, l, f, cnt,
                      live, rs, P);
            PASA_SPAN(1, 5);            // the rows' step
            col0 += page;
            valid = min(page, L_kv - col0);
            mask = valid < slot || col0 + valid - 1 > wg_first;
            if (q + 1 < n_act)
              slot_scores<SH>(s, ssum, mx, (q + 1) * gpp, gpp, mask,
                                  lc0, valid, col0, rowpos);
            PASA_SPAN(1, 2);            // sums and maxima
            wgmma_wait_all();
            fence_regs<PW / 2>(pv);
            fence_pairs<NS>(s);
            PASA_SPAN(1, 6);            // waiting for P V
            // 6. the page's fold at the accumulator dtype (live rows)
            page_acc<NPV == 1 ? D / 2 : 32, H16>(acc, acc2, pv, live, rs,
                                                 ah);
            if constexpr (NPV == 2) {
              wgmma_fence();
              slot_pv<PW, BKV, M::kBF16>(pv, s, q * gpp, gpp,
                                             va + BKV * PF_HALF);
              wgmma_commit();
              wgmma_wait_all();
              fence_regs<PW / 2>(pv);
              fence_pairs<NS>(s);
                page_acc<32, H16>(acc + (H16 ? 0 : 32), acc2 + (H16 ? 16 : 0),
                                  pv, live, rs, ah);
            }
            PASA_SPAN(1, 7);            // the fold
            PASA_TALLY(1, 15);
          }
        }
        if (lane == 0) mbar_arrive(bar_e + 8 * st);   // the stage is consumed
        PASA_SPAN(1, 8);                // the rest
      }
    }
    for (int j = 0; j < (PACK ? 0 : n_live); ++j) {
      const int col0 = j * page;
      const int valid = min(page, L_kv - col0);
      // a page wholly in the future of the warpgroup's rows (or a
      // warpgroup past the chunk) changes none of its rows
      const bool act = wg_first <= wg_last && col0 <= wg_last;
      if constexpr (BKV > PF_BN) {
        // ---- the 256-row tile: a page of npc pieces (the note above);
        // one hand-off serves every pass of a page of one piece ----
        const int npc = (valid + BKV - 1) / BKV;
        const bool whole = npc == 1;
        if (!act) {
          for (int u = 0; u < (whole ? 1 : (1 + L::NH) * npc); ++u, ++h) {
            mbar_wait(bar_f, h & 1);
            if (lane == 0) mbar_arrive(bar_e);
          }
          continue;
        }
        const uint32_t k_addr = s_base + L::K_OFF;
        const uint32_t v_addr = s_base + L::V_OFF;
        constexpr int NQ = BKV / 64;      // 64-column quarters of a piece
        constexpr int NV = D < 64 ? D / 2 : 32;   // P V sums of a V half
        float ssum[2] = {0.0f, 0.0f}, mx[2] = {-INFINITY, -INFINITY};
        float lsum[2] = {0.0f, 0.0f};
        float s[NS];
        uint32_t pa[16];
        // 1-3. the page's sums over the valid columns and maxima over the
        // visible ones (the scores themselves are not kept)
        for (int i = 0; i < npc; ++i) {
          mbar_wait(bar_f, h & 1);
#pragma unroll 1
          for (int qt = 0; qt < NQ; ++qt) {
            const int c = i * BKV + 64 * qt;   // the quarter's page column
            page_gemm_scores<BKV, 64, D, M::kBF16>(
                s, q_addr, k_addr + 64 * qt * PF_HALF);
            page_scores<NS, true, M::kScoreHalf>(s, ssum, mx, 2 * quad,
                                                 valid - c, col0 + c,
                                                 rowpos, P);
          }
          if (!whole) {
            if (lane == 0) mbar_arrive(bar_e);
            ++h;
          }
        }
        quad_reduce(ssum, mx);
        // 4-6. per 64-column half vh of V: each quarter's scores again
        // (the same bits), its P at the page's maxima, and P V into one
        // fp32 sum over the page; after the first half the rows' step;
        // then the half's accumulator columns
#pragma unroll
        for (int vh = 0; vh < L::NH; ++vh) {
          float pv[32];
          for (int i = 0; i < npc; ++i) {
            if (!whole) mbar_wait(bar_f, h & 1);
#pragma unroll 1
            for (int qt = 0; qt < NQ; ++qt) {
              const int c = i * BKV + 64 * qt;
              page_gemm_scores<BKV, 64, D, M::kBF16>(
                  s, q_addr, k_addr + 64 * qt * PF_HALF);
              float ssum_q[2] = {0.0f, 0.0f}, mx_q[2] = {0.0f, 0.0f};
              float lsum_q[2] = {0.0f, 0.0f};
              page_scores<NS, true, M::kScoreHalf>(s, ssum_q, mx_q, 2 * quad,
                                                   valid - c, col0 + c,
                                                   rowpos, P);
              page_probs<NS, H16, M>(s, mx, sh, vh ? lsum_q : lsum, pa);
              wgmma_fence();
#pragma unroll
              for (int kk = 0; kk < 4; ++kk)
                wgmma_pv<64, M::kBF16>(
                    pv, &pa[4 * kk],
                    gmma_desc(v_addr + vh * BKV * PF_HALF +
                                  (64 * qt + 16 * kk) * PF_HALF,
                              BKV * PF_HALF, 1024),
                    (i | qt | kk) != 0);
              wgmma_commit();
              wgmma_wait_all();
              fence_regs<32>(pv);
              fence_regs<16>(pa);
            }
            if (!whole) {
              if (lane == 0) mbar_arrive(bar_e);
              ++h;
            }
          }
          if (vh == 0)
            page_rows(ssum, mx, lsum, valid, col0, rowpos, m, l, f, cnt,
                      live, rs, P);
          page_acc<NV, H16>(acc + 32 * vh, acc2 + 16 * vh, pv, live, rs, ah);
        }
        if (whole) {
          if (lane == 0) mbar_arrive(bar_e);   // the stage is consumed
          ++h;
        }
      } else {
        // ---- pages of 33 to 128 rows: a page a stage ----
        const int st = h % NST;
        mbar_wait(bar_f + 8 * st, (h / NST) & 1);
        ++h;
        PASA_SPAN(1, 0);                // waiting for the stage
        PASA_TALLY(1, 14);
        if (!act) {
          if (lane == 0) mbar_arrive(bar_e + 8 * st);
          continue;
        }
        const uint32_t k_addr = s_base + L::K_OFF + st * L::OP_BYTES;
        const uint32_t v_addr = s_base + L::V_OFF + st * L::OP_BYTES;

        float ssum[2] = {0.0f, 0.0f}, mx[2] = {-INFINITY, -INFINITY};
        float lsum[2] = {0.0f, 0.0f};
        // the page's P as the P V product's A fragments (k16 step kk:
        // pa[4 kk ..])
        uint32_t pa[BKV / 4];
        float pv[L::W / 2];
        float s[NS];
        // 1. S = Q K'^T
        page_gemm_scores<BKV, BKV, D, M::kBF16>(s, q_addr, k_addr);
        PASA_SPAN(1, 1);                // the score GEMM

        // 2-3. score store, pseudo-average over the valid columns, then
        // the causal mask and the local max (masks only where a column
        // is invalid or in some row's future)
        if (valid < BKV || col0 + valid - 1 > wg_first)
          page_scores<NS, true, M::kScoreHalf>(s, ssum, mx, 2 * quad, valid,
                                               col0, rowpos, P);
        else
          page_scores<NS, false, M::kScoreHalf>(s, ssum, mx, 2 * quad,
                                                valid, col0, rowpos, P);
        quad_reduce(ssum, mx);
        PASA_SPAN(1, 2);                // sums and maxima
        // 4. local softmax at the statistic dtype, P at the score dtype,
        // then at the operand type packed as the P V product's A operand
        page_probs<NS, H16, M>(s, mx, sh, lsum, pa);
        PASA_SPAN(1, 3);                // P

        // 5. P V into a fresh fp32 sum (V MN-major: at D 128 its two
        // 64-column halves are the descriptor's leading-dimension step; at
        // D 32 pv[D / 2 ..] hold the padded half's columns), issued before
        // the rows' recovery so that the two overlap
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk)
          wgmma_pv<L::W, M::kBF16>(pv, &pa[4 * kk],
                                   gmma_desc(v_addr + kk * 16 * PF_HALF,
                                             BKV * PF_HALF, 1024),
                                   kk > 0);
        wgmma_commit();
        PASA_SPAN(1, 4);                // P V issued
        page_rows(ssum, mx, lsum, valid, col0, rowpos, m, l, f, cnt, live, rs,
                  P);
        PASA_SPAN(1, 5);                // the rows' step

        wgmma_wait_all();
        fence_regs<L::W / 2>(pv);
        fence_regs<BKV / 4>(pa);
        if (lane == 0) mbar_arrive(bar_e + 8 * st);   // the stage is consumed
        PASA_SPAN(1, 6);                // waiting for P V

        // 6. acc <- e_prev * acc + e_cur * pv at the accumulator dtype,
        // on live rows only
        page_acc<D / 2, H16>(acc, acc2, pv, live, rs, ah);
        PASA_SPAN(1, 7);                // the fold
        PASA_TALLY(1, 15);
      }
    }

    // O = acc / l at the accumulator dtype, stored at the output dtype
    // (contiguous); rows that folded nothing (l == 0) emit 0, not 0/0
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (tile * PF_BQ + rl[r] >= chunk) continue;
      const float lr = l[r] > 0.0f ? l[r] : 1.0f;
      OpT* orow =
          out + ((size_t)bh * chunk + tile * PF_BQ + rl[r]) * D + 2 * quad;
#pragma unroll
      for (int g = 0; g < D / 8; ++g) {
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

// Rank-4 map of a contiguous (P, page, KVH, D) pool, innermost first:
// boxes of one kv head's `page` rows of one page (at most PF_BOX: a wider
// page comes in pieces, zero past its last row), 64 columns with the
// 128-byte swizzle for 2-byte values (at D 32 zero past column 32), all D
// unswizzled for 8-bit codes.
template <typename PoolT, int D>
static bool make_pool_map(CUtensorMap* map, const void* pool, int num_pages,
                          int page, int kv_heads) {
  constexpr int ES = sizeof(PoolT);
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)kv_heads,
                              (cuuint64_t)page, (cuuint64_t)num_pages};
  const cuuint64_t row = (cuuint64_t)D * ES;
  const cuuint64_t strides[3] = {row, row * kv_heads, row * kv_heads * page};
  const cuuint32_t box[4] = {(cuuint32_t)(ES == 1 ? D : 64), 1,
                             (cuuint32_t)min(page, PF_BOX), 1};
  return encode_map(map, kMapType<PoolT>, pool, dims, strides, box,
                    ES == 1 ? CU_TENSOR_MAP_SWIZZLE_NONE
                            : CU_TENSOR_MAP_SWIZZLE_128B);
}

template <typename PoolT, int BKV, bool PACK, int D, bool H16, typename M>
static int launch(const void* q, const void* k_pages, const void* v_pages,
                  const SidecarPtrs& sc, const void* page_table,
                  const void* chunk_start, const void* kv_len, void* out,
                  int batch, int heads, int kv_heads, int chunk, int page,
                  int max_pages, int num_pages, const Policy& P,
                  cudaStream_t stream) {
  using L = PrefillLayout<PoolT, BKV, D>;
  using OpT = typename M::Op;
  CUtensorMap tq, tk, tv;
  const long long sh = (long long)chunk * D;
  if (!make_map(&tq, q, batch, heads, chunk, heads * sh, sh, D, PF_BQ,
                tma_dtype<OpT>(), D) ||
      !make_pool_map<PoolT, D>(&tk, k_pages, num_pages, page, kv_heads) ||
      !make_pool_map<PoolT, D>(&tv, v_pages, num_pages, page, kv_heads))
    return (int)cudaErrorInvalidValue;
  auto kernel = paged_prefill_kernel<PoolT, BKV, PACK, D, H16, M>;
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

// The instance of the policy's wgmma kind (wgmma_kind) at page tile BKV.
template <typename PoolT, int D, int BKV, bool PACK>
static int launch_kind(const void* q, const void* k_pages, const void* v_pages,
                       const SidecarPtrs& sc, const void* page_table,
                       const void* chunk_start, const void* kv_len, void* out,
                       int batch, int heads, int kv_heads, int chunk, int page,
                       int max_pages, int num_pages, int mode,
                       const Policy& P, cudaStream_t stream) {
#define PASA_PREFILL_LAUNCH(H16, M)                                          \
  launch<PoolT, BKV, PACK, D, H16, M>(q, k_pages, v_pages, sc, page_table,   \
                                chunk_start, kv_len, out, batch, heads,      \
                                kv_heads, chunk, page, max_pages, num_pages, \
                                P, stream)
  switch (wgmma_kind(mode, P)) {
    case 0: return PASA_PREFILL_LAUNCH(true, ModeF16);
    case 1: return PASA_PREFILL_LAUNCH(false, ModeF16);
    case 2: return PASA_PREFILL_LAUNCH(false, ModeF32);
    default: return PASA_PREFILL_LAUNCH(false, ModeBF16);
  }
#undef PASA_PREFILL_LAUNCH
}

// Pages of up to PF_PACK rows run in the 128-row tile several to a stage,
// of 33 to 128 one a stage (pasa_paged_prefill.cu); WIDE: 129 rows or
// more in the 256-row one (pasa_paged_prefill_wide.cu).
template <typename PoolT, int D, bool WIDE>
static int launch_pool(const void* q, const void* k_pages, const void* v_pages,
                       const SidecarPtrs& sc, const void* page_table,
                       const void* chunk_start, const void* kv_len, void* out,
                       int batch, int heads, int kv_heads, int chunk, int page,
                       int max_pages, int num_pages, int mode,
                       const Policy& P, cudaStream_t stream) {
#define PASA_PREFILL_TILE(BKV, PACK)                                          \
  launch_kind<PoolT, D, BKV, PACK>(q, k_pages, v_pages, sc, page_table,       \
                             chunk_start, kv_len, out, batch, heads, kv_heads, \
                             chunk, page, max_pages, num_pages, mode, P,      \
                             stream)
  if constexpr (WIDE) return PASA_PREFILL_TILE(256, false);
  else if (page > PF_PACK) return PASA_PREFILL_TILE(128, false);
  else return PASA_PREFILL_TILE(128, true);
#undef PASA_PREFILL_TILE
}

// The body of the C entry points (bound with ctypes): q, the pools and
// the sidecars are contiguous (pools (num_pages, page, kv_heads,
// head_dim), head_dim 32, 64 or 128; page 1 to 128, or WIDE 129 or more);
// the four sidecar pointers are read only for an 8-bit pool_kind
// (PoolKind), which RAW (bf16, fp16) or CODES (int8, fp8) must admit.  q
// and out are at the policy's input dtype (bf16 if op_bf16, else fp16),
// scores at fp16 if score_half (else fp32).  Returns the cudaError_t of
// the launch; 0 means it was queued on `stream`.
template <bool WIDE, bool RAW, bool CODES>
static int prefill_entry(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* k_shift, const void* v_scale,
    const void* v_shift, const void* page_table, const void* chunk_start,
    const void* kv_len, void* out, int batch, int heads, int kv_heads,
    int head_dim, int chunk, int page, int max_pages, int num_pages,
    int pool_kind, float beta, float inva, float shift_scale,
    float post_scale, int stat_half, int acc_half, int score_half,
    int op_bf16, void* stream) {
  const int mode = mode_id(score_half, op_bf16);
  const bool page_ok = WIDE ? page > PF_BN : page >= 1 && page <= PF_BN;
  if (batch < 1 || heads < 1 || kv_heads < 1 || heads % kv_heads ||
      chunk < 1 || !page_ok || max_pages < 1 ||
      num_pages < 1 || (chunk + PF_BQ - 1) / PF_BQ > 65535 || mode < 0 ||
      !head_dim_built(head_dim))
    return (int)cudaErrorInvalidValue;
  const bool quant = pool_kind == POOL_INT8 || pool_kind == POOL_FP8;
  if (quant && !(k_scale && k_shift && v_scale && v_shift))
    return (int)cudaErrorInvalidValue;
  const Policy P = make_policy(beta, inva, shift_scale, post_scale, stat_half, acc_half);
  const SidecarPtrs sc = {
      {static_cast<const float*>(k_scale), static_cast<const float*>(v_scale)},
      {static_cast<const float*>(k_shift), static_cast<const float*>(v_shift)}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PASA_PREFILL_POOL(T, D)                                               \
  launch_pool<T, D, WIDE>(q, k_pages, v_pages, sc, page_table, chunk_start,   \
                          kv_len, out, batch, heads, kv_heads, chunk, page,   \
                          max_pages, num_pages, mode, P, s)
#define PASA_PREFILL_WIDTH(T)                               \
  (head_dim == 32   ? PASA_PREFILL_POOL(T, 32)              \
   : head_dim == 64 ? PASA_PREFILL_POOL(T, 64)              \
                    : PASA_PREFILL_POOL(T, 128))
  if constexpr (RAW) {
    if (pool_kind == POOL_FP16) return PASA_PREFILL_WIDTH(__half);
    if (pool_kind == POOL_BF16) return PASA_PREFILL_WIDTH(__nv_bfloat16);
  }
  if constexpr (CODES) {
    if (pool_kind == POOL_INT8) return PASA_PREFILL_WIDTH(int8_t);
    if (pool_kind == POOL_FP8) return PASA_PREFILL_WIDTH(__nv_fp8_e4m3);
  }
  return (int)cudaErrorInvalidValue;
#undef PASA_PREFILL_WIDTH
#undef PASA_PREFILL_POOL
}

}  // namespace pasa
