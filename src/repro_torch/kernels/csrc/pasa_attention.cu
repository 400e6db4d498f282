// Fused PASA attention over pre-shifted keys (Algorithm 1 lines 8-23), and
// the FlashAttention-2 baseline on the same tiling, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/pasa_attention.py (_attn_kernel,
// launched by attention_kernel_call through pl.pallas_call).
//
// What it computes: full-head queries q (B, H, S1, D) against keys
// K' = M K already shifted and scaled by the shift kernel (B, KVH, S2, D)
// and values v (B, KVH, S2, D), head width D 32, 64 or 128 (a template
// parameter; D 32 in the D 64 tiles, zero-padded: hopper.cuh, "Head
// widths"), all at the policy's input dtype
// (fp16, or bf16 under bf16_fp32) and read through their strides; GQA maps query head h to kv head h / (H / KVH), so K'/V are
// never expanded.  One CTA per (b * H + h, query tile of block_q rows)
// walks the key tiles IN ORDER - the F-bar recurrence is order-dependent
// - keeping m, l, F-bar and the accumulator at the policy's dtypes and
// ONE block count for the whole tile.  Per key tile:
//   1. S = Q K'^T, stored at the score dtype: fp16 under the fp16 and
//      fp16_fp32 policies (the paper's overflow point), while under fp32
//      and bf16_fp32 it stays in the fp32 wgmma sum; at beta = 0 the
//      1/sqrt(d) scale follows the store (FlashAttention-2, Eq. 2), so raw
//      fp16 overflow is reproduced;
//   2. the row pseudo-average over ALL block_kv columns (the shift used
//      them all), an fp32 sum rounded once to the statistic dtype;
//   3. only then the causal mask and the column limit kv_valid (columns
//      at or past it are padding: the caller's zero rows, which the shift
//      has mixed into every K' row of the last block, so they count in
//      step 2, as the reference pads and masks); a tile wholly above the
//      diagonal ((i+1) * block_q - 1 < j * block_kv) is skipped and not
//      counted.  Past kv_valid, P is forced to exactly 0 (the score
//      becomes -inf once the tile's max is taken) and V is read as zero
//      (its tensor map ends at kv_valid: TMA fills the rest of the box
//      with zeros), as the reference zeroes both before P V;
//   4. the online recovery (row_update of pasa_common.cuh), and P V into
//      a FRESH fp32 sum, rounded to the accumulator dtype before it is
//      folded into the accumulator (acc_update), as the reference rounds
//      pv before combining - the fp16 policy depends on it.
// With inva = 0 and beta = 0 it is the FlashAttention-2 baseline.
//
// P V at fp32 scores (the fp32 and bf16_fp32 policies): the reference
// multiplies the fp32 P by V widened to fp32.  Here P is the register A
// operand of the fp16 / bf16 wgmma at the operand type; the row sum l is
// taken over the unrounded fp32 P.  Under fp32 P is rounded once to fp16
// (2^-12 relative), as CUDA FlashAttention-2 does.  Under bf16_fp32 one
// bf16 rounding (2^-9) moved outputs of causal rows that see a few keys
// past the reference's tolerance (by 4e-4 at the dense prefill's shape),
// so P goes in as two bf16 terms, hi = bf16(p) and lo = bf16(p - hi),
// over two products into the same fp32 sum (SPLIT_P): P to ~2^-17, for a
// second P V product on tensor cores that the softmax leaves idle and 32
// more registers per consumer thread (240 have room; the paged prefill
// kernel's 224 do not, and rounds P once).
// (tf32 wgmma would keep P at 2^-11 but takes only K-major B operands,
// and V lies MN-major in the ring: a transposed V tile would cost shared
// memory or a pass.)  Both are held to the reference's tolerances against
// the plain version and to relative RMSE 0.02 against float64.
//
// What bounds it on an H100: operations.  The two GEMMs are 4 x S1 x S2 x
// D flops per head (halved by the causal skip) against q, K', V and O
// read or written once - at S = 1024 that is ~250 flops per byte on bytes
// that fit in L2; and beside the GEMMs, the fp16 policy's per-element
// softmax steps (each rounded on its own) on the CUDA cores.  The design
// is Hopper's flash-attention shape:
//   * a CTA is one producer warpgroup and block_q / 64 consumer
//     warpgroups of 64 query rows each (setmaxnreg moves the producer's
//     registers to the consumers);
//   * the producer's one thread loads Q once, and K'/V tiles into a ring
//     of two stages, by TMA (tensor maps from the strides, 128-byte
//     swizzle) with mbarriers: the next tile arrives while the current
//     one is computed;
//   * both GEMMs are wgmma (m64n{block_kv}k16 for S from shared memory,
//     D / 16 steps of k16; m64n{W}k16 for P V with P as the register
//     operand and V read MN-major, W = tile_width(D): at D 32 the P V
//     product runs N = 64 over V's zero-padded half and the accumulator
//     keeps its first 32 columns); S stays in registers, block_kv / 2 per
//     thread, and each
//     row's
//     statistics are reduced over the 4 threads that hold it; row_update
//     runs redundantly in those 4 threads;
//   * under the all-fp16 policy the per-element softmax and accumulator
//     steps, which bound the kernel beside the tensor cores, run on fp16
//     pairs with the same bits (see "fp16 pairs" in hopper.cuh); every
//     other policy runs them in fp32, rounding where the policy stores;
//   * the longest causal query tiles are issued first.

#include "hopper.cuh"

namespace pasa {

constexpr int AT_STAGES = 2;                  // K'/V ring depth
constexpr int AT_HALF_BYTES = 64 * 2;         // one 64-column half-row (2 B)

// Scores of one tile as the policy stores them (at fp16 if SH), with the
// row sums over all columns (before the mask) and, after the mask when
// MASK (columns at or past lim[r]: the causal limit row + 1 and the
// valid-column limit), the row maxima.  s[4 g + e] holds row e >> 1 (of
// the thread's two) at tile column 8 g + 2 quad + (e & 1); col0 = the
// tile's first column + 2 quad.
template <int NS, bool MASK, bool SH>
__device__ __forceinline__ void tile_scores(float* s, float* ssum, float* mx,
                                            int col0, const int* lim,
                                            const Policy& P) {
#pragma unroll
  for (int e = 0; e < NS; ++e) {
    const int r = (e >> 1) & 1;
    float v = store_score<SH>(s[e], P);
    ssum[r] += v;                                    // all columns
    if (MASK && col0 + 8 * (e >> 2) + (e & 1) >= lim[r]) v = NEG_BIG;
    s[e] = v;
    mx[r] = fmaxf(mx[r], v);
  }
}

// ---- the kernel --------------------------------------------------------

template <int NWG, int BKV, int D>
struct AttnLayout {
  static constexpr int W = tile_width(D);                // tile columns
  static constexpr int NH = W / 64;                      // 64-col halves
  static constexpr int BQ = 64 * NWG;
  static constexpr int Q_BYTES = BQ * W * 2;             // NH 64-col halves
  static constexpr int KV_BYTES = BKV * W * 2;           // one K' or V tile
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + Q_BYTES;
  static constexpr int V_OFF = K_OFF + AT_STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + AT_STAGES * KV_BYTES;
  // barriers: Q full, then per stage K full, V full, empty
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 3 * AT_STAGES);
  static constexpr int THREADS = 128 * (NWG + 1);
};

// M: the policy's mode (operand type, score store).  H16 (only with
// ModeF16): statistics and accumulator at fp16 (the paper's policy): the
// softmax and accumulator steps run on fp16 pairs.  D: the head width.
// Columns at or past kv_valid (> s2 - BKV: only the last tile has any)
// are padding.
template <int NWG, int BKV, int D, bool H16, typename M>
__global__ void __launch_bounds__(AttnLayout<NWG, BKV, D>::THREADS, 1)
pasa_attention_kernel(const __grid_constant__ CUtensorMap tq,  // (B,H,S1,D)
                      const __grid_constant__ CUtensorMap tk,  // K' (B,KVH,S2,D)
                      const __grid_constant__ CUtensorMap tv,  // (B,KVH,S2,D)
                      typename M::Op* __restrict__ out,        // (B,H,S1,D)
                      int heads, int kv_heads, int s1, int s2, int kv_valid,
                      int causal, Policy P) {
  static_assert(!H16 || M::kScoreHalf, "the fp16 pair steps need fp16 scores");
  using OpT = typename M::Op;
  using L = AttnLayout<NWG, BKV, D>;
  // P V from the fp32 P as two bf16 terms (bf16_fp32; see the note above)
  constexpr bool SPLIT_P = M::kBF16 && !M::kScoreHalf;
  constexpr int BQ = L::BQ;
  constexpr int NS = BKV / 2;            // score registers per thread
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzled tiles want 1024-byte aligned bases
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t s_base = smem_u32(sm);
  const uint32_t bar_q = s_base + L::BAR_OFF;
  const uint32_t bar_k = bar_q + 8;                    // + 8 * stage
  const uint32_t bar_v = bar_k + 8 * AT_STAGES;
  const uint32_t bar_e = bar_v + 8 * AT_STAGES;

  const int bh = blockIdx.x;
  const int i = s1 / BQ - 1 - blockIdx.y;   // longest causal tiles first
  const int b = bh / heads, h = bh % heads;
  const int kh = h / (heads / kv_heads);
  const int n_kv = s2 / BKV;
  const int n_live = causal ? min(n_kv, ((i + 1) * BQ - 1) / BKV + 1) : n_kv;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < AT_STAGES; ++st) {
      mbar_init(bar_k + 8 * st, 1);
      mbar_init(bar_v + 8 * st, 1);
      mbar_init(bar_e + 8 * st, 4 * NWG);   // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every load ----
    if constexpr (NWG > 1)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, L::Q_BYTES);
      for (int half = 0; half < L::NH; ++half)
        tma_load_4d(s_base + L::Q_OFF + half * BQ * AT_HALF_BYTES, &tq, bar_q,
                    64 * half, i * BQ, h, b);
      for (int j = 0; j < n_live; ++j) {
        const int st = j % AT_STAGES;
        const uint32_t phase = (j / AT_STAGES) & 1;
        mbar_wait(bar_e + 8 * st, phase ^ 1);   // the stage is free
        const uint32_t kdst = s_base + L::K_OFF + st * L::KV_BYTES;
        const uint32_t vdst = s_base + L::V_OFF + st * L::KV_BYTES;
        mbar_expect_tx(bar_k + 8 * st, L::KV_BYTES);
        for (int half = 0; half < L::NH; ++half)
          tma_load_4d(kdst + half * BKV * AT_HALF_BYTES, &tk, bar_k + 8 * st,
                      64 * half, j * BKV, kh, b);
        mbar_expect_tx(bar_v + 8 * st, L::KV_BYTES);
        for (int half = 0; half < L::NH; ++half)
          tma_load_4d(vdst + half * BKV * AT_HALF_BYTES, &tv, bar_v + 8 * st,
                      64 * half, j * BKV, kh, b);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    if constexpr (NWG > 1)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int t = threadIdx.x - 128;
    const int cw = t >> 7;                 // consumer warpgroup
    const int lane = t & 31;
    const int quad = lane & 3;
    // this thread's two rows (local to the CTA tile) and its columns
    const int r_lo = 64 * cw + 16 * ((t >> 5) & 3) + (lane >> 2);
    const int row[2] = {i * BQ + r_lo, i * BQ + r_lo + 8};
    // each row's first masked column (tiles that reach past it)
    const int lim[2] = {causal ? min(row[0] + 1, kv_valid) : kv_valid,
                        causal ? min(row[1] + 1, kv_valid) : kv_valid};
    const bool sh = P.stat_half, ah = P.acc_half;

    float m[2] = {NEG_BIG, NEG_BIG}, l[2] = {0.0f, 0.0f}, f[2] = {0.0f, 0.0f};
    // the accumulator: s[]'s layout over the D head-dim columns, as fp32
    // values or (H16) fp16 pairs (acc2[2 g + r] = the pair acc[4 g + 2 r],
    // acc[4 g + 2 r + 1])
    float acc[H16 ? 1 : D / 2];
    uint32_t acc2[H16 ? D / 4 : 1];
#pragma unroll
    for (int e = 0; e < (H16 ? 1 : D / 2); ++e) acc[e] = 0.0f;
#pragma unroll
    for (int e = 0; e < (H16 ? D / 4 : 1); ++e) acc2[e] = 0u;

    const uint32_t q_addr = s_base + L::Q_OFF + cw * 64 * AT_HALF_BYTES;
    mbar_wait(bar_q, 0);
    for (int j = 0; j < n_live; ++j) {
      const int st = j % AT_STAGES;
      const uint32_t phase = (j / AT_STAGES) & 1;
      const uint32_t k_addr = s_base + L::K_OFF + st * L::KV_BYTES;
      const uint32_t v_addr = s_base + L::V_OFF + st * L::KV_BYTES;

      // 1. S = Q K'^T (D / 16 steps of k16 over the 64-column halves)
      float s[NS];
      mbar_wait(bar_k + 8 * st, phase);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk >> 2), in = (kk & 3) * 32;
        wgmma_scores<BKV, M::kBF16>(
            s, gmma_desc(q_addr + off * BQ * AT_HALF_BYTES + in, 16, 1024),
            gmma_desc(k_addr + off * BKV * AT_HALF_BYTES + in, 16, 1024),
            kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<NS>(s);

      // 2-3. score store, full-tile pseudo-average, then the mask (only
      // on tiles that reach past this warpgroup's first row, and on the
      // tile that holds padding) and the local max
      const int col0 = j * BKV + 2 * quad;
      const bool pad_tile = j == n_kv - 1 && kv_valid < s2;
      float ssum[2] = {0.0f, 0.0f}, mx[2] = {-INFINITY, -INFINITY};
      if ((causal && (j + 1) * BKV - 1 > i * BQ + 64 * cw) || pad_tile)
        tile_scores<NS, true, M::kScoreHalf>(s, ssum, mx, col0, lim, P);
      else
        tile_scores<NS, false, M::kScoreHalf>(s, ssum, mx, col0, lim, P);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int o = 1; o <= 2; o <<= 1) {
          ssum[r] += __shfl_xor_sync(0xffffffffu, ssum[r], o);
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], o));
        }
      }
      if (pad_tile) {       // P of a padding column: exp(-inf) = 0 exactly
#pragma unroll
        for (int e = 0; e < NS; ++e)
          if (col0 + 8 * (e >> 2) + (e & 1) >= kv_valid) s[e] = -INFINITY;
      }
      // 4. local softmax at the statistic dtype, P at the score dtype, then
      // at the operand type packed as the A fragments of the P V product
      // (k16 step kk: pa[4 kk .. 4 kk + 3])
      float lsum[2] = {0.0f, 0.0f};
      uint32_t pa[NS / 2];
      uint32_t pa_lo[SPLIT_P ? NS / 2 : 1];   // P - hi (bf16_fp32)
      if constexpr (H16) {
        const uint32_t mx2[2] = {h2_splat(mx[0]), h2_splat(mx[1])};
#pragma unroll
        for (int e = 0; e < NS; e += 2) {
          const int r = (e >> 1) & 1;
          const float2 d = __half22float2(
              h2_of(h2_sub(h2_bits(__floats2half2_rn(s[e], s[e + 1])), mx2[r])));
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
            if constexpr (SPLIT_P) {
              const float2 hi = unpack2<OpT>(pa[e / 2]);
              pa_lo[e / 2] =
                  pack2<OpT>(__fsub_rn(p0, hi.x), __fsub_rn(p1, hi.y));
            }
          }
        }
      }

      // 5. P V into a fresh fp32 sum (V MN-major: at D 128 its two
      // 64-column halves are the descriptor's leading-dimension step; at
      // D 32 pv[D / 2 ..] hold the padded half's zero columns),
      // issued before the row statistics' recovery so that the two overlap
      float pv[L::W / 2];
      mbar_wait(bar_v + 8 * st, phase);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
        wgmma_pv<L::W, M::kBF16>(pv, &pa[4 * kk],
                              gmma_desc(v_addr + kk * 16 * AT_HALF_BYTES,
                                        BKV * AT_HALF_BYTES, 1024),
                              kk > 0);
      if constexpr (SPLIT_P) {      // + (P - hi) V, bf16_fp32
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk)
          wgmma_pv<L::W, M::kBF16>(pv, &pa_lo[4 * kk],
                                gmma_desc(v_addr + kk * 16 * AT_HALF_BYTES,
                                          BKV * AT_HALF_BYTES, 1024),
                                1);
      }
      wgmma_commit();

#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int o = 1; o <= 2; o <<= 1)
          lsum[r] += __shfl_xor_sync(0xffffffffu, lsum[r], o);
      }
      RowStep rs[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float sbar = rnd(__fdiv_rn(ssum[r], (float)BKV), sh);
        rs[r] = row_update(m[r], l[r], f[r], j, sbar, mx[r], rnd(lsum[r], sh), P);
        m[r] = rs[r].m;
        l[r] = rs[r].l;
        f[r] = rs[r].f;
      }

      wgmma_wait_all();
      fence_regs<L::W / 2>(pv);
      fence_regs<NS / 2>(pa);
      if constexpr (SPLIT_P) fence_regs<NS / 2>(pa_lo);
      if (lane == 0) mbar_arrive(bar_e + 8 * st);   // the stage is consumed

      // 6. acc <- e_prev * acc + e_cur * pv at the accumulator dtype
      if constexpr (H16) {
        const uint32_t ep[2] = {h2_splat(rs[0].e_prev), h2_splat(rs[1].e_prev)};
        const uint32_t ec[2] = {h2_splat(rs[0].e_cur), h2_splat(rs[1].e_cur)};
#pragma unroll
        for (int i2 = 0; i2 < D / 4; ++i2) {
          const int r = i2 & 1;
          const uint32_t pv2 =
              h2_bits(__floats2half2_rn(pv[2 * i2], pv[2 * i2 + 1]));
          acc2[i2] = h2_add(h2_mul(ep[r], acc2[i2]), h2_mul(ec[r], pv2));
        }
      } else {
#pragma unroll
        for (int e = 0; e < D / 2; ++e) {
          const int r = (e >> 1) & 1;
          acc[e] = acc_update(acc[e], rnd(pv[e], ah), rs[r].e_prev,
                              rs[r].e_cur, ah);
        }
      }
    }

    // O = acc / l at the accumulator dtype, stored at the output dtype
    // (contiguous)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float lr = rnd(l[r], ah);
      OpT* orow = out + ((size_t)bh * s1 + row[r]) * D + 2 * quad;
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

template <int NWG, int BKV, int D, bool H16, typename M>
static int launch(const void* q, const void* k, const void* v, void* out,
                  int batch, int heads, int kv_heads, int s1, int s2,
                  int kv_valid, int causal, const long long* st,
                  const Policy& P, cudaStream_t stream) {
  using L = AttnLayout<NWG, BKV, D>;
  using OpT = typename M::Op;
  constexpr CUtensorMapDataType dt = tma_dtype<OpT>();
  CUtensorMap tq, tk, tv;
  // V's map ends at kv_valid: the padding rows of its last tile load as
  // zeros
  if (!make_map(&tq, q, batch, heads, s1, st[0], st[1], st[2], L::BQ, dt, D) ||
      !make_map(&tk, k, batch, kv_heads, s2, st[3], st[4], st[5], BKV, dt,
                D) ||
      !make_map(&tv, v, batch, kv_heads, kv_valid, st[6], st[7], st[8], BKV,
                dt, D))
    return (int)cudaErrorInvalidValue;
  auto kernel = pasa_attention_kernel<NWG, BKV, D, H16, M>;
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
  dim3 grid(batch * heads, s1 / L::BQ);
  kernel<<<grid, L::THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<OpT*>(out), heads, kv_heads, s1, s2, kv_valid,
      causal, P);
  return (int)cudaGetLastError();
}

// The instance of a tile shape and head width for the launch's kind
// (wgmma_kind).
template <int NWG, int BKV, int D>
static int launch_kind(int kind, const void* q, const void* k, const void* v,
                       void* out, int batch, int heads, int kv_heads, int s1,
                       int s2, int kv_valid, int causal, const long long* st,
                       const Policy& P, cudaStream_t stream) {
#define PASA_ATTN_LAUNCH(H16, M)                                            \
  launch<NWG, BKV, D, H16, M>(q, k, v, out, batch, heads, kv_heads, s1, s2, \
                              kv_valid, causal, st, P, stream)
  switch (kind) {
    case 0: return PASA_ATTN_LAUNCH(true, ModeF16);
    case 1: return PASA_ATTN_LAUNCH(false, ModeF16);
    case 2: return PASA_ATTN_LAUNCH(false, ModeF32);
    default: return PASA_ATTN_LAUNCH(false, ModeBF16);
  }
#undef PASA_ATTN_LAUNCH
}

}  // namespace pasa

// Plain C entry point (bound with ctypes).  Strides are in elements, for
// the (batch, head, row) dims of q, K' and v (each a multiple of 8, the
// rows of head_dim (32, 64 or 128) unit-stride values, 16-byte aligned
// starts); q, K', v and out are at the policy's input dtype (bf16 if
// op_bf16, else fp16), scores at fp16 if score_half (else fp32); block_q
// and block_kv are 64 or 128; columns at or past kv_valid (s2 - block_kv
// < kv_valid <= s2) are padding.  Returns the cudaError_t of the launch
// (0: queued on `stream`).
extern "C" int pasa_attention_launch(
    const void* q, const void* k, const void* v, void* out, int batch,
    int heads, int kv_heads, int s1, int s2, int head_dim, int kv_valid,
    int block_q, int block_kv,
    int causal, long long qsb, long long qsh, long long qss, long long ksb,
    long long ksh, long long kss, long long vsb, long long vsh, long long vss,
    float beta, float inva, float shift_scale, float post_scale,
    int stat_half, int acc_half, int score_half, int op_bf16, void* stream) {
  using namespace pasa;
  const long long st[9] = {qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss};
  const int mode = mode_id(score_half, op_bf16);
  bool ok = batch >= 1 && heads >= 1 && kv_heads >= 1 && !(heads % kv_heads) &&
            (block_q == 64 || block_q == 128) &&
            (block_kv == 64 || block_kv == 128) && s1 >= block_q &&
            !(s1 % block_q) && s2 >= block_kv && !(s2 % block_kv) &&
            head_dim_built(head_dim) && kv_valid <= s2 &&
            kv_valid > s2 - block_kv &&
            !(reinterpret_cast<uintptr_t>(q) % 16) &&
            !(reinterpret_cast<uintptr_t>(k) % 16) &&
            !(reinterpret_cast<uintptr_t>(v) % 16);
  for (int n = 0; n < 9; ++n) ok = ok && st[n] >= 0 && !(st[n] % 8);
  if (!ok || mode < 0) return (int)cudaErrorInvalidValue;
  const Policy P = make_policy(beta, inva, shift_scale, post_scale, stat_half,
                               acc_half);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kind = wgmma_kind(mode, P);
  const int cfg = (head_dim == 32 ? 0 : head_dim == 64 ? 1 : 2) * 4 +
                  (block_q == 128) * 2 + (block_kv == 128);
#define PASA_ATTN_SHAPE(NWG, BKV, D)                                       \
  launch_kind<NWG, BKV, D>(kind, q, k, v, out, batch, heads, kv_heads, s1, \
                           s2, kv_valid, causal, st, P, s)
  switch (cfg) {
    case 0: return PASA_ATTN_SHAPE(1, 64, 32);
    case 1: return PASA_ATTN_SHAPE(1, 128, 32);
    case 2: return PASA_ATTN_SHAPE(2, 64, 32);
    case 3: return PASA_ATTN_SHAPE(2, 128, 32);
    case 4: return PASA_ATTN_SHAPE(1, 64, 64);
    case 5: return PASA_ATTN_SHAPE(1, 128, 64);
    case 6: return PASA_ATTN_SHAPE(2, 64, 64);
    case 7: return PASA_ATTN_SHAPE(2, 128, 64);
    case 8: return PASA_ATTN_SHAPE(1, 64, 128);
    case 9: return PASA_ATTN_SHAPE(1, 128, 128);
    case 10: return PASA_ATTN_SHAPE(2, 64, 128);
    default: return PASA_ATTN_SHAPE(2, 128, 128);
  }
#undef PASA_ATTN_SHAPE
}
