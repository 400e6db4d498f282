// Shared numerics of the PASA attention kernels (sm_90a).
//
// The policy's storage rules, read from repro.core.pasa.update_state:
//  * the score GEMM takes fp16 operands into an fp32 sum and STORES the
//    result at fp16 before anything else touches it (the paper's overflow
//    point);
//  * sums feeding cross-block state (key mean, row pseudo-average, softmax
//    sum) accumulate in fp32 and round once to the statistic dtype; the
//    max stays at the statistic dtype;
//  * the state m, l, F-bar and the accumulator live at the policy's dtypes
//    (fp16 under the paper's FP16 policy): every elementwise step rounds,
//    as one torch op on fp16 tensors does.
// Elementwise steps use the _rn intrinsics so that the compiler cannot
// contract a multiply and an add into one FMA and skip a rounding.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace pasa {

constexpr float NEG_BIG = -30000.0f;   // finite -inf stand-in, exact in fp16
constexpr int HEAD_DIM = 128;          // the only head width ported so far

struct Policy {
  float beta;         // PASA shifting fraction (0 = FlashAttention-2)
  float inva;         // beta/(1-beta) rounded to the statistic dtype
  float shift_scale;  // fp32(1/sqrt(d)), folded into the shifted keys
  float post_scale;   // fp16(1/sqrt(d)), applied after the score store (beta = 0)
  bool stat_half;     // m, l, F-bar stored at fp16 (else fp32)
  bool acc_half;      // accumulator stored at fp16 (else fp32)
};

// Round to fp16 and back when the intermediate is stored at fp16.
__device__ __forceinline__ float rnd(float x, bool half_store) {
  return half_store ? __half2float(__float2half_rn(x)) : x;
}

__device__ __forceinline__ float h2f(__half x) { return __half2float(x); }

// Pool element -> fp16, elementwise: the same value the reference gets by
// casting the whole pool to the policy's input dtype.
__device__ __forceinline__ __half to_half(__half x) { return x; }
__device__ __forceinline__ __half to_half(__nv_bfloat16 x) {
  return __float2half_rn(__bfloat162float(x));
}

// Eight consecutive pool elements (16 bytes of fp16, 16 bytes of bf16) ->
// eight fp16 values packed in a uint4.
__device__ __forceinline__ uint4 load8_half(const __half* src) {
  return *reinterpret_cast<const uint4*>(src);
}
__device__ __forceinline__ uint4 load8_half(const __nv_bfloat16* src) {
  uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat16* in = reinterpret_cast<const __nv_bfloat16*>(&raw);
  uint4 out;
  __half* o = reinterpret_cast<__half*>(&out);
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i] = to_half(in[i]);
  return out;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// Shifted key element: fp16((k - beta * km) * scale), all in fp32.
__device__ __forceinline__ __half shift_key(float k, float km, const Policy& P) {
  return __float2half_rn(
      __fmul_rn(__fsub_rn(k, __fmul_rn(P.beta, km)), P.shift_scale));
}

// Score as it leaves the GEMM: stored at fp16; at beta = 0 the 1/sqrt(d)
// scale follows the store (Eq. 2), again rounded to fp16.
__device__ __forceinline__ float store_score(float dot, const Policy& P) {
  float s = h2f(__float2half_rn(dot));
  if (P.beta == 0.0f) s = h2f(__float2half_rn(__fmul_rn(s, P.post_scale)));
  return s;
}

struct RowStep {
  float e_prev, e_cur, m, l, f;
};

// Online PASA recovery of one query row (Algorithm 1 lines 14-18): fold
// the block's (sbar, m_loc, l_loc) into the running (m, l, f) after `cnt`
// folded blocks.  cnt == 0 guards the empty history.
__device__ __forceinline__ RowStep row_update(float m, float l, float f, int cnt,
                                              float sbar, float m_loc,
                                              float l_loc, const Policy& P) {
  const bool h = P.stat_half;
  float f_new = f, dm_prev = 0.0f, dm_cur = 0.0f;
  if (P.beta > 0.0f) {
    const float cntf = rnd((float)cnt, h);
    f_new = rnd(__fdiv_rn(rnd(__fadd_rn(rnd(__fmul_rn(cntf, f), h), sbar), h),
                          rnd(__fadd_rn(cntf, 1.0f), h)),
                h);
    dm_prev = rnd(__fmul_rn(P.inva, rnd(__fsub_rn(f, f_new), h)), h);
    dm_cur = rnd(__fmul_rn(P.inva, rnd(__fsub_rn(sbar, f_new), h)), h);
  }
  const float cand = cnt == 0 ? NEG_BIG : rnd(__fadd_rn(m, dm_prev), h);
  const float mc = rnd(__fadd_rn(m_loc, dm_cur), h);
  const float m_new = fmaxf(cand, mc);
  RowStep r;
  r.e_prev = rnd(expf(rnd(__fsub_rn(cand, m_new), h)), h);
  r.e_cur = rnd(expf(rnd(__fsub_rn(mc, m_new), h)), h);
  r.l = rnd(__fadd_rn(rnd(__fmul_rn(r.e_prev, l), h),
                      rnd(__fmul_rn(r.e_cur, l_loc), h)),
            h);
  r.m = m_new;
  r.f = f_new;
  return r;
}

// acc <- e_prev * acc + e_cur * pv, each product and the sum stored at the
// accumulator dtype (pv already rounded there).
__device__ __forceinline__ float acc_update(float acc, float pv, float e_prev,
                                            float e_cur, bool acc_half) {
  return rnd(__fadd_rn(rnd(__fmul_rn(e_prev, acc), acc_half),
                       rnd(__fmul_rn(e_cur, pv), acc_half)),
             acc_half);
}

// Policy built from the launch arguments.
__host__ __forceinline__ Policy make_policy(float beta, float inva,
                                            float shift_scale, float post_scale,
                                            int stat_half, int acc_half) {
  Policy P;
  P.beta = beta;
  P.inva = inva;
  P.shift_scale = shift_scale;
  P.post_scale = post_scale;
  P.stat_half = stat_half != 0;
  P.acc_half = acc_half != 0;
  return P;
}

}  // namespace pasa
