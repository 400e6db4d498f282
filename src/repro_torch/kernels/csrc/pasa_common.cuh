// Shared numerics of the PASA attention kernels (sm_90a).
//
// The policy's storage rules, read from repro.core.pasa.update_state:
//  * the score GEMM takes operands at the policy's input dtype (fp16, or
//    bf16 under bf16_fp32) into an fp32 sum and STORES the result at the
//    score dtype before anything else touches it - fp16 under the fp16
//    and fp16_fp32 policies (the paper's overflow point), fp32 under fp32
//    and bf16_fp32, where the score stays in the fp32 sum;
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
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace pasa {

constexpr float NEG_BIG = -30000.0f;   // finite -inf stand-in, exact in fp16
// The head width of the wgmma kernels (attention, shift-KV, paged
// prefill); the decode kernels take it as a template parameter D (64 or
// 128, pasa_decode_block.cuh).
constexpr int HEAD_DIM = 128;

struct Policy {
  float beta;         // PASA shifting fraction (0 = FlashAttention-2)
  float inva;         // beta/(1-beta) rounded to the statistic dtype
  float shift_scale;  // fp32(1/sqrt(d)), folded into the shifted keys
  float post_scale;   // 1/sqrt(d) at the score dtype (fp16 or fp32), applied
                      // after the score store (beta = 0)
  bool stat_half;     // m, l, F-bar stored at fp16 (else fp32)
  bool acc_half;      // accumulator stored at fp16 (else fp32)
};

// A policy's storage types, fixed per kernel instance: the operand type of
// both GEMMs (the policy's input dtype, which is also its output dtype:
// fp16, or bf16 under bf16_fp32) and whether scores and probabilities are
// stored at fp16 (score dtype fp16) or stay fp32.
template <typename OpT, bool SCORE_HALF>
struct Mode {
  using Op = OpT;
  static constexpr bool kScoreHalf = SCORE_HALF;
  static constexpr bool kBF16 = std::is_same<OpT, __nv_bfloat16>::value;
};
using ModeF16 = Mode<__half, true>;           // fp16, fp16_fp32
using ModeF32 = Mode<__half, false>;          // fp32
using ModeBF16 = Mode<__nv_bfloat16, false>;  // bf16_fp32

// The mode named by the launch arguments (score_half, op_bf16); -1 for a
// pair no policy has (bf16 operands with fp16 scores).
enum ModeId : int { MODE_F16 = 0, MODE_F32 = 1, MODE_BF16 = 2 };
__host__ inline int mode_id(int score_half, int op_bf16) {
  if (op_bf16) return score_half ? -1 : MODE_BF16;
  return score_half ? MODE_F16 : MODE_F32;
}

// Round to fp16 and back when the intermediate is stored at fp16.
__device__ __forceinline__ float rnd(float x, bool half_store) {
  return half_store ? __half2float(__float2half_rn(x)) : x;
}

__device__ __forceinline__ float h2f(__half x) { return __half2float(x); }

// A 2-byte value widened (exactly) to fp32, and an fp32 value rounded to
// the 2-byte type T.
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Two fp32 values rounded to a pair of T, as the bits of a 32-bit register
// (the first value in the low half).
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&x);
  } else {
    __half2 x = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&x);
  }
}
// A pair of T (low half first) widened to fp32.
template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t bits) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&bits));
  else
    return __half22float2(*reinterpret_cast<__half2*>(&bits));
}

// Pool element -> the operand type OpT, elementwise: the same value the
// reference gets by casting the whole pool to the policy's input dtype
// (one rounding; none when the pool holds OpT).
template <typename OpT, typename PoolT>
__device__ __forceinline__ OpT to_op(PoolT x) {
  if constexpr (std::is_same<PoolT, OpT>::value) return x;
  else return from_float<OpT>(to_float(x));
}

// Eight consecutive pool elements (16 bytes of fp16 or bf16) -> eight
// OpT values packed in a uint4.
template <typename OpT, typename PoolT>
__device__ __forceinline__ uint4 load8_op(const PoolT* src) {
  uint4 raw = *reinterpret_cast<const uint4*>(src);
  if constexpr (std::is_same<PoolT, OpT>::value) {
    return raw;
  } else {
    const PoolT* in = reinterpret_cast<const PoolT*>(&raw);
    uint4 out;
    OpT* o = reinterpret_cast<OpT*>(&out);
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = to_op<OpT>(in[i]);
    return out;
  }
}

// Pool element types, as the paged ops' ``pool_kind`` launch argument
// names them: raw values (fp16, bf16) or 8-bit codes (int8, fp8 e4m3).
enum PoolKind : int { POOL_FP16 = 0, POOL_BF16 = 1, POOL_INT8 = 2, POOL_FP8 = 3 };

template <typename T>
constexpr bool kIsCode = false;
template <>
constexpr bool kIsCode<int8_t> = true;
template <>
constexpr bool kIsCode<__nv_fp8_e4m3> = true;

// One 8-bit code -> fp32, exactly (e4m3 values are a subset of fp16's).
__device__ __forceinline__ float code_to_float(int8_t c) { return (float)c; }
__device__ __forceinline__ float code_to_float(__nv_fp8_e4m3 c) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(c.__x, __NV_E4M3)));
}

// The dequantization sidecars of one (page, kv-head) of an 8-bit pool at
// head width D, staged in shared memory before the page's codes are
// converted: side 0 is K, side 1 is V.
template <int D>
struct PageSidecars {
  float shift[2][D];
  float scale[2];
};

struct SidecarPtrs {
  const float* scale[2];  // (P, KVH)
  const float* shift[2];  // (P, KVH, D)
};

// Eight consecutive codes (one 8-byte load) -> eight OpT values
// OpT(code * scale + shift[i]): the product and the sum each rounded in
// fp32 (the _rn intrinsics keep -O3 from fusing them into an FMA), then
// one rounding to the operand type - the plain version's arithmetic.
template <typename OpT, typename CodeT>
__device__ __forceinline__ uint4 load8_dequant(const CodeT* src, float scale,
                                               const float* shift) {
  const uint2 raw = *reinterpret_cast<const uint2*>(src);
  const CodeT* c = reinterpret_cast<const CodeT*>(&raw);
  uint4 out;
  OpT* o = reinterpret_cast<OpT*>(&out);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    o[i] = from_float<OpT>(
        __fadd_rn(__fmul_rn(code_to_float(c[i]), scale), shift[i]));
  return out;
}

// Eight consecutive pool elements of row segment (side, column c8) as
// OpT: raw pools convert, 8-bit pools dequantize with the staged sidecars.
template <typename OpT, typename PoolT, int D>
__device__ __forceinline__ uint4 load_pool8(const PoolT* src, int side, int c8,
                                            const PageSidecars<D>& Q) {
  if constexpr (kIsCode<PoolT>) {
    return load8_dequant<OpT>(src, Q.scale[side], &Q.shift[side][c8]);
  } else {
    return load8_op<OpT>(src);
  }
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

// Shifted key element: OpT((k - beta * km) * scale), all in fp32, rounded
// once to the input dtype.
template <typename OpT>
__device__ __forceinline__ OpT shift_key(float k, float km, const Policy& P) {
  return from_float<OpT>(
      __fmul_rn(__fsub_rn(k, __fmul_rn(P.beta, km)), P.shift_scale));
}

// Score as it leaves the GEMM, stored at the score dtype: at fp16 (SH)
// rounded, at fp32 the GEMM's own sum; at beta = 0 the 1/sqrt(d) scale
// follows the store (Eq. 2), rounded again at the score dtype.
template <bool SH>
__device__ __forceinline__ float store_score(float dot, const Policy& P) {
  if constexpr (SH) {
    float s = h2f(__float2half_rn(dot));
    if (P.beta == 0.0f) s = h2f(__float2half_rn(__fmul_rn(s, P.post_scale)));
    return s;
  } else {
    return P.beta == 0.0f ? __fmul_rn(dot, P.post_scale) : dot;
  }
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

// A launch's one-time set-up (a kernel's dynamic shared-memory attribute,
// its cluster check), done once per kernel instance AND device: the
// attribute belongs to the device's context, so a second card needs its
// own.  The launcher keeps one static OncePerDevice per instance.
constexpr int MAX_DEVICES = 64;

struct OncePerDevice {
  bool done[MAX_DEVICES] = {};
  // The current device's flag; nullptr if the device cannot be read.
  bool* current() {
    int dev = -1;
    if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_DEVICES)
      return nullptr;
    return &done[dev];
  }
};

}  // namespace pasa
