// PASA key pre-processing K'_j = M K_j (Algorithm 1 lines 5-7), for Hopper
// (sm_90a).
//
// Replaces the TPU kernel repro/kernels/shift_kv.py (_shift_kernel,
// launched by shift_kv_kernel_call through pl.pallas_call).
//
// What it computes: for every (batch, kv-head) and every block of `block`
// (64 or 128) key rows, the product of the shifting matrix M (block x
// block, the 1/sqrt(d) scale folded in) with the block's keys (block x D,
// head width D 64 or 128), as the matrix engine does it: operands at M's dtype (fp16, or
// bf16 under the bf16_fp32 policy), an fp32 sum, ONE rounding to M's
// dtype on the store.  Keys are read through their strides (the prefill's
// (B, S, KVH, D) projection is read where it lies); bf16 keys under an
// fp16 M are rounded to fp16 first, as the reference casts K to M's dtype
// before the product.  The output is (B, KVH, S2, D) at M's dtype,
// contiguous.
//
// What bounds it on an H100: bytes.  Each key is read once and written
// once (4 bytes per element at 2-byte dtypes) against 2 x block flops per
// element, ~64 flops/byte at block 128, far below the card's ~295
// flops/byte ridge.  So the design keeps the bytes moving and puts nothing
// between a key half's arrival and its product but registers:
//   * M is symmetric (a I - b J, Eq. 10, rounded entrywise), so the block
//     is computed transposed: K'^T = K^T M.  One CTA per (b * kvh, block
//     j) of D / 64 warpgroups (two at D 128, one at 64); warpgroup w owns
//     head-dim columns [64 w, 64 w + 64), i.e. 64 rows of K'^T, and needs
//     only its own 64-column half of the key block;
//   * thread 0 issues every load by TMA at once: the key block's D / 64
//     64-column halves (each on its own mbarrier, through a tensor map
//     over the strided keys) and M (block rows x 64-column halves, from
//     L2), all 128-byte swizzled;
//   * as soon as its half has landed, a warpgroup loads it as the
//     register A operand of wgmma (ldmatrix .trans: K^T's fragments),
//     converting bf16 keys under fp16 operands to fp16 in registers, and
//     runs m64n64k16 with M as the K-major B operand from shared memory,
//     one product per 64 output key rows, the fp32 sums in registers;
//   * each product is rounded once in registers and written transposed
//     (stmatrix .trans) into a swizzled 64 x 64 box of K', which one
//     thread of the warpgroup stores by TMA; the first product's rounding
//     and store overlap the second product (block 128);
//   * shared memory: M block^2 x 2 bytes, keys and output block x 2 D
//     bytes each (96 KB at block 128 and D 128), so two CTAs fit on an SM.

#include "hopper.cuh"

namespace pasa {

constexpr int SK_HALF_BYTES = 64 * 2;     // one 64-column half-row

// One warpgroup per 64-column half of the head width D.
template <int BLOCK, int D>
struct ShiftLayout {
  static constexpr int NH = D / 64;                         // head-dim halves
  static constexpr int THREADS = 128 * NH;
  static constexpr int NB = BLOCK / 64;                     // 64-row blocks
  static constexpr int M_BYTES = BLOCK * BLOCK * 2;         // NB halves
  static constexpr int K_HALF = BLOCK * SK_HALF_BYTES;      // one key half
  static constexpr int BOX = 64 * SK_HALF_BYTES;            // one output box
  static constexpr int M_OFF = 0;
  static constexpr int K_OFF = M_OFF + M_BYTES;
  static constexpr int O_OFF = K_OFF + NH * K_HALF;         // NH x NB boxes
  static constexpr int BAR_OFF = O_OFF + NH * NB * BOX;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + NH);      // M, key halves
};

// Byte address of row `row`'s 16-byte chunk `chunk` in a 128-byte swizzled
// tile of 128-byte rows (a 1024-byte aligned base).
__device__ __forceinline__ uint32_t sw128(uint32_t base, int row, int chunk) {
  return base + row * SK_HALF_BYTES + ((chunk ^ (row & 7)) << 4);
}

// A pair of bf16 values -> a pair of fp16 values.
__device__ __forceinline__ uint32_t bf16x2_to_half2(uint32_t x) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
  __half2 h = __floats2half2_rn(f.x, f.y);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Two fp32 sums -> one 32-bit pair at the operand dtype, each rounded once.
__device__ __forceinline__ uint32_t pack2(float a, float b, __half) {
  __half2 x = __floats2half2_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&x);
}
__device__ __forceinline__ uint32_t pack2(float a, float b, __nv_bfloat16) {
  __nv_bfloat162 x = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&x);
}

// OpT: the operand and output dtype (M's); KeyT: the keys as stored; D:
// the head width.
template <typename OpT, typename KeyT, int BLOCK, int D>
__global__ void __launch_bounds__(128 * (D / 64))
shift_kv_kernel(const __grid_constant__ CUtensorMap tm,  // M (block, block)
                const __grid_constant__ CUtensorMap tk,  // K (B, KVH, S2, D)
                const __grid_constant__ CUtensorMap to,  // K' (B, KVH, S2, D)
                int kv_heads) {
  using L = ShiftLayout<BLOCK, D>;
  constexpr int NB = L::NB;
  constexpr int KS = BLOCK / 16;                      // k16 steps
  constexpr bool BF16 = std::is_same<OpT, __nv_bfloat16>::value;
  constexpr bool CONVERT = !std::is_same<OpT, KeyT>::value;
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzled tiles want 1024-byte aligned bases
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t s_base = smem_u32(sm);
  const uint32_t bar_m = s_base + L::BAR_OFF;
  const uint32_t bar_k = bar_m + 8;                   // + 8 * half
  const int bh = blockIdx.x, j = blockIdx.y;
  const int b = bh / kv_heads, h = bh % kv_heads;
  const int t = threadIdx.x;
  const int w = t >> 7;                   // warpgroup = head-dim half

  if (t == 0) {
    prefetch_map(&tk);
    prefetch_map(&tm);
    prefetch_map(&to);
    mbar_init(bar_m, 1);
    for (int hf = 0; hf < L::NH; ++hf) mbar_init(bar_k + 8 * hf, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int hf = 0; hf < L::NH; ++hf) {
      mbar_expect_tx(bar_k + 8 * hf, L::K_HALF);
      tma_load_4d(s_base + L::K_OFF + hf * L::K_HALF, &tk, bar_k + 8 * hf,
                  64 * hf, j * BLOCK, h, b);
    }
    mbar_expect_tx(bar_m, L::M_BYTES);
    for (int kh = 0; kh < NB; ++kh)
      tma_load_4d(s_base + L::M_OFF + kh * L::K_HALF, &tm, bar_m, 64 * kh, 0,
                  0, 0);
  }
  __syncthreads();   // the barriers are initialised before anyone waits

  const int lane = t & 31;
  const int wi = (t >> 5) & 3;            // warp in the warpgroup
  const int mi = lane >> 3;               // the ldmatrix / stmatrix matrix
  // A = K^T: this warp's 16 head-dim rows, key columns 16 kk .. 16 kk + 15;
  // lane i addresses key row 16 kk + 8 (mi >> 1) + i % 8 of the half tile,
  // head-dim chunk 2 wi + (mi & 1)
  const uint32_t k_half = s_base + L::K_OFF + w * L::K_HALF;
  const int chunk = 2 * wi + (mi & 1);
  uint32_t a[KS][4];
  mbar_wait(bar_k + 8 * w, 0);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    ldmatrix_x4_trans(a[kk], sw128(k_half, 16 * kk + 8 * (mi >> 1) + (lane & 7),
                                   chunk));
    if constexpr (CONVERT) {
#pragma unroll
      for (int e = 0; e < 4; ++e) a[kk][e] = bf16x2_to_half2(a[kk][e]);
    }
  }
  // D = K^T M per 64 output key rows nb: B = M rows [64 nb, 64 nb + 64)
  // (K-major: M's 64-column halves in turn)
  float acc[NB][32];
  mbar_wait(bar_m, 0);
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_rs_n64<BF16>(
          acc[nb], a[kk],
          gmma_desc(s_base + L::M_OFF + (kk >> 2) * L::K_HALF +
                        nb * 64 * SK_HALF_BYTES + (kk & 3) * 32,
                    16, 1024),
          kk > 0);
    wgmma_commit();
  }

  // acc[nb][4 g + 2 r + e] is head-dim row 16 wi + lane / 4 + 8 r, output
  // key 64 nb + 8 g + 2 (lane % 4) + e: rounded once, stored transposed
  // (stmatrix .trans: matrices (g, r = 0), (g, 1), (g + 1, 0), (g + 1,
  // 1)) into box (w, nb) = K' rows [64 nb, + 64) x head-dim [64 w, + 64)
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    if (nb + 1 < NB) wgmma_wait<NB - 1>();
    else wgmma_wait<0>();
    fence_regs<32>(acc[nb]);
    const uint32_t box = s_base + L::O_OFF + (w * NB + nb) * L::BOX;
#pragma unroll
    for (int g = 0; g < 8; g += 2) {
      uint32_t r[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int e0 = 4 * (g + (m >> 1)) + 2 * (m & 1);
        r[m] = pack2(acc[nb][e0], acc[nb][e0 + 1], OpT());
      }
      stmatrix_x4_trans(sw128(box, 8 * (g + (mi >> 1)) + (lane & 7), chunk), r);
    }
    fence_proxy_async();     // the box, before the TMA store reads it
    named_sync(1 + w, 128);
    if ((t & 127) == 0) {
      tma_store_4d(&to, box, 64 * w, j * BLOCK + 64 * nb, h, b);
      bulk_commit();
    }
  }
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) fence_regs<4>(a[kk]);
  if ((t & 127) == 0) bulk_wait_read();   // the boxes outlive the stores
}

template <typename OpT, typename KeyT, int BLOCK, int D>
static int launch(const void* m, const void* k, void* out, int batch,
                  int kv_heads, int s2, long long sb, long long sh,
                  long long ss, cudaStream_t stream) {
  using L = ShiftLayout<BLOCK, D>;
  CUtensorMap tm, tk, to;
  const cuuint64_t m_dims[4] = {BLOCK, BLOCK, 1, 1};
  const cuuint64_t m_strides[3] = {BLOCK * 2, BLOCK * BLOCK * 2,
                                   BLOCK * BLOCK * 2};
  const cuuint32_t m_box[4] = {64, BLOCK, 1, 1};
  const long long os = D, oh = (long long)s2 * os,
                  ob = (long long)kv_heads * oh;   // K' is contiguous
  if (!encode_map(&tm, tma_dtype<OpT>(), m, m_dims, m_strides, m_box,
                  CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&tk, k, batch, kv_heads, s2, sb, sh, ss, BLOCK,
                tma_dtype<KeyT>(), D) ||
      !make_map(&to, out, batch, kv_heads, s2, ob, oh, os, 64,
                tma_dtype<OpT>(), D))
    return (int)cudaErrorInvalidValue;
  auto kernel = shift_kv_kernel<OpT, KeyT, BLOCK, D>;
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
  kernel<<<dim3(batch * kv_heads, s2 / BLOCK), L::THREADS, smem, stream>>>(
      tm, tk, to, kv_heads);
  return (int)cudaGetLastError();
}

template <typename OpT, typename KeyT>
static int launch_block(const void* m, const void* k, void* out, int batch,
                        int kv_heads, int s2, int block, int head_dim,
                        long long sb, long long sh, long long ss,
                        cudaStream_t stream) {
#define PASA_SHIFT_LAUNCH(BLOCK, D)                                        \
  launch<OpT, KeyT, BLOCK, D>(m, k, out, batch, kv_heads, s2, sb, sh, ss, \
                              stream)
  if (head_dim == 128)
    return block == 128 ? PASA_SHIFT_LAUNCH(128, 128)
                        : PASA_SHIFT_LAUNCH(64, 128);
  return block == 128 ? PASA_SHIFT_LAUNCH(128, 64) : PASA_SHIFT_LAUNCH(64, 64);
#undef PASA_SHIFT_LAUNCH
}

}  // namespace pasa

// Plain C entry point (bound with ctypes).  M is (block, block)
// contiguous at the operand dtype (bf16 if m_is_bf16, else fp16), and
// must be symmetric: the kernel computes K'^T = K^T M, which is M K only
// then (the caller's device_matrix checks it); keys
// are bf16 or fp16 (bf16 keys need no conversion under a bf16 M; fp16
// keys under a bf16 M are not taken), read through the element strides
// sb, sh, ss (multiples of 8, unit stride on the head dim, 16-byte
// aligned start); block is 64 or 128 and divides s2; head_dim is 64 or
// 128.  The output is (B, KVH, S2, head_dim) at M's dtype, contiguous.
// Returns the cudaError_t of the launch (0: queued on `stream`).
extern "C" int shift_kv_launch(const void* m, const void* k, void* out,
                               int batch, int kv_heads, int s2, int block,
                               int head_dim, long long sb, long long sh,
                               long long ss, int m_is_bf16, int k_is_bf16,
                               void* stream) {
  using namespace pasa;
  bool ok = batch >= 1 && kv_heads >= 1 && (block == 64 || block == 128) &&
            (head_dim == 64 || head_dim == 128) &&
            s2 >= block && !(s2 % block) && s2 / block <= 65535 &&
            !(m_is_bf16 && !k_is_bf16) &&
            !(reinterpret_cast<uintptr_t>(m) % 16) &&
            !(reinterpret_cast<uintptr_t>(k) % 16) &&
            !(reinterpret_cast<uintptr_t>(out) % 16);
  const long long st[3] = {sb, sh, ss};
  for (int n = 0; n < 3; ++n) ok = ok && st[n] >= 0 && !(st[n] % 8);
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m_is_bf16)
    return launch_block<__nv_bfloat16, __nv_bfloat16>(
        m, k, out, batch, kv_heads, s2, block, head_dim, sb, sh, ss, s);
  if (k_is_bf16)
    return launch_block<__half, __nv_bfloat16>(m, k, out, batch, kv_heads, s2,
                                               block, head_dim, sb, sh, ss, s);
  return launch_block<__half, __half>(m, k, out, batch, kv_heads, s2, block,
                                      head_dim, sb, sh, ss, s);
}
