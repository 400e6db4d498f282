// PASA key pre-processing K'_j = M K_j (Algorithm 1 lines 5-7), for Hopper
// (sm_90a).
//
// Replaces the TPU kernel repro/kernels/shift_kv.py (_shift_kernel,
// launched by shift_kv_kernel_call through pl.pallas_call).
//
// What it computes: for every (batch, kv-head) and every block of
// `block` key rows, the product of the shifting matrix M (block x block,
// fp16, the 1/sqrt(d) scale folded in) with the block's keys (block x
// 128), as the matrix engine does it: fp16 operands, an fp32 sum, ONE
// rounding to fp16 on the store.  Keys may be bf16 or fp16 and are read
// through their strides (the prefill's (B, S, KVH, D) projection is read
// where it lies); bf16 keys are rounded to fp16 first, as the reference
// casts K to M's dtype before the product.  The output is (B, KVH, S2,
// 128) fp16, contiguous.
//
// What bounds it on an H100: bytes.  Each key is read once and written
// once (4 bytes per element at fp16) against 2 x block flops per element,
// ~64 flops/byte at block 128, far below the card's ~295 flops/byte
// ridge.  One CTA per (b * kvh, block) loads M and the key block into
// shared memory with 16-byte loads, runs the GEMM on the tensor cores
// (WMMA m16n16k16) and writes the block back with 16-byte stores.  It is
// the simple version: M is re-read from L2 by every CTA and nothing is
// pipelined.

#include <mma.h>

#include "pasa_common.cuh"

namespace pasa {

constexpr int SK_THREADS = 256;                // 8 warps
constexpr int SK_WARPS = SK_THREADS / 32;
constexpr int SK_MAX_BLOCK = 128;
constexpr int SK_LDH = HEAD_DIM + 8;           // fp16 row stride (272 B)
constexpr int SK_LDF = HEAD_DIM + 4;           // fp32 row stride

struct ShiftSmem {
  __half m[SK_MAX_BLOCK][SK_LDH];   // M, `block` x `block` used
  __half k[SK_MAX_BLOCK][SK_LDH];   // the key block at fp16
  float o[SK_MAX_BLOCK][SK_LDF];    // fp32 product before the store
};

template <typename KeyT>
__global__ void __launch_bounds__(SK_THREADS)
shift_kv_kernel(const __half* __restrict__ m,    // (block, block) contiguous
                const KeyT* __restrict__ k,      // (B, KVH, S2, 128) strided
                __half* __restrict__ out,        // (B, KVH, S2, 128)
                int kv_heads, int s2, int block, long long sb, long long sh,
                long long ss) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  ShiftSmem& S = *reinterpret_cast<ShiftSmem*>(smem_raw);
  const int bh = blockIdx.x;
  const int j = blockIdx.y;
  const int b = bh / kv_heads, h = bh % kv_heads;
  const int t = threadIdx.x;
  const int warp = t >> 5;

  // M: rows of `block` halves, 8 per 16-byte load
  const int seg = block / 8;
  for (int e = t; e < block * seg; e += SK_THREADS) {
    const int r = e / seg, c8 = (e % seg) * 8;
    *reinterpret_cast<uint4*>(&S.m[r][c8]) =
        *reinterpret_cast<const uint4*>(m + (size_t)r * block + c8);
  }
  // key block -> fp16
  const KeyT* kb = k + b * sb + h * sh + (long long)j * block * ss;
  for (int e = t; e < block * (HEAD_DIM / 8); e += SK_THREADS) {
    const int r = e / (HEAD_DIM / 8), c8 = (e % (HEAD_DIM / 8)) * 8;
    *reinterpret_cast<uint4*>(&S.k[r][c8]) = load8_half(kb + r * ss + c8);
  }
  __syncthreads();

  // O = M K on tensor cores: (block x block) x (block x 128), fp32 sums.
  constexpr int NTN = HEAD_DIM / 16;
  const int ntm = block / 16;
  for (int tile = warp; tile < ntm * NTN; tile += SK_WARPS) {
    const int tm = tile / NTN, tn = tile % NTN;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
    wmma::fill_fragment(c, 0.0f);
    for (int k0 = 0; k0 < block; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __half, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __half, wmma::row_major> bk;
      wmma::load_matrix_sync(a, &S.m[tm * 16][k0], SK_LDH);
      wmma::load_matrix_sync(bk, &S.k[k0][tn * 16], SK_LDH);
      wmma::mma_sync(c, a, bk, c);
    }
    wmma::store_matrix_sync(&S.o[tm * 16][tn * 16], c, SK_LDF, wmma::mem_row_major);
  }
  __syncthreads();

  // one rounding to fp16, 16-byte stores
  __half* ob = out + ((size_t)bh * s2 + (size_t)j * block) * HEAD_DIM;
  for (int e = t; e < block * (HEAD_DIM / 8); e += SK_THREADS) {
    const int r = e / (HEAD_DIM / 8), c8 = (e % (HEAD_DIM / 8)) * 8;
    uint4 packed;
    __half* ph = reinterpret_cast<__half*>(&packed);
#pragma unroll
    for (int i = 0; i < 8; ++i) ph[i] = __float2half_rn(S.o[r][c8 + i]);
    *reinterpret_cast<uint4*>(ob + (size_t)r * HEAD_DIM + c8) = packed;
  }
}

template <typename KeyT>
static int launch(const void* m, const void* k, void* out, int batch,
                  int kv_heads, int s2, int block, long long sb, long long sh,
                  long long ss, cudaStream_t stream) {
  const size_t smem = sizeof(ShiftSmem);
  cudaError_t err = cudaFuncSetAttribute(
      shift_kv_kernel<KeyT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(batch * kv_heads, s2 / block);
  shift_kv_kernel<KeyT><<<grid, SK_THREADS, smem, stream>>>(
      static_cast<const __half*>(m), static_cast<const KeyT*>(k),
      static_cast<__half*>(out), kv_heads, s2, block, sb, sh, ss);
  return (int)cudaGetLastError();
}

}  // namespace pasa

// Plain C entry point (bound with ctypes).  Strides are in elements of the
// key tensor; returns the cudaError_t of the launch (0: queued on `stream`).
extern "C" int shift_kv_launch(const void* m, const void* k, void* out,
                               int batch, int kv_heads, int s2, int block,
                               long long sb, long long sh, long long ss,
                               int k_is_bf16, void* stream) {
  using namespace pasa;
  if (batch < 1 || kv_heads < 1 || s2 < 1 || block < 16 ||
      block > SK_MAX_BLOCK || block % 16 || s2 % block)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k_is_bf16)
    return launch<__nv_bfloat16>(m, k, out, batch, kv_heads, s2, block, sb,
                                 sh, ss, s);
  return launch<__half>(m, k, out, batch, kv_heads, s2, block, sb, sh, ss, s);
}
