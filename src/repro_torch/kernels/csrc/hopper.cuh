// Hopper building blocks shared by the wgmma kernels (sm_90a): shared-
// memory barriers (mbarrier), TMA and bulk copies, wgmma with its shared-
// memory descriptors (fp16 and bf16 operands), the fp16-pair steps of the
// all-fp16 policy, and the host-side tensor-map encoding.  Included by pasa_attention.cu,
// pasa_paged_prefill.cu and shift_kv.cu.
#pragma once

#include <cuda.h>

#include <type_traits>

#include "pasa_common.cuh"

namespace pasa {

// ---- shared-memory addresses, mbarriers, TMA --------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// Bring a tensor map (a __grid_constant__ kernel parameter) into the TMA
// unit's cache ahead of its first use.
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// One box of a rank-4 tensor map (innermost coordinate first) into shared
// memory; completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// One box from shared memory to a rank-4 tensor map (innermost coordinate
// first), tracked in the issuing thread's bulk group.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Wait until this thread's bulk stores have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// One contiguous run of `bytes` (a multiple of 16, 16-byte aligned ends)
// from device memory into shared memory, counted on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Order this thread's generic-proxy shared-memory accesses before later
// async-proxy ones (wgmma operand reads, TMA writes) and vice versa.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier `id` (1..15) over `count` threads (a multiple of 32).
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ---- wgmma -------------------------------------------------------------

// Four 8 x 8 matrices of 16-bit elements, transposed, between shared
// memory and registers: lane i gives the address of (16-byte) row i % 8
// of matrix i / 8; register m holds matrix m's pair (row lane / 4, columns
// 2 (lane % 4), + 1) of the TRANSPOSED matrix.  So a row-major tile
// loads as the column-major fragment of an mma operand, and the
// accumulator's pairs store as rows of the transposed tile.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void stmatrix_x4_trans(uint32_t addr,
                                                  const uint32_t* r) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, "
      "%4};\n" ::"r"(addr),
      "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
      : "memory");
}


// Shared-memory matrix descriptor, 128-byte swizzle (the TMA boxes'
// layout): byte offsets of the leading and stride dimensions.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving reads or writes of wgmma registers across
// the asynchronous product.
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// The register A operand is read by the product after its issue: keep
// the registers live (unreused) until the wait.
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* a) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

#define PASA_WGMMA_D32 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
  "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
  "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define PASA_WGMMA_D64 PASA_WGMMA_D32, \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
  "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
  "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
  "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
  "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
  "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define PASA_WGMMA_R32 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31}"
#define PASA_WGMMA_R64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
  "%58, %59, %60, %61, %62, %63}"

// Each product below takes fp16 operands or, with BF16, bf16 ones, into
// an fp32 sum.

// D (m64 x n64, f32) (+)= A (smem, K-major) * B (smem, K-major)^T.
template <bool BF16>
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db,
                                             int accumulate) {
  if constexpr (BF16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " PASA_WGMMA_R32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : PASA_WGMMA_D32
        : "l"(da), "l"(db), "r"(accumulate));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " PASA_WGMMA_R32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : PASA_WGMMA_D32
        : "l"(da), "l"(db), "r"(accumulate));
  }
}

// D (m64 x n128, f32) (+)= A (smem, K-major) * B (smem, K-major)^T.
template <bool BF16>
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da, uint64_t db,
                                              int accumulate) {
  if constexpr (BF16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " PASA_WGMMA_R64
        ", %64, %65, p, 1, 1, 0, 0;\n}\n"
        : PASA_WGMMA_D64
        : "l"(da), "l"(db), "r"(accumulate));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 " PASA_WGMMA_R64
        ", %64, %65, p, 1, 1, 0, 0;\n}\n"
        : PASA_WGMMA_D64
        : "l"(da), "l"(db), "r"(accumulate));
  }
}

// D (m64 x n128, f32) (+)= A (registers: 16-bit pairs) * B (smem,
// MN-major).
template <bool BF16>
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                              uint64_t db, int accumulate) {
  if constexpr (BF16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " PASA_WGMMA_R64
        ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : PASA_WGMMA_D64
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(accumulate));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 " PASA_WGMMA_R64
        ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : PASA_WGMMA_D64
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(accumulate));
  }
}

// D (m64 x n64, f32) (+)= A (registers: 16-bit pairs) * B (smem, K-major,
// or MN-major with TRANS_B = 1).
template <bool BF16, int TRANS_B = 0>
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                             uint64_t db, int accumulate) {
  if constexpr (BF16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " PASA_WGMMA_R32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : PASA_WGMMA_D32
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(accumulate), "n"(TRANS_B));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " PASA_WGMMA_R32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : PASA_WGMMA_D32
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(accumulate), "n"(TRANS_B));
  }
}
#undef PASA_WGMMA_D32
#undef PASA_WGMMA_D64
#undef PASA_WGMMA_R32
#undef PASA_WGMMA_R64

template <int BKV, bool BF16>
__device__ __forceinline__ void wgmma_scores(float* s, uint64_t da, uint64_t db,
                                             int accumulate) {
  if constexpr (BKV == 128) wgmma_ss_n128<BF16>(s, da, db, accumulate);
  else wgmma_ss_n64<BF16>(s, da, db, accumulate);
}

// P V at head width D (64 or 128): P the register A operand, V MN-major
// from shared memory.
template <int D, bool BF16>
__device__ __forceinline__ void wgmma_pv(float* o, const uint32_t* p,
                                         uint64_t dv, int accumulate) {
  if constexpr (D == 128) wgmma_rs_n128<BF16>(o, p, dv, accumulate);
  else wgmma_rs_n64<BF16, 1>(o, p, dv, accumulate);
}

// ---- fp16 pairs --------------------------------------------------------
//
// Under the all-fp16 policy every elementwise step of the softmax and the
// accumulator takes fp16 operands and stores at fp16.  One f16x2
// operation rounded once (.rn: never contracted into an fma) gives the
// bits of the fp32 operation rounded to fp16: the fp32 product of two fp16
// values is exact, and so is their fp32 sum or difference wherever its
// rounding could move the fp16 result.  So two elements take one
// instruction where the fp32 route takes three.

__device__ __forceinline__ uint32_t h2_bits(__half2 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}
__device__ __forceinline__ __half2 h2_of(uint32_t x) {
  return *reinterpret_cast<__half2*>(&x);
}
__device__ __forceinline__ uint32_t h2_mul(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.f16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t h2_add(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.f16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t h2_sub(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.f16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
// Both halves x, for x already an fp16 value.
__device__ __forceinline__ uint32_t h2_splat(float x) {
  return h2_bits(__float2half2_rn(x));
}

// ---- host side ----------------------------------------------------------

// The instance kind of a wgmma kernel's launch (attention, paged
// prefill): 0 the fp16 pair steps (the fp16 policy), 1 fp16 scores, 2 fp32
// scores on fp16 operands, 3 fp32 scores on bf16 operands (`mode`: ModeId).
static inline int wgmma_kind(int mode, const Policy& P) {
  if (mode == MODE_F16) return (P.stat_half && P.acc_half) ? 0 : 1;
  return mode == MODE_F32 ? 2 : 3;
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (the build
// does not link libcuda).
static EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// Rank-4 map of `ptr` with extents `dims` (innermost first), byte
// strides of the outer three, boxes of `box` elements.
static bool encode_map(CUtensorMap* map, CUtensorMapDataType dtype,
                       const void* ptr, const cuuint64_t* dims,
                       const cuuint64_t* strides, const cuuint32_t* box,
                       CUtensorMapSwizzle swizzle) {
  EncodeTiledFn fn = encode_tiled();
  if (!fn) return false;
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(map, dtype, 4, const_cast<void*>(ptr), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The tensor-map element type of a 2-byte operand type.
template <typename T>
constexpr CUtensorMapDataType tma_dtype() {
  return std::is_same<T, __nv_bfloat16>::value
             ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
             : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
}

// Rank-4 map of a (B, heads, rows, head_dim) tensor of 2-byte elements
// (fp16 unless `dtype` says otherwise) read through its element strides;
// boxes of `box_rows` x 64 columns, 128-byte swizzle.  A box reaching past
// `rows` is filled with zeros there (and still counts its full bytes on
// the barrier).
static bool make_map(CUtensorMap* map, const void* ptr, int batch, int heads,
                     int rows, long long sb, long long sh, long long ss,
                     int box_rows,
                     CUtensorMapDataType dtype = CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
                     int head_dim = HEAD_DIM) {
  // a dimension of extent 1 may carry any stride (0 for an expanded
  // view): give it a valid one
  if (heads == 1) sh = (long long)rows * ss;
  if (batch == 1) sb = (long long)heads * sh;
  const cuuint64_t dims[4] = {(cuuint64_t)head_dim, (cuuint64_t)rows,
                              (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_rows, 1, 1};
  return encode_map(map, dtype, ptr, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace pasa
