// PASA flash-decode over a paged KV pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/pasa_paged_decode.py
// (_paged_decode_kernel, launched by paged_decode_kernel_call through
// pl.pallas_call), in both of its modes: raw pools (bf16, fp16) and
// quantized pools (int8 or fp8 e4m3 codes with per-page sidecars).
//
// What it computes: one new token per sequence; the GQA group's G query
// heads are the rows; each page is one PASA block (page_size == block_kv).
//
// Design: pages spread over a cluster of DEC_CLUSTER CTAs, folded exactly
// in order.  The F-bar recurrence of PASA is order-dependent, so the usual
// split-KV log-sum-exp combine would be a new convention.  But what a page
// contributes before the running state is read - s-bar, the local max and
// sum, and P V at the accumulator dtype (decode_block_partials) - does not
// depend on earlier pages.  So each (sequence, kv-head) gets a cluster:
//   1. rank r reduces the live pages j = r, r + 8, ... to their partials
//      and writes them to a workspace in device memory (the wrapper's
//      torch.empty); inside the CTA the next page's K/V bytes - and, for
//      8-bit pools, its sidecars - arrive by cp.async into a staging
//      buffer while the current page is computed, so neither the load nor
//      the sidecar -> code dependency stands in the page's path;
//   2. a cluster barrier (release / acquire at cluster scope);
//   3. rank r folds head-dim columns [16 r, 16 r + 16) of every row over
//      j = 0 .. n_live - 1 in order (decode_fold_step: row_update, run
//      redundantly by each of the row's threads, then acc_update), and
//      writes O = acc / l.
// Step 3 performs the floating-point operations of the sequential walk on
// the same values, so the result equals the contiguous decode kernel's
// (which keeps the walk) bit for bit.  One launch per call.
//
// Rules kept from the walk: pages past kv_len are never read; K and V rows
// past `valid` are not loaded (both enter shared memory as zeros); a dead
// page's sidecars are never read; a rank with no live page still arrives
// at the cluster barrier.
//
// What bounds it on an H100: latency.  The bytes (each live K/V row once,
// 2 x 128 x 2 bytes per kv-head and position for bf16, half that for
// 8-bit codes) take ~1-2 us at 3.35 TB/s; the block math is G dot
// products of 128 and G sums of `page` products per thread out of shared
// memory, ~2,000 dependent-chain FMAs per thread per page.  The cluster
// cuts the pages a CTA walks by 8 (a 1,000-token sequence: one page per
// CTA), and B x KVH x 8 CTAs fill the SMs (128 at the serve's batch 4).
// What remains is one page's latency, the fold's n_live dependent
// row_update steps and the barrier.

#include "pasa_decode_block.cuh"

namespace pasa {

constexpr int DEC_CLUSTER = 8;                             // CTAs per (b, h)
constexpr int DEC_FOLD_COLS = HEAD_DIM / DEC_CLUSTER;      // 16 per rank
static_assert(DEC_THREADS % DEC_FOLD_COLS == 0, "fold mapping");

// A page as it arrives from the pool, before conversion to fp16.
template <typename PoolT>
struct PageStage {
  PoolT k[DEC_MAX_BLOCK][HEAD_DIM];
  PoolT v[DEC_MAX_BLOCK][HEAD_DIM];
  PageSidecars sc;   // 8-bit pools only
};

constexpr size_t DEC_STAGE_OFF = (sizeof(DecodeSmem) + 127) / 128 * 128;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync_release_acquire() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Start the copy of live page `pid`'s first `valid` K and V rows of kv
// head h (and, for 8-bit pools, its sidecars) into `st`.
template <typename PoolT>
__device__ __forceinline__ void issue_page(PageStage<PoolT>& st,
                                           const PoolT* k_pages,
                                           const PoolT* v_pages,
                                           const SidecarPtrs& sc, int pid,
                                           int valid, int page, int kv_heads,
                                           int h) {
  constexpr int EPC = 16 / sizeof(PoolT);        // elements per 16 bytes
  constexpr int CPR = HEAD_DIM / EPC;            // 16-byte chunks per row
  const int t = threadIdx.x;
  for (int i = t; i < valid * CPR; i += DEC_THREADS) {
    const int r = i / CPR, c = (i % CPR) * EPC;
    const size_t off = (((size_t)pid * page + r) * kv_heads + h) * HEAD_DIM + c;
    cp_async16(&st.k[r][c], k_pages + off);
    cp_async16(&st.v[r][c], v_pages + off);
  }
  if constexpr (kIsCode<PoolT>) {
    const size_t ph = (size_t)pid * kv_heads + h;
    // (the side is picked by a select: a runtime index into the pointer
    // arrays would copy them to local memory)
    if (t < 2 * HEAD_DIM / 4) {
      const int side = t / (HEAD_DIM / 4), c = (t % (HEAD_DIM / 4)) * 4;
      const float* shift = side ? sc.shift[1] : sc.shift[0];
      cp_async16(&st.sc.shift[side][c], shift + ph * HEAD_DIM + c);
    } else if (t < 2 * HEAD_DIM / 4 + 2) {
      const int side = t - 2 * HEAD_DIM / 4;
      cp_async4(&st.sc.scale[side], (side ? sc.scale[1] : sc.scale[0]) + ph);
    }
  }
  cp_async_commit();
}

// Staged page -> S.k / S.v at fp16: raw pools convert, 8-bit pools
// dequantize with the staged sidecars; rows past `valid` become zeros.
template <typename PoolT>
__device__ __forceinline__ void convert_page(DecodeSmem& S,
                                             const PageStage<PoolT>& st,
                                             int valid, int page) {
  const int t = threadIdx.x;
  const int c8 = (t & 15) * 8;
  for (int r = t >> 4; r < page; r += DEC_THREADS / 16) {
    uint4 kk = make_uint4(0u, 0u, 0u, 0u), vv = kk;
    if (r < valid) {
      kk = load_pool8(&st.k[r][c8], 0, c8, st.sc);
      vv = load_pool8(&st.v[r][c8], 1, c8, st.sc);
    }
    const __half2* k2 = reinterpret_cast<const __half2*>(&kk);
    __half2* kd = reinterpret_cast<__half2*>(&S.k[r][c8]);
#pragma unroll
    for (int i = 0; i < 4; ++i) kd[i] = k2[i];
    *reinterpret_cast<uint4*>(&S.v[r][c8]) = vv;
  }
}

template <typename PoolT, int NG>
__global__ void __launch_bounds__(DEC_THREADS)
paged_decode_kernel(const __half* __restrict__ q,       // (B, KVH, G, D)
                    const PoolT* __restrict__ k_pages,  // (P, page, KVH, D)
                    const PoolT* __restrict__ v_pages,
                    SidecarPtrs sc,                     // 8-bit pools only
                    const int* __restrict__ page_table, // (B, max_pages)
                    const int* __restrict__ kv_len,     // (B,)
                    __half* __restrict__ out,           // (B, KVH, G, D)
                    float* __restrict__ ws_pv,     // (B, KVH, max_pages, G, D)
                    float* __restrict__ ws_stats,  // (B, KVH, max_pages, 3, G)
                    int kv_heads, int G, int page, int max_pages, Policy P) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  DecodeSmem& S = *reinterpret_cast<DecodeSmem*>(smem_raw);
  PageStage<PoolT>& st =
      *reinterpret_cast<PageStage<PoolT>*>(smem_raw + DEC_STAGE_OFF);
  const int rank = blockIdx.x;            // == the CTA's rank in its cluster
  const int b = blockIdx.y;
  const int h = blockIdx.z;
  const int t = threadIdx.x;
  const size_t bh = (size_t)b * kv_heads + h;

  const int L = kv_len[b];
  const int n_live = L > 0 ? min(max_pages, (L + page - 1) / page) : 0;
  const int* table = page_table + (size_t)b * max_pages;

  // 1. this rank's pages to partials, the next page in flight meanwhile
  if (rank < n_live) {
    issue_page(st, k_pages, v_pages, sc, table[rank], min(page, L - rank * page),
               page, kv_heads, h);
    const __half* qbh = q + bh * G * HEAD_DIM;
    for (int g = 0; g < G; ++g) S.q[g][t] = qbh[g * HEAD_DIM + t];
  }
  for (int j = rank; j < n_live; j += DEC_CLUSTER) {
    const int valid = min(page, L - j * page);
    cp_async_wait_all();
    __syncthreads();   // page j staged; the previous page's math is done
    convert_page(S, st, valid, page);
    __syncthreads();   // the staging buffer is free again
    const int jn = j + DEC_CLUSTER;
    if (jn < n_live)
      issue_page(st, k_pages, v_pages, sc, table[jn], min(page, L - jn * page),
                 page, kv_heads, h);
    float pv[NG];
    decode_block_partials<NG>(S, valid, page, G, P, pv);
    float* pvj = ws_pv + ((bh * max_pages + j) * G) * HEAD_DIM + t;
#pragma unroll
    for (int g = 0; g < NG; ++g)
      if (g < G) pvj[g * HEAD_DIM] = pv[g];
    if (t < G) {
      float* sj = ws_stats + (bh * max_pages + j) * 3 * G;
      sj[t] = S.sbar[t];
      sj[G + t] = S.m_loc[t];
      sj[2 * G + t] = S.l_loc[t];
    }
  }

  // 2. every page's partials are written
  __threadfence();
  cluster_sync_release_acquire();

  // 3. the fold of this rank's 16 columns, pages in order
  const int col = rank * DEC_FOLD_COLS + t % DEC_FOLD_COLS;
  for (int g = t / DEC_FOLD_COLS; g < G; g += DEC_THREADS / DEC_FOLD_COLS) {
    FoldState fs = fold_state_init();
    const float* sj = ws_stats + bh * max_pages * 3 * G + g;
    const float* pj = ws_pv + (bh * max_pages * G + g) * HEAD_DIM + col;
    float sbar = 0.0f, m_loc = 0.0f, l_loc = 0.0f, pv = 0.0f;
    if (n_live > 0) {
      sbar = __ldcg(sj);
      m_loc = __ldcg(sj + G);
      l_loc = __ldcg(sj + 2 * G);
      pv = __ldcg(pj);
    }
    for (int j = 0; j < n_live; ++j) {
      // the next page's partials load while this one folds
      float sbar_n = 0.0f, m_loc_n = 0.0f, l_loc_n = 0.0f, pv_n = 0.0f;
      if (j + 1 < n_live) {
        const float* sn = sj + (size_t)(j + 1) * 3 * G;
        sbar_n = __ldcg(sn);
        m_loc_n = __ldcg(sn + G);
        l_loc_n = __ldcg(sn + 2 * G);
        pv_n = __ldcg(pj + (size_t)(j + 1) * G * HEAD_DIM);
      }
      decode_fold_step(fs, j, sbar, m_loc, l_loc, pv, P);
      sbar = sbar_n;
      m_loc = m_loc_n;
      l_loc = l_loc_n;
      pv = pv_n;
    }
    // O = acc / l at the accumulator dtype, stored at fp16
    out[(bh * G + g) * HEAD_DIM + col] =
        __float2half_rn(rnd(__fdiv_rn(fs.acc, fs.l), P.acc_half));
  }
}

template <typename PoolT, int NG>
static int launch_rows(const void* q, const void* k_pages, const void* v_pages,
                  const SidecarPtrs& sc, const void* page_table,
                  const void* kv_len, void* out, void* workspace, int batch,
                  int kv_heads, int G, int page, int max_pages,
                  const Policy& P, cudaStream_t stream) {
  const size_t smem = DEC_STAGE_OFF + sizeof(PageStage<PoolT>);
  auto kernel = paged_decode_kernel<PoolT, NG>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(DEC_CLUSTER, batch, kv_heads);
  cfg.blockDim = dim3(DEC_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = DEC_CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // once per instance: the attribute, and a cluster that fits on a GPC
  static int ready = 0;
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
    ready = 1;
  }
  float* ws = static_cast<float*>(workspace);
  float* ws_stats = ws + (size_t)batch * kv_heads * max_pages * G * HEAD_DIM;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const __half*>(q),
      static_cast<const PoolT*>(k_pages), static_cast<const PoolT*>(v_pages),
      sc, static_cast<const int*>(page_table), static_cast<const int*>(kv_len),
      static_cast<__half*>(out), ws, ws_stats, kv_heads, G, page, max_pages, P);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename PoolT>
static int launch(const void* q, const void* k_pages, const void* v_pages,
                  const SidecarPtrs& sc, const void* page_table,
                  const void* kv_len, void* out, void* workspace, int batch,
                  int kv_heads, int G, int page, int max_pages,
                  const Policy& P, cudaStream_t stream) {
  if (G <= dec_rows(1))
    return launch_rows<PoolT, dec_rows(1)>(q, k_pages, v_pages, sc, page_table,
                                           kv_len, out, workspace, batch,
                                           kv_heads, G, page, max_pages, P,
                                           stream);
  return launch_rows<PoolT, DEC_MAX_G>(q, k_pages, v_pages, sc, page_table,
                                       kv_len, out, workspace, batch, kv_heads,
                                       G, page, max_pages, P, stream);
}

}  // namespace pasa

// Plain C entry point (bound with ctypes).  The four sidecar pointers are
// read only for an 8-bit pool_kind (PoolKind).  `workspace` holds
// batch * kv_heads * max_pages * group * (128 + 3) floats (the pages'
// partials).  Returns the cudaError_t of the launch; 0 means it was
// queued on `stream`.
extern "C" int pasa_paged_decode_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* k_shift, const void* v_scale,
    const void* v_shift, const void* page_table, const void* kv_len, void* out,
    void* workspace, int batch, int kv_heads, int group, int page,
    int max_pages, int pool_kind, float beta, float inva, float shift_scale,
    float post_scale, int stat_half, int acc_half, void* stream) {
  using namespace pasa;
  if (group < 1 || group > DEC_MAX_G || page < 1 || page > DEC_MAX_BLOCK ||
      batch < 1 || batch > 65535 || kv_heads < 1 || kv_heads > 65535 ||
      max_pages < 1 || !workspace)
    return (int)cudaErrorInvalidValue;
  const bool quant = pool_kind == POOL_INT8 || pool_kind == POOL_FP8;
  if (quant && !(k_scale && k_shift && v_scale && v_shift))
    return (int)cudaErrorInvalidValue;
  const Policy P = make_policy(beta, inva, shift_scale, post_scale, stat_half, acc_half);
  const SidecarPtrs sc = {
      {static_cast<const float*>(k_scale), static_cast<const float*>(v_scale)},
      {static_cast<const float*>(k_shift), static_cast<const float*>(v_shift)}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (pool_kind) {
    case POOL_FP16:
      return launch<__half>(q, k_pages, v_pages, sc, page_table, kv_len, out,
                            workspace, batch, kv_heads, group, page,
                            max_pages, P, s);
    case POOL_BF16:
      return launch<__nv_bfloat16>(q, k_pages, v_pages, sc, page_table, kv_len,
                                   out, workspace, batch, kv_heads, group,
                                   page, max_pages, P, s);
    case POOL_INT8:
      return launch<int8_t>(q, k_pages, v_pages, sc, page_table, kv_len, out,
                            workspace, batch, kv_heads, group, page,
                            max_pages, P, s);
    case POOL_FP8:
      return launch<__nv_fp8_e4m3>(q, k_pages, v_pages, sc, page_table, kv_len,
                                   out, workspace, batch, kv_heads, group,
                                   page, max_pages, P, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
