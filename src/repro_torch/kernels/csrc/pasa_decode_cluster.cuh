// PASA flash-decode with a sequence's KV blocks spread over a CTA cluster
// and folded exactly in order (sm_90a), shared by the paged decode kernel
// (pasa_paged_decode.cu: block j is page table[b, j] of a pool) and the
// contiguous decode kernel (pasa_decode.cu: block j is rows [j * block,
// (j + 1) * block) of a cache read through strides).  The two differ only
// in the addressing parameter of the kernel template: PagedBlocks or
// StridedBlocks give the address of a block's first row and its row
// stride.
//
// The F-bar recurrence of PASA is order-dependent, so the usual split-KV
// log-sum-exp combine would be a new convention.  But what a block
// contributes before the running state is read - s-bar, the local max and
// sum, and P V at the accumulator dtype (decode_block_partials) - does
// not depend on earlier blocks.  So each (sequence, kv-head) gets a
// cluster of DEC_CLUSTER CTAs:
//   1. rank r reduces the live blocks j = r, r + 8, ... to their partials
//      and writes them to a workspace in device memory (the wrapper's
//      torch.empty); inside the CTA the next block's K/V bytes - and, for
//      8-bit pools, its sidecars - arrive by cp.async into a staging
//      buffer while the current block is computed, so neither the load
//      nor the sidecar -> code dependency stands in the block's path;
//   2. a cluster barrier (release / acquire at cluster scope);
//   3. rank r folds head-dim columns [D r / 8, D (r + 1) / 8) of every
//      row (16 columns at D 128, 8 at D 64) over j = 0 .. n_live - 1 in
//      order (decode_fold_step: row_update, run redundantly by each of
//      the row's threads, then acc_update), and writes O = acc / l.
// Step 3 performs the floating-point operations of the sequential walk
// (decode_block_update, block after block) on the same values, so the
// result equals the walk's bit for bit; pasa_decode.cu keeps the walk as
// a second entry point, the on-card oracle of both cluster kernels.
//
// Rules kept from the walk: blocks past kv_len are never read; K and V
// rows past `valid` are not loaded (both enter shared memory as zeros);
// a dead page's sidecars are never read; a rank with no live block still
// arrives at the cluster barrier.
//
// Block sizes: a page holds at most 128 rows; a block of the contiguous
// cache up to 256 (DEC_MAX_BLOCK, the reference's default).  The staging
// buffer holds 128 rows, so a block of more rows arrives as pieces of 128
// that land one after another in the block's shared-memory tile; the
// block's math then runs once over all its rows - one key mean, one s-bar
// and one set of partials per block, as the walk computes them.  Shared
// memory at D 128: 78,848 + 66,568 bytes per CTA over pages (bf16),
// 153,088 + 66,568 over the contiguous cache; at D 64: 44,032 + 33,288
// and 85,504 + 33,288; in every policy mode (the block tile holds its
// operands at two bytes, and fp32 probabilities overwrite their scores:
// DecodeSmem).
//
// The head width D (64 or 128) is a template parameter of the addressing
// (PagedBlocks, StridedBlocks), and through it of the block tile, the
// staging buffer and the kernel's D threads.
//
// The kernel template takes the policy's mode (pasa_common.cuh Mode): q,
// the block's K and V, and the output at the operand type (fp16, or bf16
// under bf16_fp32), scores at fp16 or fp32; the pool or cache elements
// are converted to the operand type as they leave the staging buffer.
#pragma once

#include "pasa_decode_block.cuh"

namespace pasa {

constexpr int DEC_CLUSTER = 8;                             // CTAs per (b, h)

// One piece of a block (up to 128 rows) of head width D as it arrives
// from device memory, before conversion to the operand type.
template <typename T, int D>
struct PageStage {
  T k[DEC_PAGE_ROWS][D];
  T v[DEC_PAGE_ROWS][D];
  PageSidecars<D> sc;   // 8-bit pools only
};

// Byte offset of the staging buffer behind a block tile of MAXB rows.
template <typename OpT, int MAXB, int D>
__host__ __device__ constexpr size_t dec_stage_off() {
  return (sizeof(DecodeSmem<OpT, MAXB, D>) + 127) / 128 * 128;
}

// Rows of piece `piece` (rows [128 piece, 128 piece + 128) of a block) that
// lie before the block's `valid`.
__device__ __forceinline__ int piece_valid(int valid, int piece) {
  return max(0, min(DEC_PAGE_ROWS, valid - piece * DEC_PAGE_ROWS));
}

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

// Block j of (b, h) is page table[b, j] of a (P, page, KVH, D) pool of
// raw values or 8-bit codes (with per-(page, kv-head) sidecars).
template <typename T, int D>
struct PagedBlocks {
  using Elem = T;
  static constexpr int kMaxBlock = DEC_PAGE_ROWS;
  static constexpr int kD = D;
  const T* k;
  const T* v;
  SidecarPtrs sc;        // 8-bit pools only
  const int* table;      // (B, max_blocks)
  int block, max_blocks, kv_heads;

  __device__ int length(int b, const int* kv_len) const { return kv_len[b]; }
  __device__ int count(int L) const {
    return L > 0 ? min(max_blocks, (L + block - 1) / block) : 0;
  }
  __device__ int page_id(int b, int j) const {
    return table[(size_t)b * max_blocks + j];
  }
  // element offset of the block's first row, and the row stride
  __device__ size_t offset(int b, int h, int j) const {
    return ((size_t)page_id(b, j) * block * kv_heads + h) * D;
  }
  __device__ long long row_stride() const { return (long long)kv_heads * D; }
};

// Block j of (b, h) is rows [j * block, (j + 1) * block) of a (B, KVH, S2,
// D) cache read through the element strides sb, sh, ss (raw values only).
template <typename T, int D>
struct StridedBlocks {
  using Elem = T;
  static constexpr int kMaxBlock = DEC_MAX_BLOCK;
  static constexpr int kD = D;
  const T* k;
  const T* v;
  long long sb, sh, ss;
  int block, max_blocks, s2;

  __device__ int length(int b, const int* kv_len) const {
    return max(0, min(kv_len[b], s2));
  }
  __device__ int count(int L) const { return (L + block - 1) / block; }
  __device__ size_t offset(int b, int h, int j) const {
    return (size_t)(b * sb + h * sh + (long long)j * block * ss);
  }
  __device__ long long row_stride() const { return ss; }
};

// Start the copy of `valid` K and V rows of live block j of (b, h), from
// its row `row0` on (and, for 8-bit pools, its page's sidecars) into `st`.
template <typename Blocks>
__device__ __forceinline__ void issue_block(
    PageStage<typename Blocks::Elem, Blocks::kD>& st, const Blocks& A, int b,
    int h, int j, int row0, int valid) {
  using T = typename Blocks::Elem;
  constexpr int D = Blocks::kD;                  // also the thread count
  constexpr int EPC = 16 / sizeof(T);            // elements per 16 bytes
  constexpr int CPR = D / EPC;                   // 16-byte chunks per row
  const int t = threadIdx.x;
  const long long rs = A.row_stride();
  const size_t off = A.offset(b, h, j) + (size_t)(row0 * rs);
  for (int i = t; i < valid * CPR; i += D) {
    const int r = i / CPR, c = (i % CPR) * EPC;
    cp_async16(&st.k[r][c], A.k + off + r * rs + c);
    cp_async16(&st.v[r][c], A.v + off + r * rs + c);
  }
  if constexpr (kIsCode<T>) {
    const size_t ph = (size_t)A.page_id(b, j) * A.kv_heads + h;
    // (the side is picked by a select: a runtime index into the pointer
    // arrays would copy them to local memory)
    if (t < 2 * D / 4) {
      const int side = t / (D / 4), c = (t % (D / 4)) * 4;
      const float* shift = side ? A.sc.shift[1] : A.sc.shift[0];
      cp_async16(&st.sc.shift[side][c], shift + ph * D + c);
    } else if (t < 2 * D / 4 + 2) {
      const int side = t - 2 * D / 4;
      cp_async4(&st.sc.scale[side], (side ? A.sc.scale[1] : A.sc.scale[0]) + ph);
    }
  }
  cp_async_commit();
}

// Staged piece -> rows [row0, row0 + rows) of S.k / S.v at the operand
// type OpT: raw values convert, 8-bit codes dequantize with the staged
// sidecars; rows past the piece's `valid` become zeros.
template <typename OpT, typename Smem, typename Stage>
__device__ __forceinline__ void convert_block(Smem& S, const Stage& st,
                                              int row0, int rows, int valid) {
  constexpr int C8 = Smem::kD / 8;     // 8-element segments per row
  const int t = threadIdx.x;
  const int c8 = (t % C8) * 8;
  for (int r = t / C8; r < rows; r += Smem::kThreads / C8) {
    uint4 kk = make_uint4(0u, 0u, 0u, 0u), vv = kk;
    if (r < valid) {
      kk = load_pool8<OpT>(&st.k[r][c8], 0, c8, st.sc);
      vv = load_pool8<OpT>(&st.v[r][c8], 1, c8, st.sc);
    }
    // (K rows are 2 D + 4 bytes apart: four 4-byte stores)
    const uint32_t* k2 = reinterpret_cast<const uint32_t*>(&kk);
    uint32_t* kd = reinterpret_cast<uint32_t*>(&S.k[row0 + r][c8]);
#pragma unroll
    for (int i = 0; i < 4; ++i) kd[i] = k2[i];
    *reinterpret_cast<uint4*>(&S.v[row0 + r][c8]) = vv;
  }
}

// (min blocks 1: without it ptxas keeps to ~80 registers and spills)
template <typename Blocks, int NG, typename M>
__global__ void __launch_bounds__(Blocks::kD, 1)
cluster_decode_kernel(const typename M::Op* __restrict__ q,  // (B, KVH, G, D)
                      const Blocks A,
                      const int* __restrict__ kv_len,        // (B,)
                      typename M::Op* __restrict__ out,      // (B, KVH, G, D)
                      float* __restrict__ ws_pv,     // (B, KVH, max_blocks, G, D)
                      float* __restrict__ ws_stats,  // (B, KVH, max_blocks, 3, G)
                      int kv_heads, int G, Policy P) {
  using T = typename Blocks::Elem;
  using OpT = typename M::Op;
  constexpr int D = Blocks::kD;
  constexpr int FC = D / DEC_CLUSTER;    // columns each rank folds
  static_assert(D % DEC_CLUSTER == 0, "fold mapping");
  using Smem = DecodeSmem<OpT, Blocks::kMaxBlock, D>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& S = *reinterpret_cast<Smem*>(smem_raw);
  PageStage<T, D>& st = *reinterpret_cast<PageStage<T, D>*>(
      smem_raw + dec_stage_off<OpT, Blocks::kMaxBlock, D>());
  const int rank = blockIdx.x;            // == the CTA's rank in its cluster
  const int b = blockIdx.y;
  const int h = blockIdx.z;
  const int t = threadIdx.x;
  const size_t bh = (size_t)b * kv_heads + h;
  const int block = A.block, max_blocks = A.max_blocks;

  const int L = A.length(b, kv_len);
  const int n_live = A.count(L);

  // 1. this rank's blocks to partials, the next block's first piece in
  //    flight meanwhile
  constexpr int MAX_PIECES = Blocks::kMaxBlock / DEC_PAGE_ROWS;
  if (rank < n_live) {
    issue_block(st, A, b, h, rank, 0, piece_valid(min(block, L - rank * block), 0));
    const OpT* qbh = q + bh * G * D;
    for (int g = 0; g < G; ++g) S.q[g][t] = qbh[g * D + t];
  }
  for (int j = rank; j < n_live; j += DEC_CLUSTER) {
    const int valid = min(block, L - j * block);
#pragma unroll
    for (int pc = 0; pc < MAX_PIECES; ++pc) {
      const int row0 = pc * DEC_PAGE_ROWS;
      if (row0 >= block) break;
      cp_async_wait_all();
      __syncthreads();   // the piece is staged; the previous block's math is done
      convert_block<OpT>(S, st, row0, min(DEC_PAGE_ROWS, block - row0),
                         piece_valid(valid, pc));
      __syncthreads();   // the staging buffer is free again
      const int jn = j + DEC_CLUSTER;
      if (pc + 1 < MAX_PIECES && row0 + DEC_PAGE_ROWS < block)
        issue_block(st, A, b, h, j, row0 + DEC_PAGE_ROWS, piece_valid(valid, pc + 1));
      else if (jn < n_live)
        issue_block(st, A, b, h, jn, 0, piece_valid(min(block, L - jn * block), 0));
    }
    float pv[NG];
    decode_block_partials<NG, M>(S, valid, block, G, P, pv);
    float* pvj = ws_pv + ((bh * max_blocks + j) * G) * D + t;
#pragma unroll
    for (int g = 0; g < NG; ++g)
      if (g < G) pvj[g * D] = pv[g];
    if (t < G) {
      float* sj = ws_stats + (bh * max_blocks + j) * 3 * G;
      sj[t] = S.sbar[t];
      sj[G + t] = S.m_loc[t];
      sj[2 * G + t] = S.l_loc[t];
    }
  }

  // 2. every block's partials are written
  __threadfence();
  cluster_sync_release_acquire();

  // 3. the fold of this rank's FC columns, blocks in order
  const int col = rank * FC + t % FC;
  for (int g = t / FC; g < G; g += D / FC) {
    FoldState fs = fold_state_init();
    const float* sj = ws_stats + bh * max_blocks * 3 * G + g;
    const float* pj = ws_pv + (bh * max_blocks * G + g) * D + col;
    float sbar = 0.0f, m_loc = 0.0f, l_loc = 0.0f, pv = 0.0f;
    if (n_live > 0) {
      sbar = __ldcg(sj);
      m_loc = __ldcg(sj + G);
      l_loc = __ldcg(sj + 2 * G);
      pv = __ldcg(pj);
    }
    for (int j = 0; j < n_live; ++j) {
      // the next block's partials load while this one folds
      float sbar_n = 0.0f, m_loc_n = 0.0f, l_loc_n = 0.0f, pv_n = 0.0f;
      if (j + 1 < n_live) {
        const float* sn = sj + (size_t)(j + 1) * 3 * G;
        sbar_n = __ldcg(sn);
        m_loc_n = __ldcg(sn + G);
        l_loc_n = __ldcg(sn + 2 * G);
        pv_n = __ldcg(pj + (size_t)(j + 1) * G * D);
      }
      decode_fold_step(fs, j, sbar, m_loc, l_loc, pv, P);
      sbar = sbar_n;
      m_loc = m_loc_n;
      l_loc = l_loc_n;
      pv = pv_n;
    }
    // O = acc / l at the accumulator dtype, stored at the output dtype
    out[(bh * G + g) * D + col] =
        from_float<OpT>(rnd(__fdiv_rn(fs.acc, fs.l), P.acc_half));
  }
}

template <typename Blocks, int NG, typename M>
static int launch_cluster_rows(const void* q, const Blocks& A,
                               const void* kv_len, void* out, void* workspace,
                               int batch, int kv_heads, int G, const Policy& P,
                               cudaStream_t stream) {
  using OpT = typename M::Op;
  constexpr int D = Blocks::kD;
  const size_t smem = dec_stage_off<OpT, Blocks::kMaxBlock, D>() +
                      sizeof(PageStage<typename Blocks::Elem, D>);
  auto kernel = cluster_decode_kernel<Blocks, NG, M>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(DEC_CLUSTER, batch, kv_heads);
  cfg.blockDim = dim3(D);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = DEC_CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // once per instance and device: the attribute, and a cluster that fits
  // on a GPC
  static OncePerDevice ready;
  bool* set = ready.current();
  if (!set) return (int)cudaErrorInvalidDevice;
  if (!*set) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
    *set = true;
  }
  float* ws = static_cast<float*>(workspace);
  float* ws_stats = ws + (size_t)batch * kv_heads * A.max_blocks * G * D;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const OpT*>(q), A,
      static_cast<const int*>(kv_len), static_cast<OpT*>(out), ws, ws_stats,
      kv_heads, G, P);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// One launch of the cluster kernel over the blocks A names; `workspace`
// holds batch * kv_heads * A.max_blocks * G * (D + 3) floats (the blocks'
// partials).  The row count of the register arrays is a template
// (8 or 16 rows: dec_rows), so a group of 7 carries 8; so is the policy's
// mode (`mode`: ModeId).
template <typename Blocks, typename M>
static int launch_cluster_mode(const void* q, const Blocks& A,
                               const void* kv_len, void* out, void* workspace,
                               int batch, int kv_heads, int G, const Policy& P,
                               cudaStream_t stream) {
  if (G <= dec_rows(1))
    return launch_cluster_rows<Blocks, dec_rows(1), M>(
        q, A, kv_len, out, workspace, batch, kv_heads, G, P, stream);
  return launch_cluster_rows<Blocks, DEC_MAX_G, M>(
      q, A, kv_len, out, workspace, batch, kv_heads, G, P, stream);
}

template <typename Blocks>
static int launch_cluster(const void* q, const Blocks& A, const void* kv_len,
                          void* out, void* workspace, int batch, int kv_heads,
                          int G, int mode, const Policy& P,
                          cudaStream_t stream) {
  switch (mode) {
    case MODE_F16:
      return launch_cluster_mode<Blocks, ModeF16>(
          q, A, kv_len, out, workspace, batch, kv_heads, G, P, stream);
    case MODE_F32:
      return launch_cluster_mode<Blocks, ModeF32>(
          q, A, kv_len, out, workspace, batch, kv_heads, G, P, stream);
    case MODE_BF16:
      return launch_cluster_mode<Blocks, ModeBF16>(
          q, A, kv_len, out, workspace, batch, kv_heads, G, P, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace pasa
