// PASA flash-decode with a sequence's KV blocks reduced in parallel, each
// by a CTA of its own, and folded exactly in order (sm_90a): the kernel of
// both decode ops.  DecodeBlocks addresses either the paged decode's view
// (pasa_paged_decode.cu and its pool siblings: block j is rows [j * block,
// (j + 1) * block) of a sequence's page-table view) or contiguous decode's
// strided cache (the same rows of a (B, KVH, S2, D) cache, seen as one
// page a sequence); both run the same instances (pasa_paged_decode.cuh).
//
// The F-bar recurrence of PASA is order-dependent, so the usual split-KV
// log-sum-exp combine would be a new convention.  But what a block
// contributes before the running state is read - s-bar, the local max and
// sum, and P V at the accumulator dtype (decode_block_partials) - does
// not depend on earlier blocks.  So the work of a call is its live blocks:
//   1. the grid is (KVH, B, nx); CTA z of the pair (b, h) reduces the
//      live blocks j = z, z + nx, ... to their partials and writes them to
//      a workspace in device memory (the wrapper's torch.empty).  A CTA
//      with no live block exits on entry.  nx is the table's block count
//      (max_blocks), cut to two waves of resident CTAs over the B x KVH
//      pairs: every block its own CTA at the served shapes, while a wide
//      page table (an engine's holds max_seq_len / page pages a row)
//      launches at most two waves of CTAs that exit at once;
//   2. a CTA that has written its blocks takes its pair's ticket: every
//      thread fences its stores (__threadfence), then one atomicAdd on the
//      pair's int32 counter.  The last of the pair's min(n_live, nx) CTAs
//      to arrive resets the counter to 0 and folds.  The counters are the
//      wrapper's, one buffer a (device, stream), zeroed once when it is
//      made or grown; every launch leaves them at 0, so a call adds no
//      memset and no second launch;
//   3. the fold (fold_blocks), in chunks of as many blocks as the CTA's
//      shared memory holds: the chunk's partials arrive by cp.async (P V)
//      and __ldcg (the row statistics), both from L2; threads 0 .. G - 1
//      run the row chains (row_update block after block, cnt = j, as
//      decode_fold_step and the walk call it), writing each block's
//      e_prev / e_cur to shared memory; then thread t folds column t of
//      the G rows (acc_update, the G chains interleaved) and writes O =
//      acc / l.
// Step 3 performs the floating-point operations of the sequential walk
// (decode_block_update, block after block) on the same values, so the
// result equals the walk's bit for bit; pasa_decode_walk.cu keeps the
// walk as the on-card oracle.  A row of kv_len 0 has no live block: CTA 0
// of its pairs writes the walk's 0 / 0, folding no block.
//
// Rules kept from the walk: blocks past kv_len are never read; K and V
// rows past `valid` are not loaded (both enter shared memory as zeros); a
// dead page's sidecars are never read.
//
// Blocks and pages: a block holds up to 256 rows (DEC_MAX_BLOCK, the
// reference's default).  The tile is 128 rows for blocks of up to 128 and
// 256 above (an 8-bit pool takes the 128-row tile only where every block
// lies inside one page: one staged sidecar set), and a block arrives in
// pieces of up to 128 rows that land one after another in the tile; the
// block's math then runs once over all its rows - one key mean, one s-bar
// and one set of partials per block, as the walk computes them.  The
// block is independent of the page (the reference shifts its served
// decode in blocks of block_kv over the gathered view, whatever the page
// size): a page of any size of 1 row or more, bigger or smaller than the
// block, need not divide it.  A piece inside one page reads its id once; a
// piece over several first stages the ids of the pages its rows lie in
// (one load each), then each row's address comes from its own page; an
// 8-bit piece stages the sidecar set of each of those pages (at most
// DEC_SC_SETS: a piece of an 8-bit pool with pages under 4 rows is cut to
// 32 pages' rows) and each row dequantizes with its own page's set - the
// f32 product and sum, then one rounding, of gather_pages_dequant.
//
// Shared memory: the block tile (DecodeSmem, sized by the group's row
// bucket NG = dec_rows(G): 8 or 16) and one staging piece of 128 rows.
// 2-byte values stage only K (its tile rows are padded, so K is rewritten
// into them); V lands in the tile by cp.async and converts in place.
// 8-bit codes stage K and V.  Bytes a CTA (NG 8 / 16) and CTAs an SM (228
// KB, 1 KB reserved a CTA), the same for raw values and 8-bit codes in the
// 128-row tile:
//   D 128: 106,784 / 113,184, 2 / 2; 256-row tile 176,928 / 187,424, 1,
//          8-bit (DEC_SC_SETS sets) 210,208 / 220,704, 1;
//   D 64:  56,096 / 61,472, 4 / 3; 256-row tile 93,472 / 102,944, 2, 8-bit
//          110,368 / 119,840, 2 / 1;
//   D 32:  30,752 / 35,616, 7 / 6; 256-row tile 51,744 / 60,704, 4 / 3,
//          8-bit 60,448 / 69,408, 3.
// In every policy mode (the tile holds its operands at two bytes, and fp32
// probabilities overwrite their scores).  The fold reuses the same bytes.
//
// The head width D (32, 64 or 128) is a template parameter of the
// addressing (DecodeBlocks), and through it of the block tile, the staging
// buffer and the kernel's D threads.  A staged row is D / 8 16-byte chunks
// of 2-byte values (four at D 32), D / 16 of 8-bit codes (two at D 32);
// the sidecar shifts D / 4 chunks a side.
//
// The kernel template takes the policy's mode (pasa_common.cuh Mode): q,
// the block's K and V, and the output at the operand type (fp16, or bf16
// under bf16_fp32), scores at fp16 or fp32; the pool or cache elements
// are converted to the operand type as they leave the staging buffer (V
// in place).
#pragma once

#include <algorithm>

#include "pasa_decode_block.cuh"

namespace pasa {

// sidecar sets a staged piece of an 8-bit pool holds: one per page its
// rows touch, so a piece holds at most (DEC_SC_SETS - 1) pages' rows
constexpr int DEC_SC_SETS = 33;

// A staged page's sidecar set, 16-byte aligned in an array of them.
template <int D>
struct alignas(16) SidecarSet : PageSidecars<D> {};

// V rows of a staged piece: 8-bit codes only (2-byte values go straight
// to the tile).
template <typename T, int D, bool CODES>
struct StagedV {
  T v[DEC_PAGE_ROWS][D];
};
template <typename T, int D>
struct StagedV<T, D, false> {};

// One piece of a block (up to 128 rows) of head width D as it arrives
// from device memory, before conversion to the operand type: the ids of
// the pages its rows lie in (132 ints, so that the rows behind them stay
// 16-byte aligned for cp.async), its K rows (and V rows of codes), and
// the sidecar sets of the SETS pages they may lie in (8-bit pools only;
// one set: the piece lies inside one page).
template <typename T, int D, int SETS>
struct alignas(16) PageStage : StagedV<T, D, kIsCode<T>> {
  using Elem = T;
  static constexpr int kSets = SETS;
  int pid[DEC_PAGE_ROWS + 4];
  T k[DEC_PAGE_ROWS][D];
  std::conditional_t<(SETS > 1), SidecarSet<D>[SETS], PageSidecars<D>[1]> sc;
};

template <typename Blocks>
using StageOf = PageStage<typename Blocks::Elem, Blocks::kD, Blocks::kSets>;

// Byte offset of the staging buffer behind a block tile of MAXB rows.
template <typename OpT, int MAXB, int D, int NG>
__host__ __device__ constexpr size_t dec_stage_off() {
  return (sizeof(DecodeSmem<OpT, MAXB, D, NG>) + 127) / 128 * 128;
}

// Dynamic shared memory of an instance: the tile, then the staging piece.
template <typename Blocks, typename OpT, int NG>
__host__ __device__ constexpr size_t dec_smem_bytes() {
  return dec_stage_off<OpT, Blocks::kMaxBlock, Blocks::kD, NG>() +
         sizeof(StageOf<Blocks>);
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

// Block j of (b, h) is rows [j * block, (j + 1) * block) of sequence b's
// view: view row r is row r % page of page p = r / page, whose id is
// table[b, p] (a page-table view of a (P, page, KVH, D) pool of raw values
// or 8-bit codes with per-(page, kv-head) sidecars), or b where there is
// no table (a contiguous cache: one page of s2 rows a sequence).  Element
// c of row r of page id p, kv-head h is at p * ps + r * rs + h * hs + c.  A
// block may span pages, share a page with its neighbours or start inside
// one.
template <typename T, int D>
struct DecodeView {
  const T* k;
  const T* v;
  SidecarPtrs sc;        // 8-bit pools only
  const int* table;      // (B, max_pages), or null: page b is sequence b
  long long ps, rs, hs;  // element strides of a page, a row, a kv-head
  int block, max_blocks, page, max_pages, kv_heads;

  // the view holds max_pages * page rows
  __device__ int length(int b, const int* kv_len) const {
    return max(0, min(kv_len[b], max_pages * page));
  }
  __device__ int count(int L) const { return (L + block - 1) / block; }
  __device__ int page_id(int b, int p) const {
    return table ? table[(size_t)b * max_pages + p] : b;
  }
};

// The view as a kernel instance reads it: in a tile of MAXB rows (128, or
// 256 for wider blocks).
template <typename T, int D, int MAXB>
struct DecodeBlocks : DecodeView<T, D> {
  using Elem = T;
  static constexpr int kMaxBlock = MAXB;
  // an 8-bit piece's sidecar sets: in the 128-row tile one (the launcher
  // sends an 8-bit pool there only when every block lies inside one
  // page), in the 256-row tile DEC_SC_SETS
  static constexpr int kSets =
      kIsCode<T> && MAXB > DEC_PAGE_ROWS ? DEC_SC_SETS : 1;
  // the fewest rows of a piece (piece_rows at 1-row pages)
  static constexpr int kMinPiece = kSets > 1 ? kSets - 1 : DEC_PAGE_ROWS;
  static constexpr int kD = D;

  // rows of a staged piece: 128, or for 8-bit pools no more than keep the
  // pages the piece touches within DEC_SC_SETS
  __device__ int piece_rows() const {
    return kSets > 1 ? min(DEC_PAGE_ROWS, (kSets - 1) * this->page)
                     : DEC_PAGE_ROWS;
  }
};

// Start the copy of the `valid` K and V rows of live block j of (b, h)
// from its row `row0` on (and, for 8-bit pools, their pages' sidecars):
// K (and the codes' V) into `st`, 2-byte V into rows row0 .. of the
// tile's S.v.  A piece over several pages stages their ids first: every
// thread calls this (it synchronizes the CTA).
template <typename Blocks, typename Smem>
__device__ __forceinline__ void issue_block(StageOf<Blocks>& st, Smem& S,
                                            const Blocks& A, int b, int h,
                                            int j, int row0, int valid) {
  using T = typename Blocks::Elem;
  constexpr int D = Blocks::kD;                  // also the thread count
  constexpr int EPC = 16 / sizeof(T);            // elements per 16 bytes
  constexpr int CPR = D / EPC;                   // 16-byte chunks per row
  constexpr int RPI = D / CPR;                   // rows per pass of D threads
  const int t = threadIdx.x;
  const int c = (t % CPR) * EPC;
  // the destination of V row r's chunk (2-byte values: the tile, whose
  // elements have the pool's size)
  auto vdst = [&](int r) -> void* {
    if constexpr (kIsCode<T>) return &st.v[r][c];
    else return &S.v[row0 + r][c];
  };
  // the piece's view rows r0 .. r0 + valid - 1 lie in pages p0 .. p0 + np
  // - 1 of the row's table, from row `off` of page p0 on
  const int r0 = j * A.block + row0;
  const int p0 = r0 / A.page, off = r0 - p0 * A.page;
  const int np = valid > 0 ? (off + valid - 1) / A.page + 1 : 0;
  const size_t hc = (size_t)h * A.hs + c;
  // a piece inside one page: every thread reads its id (one cached load)
  // and the rows follow at one stride; over several pages their ids are
  // staged first (np is the same in every thread)
  const int pid0 = np == 1 ? A.page_id(b, p0) : 0;
  if (np == 1) {
    const size_t base = (size_t)pid0 * A.ps + (size_t)off * A.rs + hc;
    for (int i = t; i < valid * CPR; i += D) {
      const int r = i / CPR;
      cp_async16(&st.k[r][c], A.k + base + (size_t)r * A.rs);
      cp_async16(vdst(r), A.v + base + (size_t)r * A.rs);
    }
  } else if (np > 1) {
    for (int i = t; i < np; i += D) st.pid[i] = A.page_id(b, p0 + i);
    __syncthreads();
    int r = t / CPR;
    int s = (off + r) / A.page;                // the row's page (set)
    int pr = off + r - s * A.page;             // its row in that page
    for (; r < valid; r += RPI) {
      const size_t src = (size_t)st.pid[s] * A.ps + (size_t)pr * A.rs + hc;
      cp_async16(&st.k[r][c], A.k + src);
      cp_async16(vdst(r), A.v + src);
      for (pr += RPI; pr >= A.page; pr -= A.page) ++s;
    }
  }
  if constexpr (kIsCode<T>) {
    // each page's set: D / 4 16-byte shift chunks a side, two scales (the
    // side is picked by a select: a runtime index into the pointer arrays
    // would copy them to local memory)
    constexpr int PER = 2 * D / 4 + 2;
    for (int i = t; i < np * PER; i += D) {
      const int set = i / PER, u = i - set * PER;
      const int id = np == 1 ? pid0 : st.pid[set];
      const size_t ph = (size_t)id * A.kv_heads + h;
      if (u < 2 * D / 4) {
        const int side = u / (D / 4), cc = (u % (D / 4)) * 4;
        const float* shift = side ? A.sc.shift[1] : A.sc.shift[0];
        cp_async16(&st.sc[set].shift[side][cc], shift + ph * D + cc);
      } else {
        const int side = u - 2 * D / 4;
        cp_async4(&st.sc[set].scale[side],
                  (side ? A.sc.scale[1] : A.sc.scale[0]) + ph);
      }
    }
  }
  cp_async_commit();
}

// Staged piece -> rows [row0, row0 + rows) of S.k / S.v at the operand
// type OpT: raw K converts into the tile's padded rows and raw V converts
// in place, 8-bit codes dequantize with the sidecar set of their page (the
// piece's first row is row `off` of its first page); rows past the
// piece's `valid` become zeros.
template <typename OpT, typename Smem, typename Stage>
__device__ __forceinline__ void convert_block(Smem& S, const Stage& st,
                                              int row0, int rows, int valid,
                                              int off, int page) {
  using T = typename Stage::Elem;
  constexpr int C8 = Smem::kD / 8;     // 8-element segments per row
  constexpr bool SETS = Stage::kSets > 1;    // the piece may span pages
  constexpr bool SAME = std::is_same<T, OpT>::value;
  const int t = threadIdx.x;
  const int c8 = (t % C8) * 8;
  for (int r = t / C8; r < rows; r += Smem::kThreads / C8) {
    uint4 kk = make_uint4(0u, 0u, 0u, 0u), vv = kk;
    uint4* vd = reinterpret_cast<uint4*>(&S.v[row0 + r][c8]);
    if (r < valid) {
      const auto& sc = st.sc[SETS ? (off + r) / page : 0];
      kk = load_pool8<OpT>(&st.k[r][c8], 0, c8, sc);
      if constexpr (kIsCode<T>)
        vv = load_pool8<OpT>(&st.v[r][c8], 1, c8, sc);
      else if constexpr (!SAME)
        vv = load8_op<OpT>(reinterpret_cast<const T*>(vd));
    }
    // (K rows are 2 D + 4 bytes apart: four 4-byte stores)
    const uint32_t* k2 = reinterpret_cast<const uint32_t*>(&kk);
    uint32_t* kd = reinterpret_cast<uint32_t*>(&S.k[row0 + r][c8]);
#pragma unroll
    for (int i = 0; i < 4; ++i) kd[i] = k2[i];
    if (kIsCode<T> || !SAME || r >= valid) *vd = vv;
  }
}

// The fold of a pair's n_live blocks, in block order, by one CTA of D
// threads with `bytes` of shared memory at `smem` (free: the CTA's own
// blocks are done): the partials at pv_g (n_live, G, D) and st_g (n_live,
// 3, G) of the workspace; O (G, D) to `out`.  n_live 0 writes the walk's
// acc / l of no block.
template <int NG, int D, typename OpT>
__device__ __forceinline__ void fold_blocks(unsigned char* smem, int bytes,
                                            const float* pv_g,
                                            const float* st_g, int n_live,
                                            int G, OpT* out,
                                            const Policy& P) {
  const int t = threadIdx.x;
  // a chunk: P V (CH, G, D), the statistics (CH, 3, G), e_prev / e_cur
  // (CH, 2, G); then l (G)
  const int CH = (bytes / 4 - G) / (G * D + 5 * G);
  float* pv_s = reinterpret_cast<float*>(smem);
  float* st_s = pv_s + CH * G * D;
  float* e_s = st_s + CH * 3 * G;
  float* l_s = e_s + CH * 2 * G;
  float m = NEG_BIG, l = 0.0f, f = 0.0f;    // row t's state (t < G)
  float acc[NG];
#pragma unroll
  for (int g = 0; g < NG; ++g) acc[g] = 0.0f;
  for (int j0 = 0; j0 < n_live; j0 += CH) {
    const int nj = min(CH, n_live - j0);
    const float* pv_c = pv_g + (size_t)j0 * G * D;
    for (int i = 4 * t; i < nj * G * D; i += 4 * D)
      cp_async16(pv_s + i, pv_c + i);
    cp_async_commit();
    const float* st_c = st_g + (size_t)j0 * 3 * G;
    for (int i = t; i < nj * 3 * G; i += D) st_s[i] = __ldcg(st_c + i);
    __syncthreads();
    // the row chains while P V arrives
    if (t < G) {
      for (int jj = 0; jj < nj; ++jj) {
        const float* s = st_s + jj * 3 * G + t;
        const RowStep r = row_update(m, l, f, j0 + jj, s[0], s[G], s[2 * G], P);
        e_s[jj * 2 * G + t] = r.e_prev;
        e_s[jj * 2 * G + G + t] = r.e_cur;
        m = r.m;
        l = r.l;
        f = r.f;
      }
    }
    cp_async_wait_all();
    __syncthreads();
    // column t of the G rows: G independent chains
    for (int jj = 0; jj < nj; ++jj) {
      const float* e = e_s + jj * 2 * G;
      const float* p = pv_s + jj * G * D + t;
#pragma unroll
      for (int g = 0; g < NG; ++g)
        if (g < G)
          acc[g] = acc_update(acc[g], p[g * D], e[g], e[G + g], P.acc_half);
    }
    __syncthreads();   // before the next chunk lands on these bytes
  }
  if (t < G) l_s[t] = l;
  __syncthreads();
  // O = acc / l at the accumulator dtype, stored at the output dtype
#pragma unroll
  for (int g = 0; g < NG; ++g)
    if (g < G)
      out[g * D + t] =
          from_float<OpT>(rnd(__fdiv_rn(acc[g], l_s[g]), P.acc_half));
}

// (min blocks 1: without it ptxas keeps to ~80 registers and spills; the
// occupancy is set by the shared memory, note above)
template <typename Blocks, int NG, typename M>
__global__ void __launch_bounds__(Blocks::kD, 1)
split_decode_kernel(const typename M::Op* __restrict__ q,  // (B, KVH, G, D)
                    const Blocks A,
                    const int* __restrict__ kv_len,         // (B,)
                    typename M::Op* __restrict__ out,       // (B, KVH, G, D)
                    float* __restrict__ ws_pv,    // (B, KVH, max_blocks, G, D)
                    float* __restrict__ ws_stats, // (B, KVH, max_blocks, 3, G)
                    int* __restrict__ tickets,    // (B * KVH,), 0 on entry
                    int kv_heads, int G, Policy P) {
  using OpT = typename M::Op;
  constexpr int D = Blocks::kD;
  using Smem = DecodeSmem<OpT, Blocks::kMaxBlock, D, NG>;
  constexpr int kBytes = (int)dec_smem_bytes<Blocks, OpT, NG>();
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ int last;
  Smem& S = *reinterpret_cast<Smem*>(smem_raw);
  StageOf<Blocks>& st = *reinterpret_cast<StageOf<Blocks>*>(
      smem_raw + dec_stage_off<OpT, Blocks::kMaxBlock, D, NG>());
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int z = blockIdx.z;
  const int nx = gridDim.z;
  const int t = threadIdx.x;
  const size_t bh = (size_t)b * kv_heads + h;
  const int block = A.block, max_blocks = A.max_blocks;
  float* pv_bh = ws_pv + bh * max_blocks * G * D;
  float* st_bh = ws_stats + bh * max_blocks * 3 * G;

  const int L = A.length(b, kv_len);
  const int n_live = A.count(L);
  if (n_live == 0) {
    if (z == 0)
      fold_blocks<NG, D>(smem_raw, kBytes, pv_bh, st_bh, 0, G,
                         out + bh * G * D, P);
    return;
  }
  if (z >= n_live) return;
  const int PR = A.piece_rows();

  // 1. this CTA's blocks to partials
  constexpr int MAX_PIECES = Blocks::kMaxBlock / Blocks::kMinPiece;
  // the 256-row tile compiles rolled (build time; blocks of up to 128 run
  // the 128-row tile)
  constexpr bool kUnroll = Blocks::kMaxBlock <= DEC_PAGE_ROWS;
  for (int j = z; j < n_live; j += nx) {
    const int valid = min(block, L - j * block);
    if (j != z) __syncthreads();   // the previous block's math is done
    issue_block(st, S, A, b, h, j, 0, min(PR, valid));
    if (j == z) {
      const OpT* qbh = q + bh * G * D;
      for (int g = 0; g < G; ++g) S.q[g][t] = qbh[g * D + t];
    }
#pragma unroll (kUnroll && MAX_PIECES <= 2 ? MAX_PIECES : 1)
    for (int pc = 0; pc < MAX_PIECES; ++pc) {
      const int row0 = pc * PR;
      if (row0 >= block) break;
      cp_async_wait_all();
      __syncthreads();   // the piece is staged
      const int r0 = j * block + row0;
      convert_block<OpT>(S, st, row0, min(PR, block - row0),
                         max(0, min(PR, valid - row0)), r0 % A.page, A.page);
      __syncthreads();   // the staging buffer is free again
      if (row0 + PR < block)
        issue_block(st, S, A, b, h, j, row0 + PR,
                    max(0, min(PR, valid - row0 - PR)));
    }
    float pv[NG];
    decode_block_partials<NG, M, kUnroll>(S, valid, block, G, P, pv);
    float* pvj = pv_bh + (size_t)j * G * D + t;
#pragma unroll
    for (int g = 0; g < NG; ++g)
      if (g < G) pvj[g * D] = pv[g];
    if (t < G) {
      float* sj = st_bh + (size_t)j * 3 * G;
      sj[t] = S.sbar[t];
      sj[G + t] = S.m_loc[t];
      sj[2 * G + t] = S.l_loc[t];
    }
  }

  // 2. the pair's ticket: the last CTA to arrive folds
  __threadfence();
  __syncthreads();
  if (t == 0) last = atomicAdd(&tickets[bh], 1) == min(n_live, nx) - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (t == 0) tickets[bh] = 0;

  // 3. the fold of every block, in order
  fold_blocks<NG, D>(smem_raw, kBytes, pv_bh, st_bh, n_live, G,
                     out + bh * G * D, P);
}

// One decode call beside its blocks: the tensors, the shape and the
// policy; with `query` set, a question about the instance the call would
// launch ({shared-memory bytes, CTAs an SM}), and nothing is launched.
struct DecodeCall {
  const void* q;
  const void* kv_len;
  void* out;
  void* workspace;   // batch * kv_heads * max_blocks * G * (D + 3) floats
  int* tickets;      // batch * kv_heads int32, 0 between calls on `stream`
  int batch, kv_heads, G, mode;
  Policy P;
  cudaStream_t stream;
  int* query;
};

// An instance's resident CTAs on each card, found at its first launch
// there (when its shared-memory attributes are set): 0 until then.
struct DeviceSlots {
  int per_sm[MAX_DEVICES] = {};
  int sms[MAX_DEVICES] = {};
};

template <typename Blocks, int NG, typename M>
static int launch_rows(const Blocks& A, const DecodeCall& c) {
  using OpT = typename M::Op;
  constexpr int D = Blocks::kD;
  constexpr size_t smem = dec_smem_bytes<Blocks, OpT, NG>();
  auto kernel = split_decode_kernel<Blocks, NG, M>;
  static DeviceSlots slots;
  int dev = -1;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_DEVICES)
    return (int)cudaErrorInvalidDevice;
  if (!slots.per_sm[dev]) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
    int per_sm = 0, sms = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, D,
                                                          smem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    slots.sms[dev] = sms;
    slots.per_sm[dev] = per_sm;
  }
  if (c.query) {
    c.query[0] = (int)smem;
    c.query[1] = slots.per_sm[dev];
    return 0;
  }
  // CTAs a pair: every block its own, up to two waves over the pairs
  const long long pairs = (long long)c.batch * c.kv_heads;
  const long long waves = 2LL * slots.per_sm[dev] * slots.sms[dev];
  const int nx = (int)std::max(
      1LL, std::min((long long)A.max_blocks, (waves + pairs - 1) / pairs));
  float* ws = static_cast<float*>(c.workspace);
  float* ws_stats = ws + (size_t)c.batch * c.kv_heads * A.max_blocks * c.G * D;
  kernel<<<dim3(c.kv_heads, c.batch, nx), D, smem, c.stream>>>(
      static_cast<const OpT*>(c.q), A, static_cast<const int*>(c.kv_len),
      static_cast<OpT*>(c.out), ws, ws_stats, c.tickets, c.kv_heads, c.G,
      c.P);
  return (int)cudaGetLastError();
}

// One launch over the blocks A names.  The row count of the register and
// shared arrays is a template (8 or 16 rows: dec_rows), so a group of 7
// carries 8; so is the policy's mode (c.mode: ModeId).
template <typename Blocks, typename M>
static int launch_mode(const Blocks& A, const DecodeCall& c) {
  if (c.G <= dec_rows(1)) return launch_rows<Blocks, dec_rows(1), M>(A, c);
  return launch_rows<Blocks, DEC_MAX_G, M>(A, c);
}

template <typename Blocks>
static int launch_decode(const Blocks& A, const DecodeCall& c) {
  switch (c.mode) {
    case MODE_F16: return launch_mode<Blocks, ModeF16>(A, c);
    case MODE_F32: return launch_mode<Blocks, ModeF32>(A, c);
    case MODE_BF16: return launch_mode<Blocks, ModeBF16>(A, c);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace pasa
