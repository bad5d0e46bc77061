// The pass 1 of K1's bf16 and f32, K2's int8 and K3's packed int4 row
// stores, built for Hopper: the scores by TMA and wgmma, the selection by
// append buffers that are sorted and merged only when they fill. The
// split-N plan, the candidate layout and pass 2 are topk_common.cuh's; the
// PTX wrappers hopper.cuh's. One kernel, templated on a tile policy (below)
// for what the four stores do differently.
//
// Block (query block of QB, slice), 384 threads: warpgroup 2 produces,
// warpgroups 0 and 1 consume.
//   * The producer's first thread walks the slice's row tiles of 128 rows
//     and, in each, the row's 128-byte chunks (64 bf16 columns, 32 f32
//     columns, 128 int8 columns, or 128 bytes of int4 nibble pairs): a
//     stage of the ring holds one chunk of the tile's rows (16 KB) and the
//     query block's columns that meet it (the policy's planes of QB x 128
//     bytes), all loaded by TMA into 128-byte swizzled tiles that complete
//     on the stage's "full" mbarrier. TMA zero-fills rows past N, queries
//     past b and columns past the row. Shared memory does not grow with D:
//     the query block is never staged whole, its chunk is read again from
//     L2 for every row tile.
//   * Consumer w scores all 128 rows of a stage against its own half of
//     the query block (queries w QB/2 .. + QB/2 - 1; at QB = 8 both take the
//     8 queries and each keeps 4) by wgmma m64nN, N = max(8, QB/2), the two
//     64-row tiles against that half, K-major, sums in registers, one
//     group of products in flight while the next is issued. Every consumer
//     thread arrives on the stage's "empty" mbarrier once its products have
//     read it; no block barrier runs after the start. setmaxnreg hands the
//     producer's registers to them.
//   * Each consumer keeps its own queries' lists and syncs only its own
//     four warps (a named barrier), so while one checks and merges, the
//     other's products run, as far ahead as the ring's stages reach (a
//     stage is freed when both have read it).
//   * Split rows (K1's f32 and K3 at QB = 8, the policy's kSplit): both
//     consumers would compute the same 8 queries' products, so instead
//     consumer w takes the slice's row tiles w, w + 2, ..., all 8 queries
//     each, in lists of its own (a stage is freed by the one consumer that
//     reads it; each has its own "full" barrier a stage); a slice writes two
//     candidate lists a query (wg_candidate_lists) and pass 2 merges them
//     all. Rows still reach each list in ascending position, so the
//     selection's rules hold.
//
// Tile policies (the `Tile` argument of topk_pass1_wgmma), what the stores
// do differently:
//   using Acc = float or int;        the sums' type
//   kPlanes                          query planes of 128 bytes a query in a
//                                    stage (int4: the lo and the hi columns;
//                                    f32: its TF32 hi and lo parts)
//   kChunkCols                       elements in a row's 128-byte chunk
//   kFactors                         a (scale, offset) a query, staged in
//                                    shared memory at the start
//   kSplit, kCapMax                  split rows at QB = 8 (below); the
//                                    longest append buffer
//   chunks(d)                        a row's chunks at logical width d
//   maps(...)                        the TMA maps of rows and query (host)
//   query_box(c, q0)                 the query map's coordinates of chunk
//                                    c's planes for the block's queries
//   struct Regs                      registers the products read after
//                                    they are issued (register A
//                                    fragments), and their fence()
//   chunk<N>(acc, regs, stage, qb, bcol0, c, settle, release)
//                                    one stage's products: issues them,
//                                    keeps at most one group in flight,
//                                    calls settle() after each wait and,
//                                    for c > 0, release() once the stage
//                                    before is no longer read
//   factor(qi, b), row_factors(xs, row, valid_end)
//                                    the per-query and per-row factors
//                                    (the thread's rows row + 64 rt + 8 h)
//   score(v, f, xs), value(v)        a sum's entry becomes its score (in
//                                    place, as bits), read as a float
// K1 (WgBf16): 4 k16 steps of bf16 wgmma a chunk, both operands from the
// stage; the sum is the score. K2 (WgInt<false>): 4 k32 steps of
// s8 x s8, both from the stage. K3 (WgInt<true>): the query staged in
// two planes, chunk j's lo columns (j 128 ..) and its hi columns (D/2 +
// j 128 ..), zero past D/2 in each; each k32 step's A fragment ldmatrix'd
// from the swizzled stage and split in registers into lo + 8 (w &
// 0x0F0F0F0F) and hi + 8 (((w >> 4) & 0x0F0F0F0F) ^ 0x08080808), u8 in
// [0, 15], against the two planes by u8 x s8 wgmma with A in registers
// (two register buffers, one k32 step a group); a zero byte past the row
// unpacks to 0 and 8 and meets a zero query column. K2/K3's score is
// float(sum - offset) * q_scale * x_scale[row], in that order, as the
// plain version forms it (offset 8 sum(q) for K3, 0 for K2), so the
// scores are equal bit for bit; it is formed in the registers after the
// tile's last chunk, and x_scale of the thread's four rows is loaded at
// the tile's start. K1's f32 store (WgF32): split TF32, below.
//
// Selection. A list of k (score, position) per query, best first, and its
// threshold (the k-th score, -inf while the list is short) in shared
// memory; an append buffer of cap entries per query. After a tile's last
// chunk every accumulator entry is compared with its query's threshold
// where it lies in the registers (rows of this tile lie past every row in
// the list, so only a greater score beats the k-th). A passing entry takes
// a slot from its buffer's count (a shared-memory atomic) and is written
// there if the slot lies in the buffer; nothing is sorted per candidate,
// unlike warp_insert. If an entry of the consumer found its buffer full,
// a round follows: every buffer of the consumer more than half full is
// merged (below; the buffers dealt to its four warps in turn, and the
// ones not yet full taken along, which spares later rounds), their counts
// restart, and the entries left over take slots again, until all are
// placed. A tile with no overflow costs one barrier. The threshold rises
// only at a merge. At the slice's end every non-empty buffer is merged
// and the lists are written out as the slice's candidates.
//
// A merge is one warp's: the entries that still beat the list's k-th are
// compacted, sorted best first by a bitonic network in registers (32 x E
// entries, E = 1 to 8: shuffles within a lane's column, swaps across its
// registers), and merged into the list in one pass: an entry's rank in the
// union is its index plus the count of better entries in the other sorted
// list (binary search), every list entry moves up or drops out, highest
// group first (its count of better buffer entries searched among the
// buffer entries' own counts of better list entries, which do not fall).
// Positions are unique, so the ranks are a permutation; fillers are (-inf,
// -1). Integer sums tie exactly and often (copies of a row); the order is
// (score, position) throughout, so ties go to the lowest position.
//
// Everything here has internal linkage.

#pragma once

#include <cuda_bf16.h>

#include <algorithm>
#include <mutex>
#include <type_traits>

#include "hopper.cuh"
#include "topk_common.cuh"

namespace {

constexpr int kWgConsumers = 2;                  // consumer warpgroups
constexpr int kWgThreads = (kWgConsumers + 1) * 128;
constexpr int kWgRows = 128;                     // store rows a stage
constexpr int kWgRowBytes = kWgRows * 128;       // a stage's rows, 16 KB
constexpr int kWgCapMax = 256;                   // longest append buffer
constexpr size_t kWgSmemLimit = 232448;          // a Hopper block's

// The lists a block keeps for a query block of qb: one a query, or two
// when the consumers split the row tiles (`split`, at qb = 8; see the
// header).
__host__ __device__ constexpr int wg_lists(int qb, bool split) {
  return split && qb == 8 ? 2 * qb : qb;
}

// Where pass 1's shared memory goes for a query block of qb, lists of k,
// `stages` ring stages and buffers of `cap` entries a list, with `planes`
// planes of query a stage, if `factors` a (scale, offset) a query, and
// wg_lists(qb, split) lists: the ring (1,024-aligned stages: rows, then the
// query planes), the lists [lists][k] (scores, then positions), the
// buffers [lists][cap] (the same), thresholds [lists], buffer counts
// [lists], the factors [qb], a landing place for entries not written (32
// f32 + 32 int32) and the mbarriers (a "full" one a stage, a consumer's own
// when they split the rows, and an "empty" one); total counts 1,024 for
// the alignment.
struct WgLayout {
  int stages, cap;
  size_t stage, lists, bufs, thr, cnt, fac, trash, bars, total;
};

__host__ __device__ inline WgLayout wg_offsets(int qb, int k, int stages,
                                               int cap, int planes,
                                               bool factors, bool split) {
  const size_t nl = wg_lists(qb, split);
  WgLayout o;
  o.stages = stages;
  o.cap = cap;
  o.stage = kWgRowBytes + (size_t)planes * qb * 128;
  o.lists = o.stage * stages;
  o.bufs = o.lists + 8 * nl * k;
  o.thr = o.bufs + 8 * nl * cap;
  o.cnt = o.thr + 4 * nl;
  o.fac = o.cnt + 4 * nl;
  o.trash = o.fac + (factors ? 8 * (size_t)qb : 0);
  o.bars = o.trash + 256;
  o.total = o.bars + 8 * (nl / qb + 1) * (size_t)stages + 1024;
  return o;
}

// The ring's stages and the buffers' entries: a ring of 8 or 6 stages
// with buffers of the policy's longest, cap_max (K1 256, K2/K3 64), where
// the query block is narrow (B = 1: every stage in flight is bandwidth),
// else 4 stages with the longest buffer of at least 64 that fits (a
// multiple of 16, at most cap_max), else 3 stages with one of at least
// 32. stages = 0 if none fits (the wrapper's plan takes a narrower query
// block).
inline WgLayout wg_layout(int qb, int k, int planes, bool factors,
                          bool split, int cap_max) {
  const int plans[][2] = {{8, cap_max}, {6, cap_max}, {4, 64}, {3, 32}};
  const size_t nl = wg_lists(qb, split);
  for (const auto& p : plans) {
    const WgLayout none =
        wg_offsets(qb, k, p[0], 0, planes, factors, split);
    if (none.total > kWgSmemLimit) continue;
    const int cap = (int)std::min<size_t>(
        cap_max, (kWgSmemLimit - none.total) / (8 * nl) / 16 * 16);
    if (cap >= p[1])
      return wg_offsets(qb, k, p[0], cap, planes, factors, split);
  }
  WgLayout none = wg_offsets(qb, k, 0, 0, planes, factors, split);
  none.total = ~(size_t)0 >> 2;
  return none;
}

// num_lists: the candidate lists a query gets, num_slices times the lists
// of a slice (two when the consumers split the row tiles)
struct WgArgs {
  const int8_t* mask;
  float* cand_s;
  int* cand_i;
  int n, nchunks, b, k, num_valid, rows_per_slice, num_slices, num_lists,
      stages, cap;
};

struct WgFactor {   // a query's factors in K2/K3's score
  float scale;
  int off;
};

// Sorts the warp's 32 E entries, entry 32 e + lane in s[e] / p[e], best
// first: a bitonic network, shuffles across lanes for strides under 32 and
// swaps between a lane's registers above.
template <int E>
__device__ __forceinline__ void wg_sort(float (&s)[E], int (&p)[E],
                                        int lane) {
#pragma unroll
  for (int size = 2; size <= 32 * E; size <<= 1)
#pragma unroll
    for (int j = size >> 1; j > 0; j >>= 1) {
      if (j >= 32) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int o = e + j / 32;
          if ((e & (j / 32)) != 0 || o >= E) continue;
          // a run whose bit `size` is clear ends best first
          const bool desc = ((32 * e) & size) == 0;
          const bool swap = desc ? better(s[o], p[o], s[e], p[e])
                                 : better(s[e], p[e], s[o], p[o]);
          const float a = s[e];
          const int pa = p[e];
          s[e] = swap ? s[o] : s[e];
          p[e] = swap ? p[o] : p[e];
          s[o] = swap ? a : s[o];
          p[o] = swap ? pa : p[o];
        }
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float os = __shfl_xor_sync(kFull, s[e], j);
          const int op = __shfl_xor_sync(kFull, p[e], j);
          // the lower lane of a pair keeps the better one in a run that
          // ends best first
          const bool keep_better =
              ((lane & j) == 0) == (((32 * e + lane) & size) == 0);
          if (keep_better != better(s[e], p[e], os, op)) {
            s[e] = os;
            p[e] = op;
          }
        }
      }
    }
}

// The nv entries of bs/bp (compacted, each better than the list's k-th)
// sorted in registers (32 E >= nv) and merged into the sorted list ls/li
// of k, by one warp; bp is scratch afterwards.
template <int E>
__device__ void wg_merge_sorted(float* ls, int* li, int k, float* bs,
                                int* bp, int nv, int lane) {
  float s[E];
  int p[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = 32 * e + lane;
    s[e] = i < nv ? bs[i] : neg_inf();
    p[e] = i < nv ? bp[i] : -1;
  }
  wg_sort<E>(s, p, lane);
  __syncwarp();
  // entry j of the sorted buffer has b_j = count_better(list, entry j)
  // list entries before it, so its rank in the union is j + b_j; b_j does
  // not fall with j, and list entry i has the entries with b_j <= i before
  // it: its rank is i plus their count, found in the b_j (kept in bp)
  int rb[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = 32 * e + lane;
    const int b = i < nv ? count_better(ls, li, k, s[e], p[e]) : k;
    // the fillers past nv stay out of bp: 32 E may pass the buffer's end
    if (i < nv) bp[i] = b;
    rb[e] = i < nv ? i + b : k;
  }
  __syncwarp();
  // list entries before the best buffer entry's rank stay where they are;
  // the rest move up, a group of 32 at a time from the highest, each group
  // read before it is written
  const int start = __shfl_sync(kFull, rb[0], 0);
  for (int base = ((k - 1) / 32) * 32; base >= start - 31 && base >= 0;
       base -= 32) {
    const int i = base + lane;
    float vs = 0.f;
    int vi = 0, r = k;
    if (i >= start && i < k) {
      vs = ls[i];
      vi = li[i];
      int lo = 0, hi = nv;          // the b_j <= i
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (bp[mid] <= i)
          lo = mid + 1;
        else
          hi = mid;
      }
      r = i + lo;
    }
    __syncwarp();
    if (r < k) {
      ls[r] = vs;
      li[r] = vi;
    }
    __syncwarp();
  }
#pragma unroll
  for (int e = 0; e < E; ++e)
    if (rb[e] < k) {
      ls[rb[e]] = s[e];
      li[rb[e]] = p[e];
    }
  __syncwarp();
}

// Merges the n entries of a query's buffer bs/bp into its sorted list ls/li
// of k, by one warp (see the header). The buffer is scratch afterwards.
__device__ void wg_merge(float* ls, int* li, int k, float* bs, int* bp,
                         int n, int lane) {
  const float ts = ls[k - 1];
  const int tp = li[k - 1];
  const unsigned below = (1u << lane) - 1;
  int nv = 0;                       // compact the entries that beat the k-th
  for (int i0 = 0; i0 < n; i0 += 32) {
    const int i = i0 + lane;
    float vs = 0.f;
    int vp = -1;
    bool keep = false;
    if (i < n) {
      vs = bs[i];
      vp = bp[i];
      keep = better(vs, vp, ts, tp);
    }
    const unsigned bal = __ballot_sync(kFull, keep);
    __syncwarp();
    if (keep) {
      const int at = nv + __popc(bal & below);
      bs[at] = vs;
      bp[at] = vp;
    }
    nv += __popc(bal);
    __syncwarp();
  }
  if (nv == 0) return;
  if (nv <= 32)
    wg_merge_sorted<1>(ls, li, k, bs, bp, nv, lane);
  else if (nv <= 64)
    wg_merge_sorted<2>(ls, li, k, bs, bp, nv, lane);
  else if (nv <= 128)
    wg_merge_sorted<4>(ls, li, k, bs, bp, nv, lane);
  else
    wg_merge_sorted<8>(ls, li, k, bs, bp, nv, lane);
}

// The element types of the maps: uint8, bf16 or f32
inline int wg_elem_bytes(CUtensorMapDataType type) {
  return type == CU_TENSOR_MAP_DATA_TYPE_UINT8      ? 1
         : type == CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 ? 2
                                                    : 4;
}

// `planes` [planes][rows][cols] row-major tensors of `type` as one TMA map:
// boxes of 128 bytes of columns (128 uint8, 64 bf16 or 32 f32) x box_rows
// rows x all the planes, 128-byte swizzle, rows and columns past the tensor
// zero-filled (rank 4, the last dim of size 1, as tma_load_4d takes).
bool wg_map(CUtensorMap* map, hopper::EncodeTiled encode, const void* base,
            int rows, int cols, int box_rows, CUtensorMapDataType type,
            int planes = 1) {
  const int elem = wg_elem_bytes(type);
  const cuuint64_t row = (cuuint64_t)cols * elem;
  const cuuint64_t dims[4] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)planes, 1};
  const cuuint64_t strides[3] = {row, row * rows, row * rows * planes};
  const cuuint32_t box[4] = {(cuuint32_t)(128 / elem), (cuuint32_t)box_rows,
                             (cuuint32_t)planes, 1};
  return hopper::tensor_map_sw128(map, encode, type, base, 4, dims, strides,
                                  box);
}

// The store's map depends on (pointer, rows, columns, type) alone, so it is
// kept: a search calls the kernel on the same store again and again. Eight
// stores, the oldest replaced first; the lock makes it safe from several
// host threads.
bool wg_store_map(CUtensorMap* map, hopper::EncodeTiled encode,
                  const void* x, int n, int cols, CUtensorMapDataType type) {
  struct Entry {
    const void* x;
    int n, cols;
    CUtensorMapDataType type;
    CUtensorMap map;
  };
  static std::mutex mu;
  static Entry kept[8];
  static int next = 0;
  std::lock_guard<std::mutex> lock(mu);
  for (const Entry& e : kept)
    if (e.x == x && e.n == n && e.cols == cols && e.type == type) {
      *map = e.map;
      return true;
    }
  if (!wg_map(map, encode, x, n, cols, kWgRows, type)) return false;
  kept[next] = Entry{x, n, cols, type, *map};
  next = (next + 1) % 8;
  return true;
}

// The register A fragments of the policies that split A in registers (K3's
// nibbles, K1's f32 hi and lo parts): two buffers (k-steps in turn) of
// both row tiles' two parts, 4 registers each; a buffer is refilled once
// the wait has completed the group that read it.
template <int N>
struct WgRegsRS {
  uint32_t a[2][2][8];
  __device__ void fence() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int rt = 0; rt < 2; ++rt)
#pragma unroll
        for (int e = 0; e < 8; ++e) hopper::reg_fence(a[i][rt][e]);
  }
};

// One stage's products with both operands in the stage (K1, K2): MMA's
// k-steps of 32 bytes, 4 a chunk, A the two 64-row tiles, B the consumer's
// half of the query plane; one commit a chunk, the chunk before completed
// (and its stage released) once this one is issued.
template <class MMA, class Acc, int N, class Settle, class Release>
__device__ __forceinline__ void wg_chunk_ss(Acc (&acc)[2][N / 2],
                                            const uint8_t* st, int bcol0,
                                            int c, Settle settle,
                                            Release release) {
  using namespace hopper;
  settle();
  wgmma_fence();
  const uint64_t da0 = desc_sw128(st);
  const uint64_t da1 = desc_sw128(st + 64 * 128);
  const uint64_t db = desc_sw128(st + kWgRowBytes + bcol0 * 128);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    MMA::run(acc[0], da0 + 2 * kk, db + 2 * kk, c + kk);
    MMA::run(acc[1], da1 + 2 * kk, db + 2 * kk, c + kk);
  }
  wgmma_commit();
  if (c > 0) {            // the chunk before is done: free its stage
    wgmma_wait<1>();
    settle();
    release();
  }
}

// K1's bf16 store: the products are the scores.
struct WgBf16 {
  using Acc = float;
  static constexpr int kPlanes = 1;
  static constexpr int kChunkCols = 64;
  static constexpr bool kFactors = false;
  static constexpr bool kSplit = false;
  static constexpr int kCapMax = kWgCapMax;
  template <int N>
  struct Regs {
    __device__ void fence() {}
  };
  static int chunks(int d) { return (d + kChunkCols - 1) / kChunkCols; }
  static bool maps(CUtensorMap* tx, CUtensorMap* tq,
                   hopper::EncodeTiled encode, const void* x, const void* q,
                   int n, int d, int b, int qb) {
    return wg_store_map(tx, encode, x, n, d,
                        CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) &&
           wg_map(tq, encode, q, b, d, qb, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16);
  }
  __device__ static int4 query_box(int c, int q0) {
    return make_int4(c * kChunkCols, q0, 0, 0);
  }
  template <int N, class Settle, class Release>
  __device__ void chunk(float (&acc)[2][N / 2], Regs<N>&, const uint8_t* st,
                        int, int bcol0, int c, Settle settle,
                        Release release) const {
    wg_chunk_ss<hopper::WgmmaSS<N>, float, N>(acc, st, bcol0, c, settle,
                                              release);
  }
  __device__ void row_factors(float (&)[2][2], int, int) const {}
  __device__ void score(float&, const WgFactor&, float) const {}
  __device__ static float value(float v) { return v; }
};

// K2's int8 (kInt4 = false) and K3's packed int4 stores: exact s32 sums of
// the int8 query (quantized by the launch's first kernel into q, its
// scales q_scale and, for int4, offsets q_off) against the stored bytes.
template <bool kInt4>
struct WgInt {
  using Acc = int;
  static constexpr int kPlanes = kInt4 ? 2 : 1;
  static constexpr int kChunkCols = 128;
  static constexpr bool kFactors = true;
  // K3 only: K2 at QB = 8 waits on its rows' bytes either way, and its
  // lists at k = 100 cost more twice over (measured, PERF.md §6)
  static constexpr bool kSplit = kInt4;
  // buffers of at most 64: merges of fewer entries at a time measured
  // up to 18% faster than buffers of up to 256 (32: slower; PERF.md §6)
  static constexpr int kCapMax = 64;
  const float* x_scale;
  const float* q_scale;
  const int* q_off;

  // K3's A fragments: lo + 8 and hi + 8, one k32 step a buffer (groups
  // of two k32 steps or the whole chunk measured no faster; PERF.md §6)
  template <int N>
  struct RegsNone {
    __device__ void fence() {}
  };
  template <int N>
  using Regs =
      typename std::conditional<kInt4, WgRegsRS<N>, RegsNone<N>>::type;

  // a row's bytes, and its 128-byte chunks, at logical width d
  static int row_bytes(int d) { return kInt4 ? d / 2 : d; }
  static int chunks(int d) { return (row_bytes(d) + 127) / 128; }
  // int8: the query [b, d] as it lies, boxes of 128 bytes x qb; int4: the
  // planes [2 chunks][b][128] (plane 2 j: chunk j's lo columns, 2 j + 1 its
  // hi columns), one box of 128 bytes x qb x 2 planes a stage
  static bool maps(CUtensorMap* tx, CUtensorMap* tq,
                   hopper::EncodeTiled encode, const void* x, const void* q,
                   int n, int d, int b, int qb) {
    if (!wg_store_map(tx, encode, x, n, row_bytes(d),
                      CU_TENSOR_MAP_DATA_TYPE_UINT8))
      return false;
    if (!kInt4)
      return wg_map(tq, encode, q, b, d, qb, CU_TENSOR_MAP_DATA_TYPE_UINT8);
    const cuuint64_t planes = 2 * (cuuint64_t)chunks(d);
    const cuuint64_t dims[4] = {128, (cuuint64_t)b, planes, 1};
    const cuuint64_t strides[3] = {128, 128 * (cuuint64_t)b,
                                   128 * (cuuint64_t)b * planes};
    const cuuint32_t box[4] = {128, (cuuint32_t)qb, 2, 1};
    return hopper::tensor_map_sw128(tq, encode, CU_TENSOR_MAP_DATA_TYPE_UINT8,
                                    q, 4, dims, strides, box);
  }
  // int8: chunk c's columns; int4: chunk c's two planes
  __device__ static int4 query_box(int c, int q0) {
    return kInt4 ? make_int4(0, q0, 2 * c, 0)
                 : make_int4(c * kChunkCols, q0, 0, 0);
  }

  template <int N, class Settle, class Release>
  __device__ void chunk(int (&acc)[2][N / 2], Regs<N>& regs,
                        const uint8_t* st, int qb, int bcol0, int c,
                        Settle settle, Release release) const {
    using namespace hopper;
    if constexpr (!kInt4) {
      wg_chunk_ss<WgmmaS8<N>, int, N>(acc, st, bcol0, c, settle, release);
    } else {
      const int lane = threadIdx.x % 32;
      // this lane's ldmatrix row (row l % 16 of its warp's 16) and its
      // 16-byte half of a k32 step; a row's chunk j lies at j ^ (row % 8)
      const uint32_t a_row =
          smem_u32(st) + (threadIdx.x % 128 / 32 * 16 + lane % 16) * 128;
      const int sw = lane % 8, half = lane / 16;
      const uint64_t dlo = desc_sw128(st + kWgRowBytes + bcol0 * 128);
      const uint64_t dhi = desc_sw128(st + kWgRowBytes + (qb + bcol0) * 128);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t(&a)[2][8] = regs.a[kk % 2];
#pragma unroll
        for (int rt = 0; rt < 2; ++rt) {
          uint32_t w[4];
          ldsm_x4(w, a_row + rt * 64 * 128 + (((2 * kk + half) ^ sw) << 4));
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            a[rt][i] = w[i] & 0x0F0F0F0Fu;                            // lo + 8
            a[rt][4 + i] = ((w[i] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u; // hi + 8
          }
        }
        settle();
        wgmma_fence();
#pragma unroll
        for (int rt = 0; rt < 2; ++rt) {
          WgmmaU8S8<N>::run(acc[rt], &a[rt][0], dlo + 2 * kk, c + kk);
          WgmmaU8S8<N>::run(acc[rt], &a[rt][4], dhi + 2 * kk, 1);
        }
        wgmma_commit();
        wgmma_wait<1>();
        settle();
        // the chunk before had its last group in flight until this wait
        if (kk == 0 && c > 0) release();
      }
    }
  }

  __device__ WgFactor factor(int qi, int b) const {
    return qi < b ? WgFactor{q_scale[qi], kInt4 ? q_off[qi] : 0}
                  : WgFactor{0.f, 0};
  }
  __device__ void row_factors(float (&xs)[2][2], int row,
                              int valid_end) const {
#pragma unroll
    for (int rt = 0; rt < 2; ++rt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row + 64 * rt + 8 * h;
        xs[rt][h] = r < valid_end ? __ldg(x_scale + r) : 0.f;
      }
  }
  // the sum v -> the bits of float(v - offset) * q_scale * x_scale, in
  // that order
  __device__ void score(int& v, const WgFactor& f, float xs) const {
    v = __float_as_int(
        __fmul_rn(__fmul_rn(__int2float_rn(v - f.off), f.scale), xs));
  }
  __device__ static float value(int v) { return __int_as_float(v); }
};

// K1's f32 store: split TF32 ("3xTF32"). An f32 value v is carried as
// hi = tf32_rna(v) and lo = tf32_rna(v - hi), TF32 parts of 11 significant
// bits each; a pair's product is x_hi q_hi + x_hi q_lo + x_lo q_hi (x_lo q_lo,
// below 2^-22 of it, is dropped), each term exact, summed in the f32
// accumulators by three TF32 wgmma a k8 step. The query is split once, by
// the launch sequence's first kernel, into planes [2][b][d] (hi, then lo),
// which one TMA box a stage brings in (chunk c's 32 columns of both); each
// k8 step's A fragment is ldmatrix'd from the swizzled f32 stage and split
// in registers (two buffers, one k8 step a group, as K3's nibbles).
//
// Error. Each of hi + lo is within 2^-24 of v relative (the remainder after
// hi is at most 2^-12 of v, and lo keeps 11 bits of it), so a product is
// within about 3 * 2^-24 of x q: on unit rows the scores stay within ~1e-6
// of the plain version's f32 sums, far inside SCORE_TOL (1e-5).
// Exactness. hi + lo equals v exactly when v has at most 23 significant
// bits (the rounding of hi to nearest leaves a remainder of at most 11
// bits): every integer below 2^23 and every half-integer below 2^22. An
// integer of at most 11 significant bits (|v| < 2048, say) has lo = 0, so
// the dropped x_lo q_lo is 0 when either operand is such an integer. l2
// over SIFT-shaped integer rows (components below 256, queries and their
// -1 on the norm column integers too) therefore sums exact products: the
// norm column 0.5 |x|^2 (below 2^22 for 128 components under 2^8, ~2^17
// in SIFT1M) is carried exactly, and sums below 2^23 stay exact in f32. A
// norm column of 2^22 or more with a half (|x|^2 >= 2^23, odd), or of 2^23
// or more, is rounded in lo (one unit of 2^-24 relative), where the FMA
// route of the plain version keeps f32's 24 bits.
struct WgF32 {
  using Acc = float;
  static constexpr int kPlanes = 2;
  static constexpr int kChunkCols = 32;
  static constexpr bool kFactors = false;
  // at QB = 8 both consumers would compute the same 8 queries' products,
  // three TF32 wgmma a k8 step: each takes alternate row tiles instead
  static constexpr bool kSplit = true;
  static constexpr int kCapMax = kWgCapMax;
  // the A fragments: hi and lo, one k8 step a buffer
  template <int N>
  using Regs = WgRegsRS<N>;
  static int chunks(int d) { return (d + kChunkCols - 1) / kChunkCols; }
  // the store [n, d] as it lies; the query planes [2][b][d], one box of 32
  // columns x qb x 2 planes a stage
  static bool maps(CUtensorMap* tx, CUtensorMap* tq,
                   hopper::EncodeTiled encode, const void* x, const void* q,
                   int n, int d, int b, int qb) {
    return wg_store_map(tx, encode, x, n, d,
                        CU_TENSOR_MAP_DATA_TYPE_FLOAT32) &&
           wg_map(tq, encode, q, b, d, qb, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                  2);
  }
  __device__ static int4 query_box(int c, int q0) {
    return make_int4(c * kChunkCols, q0, 0, 0);
  }
  template <int N, class Settle, class Release>
  __device__ void chunk(float (&acc)[2][N / 2], Regs<N>& regs,
                        const uint8_t* st, int qb, int bcol0, int c,
                        Settle settle, Release release) const {
    using namespace hopper;
    const int lane = threadIdx.x % 32;
    // this lane's ldmatrix row (row l % 16 of its warp's 16) and its
    // 16-byte half (4 columns) of a k8 step; a row's 16-byte chunk j lies
    // at j ^ (row % 8)
    const uint32_t a_row =
        smem_u32(st) + (threadIdx.x % 128 / 32 * 16 + lane % 16) * 128;
    const int sw = lane % 8, half = lane / 16;
    const uint64_t dhi = desc_sw128(st + kWgRowBytes + bcol0 * 128);
    const uint64_t dlo = desc_sw128(st + kWgRowBytes + (qb + bcol0) * 128);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t(&a)[2][8] = regs.a[kk % 2];
#pragma unroll
      for (int rt = 0; rt < 2; ++rt) {
        uint32_t w[4];
        ldsm_x4(w, a_row + rt * 64 * 128 + (((2 * kk + half) ^ sw) << 4));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float v = __uint_as_float(w[i]);
          a[rt][i] = tf32_rna(v);                                   // hi
          a[rt][4 + i] = tf32_rna(v - __uint_as_float(a[rt][i]));   // lo
        }
      }
      settle();
      wgmma_fence();
      // the small terms first, then x_hi q_hi
#pragma unroll
      for (int rt = 0; rt < 2; ++rt) {
        WgmmaTF32<N>::run(acc[rt], &a[rt][4], dhi + 2 * kk, c + kk);
        WgmmaTF32<N>::run(acc[rt], &a[rt][0], dlo + 2 * kk, 1);
        WgmmaTF32<N>::run(acc[rt], &a[rt][0], dhi + 2 * kk, 1);
      }
      wgmma_commit();
      wgmma_wait<1>();
      settle();
      // the chunk before had its last group in flight until this wait
      if (kk == 0 && c > 0) release();
    }
  }
  __device__ void row_factors(float (&)[2][2], int, int) const {}
  __device__ void score(float&, const WgFactor&, float) const {}
  __device__ static float value(float v) { return v; }
};

template <class Tile, int QB>
__global__ void __launch_bounds__(kWgThreads, 1)
    topk_pass1_wgmma(const __grid_constant__ CUtensorMap tx,
                     const __grid_constant__ CUtensorMap tq, const WgArgs a,
                     const Tile tile) {
  using namespace hopper;
  using Acc = typename Tile::Acc;
  constexpr int N = QB >= 16 ? QB / 2 : 8;   // a consumer's product width
  constexpr int NJ = N / 8;                  // its 8-column tiles
  // the consumers take alternate row tiles, each keeping all QB queries
  // in lists of its own (else each keeps half the queries over every tile)
  constexpr bool kSplit = wg_lists(QB, Tile::kSplit) > QB;
  constexpr int QOWN = kSplit ? QB : QB / 2;  // queries a consumer keeps
  constexpr int NL = wg_lists(QB, Tile::kSplit);   // lists of the block
  static_assert(QB >= 8 && QB <= 128 && (QB & (QB - 1)) == 0, "QB");

  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const WgLayout o = wg_offsets(QB, a.k, a.stages, a.cap, Tile::kPlanes,
                                Tile::kFactors, Tile::kSplit);
  const int k = a.k, cap = a.cap;
  float* ls = reinterpret_cast<float*>(sm + o.lists);
  int* li = reinterpret_cast<int*>(ls + NL * k);
  float* bs = reinterpret_cast<float*>(sm + o.bufs);
  int* bp = reinterpret_cast<int*>(bs + NL * cap);
  float* thr = reinterpret_cast<float*>(sm + o.thr);
  int* cnt = reinterpret_cast<int*>(sm + o.cnt);
  WgFactor* fac = reinterpret_cast<WgFactor*>(sm + o.fac);
  float* trash_s = reinterpret_cast<float*>(sm + o.trash);
  int* trash_p = reinterpret_cast<int*>(trash_s + 32);
  // full[w * stages + s] when the consumers split the rows: a consumer
  // waits for its own rounds of a stage only; a wait by parity cannot tell
  // a round of the other consumer's from its own
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + o.bars);
  uint64_t* empty = full + (kSplit ? 2 : 1) * a.stages;

  const int q0 = blockIdx.x * QB;
  const int slice = blockIdx.y;
  const int row_begin = slice * a.rows_per_slice;
  const int row_end = min(a.n, row_begin + a.rows_per_slice);
  const int valid_end = min(row_end, a.num_valid);
  const int ntiles =
      valid_end > row_begin ? (valid_end - row_begin + kWgRows - 1) / kWgRows
                            : 0;
  const int nchunks = a.nchunks;

  for (int i = threadIdx.x; i < NL * k; i += kWgThreads) {
    ls[i] = neg_inf();
    li[i] = -1;
  }
  for (int i = threadIdx.x; i < NL; i += kWgThreads) {
    thr[i] = neg_inf();
    cnt[i] = 0;
  }
  if constexpr (Tile::kFactors)
    for (int i = threadIdx.x; i < QB; i += kWgThreads)
      fac[i] = tile.factor(q0 + i, a.b);
  if (threadIdx.x == 0) {
    for (int s = 0; s < (kSplit ? 2 : 1) * a.stages; ++s)
      mbar_init(&full[s], 1);
    // a stage is read by both consumers, or by the one whose tile it is
    for (int s = 0; s < a.stages; ++s)
      mbar_init(&empty[s], (kSplit ? 1 : kWgConsumers) * 128);
    fence_barrier_init();
  }
  // every list is set before any warp reads or writes it out (F7: a slice
  // with no valid row goes straight to the write-out)
  __syncthreads();

  if (threadIdx.x >= kWgConsumers * 128) {   // ---- producer warpgroup
    setmaxnreg_dec<40>();
    if (threadIdx.x == kWgConsumers * 128) {
      int s = 0;
      uint32_t ph = 0;
      for (int t = 0; t < ntiles; ++t)
        for (int c = 0; c < nchunks; ++c) {
          mbar_wait(&empty[s], ph ^ 1);
          uint8_t* st = sm + s * o.stage;
          uint64_t* f = &full[(kSplit ? t % 2 * a.stages : 0) + s];
          mbar_expect_tx(f, (uint32_t)o.stage);
          tma_load_4d(st, &tx, f, c * Tile::kChunkCols,
                      row_begin + t * kWgRows, 0, 0);
          const int4 qc = Tile::query_box(c, q0);   // every plane of chunk c
          tma_load_4d(st + kWgRowBytes, &tq, f, qc.x, qc.y, qc.z, qc.w);
          if (++s == a.stages) {
            s = 0;
            ph ^= 1;
          }
        }
    }
    return;
  }

  // ---- consumer warpgroups
  setmaxnreg_inc<232>();
  const int wg = threadIdx.x / 128;
  const int v = (threadIdx.x % 128) / 32;    // warp within the warpgroup
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, cc = lane & 3;
  const int bcol0 = QB >= 16 ? wg * QOWN : 0;   // its product's 1st query
  const int own0 = kSplit ? 0 : wg * QOWN;       // the 1st query it keeps
  const int lq0 = kSplit ? wg * QB : own0;       // and that query's list
  const int nown = max(0, min(QOWN, a.b - q0 - own0));   // real ones
  const int bar = 1 + wg;                        // its named barrier

  // the kept query of this thread's column (j, e), or -1
  auto kept = [&](int j, int e) {
    const int qo = bcol0 + 8 * j + 2 * cc + e - own0;
    return qo >= 0 && qo < nown ? qo : -1;
  };
  // an accumulator entry: row tile rt, column tile j, row half h, column e
  auto bit_of = [](int rt, int j, int h, int e) {
    return ((rt * NJ + j) * 2 + h) * 2 + e;
  };

  Acc acc[2][N / 2];
  typename Tile::template Regs<N> regs;
  float xs[2][2];      // the tile's row factors
  int r0 = 0;          // the tile's first row

  auto settle = [&]() {
#pragma unroll
    for (int rt = 0; rt < 2; ++rt)
#pragma unroll
      for (int i = 0; i < N / 2; ++i) reg_fence(acc[rt][i]);
    regs.fence();
  };
  // an entry's score: after finish() the accumulators hold the scores' bits
  auto val = [&](int rt, int i) { return Tile::value(acc[rt][i]); };

  // Writes the entries of `bits` into their queries' buffers, a slot each
  // from the buffer's count by a shared-memory atomic, and returns the ones
  // whose slot lay past the buffer. The store goes through a chosen address
  // (a landing place when there is nothing to write), so no accumulator is
  // read under a thread's own branch.
  auto append = [&](uint64_t bits) {
    uint64_t left = 0;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int at = (lq0 + kept(j, e)) * cap;
#pragma unroll
        for (int rt = 0; rt < 2; ++rt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int b = bit_of(rt, j, h, e);
            const bool p = (bits >> b) & 1;
            int slot = cap;
            if (p) slot = atomicAdd(&cnt[lq0 + kept(j, e)], 1);
            const bool put = slot < cap;
            *(put ? bs + at + slot : trash_s + lane) =
                val(rt, 4 * j + 2 * h + e);
            *(put ? bp + at + slot : trash_p + lane) =
                r0 + 64 * rt + 16 * v + g + 8 * h;
            left |= (uint64_t)(p && !put) << b;
          }
      }
    return left;
  };

  // K2/K3: the tile's sums -> their scores, in place, every entry (the
  // factors of a column this consumer does not keep are any query's)
  auto finish = [&]() {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qo = kept(j, e);
        const WgFactor f = fac[own0 + (qo >= 0 ? qo : 0)];
#pragma unroll
        for (int rt = 0; rt < 2; ++rt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            tile.score(acc[rt][4 * j + 2 * h + e], f, xs[rt][h]);
      }
  };

  // The tile's selection (see the header); the consumer's warps only.
  auto epilogue = [&]() {
    if constexpr (Tile::kFactors) finish();
    bool ok[2][2];
#pragma unroll
    for (int rt = 0; rt < 2; ++rt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + 64 * rt + 16 * v + g + 8 * h;
        ok[rt][h] = row < valid_end && (a.mask == nullptr || a.mask[row] > 0);
      }
    uint64_t bits = 0;   // the entries that beat their threshold
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qo = kept(j, e);
        const float t = qo >= 0 ? thr[lq0 + qo] : 0.f;
#pragma unroll
        for (int rt = 0; rt < 2; ++rt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            bits |= (uint64_t)(qo >= 0 && ok[rt][h] &&
                               val(rt, 4 * j + 2 * h + e) > t)
                    << bit_of(rt, j, h, e);
      }
    uint64_t left = append(bits);
    // a buffer overflowed: merge the full ones, then place what is left
    while (named_barrier_or(bar, 128, left != 0)) {
      // the buffers more than half full (the overflowing ones among
      // them; merging the others now spares a round later), read by every
      // warp before any count restarts, then dealt to the four warps in
      // turn (QOWN <= 64)
      unsigned full_q[2] = {0u, 0u};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int u = 32 * h + lane;
        full_q[h] =
            __ballot_sync(kFull, u < nown && 2 * cnt[lq0 + u] > cap);
      }
      named_barrier_sync(bar, 128);
      int seen = 0;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        for (unsigned m = full_q[h]; m; m &= m - 1, ++seen) {
          if (seen % 4 != v) continue;
          const int ql = lq0 + 32 * h + __ffs(m) - 1;
          wg_merge(ls + ql * k, li + ql * k, k, bs + ql * cap,
                   bp + ql * cap, min(cnt[ql], cap), lane);
          if (lane == 0) {
            cnt[ql] = 0;
            thr[ql] = ls[ql * k + k - 1];
          }
          __syncwarp();
        }
      named_barrier_sync(bar, 128);
      left = append(left);
    }
  };

  int s = 0, prev = 0;
  uint32_t ph = 0;
  uint32_t own_ph = 0;   // split rows: the phase of each of its full[] stages
  for (int t = kSplit ? wg : 0; t < ntiles; t += kSplit ? 2 : 1) {
    if (kSplit) s = t * nchunks % a.stages;   // past the other's tile
    r0 = row_begin + t * kWgRows;
    tile.row_factors(xs, r0 + 16 * v + g, valid_end);
    for (int c = 0; c < nchunks; ++c) {
      if (kSplit) {
        mbar_wait(&full[wg * a.stages + s], (own_ph >> s) & 1);
        own_ph ^= 1u << s;
      } else {
        mbar_wait(&full[s], ph);
      }
      tile.template chunk<N>(acc, regs, sm + s * o.stage, QB, bcol0, c,
                             settle, [&]() { mbar_arrive(&empty[prev]); });
      prev = s;
      if (++s == a.stages) {
        s = 0;
        ph ^= 1;
      }
    }
    wgmma_wait<0>();
    settle();
    mbar_arrive(&empty[prev]);
    epilogue();
  }

  // the buffers' last entries, then the lists as the slice's candidates
  // (list wg of the slice's two when the consumers split the row tiles)
  for (int u = v; u < nown; u += 4) {
    const int ql = lq0 + u;
    if (cnt[ql] > 0)
      wg_merge(ls + ql * k, li + ql * k, k, bs + ql * cap, bp + ql * cap,
               cnt[ql], lane);
    const size_t out =
        ((size_t)(q0 + own0 + u) * a.num_lists +
         (kSplit ? 2 * slice + wg : slice)) * k;
    for (int i = lane; i < k; i += 32) {
      a.cand_s[out + i] = ls[ql * k + i];
      a.cand_i[out + i] = li[ql * k + i];
    }
  }
}

template <class Tile, int QB>
cudaError_t launch_pass1_wgmma(const CUtensorMap& tx, const CUtensorMap& tq,
                               const WgArgs& a, const Tile& tile, size_t smem,
                               cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      topk_pass1_wgmma<Tile, QB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.b + QB - 1) / QB, a.num_slices);
  topk_pass1_wgmma<Tile, QB><<<grid, kWgThreads, smem, stream>>>(tx, tq, a,
                                                                 tile);
  return cudaGetLastError();
}

// The plan of a tile policy's pass 1 for a query block of qb at k.
template <class Tile>
WgLayout wg_plan(int qb, int k) {
  return wg_layout(qb, k, Tile::kPlanes, Tile::kFactors, Tile::kSplit,
                   Tile::kCapMax);
}

// The candidate lists a query gets from num_slices slices (pass 2 merges
// them).
template <class Tile>
int wg_candidate_lists(int qb, int num_slices) {
  return num_slices * wg_lists(qb, Tile::kSplit) / qb;
}

// Pass 1 for a query block of qb in {8, 16, 32, 64, 128}: the CUDA error
// code, or hopper::kNoEncoder / kMapRefused (nothing launched). x is the
// store, q the query as the policy's map reads it, d the logical width.
template <class Tile>
int run_wgmma(int qb, const Tile& tile, const void* x, const void* q,
              const void* mask, void* cand_s, void* cand_i, int n, int d,
              int b, int k, int num_valid, int rows_per_slice,
              int num_slices, cudaStream_t stream) {
  const WgLayout lay = wg_plan<Tile>(qb, k);
  if (lay.stages == 0 || rows_per_slice % kWgRows != 0)
    return (int)cudaErrorInvalidValue;
  const hopper::EncodeTiled encode = hopper::encode_tiled();
  if (encode == nullptr) return hopper::kNoEncoder;
  CUtensorMap tx, tq;
  if (!Tile::maps(&tx, &tq, encode, x, q, n, d, b, qb))
    return hopper::kMapRefused;
  const WgArgs a{static_cast<const int8_t*>(mask), static_cast<float*>(cand_s),
                 static_cast<int*>(cand_i), n, Tile::chunks(d), b, k,
                 num_valid, rows_per_slice, num_slices,
                 wg_candidate_lists<Tile>(qb, num_slices), lay.stages,
                 lay.cap};
  switch (qb) {
    case 8:
      return (int)launch_pass1_wgmma<Tile, 8>(tx, tq, a, tile, lay.total,
                                              stream);
    case 16:
      return (int)launch_pass1_wgmma<Tile, 16>(tx, tq, a, tile, lay.total,
                                               stream);
    case 32:
      return (int)launch_pass1_wgmma<Tile, 32>(tx, tq, a, tile, lay.total,
                                               stream);
    case 64:
      return (int)launch_pass1_wgmma<Tile, 64>(tx, tq, a, tile, lay.total,
                                               stream);
    case 128:
      return (int)launch_pass1_wgmma<Tile, 128>(tx, tq, a, tile, lay.total,
                                                stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
