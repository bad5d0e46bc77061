// K1's pass 1 over a bf16 store, built for Hopper: the scores by TMA and
// wgmma, the selection by append buffers that are sorted and merged only
// when they fill. The split-N plan, the candidate layout and pass 2 are
// topk_common.cuh's; the PTX wrappers hopper.cuh's.
//
// Block (query block of QB, slice), 384 threads: warpgroup 2 produces,
// warpgroups 0 and 1 consume.
//   * The producer's first thread walks the slice's row tiles of 128 rows
//     and, in each, the row's 64-column (128-byte) chunks: a stage of the
//     ring holds one chunk of the tile's rows (16 KB) and the same chunk of
//     the query block (QB x 128 bytes), both loaded by TMA into 128-byte
//     swizzled tiles that complete on the stage's "full" mbarrier. TMA
//     zero-fills rows past N, queries past b and columns past D. Shared
//     memory no longer grows with D: the query block is never staged whole,
//     its chunk is read again from L2 for every row tile.
//   * Consumer w scores all 128 rows of a stage against its own half of
//     the query block (queries w QB/2 .. + QB/2 - 1; at QB = 8 both take the
//     8 queries and each keeps 4) by wgmma m64nNk16, N = max(8, QB/2), A the
//     two 64-row tiles and B the queries, both K-major from shared memory,
//     f32 sums in registers, one chunk's products in flight while the next
//     is issued. Every consumer thread arrives on the stage's "empty"
//     mbarrier once its products have read it; no block barrier runs after
//     the start. setmaxnreg hands the producer's registers to them.
//   * Each consumer keeps its own queries' lists and syncs only its own
//     four warps (a named barrier), so while one checks and merges, the
//     other's products run, as far ahead as the ring's stages reach (a
//     stage is freed when both have read it).
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
// -1).
//
// Everything here has internal linkage.

#pragma once

#include <cuda_bf16.h>

#include <algorithm>
#include <mutex>

#include "hopper.cuh"
#include "topk_common.cuh"

namespace {

constexpr int kWgConsumers = 2;                  // consumer warpgroups
constexpr int kWgThreads = (kWgConsumers + 1) * 128;
constexpr int kWgRows = 128;                     // store rows a stage
constexpr int kWgCols = 64;                      // bf16 columns a stage
constexpr int kWgRowBytes = kWgRows * 128;       // a stage's rows, 16 KB
constexpr int kWgCapMax = 256;                   // longest append buffer
constexpr size_t kWgSmemLimit = 232448;          // a Hopper block's

// Where pass 1's shared memory goes for a query block of qb, lists of k,
// `stages` ring stages and buffers of `cap` entries a query: the ring
// (1,024-aligned stages: rows, then the query chunk), the lists [qb][k]
// (scores, then positions), the buffers [qb][cap] (the same), thresholds
// [qb], buffer counts [qb], a landing place for entries not written (32
// f32 + 32 int32) and the mbarriers; total counts 1,024 for the
// alignment.
struct WgLayout {
  int stages, cap;
  size_t stage, lists, bufs, thr, cnt, trash, bars, total;
};

__host__ __device__ inline WgLayout wg_offsets(int qb, int k, int stages,
                                               int cap) {
  WgLayout o;
  o.stages = stages;
  o.cap = cap;
  o.stage = kWgRowBytes + (size_t)qb * 128;
  o.lists = o.stage * stages;
  o.bufs = o.lists + 8 * (size_t)qb * k;
  o.thr = o.bufs + 8 * (size_t)qb * cap;
  o.cnt = o.thr + 4 * (size_t)qb;
  o.trash = o.cnt + 4 * (size_t)qb;
  o.bars = o.trash + 256;
  o.total = o.bars + 16 * (size_t)stages + 1024;
  return o;
}

// The ring's stages and the buffers' entries: a ring of 8 or 6 stages
// with buffers of 256 where the query block is narrow (B = 1: every stage
// in flight is bandwidth), else 4 stages with the longest buffer of at
// least 64 that fits (a multiple of 16, at most 256), else 3 stages with
// one of at least 32. stages = 0 if none fits (the wrapper's plan takes a
// narrower query block).
inline WgLayout wg_layout(int qb, int k) {
  const int plans[][2] = {{8, 256}, {6, 256}, {4, 64}, {3, 32}};
  for (const auto& p : plans) {
    const WgLayout none = wg_offsets(qb, k, p[0], 0);
    if (none.total > kWgSmemLimit) continue;
    const int cap = (int)std::min<size_t>(
        kWgCapMax, (kWgSmemLimit - none.total) / (8 * (size_t)qb) / 16 * 16);
    if (cap >= p[1]) return wg_offsets(qb, k, p[0], cap);
  }
  WgLayout none = wg_offsets(qb, k, 0, 0);
  none.total = ~(size_t)0 >> 2;
  return none;
}

struct WgArgs {
  const int8_t* mask;
  float* cand_s;
  int* cand_i;
  int n, d, b, k, num_valid, rows_per_slice, num_slices, stages, cap;
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

template <int QB>
__global__ void __launch_bounds__(kWgThreads, 1)
    topk_pass1_wgmma(const __grid_constant__ CUtensorMap tx,
                     const __grid_constant__ CUtensorMap tq, const WgArgs a) {
  using namespace hopper;
  constexpr int N = QB >= 16 ? QB / 2 : 8;   // a consumer's product width
  constexpr int NJ = N / 8;                  // its 8-column tiles
  constexpr int QOWN = QB / 2;               // queries a consumer keeps
  static_assert(QB >= 8 && QB <= 128 && (QB & (QB - 1)) == 0, "QB");

  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const WgLayout o = wg_offsets(QB, a.k, a.stages, a.cap);
  const int k = a.k, cap = a.cap;
  float* ls = reinterpret_cast<float*>(sm + o.lists);
  int* li = reinterpret_cast<int*>(ls + QB * k);
  float* bs = reinterpret_cast<float*>(sm + o.bufs);
  int* bp = reinterpret_cast<int*>(bs + QB * cap);
  float* thr = reinterpret_cast<float*>(sm + o.thr);
  int* cnt = reinterpret_cast<int*>(sm + o.cnt);
  float* trash_s = reinterpret_cast<float*>(sm + o.trash);
  int* trash_p = reinterpret_cast<int*>(trash_s + 32);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + o.bars);
  uint64_t* empty = full + a.stages;

  const int q0 = blockIdx.x * QB;
  const int slice = blockIdx.y;
  const int row_begin = slice * a.rows_per_slice;
  const int row_end = min(a.n, row_begin + a.rows_per_slice);
  const int valid_end = min(row_end, a.num_valid);
  const int ntiles =
      valid_end > row_begin ? (valid_end - row_begin + kWgRows - 1) / kWgRows
                            : 0;
  const int nchunks = (a.d + kWgCols - 1) / kWgCols;

  for (int i = threadIdx.x; i < QB * k; i += kWgThreads) {
    ls[i] = neg_inf();
    li[i] = -1;
  }
  for (int i = threadIdx.x; i < QB; i += kWgThreads) {
    thr[i] = neg_inf();
    cnt[i] = 0;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWgConsumers * 128);
    }
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
          mbar_expect_tx(&full[s], (uint32_t)o.stage);
          tma_load_4d(st, &tx, &full[s], c * kWgCols,
                      row_begin + t * kWgRows, 0, 0);
          tma_load_4d(st + kWgRowBytes, &tq, &full[s], c * kWgCols, q0, 0,
                      0);
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
  const int own0 = wg * QOWN;                    // the 1st query it keeps
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

  float acc[2][N / 2];
  int r0 = 0;          // the tile's first row

  auto settle = [&]() {
#pragma unroll
    for (int rt = 0; rt < 2; ++rt)
#pragma unroll
      for (int i = 0; i < N / 2; ++i) reg_fence(acc[rt][i]);
  };

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
        const int at = (own0 + kept(j, e)) * cap;
#pragma unroll
        for (int rt = 0; rt < 2; ++rt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int b = bit_of(rt, j, h, e);
            const bool p = (bits >> b) & 1;
            int slot = cap;
            if (p) slot = atomicAdd(&cnt[own0 + kept(j, e)], 1);
            const bool put = slot < cap;
            *(put ? bs + at + slot : trash_s + lane) =
                acc[rt][4 * j + 2 * h + e];
            *(put ? bp + at + slot : trash_p + lane) =
                r0 + 64 * rt + 16 * v + g + 8 * h;
            left |= (uint64_t)(p && !put) << b;
          }
      }
    return left;
  };

  // The tile's selection (see the header); the consumer's warps only.
  auto epilogue = [&]() {
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
        const float t = qo >= 0 ? thr[own0 + qo] : 0.f;
#pragma unroll
        for (int rt = 0; rt < 2; ++rt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            bits |= (uint64_t)(qo >= 0 && ok[rt][h] &&
                               acc[rt][4 * j + 2 * h + e] > t)
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
            __ballot_sync(kFull, u < nown && 2 * cnt[own0 + u] > cap);
      }
      named_barrier_sync(bar, 128);
      int seen = 0;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        for (unsigned m = full_q[h]; m; m &= m - 1, ++seen) {
          if (seen % 4 != v) continue;
          const int ql = own0 + 32 * h + __ffs(m) - 1;
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
  for (int t = 0; t < ntiles; ++t) {
    for (int c = 0; c < nchunks; ++c) {
      mbar_wait(&full[s], ph);
      settle();
      wgmma_fence();
      const uint8_t* st = sm + s * o.stage;
      const uint64_t da0 = desc_sw128(st);
      const uint64_t da1 = desc_sw128(st + 64 * 128);
      const uint64_t db = desc_sw128(st + kWgRowBytes + bcol0 * 128);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        WgmmaSS<N>::run(acc[0], da0 + 2 * kk, db + 2 * kk, c + kk);
        WgmmaSS<N>::run(acc[1], da1 + 2 * kk, db + 2 * kk, c + kk);
      }
      wgmma_commit();
      if (c > 0) {            // the chunk before is done: free its stage
        wgmma_wait<1>();
        settle();
        mbar_arrive(&empty[prev]);
      }
      prev = s;
      if (++s == a.stages) {
        s = 0;
        ph ^= 1;
      }
    }
    wgmma_wait<0>();
    settle();
    mbar_arrive(&empty[prev]);
    r0 = row_begin + t * kWgRows;
    epilogue();
  }

  // the buffers' last entries, then the lists as the slice's candidates
  for (int u = v; u < nown; u += 4) {
    const int ql = own0 + u;
    if (cnt[ql] > 0)
      wg_merge(ls + ql * k, li + ql * k, k, bs + ql * cap, bp + ql * cap,
               cnt[ql], lane);
    const size_t out = ((size_t)(q0 + ql) * a.num_slices + slice) * k;
    for (int i = lane; i < k; i += 32) {
      a.cand_s[out + i] = ls[ql * k + i];
      a.cand_i[out + i] = li[ql * k + i];
    }
  }
}

// A bf16 [rows, d] row-major tensor as a TMA map: boxes of 64 columns x
// box_rows rows, 128-byte swizzle, rows and columns past the tensor
// zero-filled (rank 4, the last two dims of size 1, as tma_load_4d takes).
bool wg_rows_map(CUtensorMap* map, hopper::EncodeTiled encode,
                 const void* base, int rows, int d, int box_rows) {
  const cuuint64_t row = (cuuint64_t)d * 2;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)rows, 1, 1};
  const cuuint64_t strides[3] = {row, row * rows, row * rows};
  const cuuint32_t box[4] = {(cuuint32_t)kWgCols, (cuuint32_t)box_rows, 1,
                             1};
  return hopper::tensor_map_bf16(map, encode, base, 4, dims, strides, box);
}

// The store's map depends on (pointer, rows, d) alone, so it is kept: a
// search calls K1 on the same store again and again. Eight stores, the
// oldest replaced first; the lock makes it safe from several host threads.
bool wg_store_map(CUtensorMap* map, hopper::EncodeTiled encode,
                  const void* x, int n, int d) {
  struct Entry {
    const void* x;
    int n, d;
    CUtensorMap map;
  };
  static std::mutex mu;
  static Entry kept[8];
  static int next = 0;
  std::lock_guard<std::mutex> lock(mu);
  for (const Entry& e : kept)
    if (e.x == x && e.n == n && e.d == d) {
      *map = e.map;
      return true;
    }
  if (!wg_rows_map(map, encode, x, n, d, kWgRows)) return false;
  kept[next] = Entry{x, n, d, *map};
  next = (next + 1) % 8;
  return true;
}

template <int QB>
cudaError_t launch_pass1_wgmma(const CUtensorMap& tx, const CUtensorMap& tq,
                               const WgArgs& a, size_t smem,
                               cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      topk_pass1_wgmma<QB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.b + QB - 1) / QB, a.num_slices);
  topk_pass1_wgmma<QB><<<grid, kWgThreads, smem, stream>>>(tx, tq, a);
  return cudaGetLastError();
}

// Pass 1 for a query block of qb in {8, 16, 32, 64, 128}: the CUDA error
// code, or hopper::kNoEncoder / kMapRefused (nothing launched).
int run_wgmma(int qb, const void* x, const void* q, const void* mask,
              void* cand_s, void* cand_i, int n, int d, int b, int k,
              int num_valid, int rows_per_slice, int num_slices,
              cudaStream_t stream) {
  const WgLayout lay = wg_layout(qb, k);
  if (lay.stages == 0 || rows_per_slice % kWgRows != 0)
    return (int)cudaErrorInvalidValue;
  const hopper::EncodeTiled encode = hopper::encode_tiled();
  if (encode == nullptr) return hopper::kNoEncoder;
  CUtensorMap tx, tq;
  if (!wg_store_map(&tx, encode, x, n, d) ||
      !wg_rows_map(&tq, encode, q, b, d, qb))
    return hopper::kMapRefused;
  const WgArgs a{static_cast<const int8_t*>(mask), static_cast<float*>(cand_s),
                 static_cast<int*>(cand_i), n, d, b, k, num_valid,
                 rows_per_slice, num_slices, lay.stages, lay.cap};
  switch (qb) {
    case 8: return (int)launch_pass1_wgmma<8>(tx, tq, a, lay.total, stream);
    case 16: return (int)launch_pass1_wgmma<16>(tx, tq, a, lay.total, stream);
    case 32: return (int)launch_pass1_wgmma<32>(tx, tq, a, lay.total, stream);
    case 64: return (int)launch_pass1_wgmma<64>(tx, tq, a, lay.total, stream);
    case 128:
      return (int)launch_pass1_wgmma<128>(tx, tq, a, lay.total, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
