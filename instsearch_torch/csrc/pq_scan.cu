// Fused PQ-ADC top-k over 4-bit product-quantization codes, for Hopper
// (sm_90a): K4.
//
// Replaces the TPU kernel instsearch_tpu/kernels/pq_scan.py::pq_topk (Pallas
// body `_kernel_pq`, its one-hot construction `_onehot_half`, and K1's
// epilogue `_fold_tile`). Same function:
//   codes [N, G] int8, G >= M/2: byte j < M/2 holds the code of subspace j
//         in its low nibble (byte - 16 * (byte >> 4)) and of subspace
//         j + M/2 in its high nibble ((byte >> 4) + 8), ops/pq.py::
//         encode_pq; bytes past M/2 are padding;
//   q     [B, D] f32 and centroids [M, 16, D/M] f32;
//   ->    scores [B, k] f32 = s_lo + s_hi, where s_lo is the f32 sum of
//         lut[b, m, code_m] over m < M/2 in ascending m, from 0, and s_hi
//         the same over m >= M/2, lut the bf16-rounded table below; sorted
//         descending, with row positions [B, k] int32.
// The table: lut[b, m, j] = bf16(q[b, m ds] C[m, j, 0] + q[b, m ds + 1]
// C[m, j, 1] + ... ), each product and each sum an f32 operation rounded to
// nearest, left to right, then rounded to bf16 to nearest-even; the
// padding bytes' subspaces get zero rows. That order, and the order of the
// scan's additions, are the plain version's (instsearch_torch/kernels/
// pq_scan.py::_lut, ::pq_topk_reference), so the two agree bit for bit. The
// build has no --use_fast_math, and the table's products and sums are
// __fmul_rn/__fadd_rn, which nvcc never contracts into FMAs. Rows >=
// num_valid or with mask <= 0 are never returned; ties go to the lowest row
// position; slots past the count of valid rows come back as (-inf, -1).
//
// What bounds it on the card. Bytes: N * G of codes, each read once: at 1M
// rows and M = 64, 32 MiB, about 0.010 ms at the H100's published 3.35
// TB/s; at 64M rows 2 GiB, about 0.64 ms. Operations: B * N * M f32
// additions, each of a table entry looked up in shared memory: 64M rows x
// 64 x 128 queries is 5.5e11, 8.2 ms at the published 67 TFLOP/s f32 rate.
// The lookups bind first. Shared memory delivers 128 bytes a clock to an
// SM: 32 f32 entries, ~7.4e12 a second on 132 SMs at ~1.75 GHz, 74 ms for
// that case; at B = 1 a row costs two lookups a byte, so the lookups come
// close to the byte bound and must overlap the stream.
//
// What the design does about it. One launch sequence on the caller's
// stream, from one C call:
//   1. pq_table_kernel builds the table [B, 2G, 16] f32 (bf16 values) into
//      scratch behind the candidates: no eager table ops on the host;
//   2. pq_pass1, K4's own pass 1. Block (query block of QB, slice): 8
//      scoring warps, at QB = 1 a fold warp, and a producer warp:
//        * the producer's first lane streams the slice's 256-row chunks of
//          codes (256 G contiguous bytes, 8 KB at M = 64) by 1-D bulk async
//          copy into a ring of 3 or 4 stages, each guarded by a full and
//          an empty mbarrier; a chunk whose size is not a multiple of 16
//          bytes (the last one of the store) takes its tail by 4-byte loads
//          before the stage's arrival;
//        * the block's table lies in shared memory query-minor, [subspace]
//          [code][query]: at QB >= 2 as bf16 pairs, two queries a 32-bit
//          word, so a wavefront delivers 64 entries (PqTable), widened to
//          f32 exactly by a shift or a mask; 8-byte vectors of four
//          queries lie so that a half-warp's load is one wavefront
//          whatever its 16 rows' codes. A row's nibbles become the table's
//          byte offsets four at a time (a shift and a mask of the code
//          word, then a byte permute each), and the high nibble's rows are
//          stored at code ^ 8, so the raw nibble indexes them;
//        * each scoring thread scores one row of the chunk for the QB
//          queries from the stage, releases the stage, writes its scores
//          into one of kBufs score buffers and marks, by a ballot per
//          query, the rows that beat the query's k-th as it stands (a row
//          lies past every row in the lists, so only a greater score can);
//        * the folds: at QB = 1 the fold warp, at QB >= 2 each scoring warp
//          for its queries a chunk behind its scoring, takes the marked rows
//          (full/free mbarriers per score buffer), and inserts one or two,
//          or sorts 32 at a time and merges them (K1's warp_insert, or the
//          merge of ranks below). An unmarked chunk costs a fold two loads;
//   3. topk_common.cuh's pass 2.
//
// Not here: the TPU's one-hot product on the tensor cores. Their f32
// accumulation is not specified as IEEE round-to-nearest (published studies
// of earlier generations found truncation), so the scores would no longer
// equal the plain version's. A product against a zero accumulator with a
// single non-zero term is exact, but building one-hot fragments costs about
// one integer operation a lookup, no better than the shared-memory load.

#include <cuda_bf16.h>

#include "hopper.cuh"
#include "topk_common.cuh"

namespace {

constexpr int kCodes = 16;                    // codes a subspace
constexpr int kTableThreads = 256;
// a folding warp's own shared memory: the gathered rows' indices (a byte
// each) and a batch of 32 (score, position)
constexpr int kFoldBytes = kChunk + 32 * (4 + 4);

static_assert(kChunk == kThreads, "one row of a chunk per scoring thread");

// ---- 1. the table ---------------------------------------------------------

// One thread per entry of out [b, 2 groups, 16]: subspace row r < groups is
// subspace r (zero past m / 2), row groups + r is subspace m / 2 + r.
__global__ void __launch_bounds__(kTableThreads)
pq_table_kernel(const float* __restrict__ q, const float* __restrict__ cent,
                float* __restrict__ out, int b, int m, int ds, int groups) {
  const int per = 2 * groups * kCodes;
  const int i = blockIdx.x * kTableThreads + threadIdx.x;
  if (i >= b * per) return;
  const int qi = i / per, e = i % per, r = e / kCodes, j = e % kCodes;
  const int half = m / 2;
  const int sub = r < groups ? (r < half ? r : -1)
                             : (r - groups < half ? half + r - groups : -1);
  float v = 0.f;
  if (sub >= 0) {
    const float* qr = q + (size_t)qi * m * ds + (size_t)sub * ds;
    const float* c = cent + ((size_t)sub * kCodes + j) * ds;
    float acc = __fmul_rn(qr[0], c[0]);
    for (int t = 1; t < ds; ++t) acc = __fadd_rn(acc, __fmul_rn(qr[t], c[t]));
    v = __bfloat162float(__float2bfloat16_rn(acc));
  }
  out[i] = v;
}

cudaError_t launch_table(const void* q, const void* cent, void* out, int b,
                         int d, int m, int groups, cudaStream_t stream) {
  const int total = b * 2 * groups * kCodes;
  pq_table_kernel<<<(total + kTableThreads - 1) / kTableThreads,
                    kTableThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(cent),
      static_cast<float*>(out), b, m, d / m, groups);
  return cudaGetLastError();
}

// ---- 2. pass 1 ------------------------------------------------------------

// The block's table in shared memory, query-minor, as 32-bit words. At QB =
// 1 a word is the f32 entry of (row r, slot s). At QB >= 2 a word holds the
// bf16 entries of two queries, 2 jp in its low half and 2 jp + 1 in its high
// half (the table's values are bf16, so the halves widen back exactly), and
// a (r, s) has kWords = QB / 2 of them. Packing two queries a word doubles
// the entries a shared-memory wavefront delivers.
//
// The layout follows how a warp's loads are served: a 4-byte load by the
// whole warp at once, an 8-byte load by half-warps, a 16-byte one by
// quarter-warps, each phase one wavefront of 128 bytes unless two of its
// lanes want different words of one bank. A warp's 32 rows read up to 16
// distinct slots of a table row at once, so at QB >= 4 the words go in
// 8-byte vectors of four queries, vector v of all 16 slots of a row in one
// 128-byte line ([row][v][slot]): whatever the codes, each half-warp's load
// is one wavefront, 64 entries a clock. (16-byte vectors would put slots s
// and s + 8 on the same banks, and a quarter-warp's 8 random codes collide
// often.) At QB <= 2 a slot is one word and the 16 slots of a row lie in 16
// banks. The slot s of a code c is c for the low nibbles' rows, c ^ 8 for
// the high ones', the nibble as stored. tests/test_torch_pq_table.py
// emulates the layout and the loads' banks.
template <int QB>
struct PqTable {
  static constexpr int kWords = QB >= 2 ? QB / 2 : 1;
  static constexpr int kVecWords = QB >= 4 ? 2 : 1;    // words a load
  static constexpr int kVecs = kWords / kVecWords;     // loads a (r, s)
  static constexpr int kRowBytes = kCodes * kWords * 4;
  static constexpr int kVecBytes = kCodes * kVecWords * 4;  // a [v] line
  static_assert(QB <= 16, "the accumulators of 16 queries a thread at most");
  __host__ __device__ static constexpr size_t bytes(int groups) {
    return (size_t)2 * groups * kRowBytes;
  }
  // the word offset of word jp of (r, s)
  __device__ static int index(int r, int s, int jp) {
    return (r * kRowBytes + (jp / kVecWords) * kVecBytes) / 4 +
           s * kVecWords + jp % kVecWords;
  }
  // byte t of the result: the byte offset in its row's first line of the
  // slot of nibble t (the low four bits of byte t of nib); at most 120
  __device__ static uint32_t slots(uint32_t nib) {
    return nib * (kVecWords * 4);
  }
  // word jp of (r, s) from the table [b, 2 groups, 16] f32 in global memory
  __device__ static uint32_t word(const float* table, int per, int b, int q0,
                                  int jp, int e) {
    auto at = [&](int j) {
      return q0 + j < b ? __float_as_uint(table[(size_t)(q0 + j) * per + e])
                        : 0u;
    };
    if constexpr (QB == 1) return at(0);
    else return (at(2 * jp) >> 16) | (at(2 * jp + 1) & 0xffff0000u);
  }
  // acc[j] += table[r, s, j] for the QB queries, in one addition each. row:
  // the table's row r; off: the slot's offset from `slots`.
  __device__ static void add(float (&acc)[QB], const unsigned char* row,
                             uint32_t off) {
    const unsigned char* e = row + off;
    if constexpr (QB == 1) {
      acc[0] += *reinterpret_cast<const float*>(e);
    } else {
#pragma unroll
      for (int v = 0; v < kVecs; ++v) {
        uint32_t w[kVecWords];
        if constexpr (kVecWords == 2) {
          const uint2 x = *reinterpret_cast<const uint2*>(e + v * kVecBytes);
          w[0] = x.x;
          w[1] = x.y;
        } else {
          w[0] = *reinterpret_cast<const uint32_t*>(e + v * kVecBytes);
        }
#pragma unroll
        for (int t = 0; t < kVecWords; ++t) {
          const int q = 2 * (v * kVecWords + t);
          acc[q] += __uint_as_float(w[t] << 16);
          acc[q + 1] += __uint_as_float(w[t] & 0xffff0000u);
        }
      }
    }
  }
};

// Pass 1's warps for a query block of QB: kWarps scoring warps (one row of
// a chunk a thread), then at QB = 1 a fold warp, then the producer warp. At
// QB >= 2 the scoring warps fold too, query qi in warp qi % kWarps, a chunk
// behind their scoring. kBufs score buffers lie between scoring and
// folding.
template <int QB>
struct PqWarps {
  static constexpr bool kFoldWarp = QB == 1;
  static constexpr int kProducer = kWarps + (kFoldWarp ? 1 : 0);
  static constexpr int kThreads = (kProducer + 1) * 32;
  static constexpr int kFolders = kFoldWarp ? 1 : kWarps;
  static constexpr int kBufs = QB >= 16 ? 2 : QB == 1 ? 4 : 3;
  static constexpr int kStages = QB >= 16 ? 3 : 4;   // chunks of codes
};

// Byte offsets of a pass-1 block's shared memory: the table first (at the
// start of the window, so its rows' addresses fold into the loads'
// immediates), then the ring (the bulk copies' destinations), `bufs` score
// buffers [QB][256] f32 and as many of pass masks [QB][8 warps], the lists
// [QB][k], each folding warp's gathered row indices (256 bytes) and batch
// of 32 (score, position), and the mbarriers.
struct PqSmem {
  size_t table, ring, sc, masks, ls, li, gather, bars, total;
  __host__ __device__ PqSmem(size_t table_bytes, int qb, int stages,
                             int bufs, int folders, int groups, int k) {
    table = 0;
    ring = align16(table_bytes);
    sc = ring + (size_t)stages * kChunk * groups;
    masks = sc + bufs * sizeof(float) * (size_t)qb * kChunk;
    ls = masks + bufs * sizeof(uint32_t) * (size_t)qb * kWarps;
    li = ls + sizeof(float) * (size_t)qb * k;
    gather = li + sizeof(int) * (size_t)qb * k;
    bars = align16(gather + (size_t)kFoldBytes * folders);
    total = bars + 2 * (stages + bufs) * sizeof(uint64_t);
  }
};

// The entries of the low and high nibbles of one 32-bit word of a row's
// codes (subspaces g0 .. g0 + 3) added to its sums, in ascending subspace.
// The word's nibbles become slot offsets four at a time (PqTable::slots),
// and one byte permute takes each out.
template <int QB>
__device__ __forceinline__ void score_word(float (&s_lo)[QB],
                                           float (&s_hi)[QB],
                                           const unsigned char* lo_rows,
                                           const unsigned char* hi_rows,
                                           uint32_t word) {
  constexpr int kRow = PqTable<QB>::kRowBytes;
  const uint32_t lo = PqTable<QB>::slots(word & 0x0F0F0F0Fu);
  const uint32_t hi = PqTable<QB>::slots((word >> 4) & 0x0F0F0F0Fu);
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    PqTable<QB>::add(s_lo, lo_rows + t * kRow, __byte_perm(lo, 0, 0x4440 + t));
    PqTable<QB>::add(s_hi, hi_rows + t * kRow, __byte_perm(hi, 0, 0x4440 + t));
  }
}

// One row's codes (p, `groups` bytes) scored against the table (tbl): G > 0
// is the row width as a constant, which makes every table row's address
// one too; G = 0 takes `groups`.
template <int QB, int G>
__device__ __forceinline__ void score_row(float (&s_lo)[QB],
                                          float (&s_hi)[QB],
                                          const unsigned char* tbl,
                                          const unsigned char* p,
                                          int groups) {
  constexpr int kRow = PqTable<QB>::kRowBytes;
  if (G > 0) groups = G;
  const unsigned char* lo = tbl;                          // table row g
  const unsigned char* hi = tbl + (size_t)groups * kRow;  // groups + g
  if (groups % 16 == 0) {          // the row as 16-byte vectors
#pragma unroll
    for (int v = 0; v < (G > 0 ? G / 16 : groups / 16); ++v) {
      const uint4 x = reinterpret_cast<const uint4*>(p)[v];
      const int r = 16 * v * kRow;
      score_word<QB>(s_lo, s_hi, lo + r, hi + r, x.x);
      score_word<QB>(s_lo, s_hi, lo + r + 4 * kRow, hi + r + 4 * kRow, x.y);
      score_word<QB>(s_lo, s_hi, lo + r + 8 * kRow, hi + r + 8 * kRow, x.z);
      score_word<QB>(s_lo, s_hi, lo + r + 12 * kRow, hi + r + 12 * kRow,
                     x.w);
    }
  } else {
    for (int w = 0; w < groups / 4; ++w)
      score_word<QB>(s_lo, s_hi, lo + 4 * w * kRow, hi + 4 * w * kRow,
                     reinterpret_cast<const uint32_t*>(p)[w]);
  }
}

// Sorts the warp's 32 (score, position) pairs, one a lane, best first
// (bitonic; (-inf, -1) fillers last).
__device__ __forceinline__ void warp_sort32(float& s, int& p, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int j = size >> 1; j > 0; j >>= 1) {
      const float os = __shfl_xor_sync(kFull, s, j);
      const int op = __shfl_xor_sync(kFull, p, j);
      // the lower lane of a pair keeps the better one in a descending run
      const bool keep_better = ((lane & j) == 0) == ((lane & size) == 0);
      const bool mine_better = better(s, p, os, op);
      if (keep_better != mine_better) {
        s = os;
        p = op;
      }
    }
  }
}


// Merges the warp's sorted batch (lanes 0 .. n - 1, best first; n >= 1, each
// better than the list's k-th) into the sorted list ls/li of length k, in
// place: every entry's rank in the union is its index plus the count of
// better entries in the other list (valid entries are distinct, so the
// ranks are a permutation); entries ranked k or more drop out. The list
// before the batch's best entry stays; the batch ranks are taken against
// the list as it was; list entries only move to higher slots, so groups of
// 32 move highest first, each read before it is written. bs/bp: 32 slots
// of shared memory for the batch.
__device__ void merge_batch(float* ls, int* li, int k, float s, int p, int n,
                            float* bs, int* bp, int lane) {
  bs[lane] = s;
  bp[lane] = p;
  __syncwarp();
  const int rb = lane < n ? lane + count_better(ls, li, k, s, p) : k;
  const int start = __shfl_sync(kFull, rb, 0);
  for (int base = ((k - 1) / 32) * 32; base >= start - 31 && base >= 0;
       base -= 32) {
    const int i = base + lane;
    float vs = 0.f;
    int vi = 0, r = k;
    if (i >= start && i < k) {
      vs = ls[i];
      vi = li[i];
      r = i + count_better(bs, bp, n, vs, vi);
    }
    __syncwarp();
    if (r < k) {
      ls[r] = vs;
      li[r] = vi;
    }
    __syncwarp();
  }
  if (rb < k) {
    ls[rb] = s;
    li[rb] = p;
  }
  __syncwarp();
}

// Folds one chunk's scores of one query (scq, 256) into its list, by one
// warp. The scoring warps marked the rows whose score beat the list's k-th
// as they read it (mq, a word per scoring warp's 32 rows); the marked rows
// that still beat it are gathered in order, their scores into the front of
// scq (in place: a row's slot never lies past its own) and their row
// indices into gi (256 bytes), then go in batches of 32: one or two are
// inserted one at a time, more are sorted and merged (bs/bp: the warp's 32
// batch slots).
__device__ void fold_chunk(float* l_s, int* l_i, int k, float* scq,
                           const uint32_t* mq, int chunk, uint8_t* gi,
                           float* bs, int* bp, int lane) {
  const uint4 m0 = reinterpret_cast<const uint4*>(mq)[0];
  const uint4 m1 = reinterpret_cast<const uint4*>(mq)[1];
  if (!(m0.x | m0.y | m0.z | m0.w | m1.x | m1.y | m1.z | m1.w)) return;
  const uint32_t ms[kWarps] = {m0.x, m0.y, m0.z, m0.w,
                               m1.x, m1.y, m1.z, m1.w};
  // a row of this chunk lies past every row in the list, so it beats the
  // k-th exactly when its score is greater
  const float ts = l_s[k - 1];
  int n = 0;
#pragma unroll
  for (int g = 0; g < kWarps; ++g) {
    if (!ms[g]) continue;
    const float s = scq[32 * g + lane];
    const bool pass = ((ms[g] >> lane) & 1) && s > ts;
    const uint32_t bits = __ballot_sync(kFull, pass);
    __syncwarp();
    if (pass) {
      const int at = n + __popc(bits & ((1u << lane) - 1));
      scq[at] = s;
      gi[at] = (uint8_t)(32 * g + lane);
    }
    n += __popc(bits);
  }
  __syncwarp();
  for (int b0 = 0; b0 < n; b0 += 32) {
    float t_s = l_s[k - 1];
    int t_p = l_i[k - 1];
    const int i = b0 + lane;
    const float s = i < n ? scq[i] : neg_inf();
    const int p = i < n ? chunk + gi[i] : -1;
    const bool pass = i < n && better(s, p, t_s, t_p);
    uint32_t bits = __ballot_sync(kFull, pass);
    const int c = __popc(bits);
    if (c == 0) continue;
    if (c <= 2) {
      while (bits) {
        const int src = __ffs(bits) - 1;
        bits &= bits - 1;
        const float vs = __shfl_sync(kFull, s, src);
        const int vp = __shfl_sync(kFull, p, src);
        if (better(vs, vp, t_s, t_p)) {
          warp_insert(l_s, l_i, k, vs, vp, lane);
          t_s = l_s[k - 1];
          t_p = l_i[k - 1];
        }
      }
      continue;
    }
    float vs = pass ? s : neg_inf();
    int vp = pass ? p : -1;
    warp_sort32(vs, vp, lane);
    merge_batch(l_s, l_i, k, vs, vp, c, bs, bp, lane);
  }
}

template <int QB>
__global__ void __launch_bounds__(PqWarps<QB>::kThreads, 2)
pq_pass1(const int8_t* __restrict__ codes, const float* __restrict__ table,
         const int8_t* __restrict__ mask, int n, int groups, int b, int k,
         int num_valid, int rows_per_slice, float* __restrict__ cand_s,
         int* __restrict__ cand_i, int num_slices) {
  using Tbl = PqTable<QB>;
  using W = PqWarps<QB>;
  constexpr int kBufs = W::kBufs;
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kPqStages = W::kStages;
  const PqSmem at(Tbl::bytes(groups), QB, kPqStages, kBufs, W::kFolders,
                  groups, k);
  unsigned char* ring = smem + at.ring;
  uint32_t* tbl = reinterpret_cast<uint32_t*>(smem + at.table);
  float* sc = reinterpret_cast<float*>(smem + at.sc);
  uint32_t* masks = reinterpret_cast<uint32_t*>(smem + at.masks);
  float* ls = reinterpret_cast<float*>(smem + at.ls);
  int* li = reinterpret_cast<int*>(smem + at.li);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + at.bars);
  uint64_t* empty = full + kPqStages;
  uint64_t* ready = empty + kPqStages;      // scores of a buffer written
  uint64_t* freed = ready + kBufs;          // and folded

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * QB;
  const int slice = blockIdx.y;
  const int row_begin = slice * rows_per_slice;
  const int row_end = min(n, row_begin + rows_per_slice);
  const int valid_end = min(row_end, num_valid);
  const int nchunks = (row_end - row_begin + kChunk - 1) / kChunk;
  const int stage_bytes = kChunk * groups;

  if (tid == 0) {
    for (int s = 0; s < kPqStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kWarps);
    }
    for (int s = 0; s < kBufs; ++s) {
      hopper::mbar_init(&ready[s], kWarps);
      hopper::mbar_init(&freed[s], W::kFolders);
    }
    hopper::fence_barrier_init();
  }
  // the query block's table, laid out query-minor; zeros past b
  const int per = 2 * groups * kCodes;
  for (int i = tid; i < Tbl::kWords * per; i += W::kThreads) {
    const int jp = i / per, e = i % per, r = e / kCodes, c = e % kCodes;
    tbl[Tbl::index(r, r < groups ? c : c ^ 8, jp)] =
        Tbl::word(table, per, b, q0, jp, e);
  }
  for (int i = tid; i < QB * k; i += W::kThreads) {
    ls[i] = neg_inf();
    li[i] = -1;
  }
  __syncthreads();

  if (warp == W::kProducer) {
    if (lane == 0) {
      for (int it = 0; it < nchunks; ++it) {
        const int s = it % kPqStages;
        if (it >= kPqStages)
          hopper::mbar_wait(&empty[s], ((it / kPqStages) - 1) & 1);
        const int r0 = row_begin + it * kChunk;
        const uint32_t bytes = (uint32_t)min(kChunk, row_end - r0) * groups;
        const uint32_t bulk = bytes & ~15u;
        unsigned char* dst = ring + (size_t)s * stage_bytes;
        const int8_t* src = codes + (size_t)r0 * groups;
        for (uint32_t i = bulk; i < bytes; i += 4)   // the ragged tail
          *reinterpret_cast<uint32_t*>(dst + i) =
              __ldg(reinterpret_cast<const uint32_t*>(src + i));
        hopper::mbar_expect_tx(&full[s], bulk);
        if (bulk) hopper::bulk_load(dst, src, bulk, &full[s]);
      }
    }
    return;
  }

  // folding: chunk `it`'s queries qi = f, f + folders, ... of this warp,
  // once every scoring warp has written them; then the buffer is freed
  const int f = W::kFoldWarp ? 0 : warp;
  unsigned char* own = smem + at.gather + (size_t)kFoldBytes * f;
  uint8_t* gi = own;
  float* bs = reinterpret_cast<float*>(own + kChunk);
  int* bp = reinterpret_cast<int*>(own + kChunk + 32 * 4);
  auto fold = [&](int it) {
    const int sb = it % kBufs;
    hopper::mbar_wait(&ready[sb], (it / kBufs) & 1);
    float* buf = sc + sb * QB * kChunk;
    const uint32_t* mbuf = masks + sb * QB * kWarps;
    for (int qi = f; qi < QB && q0 + qi < b; qi += W::kFolders)
      fold_chunk(ls + qi * k, li + qi * k, k, buf + qi * kChunk,
                 mbuf + qi * kWarps, row_begin + it * kChunk, gi, bs, bp,
                 lane);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&freed[sb]);
  };
  auto write_lists = [&]() {
    for (int qi = f; qi < QB && q0 + qi < b; qi += W::kFolders) {
      const size_t o = ((size_t)(q0 + qi) * num_slices + slice) * k;
      for (int i = lane; i < k; i += 32) {
        cand_s[o + i] = ls[qi * k + i];
        cand_i[o + i] = li[qi * k + i];
      }
    }
  };

  if (W::kFoldWarp && warp == kWarps) {       // the fold warp (QB = 1)
    for (int it = 0; it < nchunks; ++it) fold(it);
    write_lists();
    return;
  }

  // the scoring warps: one row of each chunk a thread
  for (int it = 0; it < nchunks; ++it) {
    const int s = it % kPqStages;
    const int sb = it % kBufs;
    const int chunk = row_begin + it * kChunk;
    const int row = chunk + tid;
    const bool ok = row < valid_end && (mask == nullptr || mask[row] > 0);
    float s_lo[QB], s_hi[QB];
#pragma unroll
    for (int j = 0; j < QB; ++j) s_lo[j] = s_hi[j] = 0.f;
    hopper::mbar_wait(&full[s], (it / kPqStages) & 1);
    if (ok) {
      const unsigned char* p = ring + (size_t)s * stage_bytes +
                               (size_t)tid * groups;
      // at B = 1 over M = 64 every table address is a constant offset
      // from the nibble's, with no addition a lookup
      if constexpr (QB == 1) {
        if (groups == 32)
          score_row<QB, 32>(s_lo, s_hi, smem + at.table, p, groups);
        else
          score_row<QB, 0>(s_lo, s_hi, smem + at.table, p, groups);
      } else {
        score_row<QB, 0>(s_lo, s_hi, smem + at.table, p, groups);
      }
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
    if (it >= kBufs) hopper::mbar_wait(&freed[sb], ((it / kBufs) - 1) & 1);

    // the scores, and which of them beat their query's k-th: a row of this
    // chunk lies past every row in the lists, so only a greater score can
    // (ties go to the lower position). The k-th only rises, so reading it
    // while a list is folded into lets through more, not less.
    float* buf = sc + sb * QB * kChunk;
    uint32_t* mbuf = masks + sb * QB * kWarps;
#pragma unroll
    for (int j = 0; j < QB; ++j) {
      const float v = ok ? s_lo[j] + s_hi[j] : neg_inf();
      buf[j * kChunk + tid] = v;
      const uint32_t m = __ballot_sync(kFull, v > ls[j * k + k - 1]);
      if (lane == 0) mbuf[j * kWarps + warp] = m;
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&ready[sb]);
    if (!W::kFoldWarp && it > 0) fold(it - 1);      // a chunk behind
  }
  if (!W::kFoldWarp) {
    if (nchunks > 0) fold(nchunks - 1);
    write_lists();
  }
}

template <int QB>
size_t pass1_bytes(int groups, int k) {
  using W = PqWarps<QB>;
  return PqSmem(PqTable<QB>::bytes(groups), QB, W::kStages, W::kBufs,
                W::kFolders, groups, k).total;
}

template <int QB>
cudaError_t launch_pq_pass1(const void* codes, const void* table,
                            const void* mask, int n, int groups, int b, int k,
                            int num_valid, int rows_per_slice, int num_slices,
                            void* cand_s, void* cand_i, cudaStream_t stream) {
  const size_t smem = pass1_bytes<QB>(groups, k);
  cudaError_t err = cudaFuncSetAttribute(
      pq_pass1<QB>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((b + QB - 1) / QB, num_slices);
  pq_pass1<QB><<<grid, PqWarps<QB>::kThreads, smem, stream>>>(
      static_cast<const int8_t*>(codes), static_cast<const float*>(table),
      static_cast<const int8_t*>(mask), n, groups, b, k, num_valid,
      rows_per_slice, static_cast<float*>(cand_s), static_cast<int*>(cand_i),
      num_slices);
  return cudaGetLastError();
}

#define ISF_PQ_QBS(X) X(1) X(2) X(4) X(8) X(16)

}  // namespace

extern "C" {

// Shared memory pass 1 needs for a query block of qb (1, 2, 4, 8 or 16)
// over codes of `groups` bytes a row; -1 for another qb. The wrapper sizes
// qb with it.
long long isf_pq_pass1_smem(int qb, int groups, int k) {
#define ISF_CASE(QB) \
  if (qb == QB) return (long long)pass1_bytes<QB>(groups, k);
  ISF_PQ_QBS(ISF_CASE)
#undef ISF_CASE
  return -1;
}

// The launch sequence's first kernel alone: q [b, d] f32 and centroids
// [m, 16, d / m] f32 -> table [b, 2 groups, 16] f32. Returns the CUDA error
// code (0 = launched).
int isf_pq_table(const void* q, const void* centroids, void* table, int b,
                 int d, int m, int groups, void* stream_ptr) {
  if (b <= 0 || m <= 0 || m % 2 || d % m || m / 2 > groups)
    return (int)cudaErrorInvalidValue;
  return (int)launch_table(q, centroids, table, b, d, m, groups,
                           static_cast<cudaStream_t>(stream_ptr));
}

// codes: [n, groups] int8, 16-byte aligned, groups % 4 == 0 and >= m / 2;
// q [b, d] f32; centroids [m, 16, d / m] f32; table: scratch of b * 2 *
// groups * 16 floats; mask may be null. cand_s/cand_i hold b * num_slices
// * k entries. Launches the table, pass 1 and pass 2 on the stream; returns
// the CUDA error code (0 = launched).
int isf_pq_topk(const void* codes, const void* q, const void* centroids,
                void* table, const void* mask, void* out_s, void* out_i,
                void* cand_s, void* cand_i, int n, int groups, int b, int d,
                int m, int k, int num_valid, int qb, int rows_per_slice,
                int num_slices, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (bad_plan(n, groups, b, k, rows_per_slice, num_slices) || groups % 4)
    return (int)cudaErrorInvalidValue;
  int err = isf_pq_table(q, centroids, table, b, d, m, groups, stream);
  if (err) return err;
  cudaError_t e = cudaErrorInvalidValue;
#define ISF_CASE(QB)                                                      \
  if (qb == QB)                                                           \
    e = launch_pq_pass1<QB>(codes, table, mask, n, groups, b, k,          \
                            num_valid, rows_per_slice, num_slices, cand_s, \
                            cand_i, stream);
  ISF_PQ_QBS(ISF_CASE)
#undef ISF_CASE
  if (e != cudaSuccess) return (int)e;
  return (int)launch_pass2(cand_s, cand_i, out_s, out_i, b, k, num_slices,
                           stream);
}

}  // extern "C"
