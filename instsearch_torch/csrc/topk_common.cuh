// Split-N fused top-k, shared by the port's top-k kernels (K1 topk_matmul,
// K2 topk_matmul_int8, K3 topk_matmul_int4, K4 pq_topk): the selection
// code and pass 2 for all four, and the FMA pass 1, templated on how a row
// is scored, for K1's f32 store (the bf16, int8 and int4 stores take the
// TMA + wgmma pass 1 of topk_wgmma.cuh, K4 its own pass 1 in pq_scan.cu).
//
// Pass 1: block (qblock, slice) scores rows [slice * rows_per_slice, ...)
// against queries [qblock * QB, ...) and keeps each query's top-k of its
// slice in shared memory. Pass 2 merges the num_slices * k candidates per
// query. The TPU kernels carry one running top-k across a sequential grid;
// Hopper runs blocks in parallel, hence the split. How a row is scored is a
// policy class (the `Rows` template argument of topk_pass1):
//
//   using Acc = ...;                   accumulator type (float or int)
//   __host__ __device__ static size_t query_bytes(int qb, int d);
//                                      shared memory of a block of qb
//                                      queries, a multiple of 16
//   int vecs() const;                  16-byte vectors per stored row
//   uint4 load(int row, int v) const;  vector v of a stored row
//   void load_query(char* qsm, int qb, int q0, int b, int tid, int lane,
//                   int warp) const;   fill the query block
//   template <int QB, int R>
//   void accumulate(Acc (&acc)[R][QB], const uint4 (&raw)[R],
//                   const char* qsm, int v) const;
//                                      add vector v of R rows to the QB
//                                      queries' per-lane partial sums
//   template <int QB>
//   float score(Acc tot, int qi, int row, const char* qsm) const;
//                                      the reduced sum -> the row's score
//                                      for block query qi
//
// Ranking rules, the TPU kernels' own: (score desc, position asc); rows at
// or past num_valid, or whose mask entry is not > 0, never enter; slots
// past the count of valid rows come back as (-inf, -1).
//
// Everything here has internal linkage: each source that includes it gets
// its own copy of the kernels.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                    // pass 1: warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 256;                  // rows scored per selection round
constexpr int kRowsInFlight = 8;             // rows a warp scores together
constexpr int kMergeMaxWarps = 32;           // pass 2: warps per query
constexpr int kMergeSmem = 96 * 1024;        // pass 2: bytes of lists a block keeps
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr size_t align16(size_t v) {
  return (v + 15) / 16 * 16;
}

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ bool better(float s1, int p1, float s2, int p2) {
  // (score desc, position asc); NaN never wins
  return s1 > s2 || (s1 == s2 && p1 < p2);
}

// Insert (s, p) into the sorted list ls/li of length k; the caller has
// checked that it beats ls[k-1]. Warp-cooperative; lists live in shared
// memory and are private to the calling warp.
__device__ void warp_insert(float* ls, int* li, int k, float s, int p,
                            int lane) {
  int rank = 0;
  for (int base = 0; base < k; base += 32) {
    const int i = base + lane;
    const bool b = i < k && better(ls[i], li[i], s, p);
    rank += __popc(__ballot_sync(kFull, b));
  }
  // shift [rank, k - 1) up by one slot, the highest group of 32 first, so a
  // group reads its left neighbour before that neighbour is overwritten
  const int lo = (rank / 32) * 32;
  for (int base = ((k - 1) / 32) * 32; base >= lo; base -= 32) {
    const int i = base + lane;
    const bool mv = i > rank && i < k;
    float vs = 0.f;
    int vi = 0;
    if (mv) {
      vs = ls[i - 1];
      vi = li[i - 1];
    }
    __syncwarp();
    if (mv) {
      ls[i] = vs;
      li[i] = vi;
    }
    __syncwarp();
  }
  if (lane == 0) {
    ls[rank] = s;
    li[rank] = p;
  }
  __syncwarp();
}

// Number of entries of the sorted list ls/li (length k) that are better
// than (s, p): they form a prefix, found by binary search.
__device__ __forceinline__ int count_better(const float* ls, const int* li,
                                            int k, float s, int p) {
  int lo = 0, hi = k;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (better(ls[mid], li[mid], s, p))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// a <- top k of the sorted lists a and b (each of length k, in shared
// memory; c is scratch of the same size). Every element's rank in the
// union is its index plus the count of better elements in the other list;
// valid entries are distinct (row positions are unique), so the ranks of
// valid entries are a permutation, and the (-inf, -1) fillers land past
// them. Warp-cooperative.
__device__ void warp_merge(float* a_s, int* a_i, const float* b_s,
                           const int* b_i, float* c_s, int* c_i, int k,
                           int lane) {
  for (int i = lane; i < k; i += 32) {
    const int r = i + count_better(b_s, b_i, k, a_s[i], a_i[i]);
    if (r < k) {
      c_s[r] = a_s[i];
      c_i[r] = a_i[i];
    }
  }
  for (int j = lane; j < k; j += 32) {
    const int r = j + count_better(a_s, a_i, k, b_s[j], b_i[j]);
    if (r < k) {
      c_s[r] = b_s[j];
      c_i[r] = b_i[j];
    }
  }
  __syncwarp();
  for (int i = lane; i < k; i += 32) {
    a_s[i] = c_s[i];
    a_i[i] = c_i[i];
  }
  __syncwarp();
}

__host__ __device__ constexpr int log2_of(int v) {
  return v <= 1 ? 0 : 1 + log2_of(v / 2);
}

// Reduce v[0..QB) over the 32 lanes; returns, on every lane, the total for
// query lane / (32 / QB). A reduce-scatter: QB shuffles per row instead of
// 5 * QB.
template <typename A, int QB>
__device__ __forceinline__ A warp_reduce_scatter(A (&v)[QB], int lane) {
  // a constant trip count, so the loop unrolls and v stays in registers
  constexpr int kSteps = log2_of(QB);
#pragma unroll
  for (int st = 0; st < kSteps; ++st) {
    const int w = QB >> (st + 1);
    const int bit = 16 >> st;
    const bool upper = (lane & bit) != 0;
#pragma unroll
    for (int i = 0; i < w; ++i) {
      const A send = upper ? v[i] : v[i + w];
      const A keep = upper ? v[i + w] : v[i];
      v[i] = keep + __shfl_xor_sync(kFull, send, bit);
    }
  }
  A s = v[0];
#pragma unroll
  for (int off = 16 / QB; off >= 1; off >>= 1)
    s += __shfl_xor_sync(kFull, s, off);
  return s;
}

template <class Rows>
size_t pass1_smem(int qb, int d, int k) {
  return Rows::query_bytes(qb, d) + sizeof(float) * (size_t)qb * kChunk +
         (sizeof(float) + sizeof(int)) * (size_t)qb * k;
}

// Scoring of one chunk with a warp per row (K1's f32 store): each warp scores
// kRowsInFlight rows at a time, its lanes over the rows' 16-byte vectors,
// then reduces across lanes; sc[qi * kChunk + r] <- row chunk + r's score.
template <class Rows, int QB>
__device__ __forceinline__ void score_chunk_by_warps(
    const Rows& rows, const int8_t* __restrict__ mask, int chunk,
    int valid_end, const char* qsm, float* sc, int lane, int warp) {
  constexpr int kRowsPerWarp = kChunk / kWarps;
  constexpr int kGroup = 32 / QB;                      // lanes per query
  using Acc = typename Rows::Acc;
  const int nvec = rows.vecs();
  for (int g = 0; g < kRowsPerWarp; g += kRowsInFlight) {
    const int r0 = chunk + warp * kRowsPerWarp + g;
    Acc acc[kRowsInFlight][QB];
#pragma unroll
    for (int r = 0; r < kRowsInFlight; ++r)
#pragma unroll
      for (int j = 0; j < QB; ++j) acc[r][j] = Acc(0);
    if (r0 < valid_end) {
      for (int v = lane; v < nvec; v += 32) {
        uint4 raw[kRowsInFlight];
#pragma unroll
        for (int r = 0; r < kRowsInFlight; ++r) {
          const int row = r0 + r;
          raw[r] = row < valid_end ? rows.load(row, v)
                                   : make_uint4(0, 0, 0, 0);
        }
        rows.template accumulate<QB, kRowsInFlight>(acc, raw, qsm, v);
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsInFlight; ++r) {
      const Acc tot = warp_reduce_scatter<Acc, QB>(acc[r], lane);
      const int row = r0 + r;
      if ((lane % kGroup) == 0) {
        const int qi = lane / kGroup;
        const bool ok = row < valid_end && (mask == nullptr || mask[row] > 0);
        sc[qi * kChunk + (row - chunk)] =
            ok ? rows.template score<QB>(tot, qi, row, qsm) : neg_inf();
      }
    }
  }
}

template <class Rows, int QB>
__global__ void __launch_bounds__(kThreads)
topk_pass1(const Rows rows, const int8_t* __restrict__ mask, int n, int d,
           int b, int k, int num_valid, int rows_per_slice, int num_slices,
           float* __restrict__ cand_s, int* __restrict__ cand_i) {
  extern __shared__ float4 smem4[];
  char* qsm = reinterpret_cast<char*>(smem4);             // query block
  float* sc = reinterpret_cast<float*>(qsm + Rows::query_bytes(QB, d));
  float* ls = sc + QB * kChunk;                           // [QB, k]
  int* li = reinterpret_cast<int*>(ls + QB * k);          // [QB, k]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * QB;
  const int slice = blockIdx.y;

  rows.load_query(qsm, QB, q0, b, tid, lane, warp);
  for (int i = tid; i < QB * k; i += kThreads) {
    ls[i] = neg_inf();
    li[i] = -1;
  }
  __syncthreads();

  const int row_begin = slice * rows_per_slice;
  const int row_end = min(n, row_begin + rows_per_slice);
  const int valid_end = min(row_end, num_valid);

  for (int chunk = row_begin; chunk < row_end; chunk += kChunk) {
    // ---- score kChunk rows into sc -----------------------------------
    score_chunk_by_warps<Rows, QB>(rows, mask, chunk, valid_end, qsm, sc,
                                   lane, warp);
    __syncthreads();

    // ---- fold the chunk into each query's running list -----------------
    for (int qi = warp; qi < QB && q0 + qi < b; qi += kWarps) {
      float* l_s = ls + qi * k;
      int* l_i = li + qi * k;
      float ts = l_s[k - 1];
      int tp = l_i[k - 1];
      for (int j0 = 0; j0 < kChunk; j0 += 32) {
        const float s = sc[qi * kChunk + j0 + lane];
        const int p = chunk + j0 + lane;
        unsigned m = __ballot_sync(kFull, better(s, p, ts, tp));
        while (m) {
          const int src = __ffs(m) - 1;
          m &= m - 1;
          const float cs = __shfl_sync(kFull, s, src);
          const int cp = __shfl_sync(kFull, p, src);
          if (better(cs, cp, ts, tp)) {
            warp_insert(l_s, l_i, k, cs, cp, lane);
            ts = l_s[k - 1];
            tp = l_i[k - 1];
          }
        }
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < QB * k; i += kThreads) {
    const int qi = i / k;
    if (q0 + qi < b) {
      const size_t o = ((size_t)(q0 + qi) * num_slices + slice) * k + i % k;
      cand_s[o] = ls[i];
      cand_i[o] = li[i];
    }
  }
}

// Pass 2: one block per query. Warp w merges the sorted lists of slices
// w, w + W, ... into its own list (slices whose best entry cannot beat the
// list's k-th are skipped), then the warps' lists merge pairwise in a tree.
__global__ void __launch_bounds__(kMergeMaxWarps * 32)
topk_pass2(const float* __restrict__ cand_s, const int* __restrict__ cand_i,
           int k, int num_slices, float* __restrict__ out_s,
           int* __restrict__ out_i) {
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int qi = blockIdx.x;
  // per warp: list a, incoming list b, scratch c; each k scores + k ids
  float* base = reinterpret_cast<float*>(smem4) + (size_t)warp * 6 * k;
  float* a_s = base;
  int* a_i = reinterpret_cast<int*>(base + k);
  float* b_s = base + 2 * k;
  int* b_i = reinterpret_cast<int*>(base + 3 * k);
  float* c_s = base + 4 * k;
  int* c_i = reinterpret_cast<int*>(base + 5 * k);
  for (int i = lane; i < k; i += 32) {
    a_s[i] = neg_inf();
    a_i[i] = -1;
  }
  __syncwarp();
  for (int sl = warp; sl < num_slices; sl += nwarps) {
    const size_t g = ((size_t)qi * num_slices + sl) * k;
    if (!better(cand_s[g], cand_i[g], a_s[k - 1], a_i[k - 1])) continue;
    for (int j = lane; j < k; j += 32) {
      b_s[j] = cand_s[g + j];
      b_i[j] = cand_i[g + j];
    }
    __syncwarp();
    warp_merge(a_s, a_i, b_s, b_i, c_s, c_i, k, lane);
  }
  for (int step = 1; step < nwarps; step *= 2) {
    __syncthreads();
    if (warp % (2 * step) == 0 && warp + step < nwarps) {
      const float* o_s = a_s + (size_t)step * 6 * k;
      const int* o_i = reinterpret_cast<const int*>(o_s + k);
      if (better(o_s[0], o_i[0], a_s[k - 1], a_i[k - 1]))
        warp_merge(a_s, a_i, o_s, o_i, c_s, c_i, k, lane);
    }
  }
  if (warp == 0) {
    for (int i = lane; i < k; i += 32) {
      out_s[(size_t)qi * k + i] = a_s[i];
      out_i[(size_t)qi * k + i] = a_i[i];
    }
  }
}

template <class Rows, int QB>
cudaError_t launch_pass1(const Rows& rows, const void* mask, int n, int d,
                         int b, int k, int num_valid, int rows_per_slice,
                         int num_slices, void* cand_s, void* cand_i,
                         cudaStream_t stream) {
  const size_t smem = pass1_smem<Rows>(QB, d, k);
  cudaError_t err = cudaFuncSetAttribute(
      topk_pass1<Rows, QB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((b + QB - 1) / QB, num_slices);
  topk_pass1<Rows, QB><<<grid, kThreads, smem, stream>>>(
      rows, static_cast<const int8_t*>(mask), n, d, b, k, num_valid,
      rows_per_slice, num_slices, static_cast<float*>(cand_s),
      static_cast<int*>(cand_i));
  return cudaGetLastError();
}

// Pass 1 for a query block of qb (1, 2, 4 or 8) rows.
template <class Rows>
cudaError_t dispatch_qb(int qb, const Rows& rows, const void* mask, int n,
                        int d, int b, int k, int num_valid,
                        int rows_per_slice, int num_slices, void* cand_s,
                        void* cand_i, cudaStream_t stream) {
#define ISF_QB_CASE(QB)                                                     \
  case QB:                                                                  \
    return launch_pass1<Rows, QB>(rows, mask, n, d, b, k, num_valid,        \
                                  rows_per_slice, num_slices, cand_s,       \
                                  cand_i, stream);
  switch (qb) {
    ISF_QB_CASE(1)
    ISF_QB_CASE(2)
    ISF_QB_CASE(4)
    ISF_QB_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef ISF_QB_CASE
}

bool bad_plan(int n, int d, int b, int k, int rows_per_slice,
              int num_slices) {
  return n <= 0 || b <= 0 || k <= 0 || d <= 0 || num_slices <= 0 ||
         rows_per_slice <= 0 || rows_per_slice % kChunk != 0;
}

cudaError_t launch_pass2(const void* cand_s, const void* cand_i, void* out_s,
                         void* out_i, int b, int k, int num_slices,
                         cudaStream_t stream) {
  int nwarps = kMergeSmem / (6 * k * (int)sizeof(float));
  nwarps = nwarps < kMergeMaxWarps ? nwarps : kMergeMaxWarps;
  nwarps = nwarps < num_slices ? nwarps : num_slices;
  nwarps = nwarps > 1 ? nwarps : 1;
  const size_t smem2 = (size_t)nwarps * 6 * k * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      topk_pass2, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem2);
  if (err != cudaSuccess) return err;
  topk_pass2<<<b, nwarps * 32, smem2, stream>>>(
      static_cast<const float*>(cand_s), static_cast<const int*>(cand_i), k,
      num_slices, static_cast<float*>(out_s), static_cast<int*>(out_i));
  return cudaGetLastError();
}

}  // namespace
