// The tensor-core pass 1 of K2/K3's int8 and packed int4 row stores
// (topk_matmul_int.cu), templated on how a row tile is scored. The
// selection rules, the candidate layout and pass 2 are topk_common.cuh's;
// the PTX wrappers are warp_mma.cuh's.
//
// Block (query block, slice). The block stages its query block (QB of 8 to
// 128 queries; queries past b are zero rows) once in shared memory and
// streams its slice through a ring of S stages of R rows x 128 bytes, filled
// with cp.async (16 bytes a thread, .cg, zero-filled past the valid rows and
// past the row's bytes). A row stride of 144 bytes keeps ldmatrix free of
// bank conflicts without a swizzle. Warp w scores rows 16 (w % WR) .. + 15
// of each R-row tile against queries QW (w / WR) .. + QW - 1 of the block by
// mma.sync, A the row tile and B the query rows as they lie, both by
// ldmatrix, and keeps the lists of queries w, w + kWarps, ... (in its
// registers for k <= kRegListMax, entry l in lane l; in shared memory
// above).
//
// The ldmatrix.x4 A fragment of a 16-row x 32-byte tile is the A fragment
// of m16n8k32 in int8 for either store, and so are the B and C fragments
// (warp_mma.cuh), so the ring, the fragment loads, the threshold check and
// the fold are byte for byte the same for both; a tile policy (the `Tile`
// template argument) supplies the rest:
//
//   using Acc = ...;                  C fragment type (float or int)
//   __host__ __device__ static int row_bytes(int d);
//                                     bytes of a stored row of width d
//   __host__ __device__ static int query_stride(int d);
//                                     bytes of a staged query row: 16 past
//                                     a multiple of 128, so ldmatrix's 8
//                                     rows hit 8 distinct bank groups
//   const char* rows() const;         the store, row r at r * row_bytes(d)
//   __host__ __device__ static size_t query_bytes(int qb, int d);
//                                     the staged query block, a multiple
//                                     of 16 (the rows, then what score
//                                     reads per query)
//   void load_query(char* qs, int qb, int q0, int b, int d, int tid) const;
//                                     stage queries q0 .. q0 + qb - 1, zero
//                                     columns past d and rows past b
//   template <int NT>
//   void products(Acc (&acc)[NT][4], const uint32_t (&a)[4],
//                 const char* qp, int qstride, int d, int lane) const;
//                                     one 32-byte k-step of a 16-row tile:
//                                     a is its A fragment, qp the B operand
//                                     (the warp's first query at the
//                                     k-step's byte column)
//   void row_scales(float (&rs)[2], int row, int valid_end) const;
//                                     per-row factors of rows row, row + 8,
//                                     loaded at a tile's first chunk
//   struct Factor; Factor factor(int qi, const char* qmeta) const;
//   float score(Acc v, const Factor& f, float rs) const;
//                                     a C fragment entry -> the row's score
//
// Selection, after a tile's last column chunk: within a slice the rows come
// in ascending position, so a row of this tile can beat a list's k-th entry
// (an earlier row) only by a greater score; each score is compared with its
// query's threshold while it is still in its C fragment, and only the ones
// that pass are written, -inf for the rest. Then each warp scans its own
// queries' scores with a ballot per 32 and inserts the ones that still beat
// the list, with the full (score, position) order. Exact integer sums tie
// exactly, and the rule holds for ties too.
//
// Everything here has internal linkage.

#pragma once

#include "topk_common.cuh"
#include "warp_mma.cuh"

namespace {

constexpr int kMmaBytes = 128;               // bytes of a staged row chunk
constexpr int kMmaStride = kMmaBytes + 16;   // its row stride: 144 bytes

// The block's plan for a query block of qb: kWarps warps as mma_warps_q(qb)
// groups across the queries times the rest across the rows, 16 rows a warp.
__host__ __device__ constexpr int mma_warps_q(int qb) {
  return qb == 128 ? 2 : 1;
}
__host__ __device__ constexpr int mma_rows(int qb) {   // R, rows a tile
  return 16 * (kWarps / mma_warps_q(qb));
}
__host__ __device__ constexpr int mma_stages(int qb) { // ring of R x 128 B
  return mma_rows(qb) == 64 ? 4 : 3;
}
__host__ __device__ constexpr int mma_sc_stride(int qb) {
  // a query's row of passing scores; +4 so the C fragments' stores (queries
  // 2 apart, rows 1 apart) fall in distinct banks
  return mma_rows(qb) + 4;
}

constexpr int kRegListMax = 32;   // k up to this: a warp's lists live in
                                  // its registers, entry l in lane l

// Shared memory of topk_pass1_mma: the staged query block, the stage ring,
// the passing scores [qb][R + 4] f32, each query's threshold (the score of
// its list's k-th entry) and, for k > kRegListMax, the lists [qb][k]
// (scores, then positions).
template <class Tile>
size_t mma_smem(int qb, int d, int k) {
  return Tile::query_bytes(qb, d) +
         (size_t)mma_stages(qb) * mma_rows(qb) * kMmaStride +
         sizeof(float) * qb * mma_sc_stride(qb) + sizeof(float) * qb +
         (k > kRegListMax ? (sizeof(float) + sizeof(int)) * (size_t)qb * k
                          : 0);
}

// Stage qb query rows of row_bytes each (a multiple of 16) from q into qs at
// qstride, qcols bytes a row: zeros past row_bytes and for queries past b.
__device__ __forceinline__ void stage_query_rows(char* qs, const char* q,
                                                 int row_bytes, int qstride,
                                                 int qcols, int qb, int q0,
                                                 int b, int tid) {
  const int qvecs = qcols / 16;
  for (int i = tid; i < qb * qvecs; i += kThreads) {
    const int qi = i / qvecs;
    const int col = (i % qvecs) * 16;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + qi < b && col < row_bytes)
      v = __ldg(reinterpret_cast<const uint4*>(
          q + (size_t)(q0 + qi) * row_bytes + col));
    *reinterpret_cast<uint4*>(qs + (size_t)qi * qstride + col) = v;
  }
}

// The B fragments of a warp's NT n-tiles of 8 queries at one k-step, qp at
// its first query: f(j, b0, b1) for each n-tile j, two n-tiles an ldmatrix.
template <int NT, class F>
__device__ __forceinline__ void for_b_fragments(const char* qp, int qstride,
                                                int lane, F&& f) {
  if constexpr (NT == 1) {
    uint32_t bq[4];
    ldmatrix_x2(bq, qp);
    f(0, bq[0], bq[1]);
  } else {
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t bq[4];
      ldmatrix_x4(bq, qp + (size_t)(8 * j + (lane >> 4) * 8) * qstride);
      f(j, bq[0], bq[1]);
      f(j + 1, bq[2], bq[3]);
    }
  }
}

// Insert (s, p) into a list held one entry a lane (entry l in lane l < k),
// which it beats: lanes past the rank take their left neighbour's entry.
__device__ __forceinline__ void reg_insert(float& ls, int& li, int k,
                                           float s, int p, int lane) {
  const int rank =
      __popc(__ballot_sync(kFull, lane < k && better(ls, li, s, p)));
  const float up_s = __shfl_up_sync(kFull, ls, 1);
  const int up_i = __shfl_up_sync(kFull, li, 1);
  if (lane == rank) {
    ls = s;
    li = p;
  } else if (lane > rank) {
    ls = up_s;
    li = up_i;
  }
}

// One block an SM at QB >= 64 (its shared memory), so up to 255 registers;
// two at QB <= 32.
template <class Tile, int QB, bool kRegLists>
__global__ void __launch_bounds__(kThreads, QB >= 64 ? 1 : 2)
topk_pass1_mma(const Tile tile, const int8_t* __restrict__ mask, int n,
               int d, int b, int k, int num_valid, int rows_per_slice,
               int num_slices, float* __restrict__ cand_s,
               int* __restrict__ cand_i) {
  using Acc = typename Tile::Acc;
  constexpr int WR = kWarps / mma_warps_q(QB);
  constexpr int R = mma_rows(QB);
  constexpr int S = mma_stages(QB);
  constexpr int SC = mma_sc_stride(QB);
  constexpr int QW = QB / mma_warps_q(QB);     // queries a warp scores
  constexpr int NT = QW / 8;                    // its n-tiles of 8 queries
  constexpr int OWN = (QB + kWarps - 1) / kWarps;   // queries a warp keeps
  static_assert(NT >= 1 && (NT == 1 || NT % 2 == 0), "query block");
  static_assert((R * kMmaBytes / 16) % kThreads == 0, "stage copy");

  extern __shared__ float4 smem4[];
  const int row_bytes = Tile::row_bytes(d);
  const int qstride = Tile::query_stride(d);
  char* qs = reinterpret_cast<char*>(smem4);            // [QB][qstride]
  const char* qmeta = qs + (size_t)QB * qstride;        // the policy's
  char* st = qs + Tile::query_bytes(QB, d);             // [S][R][kMmaStride]
  float* sc = reinterpret_cast<float*>(st + S * R * kMmaStride);  // [QB][SC]
  float* thr = sc + QB * SC;                            // [QB]
  float* ls = thr + QB;                                 // [QB][k], k > 32
  int* li = reinterpret_cast<int*>(ls + QB * k);        // [QB][k], k > 32

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2, c = 2 * (lane & 3);
  const int wrow = 16 * (warp % WR);           // the warp's rows in a tile
  const int wq = QW * (warp / WR);             // its first query
  const int q0 = blockIdx.x * QB;
  const int slice = blockIdx.y;

  tile.load_query(qs, QB, q0, b, d, tid);
  for (int i = tid; i < QB; i += kThreads) thr[i] = neg_inf();
  float rl_s[OWN];                             // register lists, kRegLists
  int rl_i[OWN];
#pragma unroll
  for (int u = 0; u < OWN; ++u) {
    rl_s[u] = neg_inf();
    rl_i[u] = -1;
  }
  if (!kRegLists) {
    for (int i = tid; i < QB * k; i += kThreads) {
      ls[i] = neg_inf();
      li[i] = -1;
    }
  }
  // a warp writes out lists that other warps initialized: a slice with no
  // valid rows goes from here straight to the write-out, which without
  // this barrier can read what an earlier block left in shared memory
  __syncthreads();

  const int row_begin = slice * rows_per_slice;
  const int row_end = min(n, row_begin + rows_per_slice);
  const int valid_end = min(row_end, num_valid);
  const int ntiles =
      valid_end > row_begin ? (valid_end - row_begin + R - 1) / R : 0;
  const int nchunks = (row_bytes + kMmaBytes - 1) / kMmaBytes;
  const int total = ntiles * nchunks;

  // step `it` = (tile it / nchunks, column chunk it % nchunks) into stage
  // it % S; rows at or past valid_end and bytes at or past row_bytes read
  // zeros
  auto load = [&](int it) {
    if (it < total) {
      const int r0 = row_begin + (it / nchunks) * R;
      const int c0 = (it % nchunks) * kMmaBytes;
      char* dst = st + (it % S) * R * kMmaStride;
#pragma unroll
      for (int j = 0; j < R * kMmaBytes / 16 / kThreads; ++j) {
        const int i = tid + j * kThreads;
        const int r = i >> 3;
        const int col = c0 + (i & 7) * 16;
        const bool ok = r0 + r < valid_end && col < row_bytes;
        const char* src = ok ? tile.rows() + (size_t)(r0 + r) * row_bytes +
                                   col
                             : tile.rows();
        cp_async16(dst + r * kMmaStride + (i & 7) * 16, src, ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };

  for (int s = 0; s < S - 1; ++s) load(s);
  Acc acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = Acc(0);
  float rs[2] = {0.f, 0.f};                    // the tile's row factors

  for (int it = 0; it < total; ++it) {
    cp_async_wait<S - 2>();
    __syncthreads();              // stage it % S is in; it - 1's is free
    load(it + S - 1);
    const char* stage = st + (it % S) * R * kMmaStride;
    const int chunk = it % nchunks;
    if (chunk == 0)
      tile.row_scales(rs, row_begin + (it / nchunks) * R + wrow + g,
                      valid_end);
#pragma unroll
    for (int kk = 0; kk < kMmaBytes; kk += 32) {
      uint32_t a[4];
      ldmatrix_x4(a, stage + (wrow + (lane & 15)) * kMmaStride + kk +
                         (lane >> 4) * 16);
      tile.template products<NT>(
          acc, a,
          qs + (wq + (lane & 7)) * qstride + chunk * kMmaBytes + kk +
              ((lane >> 3) & 1) * 16,
          qstride, d, lane);
    }
    if (chunk != nchunks - 1) continue;

    // ---- the tile's scores are complete: select ------------------------
    const int r0 = row_begin + (it / nchunks) * R;
    bool row_ok[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + wrow + g + 8 * h;
      row_ok[h] = row < valid_end && (mask == nullptr || mask[row] > 0);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qi = wq + 8 * j + c + e;
        const float t = thr[qi];
        const typename Tile::Factor f = tile.factor(qi, qmeta);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float s = tile.score(acc[j][2 * h + e], f, rs[h]);
          sc[qi * SC + wrow + g + 8 * h] =
              row_ok[h] && s > t ? s : neg_inf();
          acc[j][2 * h + e] = Acc(0);
        }
      }
    __syncthreads();
    // fold each of the warp's own queries' passing scores into its list
#pragma unroll
    for (int u = 0; u < OWN; ++u) {
      const int qi = warp + kWarps * u;
      if (qi >= QB || q0 + qi >= b) break;
      float* l_s = ls + qi * k;
      int* l_i = li + qi * k;
      float ts = kRegLists ? __shfl_sync(kFull, rl_s[u], k - 1) : l_s[k - 1];
      int tp = kRegLists ? __shfl_sync(kFull, rl_i[u], k - 1) : l_i[k - 1];
      bool moved = false;
#pragma unroll
      for (int j0 = 0; j0 < R; j0 += 32) {
        const float s = sc[qi * SC + j0 + lane];
        const int p = r0 + j0 + lane;
        unsigned m = __ballot_sync(kFull, better(s, p, ts, tp));
        while (m) {
          const int src = __ffs(m) - 1;
          m &= m - 1;
          const float cs = __shfl_sync(kFull, s, src);
          const int cp = __shfl_sync(kFull, p, src);
          if (!better(cs, cp, ts, tp)) continue;
          if constexpr (kRegLists) {
            reg_insert(rl_s[u], rl_i[u], k, cs, cp, lane);
            ts = __shfl_sync(kFull, rl_s[u], k - 1);
            tp = __shfl_sync(kFull, rl_i[u], k - 1);
          } else {
            warp_insert(l_s, l_i, k, cs, cp, lane);
            ts = l_s[k - 1];
            tp = l_i[k - 1];
          }
          moved = true;
        }
      }
      if (moved && lane == 0) thr[qi] = ts;
    }
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int u = 0; u < OWN; ++u) {
    const int qi = warp + kWarps * u;
    if (qi >= QB || q0 + qi >= b) break;
    const size_t o = ((size_t)(q0 + qi) * num_slices + slice) * k;
    if (kRegLists) {
      if (lane < k) {
        cand_s[o + lane] = rl_s[u];
        cand_i[o + lane] = rl_i[u];
      }
    } else {
      for (int i = lane; i < k; i += 32) {
        cand_s[o + i] = ls[qi * k + i];
        cand_i[o + i] = li[qi * k + i];
      }
    }
  }
}

template <class Tile, int QB, bool kRegLists>
cudaError_t launch_pass1_mma(const Tile& tile, const void* mask, int n, int d,
                             int b, int k, int num_valid, int rows_per_slice,
                             int num_slices, void* cand_s, void* cand_i,
                             cudaStream_t stream) {
  const size_t smem = mma_smem<Tile>(QB, d, k);
  cudaError_t err = cudaFuncSetAttribute(
      topk_pass1_mma<Tile, QB, kRegLists>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((b + QB - 1) / QB, num_slices);
  topk_pass1_mma<Tile, QB, kRegLists><<<grid, kThreads, smem, stream>>>(
      tile, static_cast<const int8_t*>(mask), n, d, b, k, num_valid,
      rows_per_slice, num_slices, static_cast<float*>(cand_s),
      static_cast<int*>(cand_i));
  return cudaGetLastError();
}

// Pass 1 for a query block of qb in {8, 16, 32, 64, 128}.
template <class Tile>
cudaError_t run_mma(int qb, const Tile& tile, const void* mask, void* cand_s,
                    void* cand_i, int n, int d, int b, int k, int num_valid,
                    int rows_per_slice, int num_slices, cudaStream_t stream) {
#define ISF_MMA_CASE(QB)                                                    \
  case QB:                                                                  \
    return k <= kRegListMax                                                 \
               ? launch_pass1_mma<Tile, QB, true>(tile, mask, n, d, b, k,   \
                                                  num_valid, rows_per_slice,\
                                                  num_slices, cand_s,       \
                                                  cand_i, stream)           \
               : launch_pass1_mma<Tile, QB, false>(tile, mask, n, d, b, k,  \
                                                   num_valid,               \
                                                   rows_per_slice,          \
                                                   num_slices, cand_s,      \
                                                   cand_i, stream);
  switch (qb) {
    ISF_MMA_CASE(8)
    ISF_MMA_CASE(16)
    ISF_MMA_CASE(32)
    ISF_MMA_CASE(64)
    ISF_MMA_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef ISF_MMA_CASE
}

}  // namespace
