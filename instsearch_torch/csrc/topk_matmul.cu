// Fused brute-force top-k over a float row store, for Hopper (sm_90a).
//
// Replaces the TPU kernel instsearch_tpu/kernels/topk_matmul.py::topk_matmul
// (Pallas body `_kernel`, epilogue `_fold_tile` / `_insert_sorted` /
// `_merge_topk`). Same function: x [N, D] (bf16 or f32), q [B, D] of the same
// dtype -> (scores [B, k] f32 sorted descending, row positions [B, k] int32).
// Products are accumulated in f32; rows >= num_valid or with mask <= 0 are
// never returned; ties go to the lowest row position; slots past the count of
// valid rows come back as (-inf, -1).
//
// What bounds it on the card. The store streams from device memory once:
// N * D * 2 bytes in bf16, 1 GiB at 1M x 512, about 0.32 ms at the H100's
// published 3.35 TB/s. The scores are 2 * B * N * D operations, 128 a byte
// at B = 128, under the ~295 a byte where the bf16 tensor cores would bound
// it; on the CUDA cores (67 TFLOP/s in f32) they bound it from B of about 8.
// The [B, N] score matrix is never written out: that would cost 4 bytes per
// row per query on top of the stream.
//
// What the design does about it (the split-N passes are in topk_common.cuh).
//   * Split N. The TPU grid runs its row tiles in order and carries one
//     running top-k across them; Hopper runs blocks in parallel, so pass 1
//     gives each block (CTA) one contiguous slice of rows and one block of
//     queries, and keeps a per-query partial top-k over that slice in
//     shared memory. Pass 2 merges the num_slices * k candidates per query.
//     blockIdx.x walks the query blocks fastest, so the blocks that read the
//     same slice for different queries run together and share it through L2.
//   * bf16: the tensor-core pass 1 (topk_pass1_mma below), at every B. A
//     block stages its query block (QB of 8 to 128 queries; a smaller batch
//     leaves the rest of its 8 zero) once in shared memory as bf16, exact
//     since the query is already in the store's dtype, and streams its slice
//     through a ring of shared-memory stages of R rows x 64 columns, filled
//     with cp.async (16 bytes a thread, .cg, zero-filled past the valid rows
//     and past D). cp.async rather than TMA: the zero fill covers the ragged
//     rows and columns, a row stride of 144 bytes keeps ldmatrix free of bank
//     conflicts without a swizzle, and no tensor map has to be built on the
//     host for every store. Each warp scores 16 rows x its queries with
//     mma.sync.m16n8k16 (bf16 operands, f32 sums: the products are exact,
//     only the order of the sums differs from the plain version), A the row
//     tile and B the query rows as they lie, both by ldmatrix. After a tile's
//     last column chunk every score is compared with its query's current
//     k-th entry while it is still in its C fragment; only the ones that
//     pass reach shared memory as candidates, and each warp folds its own
//     queries' candidates into lists kept in its registers (k <= 32; in
//     shared memory above). At large B the fold, not the products, sets the
//     pace. wgmma is not needed: the bound is bytes at every B up to the
//     query_chunk of 128.
//   * f32: the FMA pass 1. Each warp scores kRowsInFlight rows at a time,
//     every lane reading 16-byte vectors of neighbouring addresses; the query
//     block stays in shared memory; a reduce-scatter over the QB partial sums
//     costs QB shuffles per row instead of 5 * QB; a chunk's score enters the
//     list only when it beats the current k-th entry, checked with one ballot
//     per 32 scores. f32 stays off the tensor cores: TF32 keeps about 10
//     bits, far past SCORE_TOL.
//
// Not yet: TMA, warp specialisation, a persistent grid. The wrapper
// (instsearch_torch/kernels/topk_matmul.py) allocates outputs and scratch
// and picks the plan; this file allocates nothing and launches on the
// caller's stream.

#include <cuda_bf16.h>

#include "topk_common.cuh"
#include "warp_mma.cuh"

namespace {

// Row scoring for K1's f32 store: the query block in shared memory as f32
// [QB, d], f32 FMA per component.
struct FloatRows {
  using Acc = float;
  static constexpr int kElems = 4;           // 16 bytes
  const float* x;
  const float* q;
  int d;

  __host__ __device__ static size_t query_bytes(int qb, int d) {
    return sizeof(float) * (size_t)qb * d;
  }
  __device__ int vecs() const { return d / kElems; }
  __device__ uint4 load(int row, int v) const {
    return __ldg(reinterpret_cast<const uint4*>(x + (size_t)row * d) + v);
  }
  __device__ void load_query(char* qsm, int qb, int q0, int b, int tid,
                             int lane, int warp) const {
    float* qs = reinterpret_cast<float*>(qsm);
    for (int i = tid; i < qb * d; i += kThreads) {
      const int qi = i / d;
      qs[i] = (q0 + qi < b) ? q[(size_t)(q0 + qi) * d + i % d] : 0.f;
    }
  }
  template <int QB, int R>
  __device__ void accumulate(float (&acc)[R][QB], const uint4 (&raw)[R],
                             const char* qsm, int v) const {
#pragma unroll
    for (int j = 0; j < QB; ++j) {
      const float* qv = reinterpret_cast<const float*>(qsm) + (size_t)j * d +
                        (size_t)v * kElems;
#pragma unroll
      for (int e = 0; e < kElems; ++e) {
        const float qe = qv[e];
#pragma unroll
        for (int r = 0; r < R; ++r)
          acc[r][j] = fmaf(__uint_as_float((&raw[r].x)[e]), qe, acc[r][j]);
      }
    }
  }
  template <int QB>
  __device__ float score(float tot, int, int, const char*) const {
    return tot;
  }
};

// ---------------------------------------------------------------------------
// bf16 rows on the tensor cores (fragments: warp_mma.cuh). A's rows are
// store rows, B's columns are queries and k runs over D.
// ---------------------------------------------------------------------------

constexpr int kMmaCols = 64;                 // columns of a staged row tile
constexpr int kMmaStride = kMmaCols + 8;     // its row stride: 144 bytes, so
                                             // ldmatrix's 8 rows hit 8
                                             // distinct 16-byte bank groups

// The block's plan for a query block of qb: kWarps warps as mma_warps_q(qb)
// groups across the queries times the rest across the rows, 16 rows a warp.
__host__ __device__ constexpr int mma_warps_q(int qb) {
  return qb == 128 ? 2 : 1;
}
__host__ __device__ constexpr int mma_rows(int qb) {   // R, rows a tile
  return 16 * (kWarps / mma_warps_q(qb));
}
__host__ __device__ constexpr int mma_stages(int qb) { // ring of R x 64
  return mma_rows(qb) == 64 ? 4 : 3;
}
__host__ __device__ constexpr int mma_sc_stride(int qb) {
  // a query's row of passing scores; +4 so the C fragments' stores (queries
  // 2 apart, rows 1 apart) fall in distinct banks
  return mma_rows(qb) + 4;
}

constexpr int kRegListMax = 32;   // k up to this: a warp's lists live in
                                  // its registers, entry l in lane l

// Shared memory of topk_pass1_mma: the query block [qb][D64 + 8] bf16, the
// stage ring, the passing scores [qb][R + 4] f32, each query's threshold
// (the score of its list's k-th entry) and, for k > kRegListMax, the lists
// [qb][k] (scores, then positions).
size_t mma_smem(int qb, int d, int k) {
  const size_t dpad = (size_t)(d + kMmaCols - 1) / kMmaCols * kMmaCols;
  return sizeof(bf16) * qb * (dpad + 8) +
         sizeof(bf16) * mma_stages(qb) * mma_rows(qb) * kMmaStride +
         sizeof(float) * qb * mma_sc_stride(qb) + sizeof(float) * qb +
         (k > kRegListMax ? (sizeof(float) + sizeof(int)) * (size_t)qb * k
                          : 0);
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

// Pass 1 of the bf16 store on the tensor cores; the selection rules, the
// candidate layout and pass 2 are topk_common.cuh's. Block (query block,
// slice); warp w scores rows 16 (w % WR) .. + 15 of each R-row tile against
// queries QW (w / WR) .. + QW - 1 of the block, and keeps the lists of
// queries w, w + kWarps, ... (in its registers for k <= kRegListMax).
//
// Selection, after a tile's last column chunk: within a slice the rows come
// in ascending position, so a row of this tile can beat a list's k-th entry
// (an earlier row) only by a greater score; each score is compared with its
// query's threshold while it is still in its C fragment, and only the ones
// that pass are written, -inf for the rest. Then each warp scans its own
// queries' scores with a ballot per 32 and inserts the ones that still beat
// the list, with the full (score, position) order.
// One block an SM at QB >= 64 (its shared memory), so up to 255 registers;
// two at QB <= 32.
template <int QB, bool kRegLists>
__global__ void __launch_bounds__(kThreads, QB >= 64 ? 1 : 2)
topk_pass1_mma(const bf16* __restrict__ x, const bf16* __restrict__ q,
               const int8_t* __restrict__ mask, int n, int d, int b, int k,
               int num_valid, int rows_per_slice, int num_slices,
               float* __restrict__ cand_s, int* __restrict__ cand_i) {
  constexpr int WR = kWarps / mma_warps_q(QB);
  constexpr int R = mma_rows(QB);
  constexpr int S = mma_stages(QB);
  constexpr int SC = mma_sc_stride(QB);
  constexpr int QW = QB / mma_warps_q(QB);     // queries a warp scores
  constexpr int NT = QW / 8;                    // its n-tiles of 8 queries
  constexpr int OWN = (QB + kWarps - 1) / kWarps;   // queries a warp keeps
  static_assert(NT >= 1 && (NT == 1 || NT % 2 == 0), "query block");
  static_assert((R * kMmaCols / 8) % kThreads == 0, "stage copy");

  extern __shared__ float4 smem4[];
  const int dpad = (d + kMmaCols - 1) / kMmaCols * kMmaCols;
  const int qstride = dpad + 8;
  bf16* qs = reinterpret_cast<bf16*>(smem4);            // [QB][qstride]
  bf16* st = qs + (size_t)QB * qstride;                 // [S][R][kMmaStride]
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

  // the query block, zeros past b and past d
  const int qvecs = dpad / 8;
  for (int i = tid; i < QB * qvecs; i += kThreads) {
    const int qi = i / qvecs;
    const int col = (i % qvecs) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + qi < b && col < d)
      v = __ldg(reinterpret_cast<const uint4*>(q + (size_t)(q0 + qi) * d +
                                               col));
    *reinterpret_cast<uint4*>(qs + (size_t)qi * qstride + col) = v;
  }
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

  const int row_begin = slice * rows_per_slice;
  const int row_end = min(n, row_begin + rows_per_slice);
  const int valid_end = min(row_end, num_valid);
  const int ntiles =
      valid_end > row_begin ? (valid_end - row_begin + R - 1) / R : 0;
  const int nchunks = dpad / kMmaCols;
  const int total = ntiles * nchunks;

  // step `it` = (tile it / nchunks, column chunk it % nchunks) into stage
  // it % S; rows at or past valid_end and columns at or past d read zeros
  auto load = [&](int it) {
    if (it < total) {
      const int r0 = row_begin + (it / nchunks) * R;
      const int c0 = (it % nchunks) * kMmaCols;
      bf16* dst = st + (it % S) * R * kMmaStride;
#pragma unroll
      for (int j = 0; j < R * kMmaCols / 8 / kThreads; ++j) {
        const int i = tid + j * kThreads;
        const int r = i >> 3;
        const int col = c0 + (i & 7) * 8;
        const bool ok = r0 + r < valid_end && col < d;
        const bf16* src = ok ? x + (size_t)(r0 + r) * d + col : x;
        cp_async16(dst + r * kMmaStride + (i & 7) * 8, src, ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };

  for (int s = 0; s < S - 1; ++s) load(s);
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int it = 0; it < total; ++it) {
    cp_async_wait<S - 2>();
    __syncthreads();              // stage it % S is in; it - 1's is free
    load(it + S - 1);
    const bf16* tile = st + (it % S) * R * kMmaStride;
    const int chunk = it % nchunks;
#pragma unroll
    for (int kk = 0; kk < kMmaCols; kk += 16) {
      uint32_t a[4];
      ldmatrix_x4(a, tile + (wrow + (lane & 15)) * kMmaStride + kk +
                         (lane >> 4) * 8);
      const bf16* qp = qs + (size_t)(wq + (lane & 7)) * qstride +
                       chunk * kMmaCols + kk + ((lane >> 3) & 1) * 8;
      if constexpr (NT == 1) {
        uint32_t bq[4];
        ldmatrix_x2(bq, qp);
        mma_bf16(acc[0], a, bq[0], bq[1]);
      } else {
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t bq[4];
          ldmatrix_x4(bq, qp + (size_t)(8 * j + (lane >> 4) * 8) * qstride);
          mma_bf16(acc[j], a, bq[0], bq[1]);
          mma_bf16(acc[j + 1], a, bq[2], bq[3]);
        }
      }
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
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float s = acc[j][2 * h + e];
          sc[qi * SC + wrow + g + 8 * h] =
              row_ok[h] && s > t ? s : neg_inf();
          acc[j][2 * h + e] = 0.f;
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

template <int QB, bool kRegLists>
cudaError_t launch_pass1_mma(const void* x, const void* q, const void* mask,
                             int n, int d, int b, int k, int num_valid,
                             int rows_per_slice, int num_slices, void* cand_s,
                             void* cand_i, cudaStream_t stream) {
  const size_t smem = mma_smem(QB, d, k);
  cudaError_t err = cudaFuncSetAttribute(
      topk_pass1_mma<QB, kRegLists>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((b + QB - 1) / QB, num_slices);
  topk_pass1_mma<QB, kRegLists><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(q),
      static_cast<const int8_t*>(mask), n, d, b, k, num_valid, rows_per_slice,
      num_slices, static_cast<float*>(cand_s), static_cast<int*>(cand_i));
  return cudaGetLastError();
}

cudaError_t run_mma(int qb, const void* x, const void* q, const void* mask,
                    void* cand_s, void* cand_i, int n, int d, int b, int k,
                    int num_valid, int rows_per_slice, int num_slices,
                    cudaStream_t stream) {
#define ISF_MMA_CASE(QB)                                                    \
  case QB:                                                                  \
    return k <= kRegListMax                                                 \
               ? launch_pass1_mma<QB, true>(x, q, mask, n, d, b, k,         \
                                            num_valid, rows_per_slice,      \
                                            num_slices, cand_s, cand_i,     \
                                            stream)                         \
               : launch_pass1_mma<QB, false>(x, q, mask, n, d, b, k,        \
                                             num_valid, rows_per_slice,     \
                                             num_slices, cand_s, cand_i,    \
                                             stream);
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

extern "C" {

// The f32 store (the FMA pass 1). Shared memory pass 1 needs for a query
// block of qb rows; the wrapper sizes qb with it.
long long isf_topk_pass1_smem(int qb, int d, int k) {
  return (long long)pass1_smem<FloatRows>(qb, d, k);
}

// mask may be null. cand_s/cand_i hold b * num_slices * k entries. Returns
// the CUDA error code (0 = launched).
int isf_topk_matmul(const void* x, const void* q, const void* mask,
                    void* out_s, void* out_i, void* cand_s, void* cand_i,
                    int n, int d, int b, int k, int num_valid, int qb,
                    int rows_per_slice, int num_slices, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (bad_plan(n, d, b, k, rows_per_slice, num_slices))
    return (int)cudaErrorInvalidValue;
  const FloatRows rows{static_cast<const float*>(x),
                       static_cast<const float*>(q), d};
  cudaError_t err = dispatch_qb(qb, rows, mask, n, d, b, k, num_valid,
                                rows_per_slice, num_slices, cand_s, cand_i,
                                stream);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_pass2(cand_s, cand_i, out_s, out_i, b, k, num_slices,
                           stream);
}

// The bf16 store on the tensor cores (topk_pass1_mma); qb in {8, 16, 32,
// 64, 128}, d % 8 == 0. Otherwise as isf_topk_matmul.
long long isf_topk_mma_smem(int qb, int d, int k) {
  return (long long)mma_smem(qb, d, k);
}

int isf_topk_matmul_mma(const void* x, const void* q, const void* mask,
                        void* out_s, void* out_i, void* cand_s, void* cand_i,
                        int n, int d, int b, int k, int num_valid, int qb,
                        int rows_per_slice, int num_slices,
                        void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (bad_plan(n, d, b, k, rows_per_slice, num_slices) || d % 8 != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = run_mma(qb, x, q, mask, cand_s, cand_i, n, d, b, k,
                            num_valid, rows_per_slice, num_slices, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_pass2(cand_s, cand_i, out_s, out_i, b, k, num_slices,
                           stream);
}

}  // extern "C"
