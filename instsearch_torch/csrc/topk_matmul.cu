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
//   * bf16: the tensor-core pass 1 (topk_mma.cuh, with Bf16Tile below), at
//     every B, shared with K2/K3 (topk_matmul_int.cu). A
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
#include "topk_mma.cuh"

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

// bf16 rows on the tensor cores: topk_mma.cuh's pass 1 with this tile
// policy. The query is already in the store's dtype, so the staged query
// block is exact; 4 k-steps of m16n8k16 a 128-byte chunk, f32 sums (the
// products are exact, only the order of the sums differs from the plain
// version), and the score is the sum.
struct Bf16Tile {
  using Acc = float;
  struct Factor {};
  const bf16* x;
  const bf16* q;

  __host__ __device__ static int row_bytes(int d) { return 2 * d; }
  __host__ __device__ static int query_stride(int d) {
    return (row_bytes(d) + kMmaBytes - 1) / kMmaBytes * kMmaBytes + 16;
  }
  __host__ __device__ static size_t query_bytes(int qb, int d) {
    return (size_t)qb * query_stride(d);
  }
  __device__ const char* rows() const {
    return reinterpret_cast<const char*>(x);
  }
  __device__ void load_query(char* qs, int qb, int q0, int b, int d,
                             int tid) const {
    stage_query_rows(qs, reinterpret_cast<const char*>(q), row_bytes(d),
                     query_stride(d), query_stride(d) - 16, qb, q0, b, tid);
  }
  template <int NT>
  __device__ void products(float (&acc)[NT][4], const uint32_t (&a)[4],
                           const char* qp, int qstride, int,
                           int lane) const {
    for_b_fragments<NT>(qp, qstride, lane,
                        [&](int j, uint32_t b0, uint32_t b1) {
                          mma_bf16(acc[j], a, b0, b1);
                        });
  }
  __device__ void row_scales(float (&)[2], int, int) const {}
  __device__ Factor factor(int, const char*) const { return {}; }
  __device__ float score(float v, const Factor&, float) const { return v; }
};

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

// The bf16 store on the tensor cores (topk_mma.cuh); qb in {8, 16, 32,
// 64, 128}, d % 8 == 0. Otherwise as isf_topk_matmul.
long long isf_topk_mma_smem(int qb, int d, int k) {
  return (long long)mma_smem<Bf16Tile>(qb, d, k);
}

int isf_topk_matmul_mma(const void* x, const void* q, const void* mask,
                        void* out_s, void* out_i, void* cand_s, void* cand_i,
                        int n, int d, int b, int k, int num_valid, int qb,
                        int rows_per_slice, int num_slices,
                        void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (bad_plan(n, d, b, k, rows_per_slice, num_slices) || d % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const Bf16Tile tile{static_cast<const bf16*>(x), static_cast<const bf16*>(q)};
  cudaError_t err = run_mma(qb, tile, mask, cand_s, cand_i, n, d, b, k,
                            num_valid, rows_per_slice, num_slices, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_pass2(cand_s, cand_i, out_s, out_i, b, k, num_slices,
                           stream);
}

}  // extern "C"
