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
// published 3.35 TB/s. The scores are 2 * B * N * D operations, B
// operations a byte of bf16 store: 128 at B = 128. The bf16 tensor cores
// (989 TFLOP/s) bound it only past ~295 a byte, but reaching the byte bound
// at B = 128 takes ~430 TFLOP/s of them, which mma.sync fed from ldmatrix
// never gave (~100 TFLOP/s measured, PERF.md); on the CUDA cores (67
// TFLOP/s in f32) the scores bound it from B of about 8. The [B, N] score
// matrix is never written out: that would cost 4 bytes per row per query
// on top of the stream.
//
// What the design does about it (the split-N passes are in topk_common.cuh).
//   * Split N. The TPU grid runs its row tiles in order and carries one
//     running top-k across them; Hopper runs blocks in parallel, so pass 1
//     gives each block (CTA) one contiguous slice of rows and one block of
//     queries, and keeps a per-query partial top-k over that slice in
//     shared memory. Pass 2 merges the num_slices * k candidates per query.
//     blockIdx.x walks the query blocks fastest, so the blocks that read the
//     same slice for different queries run together and share it through L2.
//   * bf16: topk_wgmma.cuh's pass 1, at every B: warp-specialised, a
//     producer thread streaming 128-row x 128-byte chunks of the slice and
//     the same chunk of the query block by TMA into a ring of mbarrier
//     stages, two consumer warpgroups scoring them by wgmma (the only road
//     to the tensor cores' full rate: operands straight from the swizzled
//     tiles, no ldmatrix, no block barrier), so the products keep up with
//     the byte bound at B = 128 and shared memory no longer caps the query
//     block at large D. Its selection appends passing scores to per-query
//     buffers and sorts and merges buffers only when one fills: inserting
//     each candidate alone (warp_insert) would set the pace at k = 100 and
//     200, not the scan. The products are exact (bf16 operands, the query
//     already in the store's dtype), f32 sums in another order than the
//     plain version's.
//   * f32: the FMA pass 1. Each warp scores kRowsInFlight rows at a time,
//     every lane reading 16-byte vectors of neighbouring addresses; the query
//     block stays in shared memory; a reduce-scatter over the QB partial sums
//     costs QB shuffles per row instead of 5 * QB; a chunk's score enters the
//     list only when it beats the current k-th entry, checked with one ballot
//     per 32 scores. f32 stays off the tensor cores: TF32 keeps about 10
//     bits, far past SCORE_TOL. Its pace is the CUDA cores'.
//
// The wrapper (instsearch_torch/kernels/topk_matmul.py) allocates outputs
// and scratch and picks the plan; this file allocates nothing and launches
// on the caller's stream.

#include <cuda_bf16.h>

#include "topk_common.cuh"
#include "topk_wgmma.cuh"

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

// The plan of topk_wgmma.cuh's pass 1 for a query block of qb at k over a
// bf16 (kind 0), int8 (1) or int4 (2) store: the ring's stages and the
// append buffers' entries (stages_cap[0], [1]; 0, 0 if nothing fits) and
// its shared memory in bytes.
long long isf_topk_wgmma_plan(int kind, int qb, int k, int* stages_cap) {
  const WgLayout lay = kind == 0   ? wg_plan<WgBf16>(qb, k)
                       : kind == 1 ? wg_plan<WgInt<false>>(qb, k)
                                   : wg_plan<WgInt<true>>(qb, k);
  stages_cap[0] = lay.stages;
  stages_cap[1] = lay.cap;
  return (long long)lay.total;
}

// The bf16 store by TMA and wgmma: qb in {8, 16, 32, 64, 128}, d % 8 == 0,
// rows_per_slice a multiple of 256. Otherwise as isf_topk_matmul; returns
// -1 (hopper::kNoEncoder) if libcuda has no tensor-map encoder and -2
// (kMapRefused) if it refuses x or q, launching nothing.
int isf_topk_matmul_wgmma(const void* x, const void* q, const void* mask,
                          void* out_s, void* out_i, void* cand_s,
                          void* cand_i, int n, int d, int b, int k,
                          int num_valid, int qb, int rows_per_slice,
                          int num_slices, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (bad_plan(n, d, b, k, rows_per_slice, num_slices) || d % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const int err = run_wgmma(qb, WgBf16{}, x, q, mask, cand_s, cand_i, n, d,
                            b, k, num_valid, rows_per_slice, num_slices,
                            stream);
  if (err != 0) return err;
  return (int)launch_pass2(cand_s, cand_i, out_s, out_i, b, k, num_slices,
                           stream);
}

}  // extern "C"
