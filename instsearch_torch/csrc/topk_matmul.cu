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
// published 3.35 TB/s; twice that in f32. The scores are 2 * B * N * D
// operations, B operations a byte of bf16 store: 128 at B = 128. The bf16
// tensor cores (989 TFLOP/s) bound it only past ~295 a byte, but reaching
// the byte bound at B = 128 takes ~430 TFLOP/s of them, which only wgmma
// fed by TMA gives. An f32 store has no f32 tensor-core product: on the
// CUDA cores (67 TFLOP/s) its scores bound it from B of about 8 (2.05 ms at
// 1M x 512, B = 128); split TF32, three TF32 products a pair at 495
// TFLOP/s, brings that to 0.83 ms, near the f32 bytes' 0.64 ms. The [B, N]
// score matrix is never written out: that would cost 4 bytes per row per
// query on top of the stream.
//
// What the design does about it (the split-N passes are in topk_common.cuh).
//   * Split N. The TPU grid runs its row tiles in order and carries one
//     running top-k across them; Hopper runs blocks in parallel, so pass 1
//     gives each block (CTA) one contiguous slice of rows and one block of
//     queries, and keeps a per-query partial top-k over that slice in
//     shared memory. Pass 2 merges each query's candidate lists.
//     blockIdx.x walks the query blocks fastest, so the blocks that read the
//     same slice for different queries run together and share it through L2.
//   * topk_wgmma.cuh's pass 1, at every B and both dtypes: warp-specialised,
//     a producer thread streaming 128-row x 128-byte chunks of the slice and
//     the same chunk of the query block by TMA into a ring of mbarrier
//     stages, two consumer warpgroups scoring them by wgmma (the only road
//     to the tensor cores' full rate: no block barrier), so the products
//     keep up with the byte bound at B = 128 and shared memory no longer
//     caps the query block at large D. Its selection appends passing scores
//     to per-query buffers and sorts and merges buffers only when one fills:
//     inserting each candidate alone (warp_insert) would set the pace at
//     k = 100 and 200, not the scan.
//   * bf16 (WgBf16): both operands from the stage; the products are exact
//     (bf16 operands, the query already in the store's dtype), f32 sums in
//     another order than the plain version's.
//   * f32 (WgF32): split TF32. The launch sequence's first kernel splits
//     the query into TF32 hi and lo planes; pass 1 splits each A fragment
//     of the f32 stage in registers and sums x_hi q_hi + x_hi q_lo +
//     x_lo q_hi by TF32 wgmma: ~2^-22 of each product, exact on integer
//     rows of up to 23 significant bits (topk_wgmma.cuh, WgF32).
//
// The wrapper (instsearch_torch/kernels/topk_matmul.py) allocates outputs
// and scratch and picks the plan; this file allocates nothing and launches
// on the caller's stream.

#include <cuda_bf16.h>

#include "topk_common.cuh"
#include "topk_wgmma.cuh"

namespace {

// The launch sequence's first kernel over an f32 store: q [b, d] -> planes
// [2][b][d], hi = tf32_rna(v) then lo = tf32_rna(v - hi), one element a
// thread.
constexpr int kSplitThreads = 256;

__global__ void __launch_bounds__(kSplitThreads)
split_query_tf32(const float* __restrict__ q, float* __restrict__ planes,
                 int n) {
  const int i = blockIdx.x * kSplitThreads + threadIdx.x;
  if (i >= n) return;
  const float v = q[i];
  const float hi = __uint_as_float(hopper::tf32_rna(v));
  planes[i] = hi;
  planes[n + i] = __uint_as_float(hopper::tf32_rna(v - hi));
}

}  // namespace

extern "C" {

// The plan of topk_wgmma.cuh's pass 1 for a query block of qb at k over a
// bf16 (kind 0), int8 (1), int4 (2) or f32 (3) store: the ring's stages and
// the append buffers' entries (stages_cap[0], [1]; 0, 0 if nothing fits)
// and its shared memory in bytes.
long long isf_topk_wgmma_plan(int kind, int qb, int k, int* stages_cap) {
  const WgLayout lay = kind == 0   ? wg_plan<WgBf16>(qb, k)
                       : kind == 1 ? wg_plan<WgInt<false>>(qb, k)
                       : kind == 2 ? wg_plan<WgInt<true>>(qb, k)
                                   : wg_plan<WgF32>(qb, k);
  stages_cap[0] = lay.stages;
  stages_cap[1] = lay.cap;
  return (long long)lay.total;
}

// The bf16 store by TMA and wgmma: x [n, d], q [b, d] bf16, 16-byte
// aligned; qb in {8, 16, 32, 64, 128}, d % 8 == 0, rows_per_slice a
// multiple of 256; mask may be null; cand_s/cand_i hold b * num_slices * k
// entries. Launches pass 1 and pass 2 on the stream; returns the CUDA
// error code (0 = launched), or -1 (hopper::kNoEncoder) if libcuda has no
// tensor-map encoder and -2 (kMapRefused) if it refuses x or q, launching
// nothing.
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

// The f32 store by split TF32 on TMA and wgmma: x [n, d], q [b, d] f32,
// 16-byte aligned; q_planes scratch of 2 * b * d floats, 16-byte aligned;
// d % 8 == 0; cand_s/cand_i hold b * num_slices * k entries, twice that at
// qb = 8 (each slice's two consumers keep lists of their own). Launches the
// query's split, pass 1 and pass 2; otherwise as isf_topk_matmul_wgmma.
int isf_topk_matmul_f32_wgmma(const void* x, const void* q, void* q_planes,
                              const void* mask, void* out_s, void* out_i,
                              void* cand_s, void* cand_i, int n, int d, int b,
                              int k, int num_valid, int qb,
                              int rows_per_slice, int num_slices,
                              void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (bad_plan(n, d, b, k, rows_per_slice, num_slices) || d % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const int elems = b * d;
  split_query_tf32<<<(elems + kSplitThreads - 1) / kSplitThreads,
                     kSplitThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<float*>(q_planes), elems);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int rc = run_wgmma(qb, WgF32{}, x, q_planes, mask, cand_s, cand_i, n,
                           d, b, k, num_valid, rows_per_slice, num_slices,
                           stream);
  if (rc != 0) return rc;
  return (int)launch_pass2(cand_s, cand_i, out_s, out_i, b, k,
                           wg_candidate_lists<WgF32>(qb, num_slices), stream);
}

}  // extern "C"
