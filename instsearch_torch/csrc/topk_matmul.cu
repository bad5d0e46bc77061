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
// What bounds it on the card. At B = 1 the kernel is a pure stream of the
// store from device memory: N * D * 2 bytes in bf16, 1 GiB at 1M x 512, which
// is about 0.32 ms at the H100's published 3.35 TB/s. The scores are 2*N*D
// flops per query, far below the CUDA cores' rate until B reaches the tens.
// The [B, N] score matrix is never written out: that would cost 4 bytes per
// row per query on top of the stream.
//
// What the design does about it (the split-N passes are in topk_common.cuh).
//   * Split N. The TPU grid runs its row tiles in order and carries one
//     running top-k across them; Hopper runs blocks in parallel, so pass 1
//     gives each block (CTA) one contiguous slice of rows and one block of up
//     to QB queries, and keeps a per-query partial top-k over that slice in
//     shared memory. Pass 2 merges the num_slices * k candidates per query.
//   * The stream: each warp scores ROWS_IN_FLIGHT rows at a time, every lane
//     reading 16-byte vectors of neighbouring addresses, so enough bytes are
//     in flight to cover memory latency. The query block stays in shared
//     memory as f32 (a bf16 query converts exactly). blockIdx.x walks the
//     query blocks fastest, so the blocks that read the same slice for
//     different queries run together and share it through L2.
//   * Warp reduction: a reduce-scatter over the QB per-query partial sums
//     costs QB shuffles per row instead of 5 * QB.
//   * Threshold skip, as on the TPU: a chunk's score only enters the list
//     when it beats the current k-th entry, checked with one ballot per 32
//     scores, so once the list has filled most chunks cost no insertion.
//
// Simple first: no tensor cores, TMA or warp specialisation yet. The wrapper
// (instsearch_torch/kernels/topk_matmul.py) allocates outputs and scratch;
// this file allocates nothing and launches on the caller's stream.

#include <cuda_bf16.h>

#include "topk_common.cuh"

namespace {

template <typename T>
struct Vec;

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kElems = 8;           // 16 bytes
  __device__ static __forceinline__ float get(const uint4& r, int e) {
    const uint32_t w = (&r.x)[e >> 1];
    const uint32_t bits = (e & 1) ? (w & 0xffff0000u) : (w << 16);
    return __uint_as_float(bits);
  }
  __device__ static __forceinline__ float to_float(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
};

template <>
struct Vec<float> {
  static constexpr int kElems = 4;
  __device__ static __forceinline__ float get(const uint4& r, int e) {
    return __uint_as_float((&r.x)[e]);
  }
  __device__ static __forceinline__ float to_float(float v) { return v; }
};

// Row scoring for K1: bf16 or f32 rows, the query block in shared memory as
// f32 [QB, d], f32 FMA per component.
template <typename T>
struct FloatRows {
  using Acc = float;
  const T* x;
  const T* q;
  int d;

  __host__ __device__ static size_t query_bytes(int qb, int d) {
    return sizeof(float) * (size_t)qb * d;
  }
  __device__ int vecs() const { return d / Vec<T>::kElems; }
  __device__ uint4 load(int row, int v) const {
    return __ldg(reinterpret_cast<const uint4*>(x + (size_t)row * d) + v);
  }
  __device__ void load_query(char* qsm, int qb, int q0, int b, int tid,
                             int lane, int warp) const {
    float* qs = reinterpret_cast<float*>(qsm);
    for (int i = tid; i < qb * d; i += kThreads) {
      const int qi = i / d;
      qs[i] = (q0 + qi < b)
                  ? Vec<T>::to_float(q[(size_t)(q0 + qi) * d + i % d])
                  : 0.f;
    }
  }
  template <int QB, int R>
  __device__ void accumulate(float (&acc)[R][QB], const uint4 (&raw)[R],
                             const char* qsm, int v) const {
    constexpr int E = Vec<T>::kElems;
#pragma unroll
    for (int j = 0; j < QB; ++j) {
      const float* qv =
          reinterpret_cast<const float*>(qsm) + (size_t)j * d + (size_t)v * E;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float qe = qv[e];
#pragma unroll
        for (int r = 0; r < R; ++r)
          acc[r][j] = fmaf(Vec<T>::get(raw[r], e), qe, acc[r][j]);
      }
    }
  }
  template <int QB>
  __device__ float score(float tot, int, int, const char*) const {
    return tot;
  }
};

template <typename T>
cudaError_t run_float(const void* x, const void* q, const void* mask,
                      void* cand_s, void* cand_i, int n, int d, int b, int k,
                      int num_valid, int qb, int rows_per_slice,
                      int num_slices, cudaStream_t stream) {
  const FloatRows<T> rows{static_cast<const T*>(x), static_cast<const T*>(q),
                          d};
  return dispatch_qb(qb, rows, mask, n, d, b, k, num_valid, rows_per_slice,
                     num_slices, cand_s, cand_i, stream);
}

}  // namespace

extern "C" {

// Shared memory pass 1 needs for a query block of qb rows; the wrapper sizes
// qb with it.
long long isf_topk_pass1_smem(int qb, int d, int k) {
  return (long long)pass1_smem<FloatRows<float>>(qb, d, k);
}

// dtype: 0 = float32, 1 = bfloat16. mask may be null. cand_s/cand_i hold
// b * num_slices * k entries. Returns the CUDA error code (0 = launched).
int isf_topk_matmul(const void* x, const void* q, const void* mask,
                    void* out_s, void* out_i, void* cand_s, void* cand_i,
                    int n, int d, int b, int k, int num_valid, int dtype,
                    int qb, int rows_per_slice, int num_slices,
                    void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (bad_plan(n, d, b, k, rows_per_slice, num_slices))
    return (int)cudaErrorInvalidValue;
  cudaError_t err =
      dtype == 1 ? run_float<__nv_bfloat16>(x, q, mask, cand_s, cand_i, n, d,
                                            b, k, num_valid, qb,
                                            rows_per_slice, num_slices, stream)
      : dtype == 0 ? run_float<float>(x, q, mask, cand_s, cand_i, n, d, b, k,
                                      num_valid, qb, rows_per_slice,
                                      num_slices, stream)
                   : cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  return (int)launch_pass2(cand_s, cand_i, out_s, out_i, b, k, num_slices,
                           stream);
}

}  // extern "C"
