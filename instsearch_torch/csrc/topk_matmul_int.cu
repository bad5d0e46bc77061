// Fused brute-force top-k over quantized row stores, for Hopper (sm_90a):
// K2 over int8 rows and K3 over packed int4 rows.
//
// Replaces the TPU kernels instsearch_tpu/kernels/topk_matmul.py::
// topk_matmul_int8 (Pallas body `_kernel_int8`) and ::topk_matmul_int4
// (`_kernel_int4`), which share K1's epilogue `_fold_tile`. Same functions:
//   K2  x [N, D] int8, x_scale [N] f32, q [B, D] f32, quantized per row to
//       int8 (ops/quantize.py::quantize_rows) by the first kernel of the
//       launch sequence;
//   K3  x [N, D/2] int8, byte j = 16 * hi + (lo + 8) holding components j
//       (lo) and j + D/2 (hi), ops/quantize.py::quantize_rows_int4; the same
//       int8 query;
//   ->  scores [B, k] f32 = float(int32 q . x) * q_scale * x_scale[row], in
//       that order, sorted descending, and row positions [B, k] int32.
// The integer sum is exact, so the answer equals the plain versions in
// instsearch_torch/kernels/topk_matmul.py bit for bit, ties included. Rows
// >= num_valid or with mask <= 0 are never returned; ties go to the lowest
// row position; slots past the count of valid rows come back as (-inf, -1).
//
// What bounds it on the card. Both stream the store once: int8 at 1M x 512
// reads 512 MiB of rows and 4 MiB of scales, a floor of about 0.16 ms at the
// H100's published 3.35 TB/s; int4 reads 256 MiB + 4 MiB, about 0.08 ms. The
// products are 2 * B * N * D integer operations, 256 a byte of int8 rows
// and 512 of int4 rows at B = 128: at the int8 tensor cores' 1,979 TOPS the
// bytes still bound both (0.069 ms of products at B = 128). Reaching that
// rate takes wgmma, and keeping the selection off the pace at k = 100 takes
// K1's append buffers rather than inserting each candidate alone.
//
// What the design does about it. One launch sequence on the caller's stream:
//   1. quantize_query_rows: the query rows to int8 in scratch, bit for bit as
//      quantize_rows, with each row's scale and, for int4, the offset
//      8 * sum(q); for int4 written as K3's query planes (below);
//   2. topk_wgmma.cuh's pass 1, K1's kernel with the tile policy
//      WgInt<int4>: 128-row x 128-byte chunks of the store and the query
//      block's matching columns by TMA into an mbarrier ring, the products
//      by integer wgmma (K2: s8 x s8 from shared memory; K3: each A fragment
//      split into lo + 8 and hi + 8 nibbles in registers, u8 x s8 against
//      the query's lo and hi planes), the scores formed in registers, the
//      selection by append buffers and bitonic merges;
//   3. topk_common.cuh's pass 2.

#include "topk_common.cuh"
#include "topk_wgmma.cuh"

namespace {

// One block a query row: max |x| by a block reduction, then each thread
// quantizes its columns as ops/quantize.py::quantize_rows does
// (scale = max(max |row|, 1e-12) * f32(1/127), a product with the f32
// reciprocal as the reference's compiled program has it; rint(x / scale)
// with IEEE division, halves to even; clamped to +-127) and the block sums
// them for the int4 offset 8 * sum(q). With planes = 0 the values go out
// as q [b, d]; else as K3's query planes [planes][b][128]: plane 2 j holds
// columns j 128 .., plane 2 j + 1 columns d/2 + j 128 .., zero past d/2.
constexpr int kQuantThreads = 128;

__device__ __forceinline__ int8_t quantize_one(float x, float scale) {
  return static_cast<int8_t>(
      fminf(fmaxf(rintf(__fdiv_rn(x, scale)), -127.f), 127.f));
}

__global__ void __launch_bounds__(kQuantThreads)
quantize_query_rows(const float* __restrict__ x, int8_t* __restrict__ q,
                    float* __restrict__ q_scale, int* __restrict__ q_off,
                    int d, int planes) {
  __shared__ float red_m[kQuantThreads / 32];
  __shared__ int red_s[kQuantThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* row = x + (size_t)blockIdx.x * d;
  float m = 0.f;
  for (int i = threadIdx.x; i < d; i += kQuantThreads)
    m = fmaxf(m, fabsf(row[i]));
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
  if (lane == 0) red_m[warp] = m;
  __syncthreads();
  m = red_m[0];
#pragma unroll
  for (int w = 1; w < kQuantThreads / 32; ++w) m = fmaxf(m, red_m[w]);
  const float scale = fmaxf(m, 1e-12f) * static_cast<float>(1.0 / 127.0);
  int s = 0;
  if (planes == 0) {
    for (int i = threadIdx.x; i < d; i += kQuantThreads) {
      const int8_t v = quantize_one(row[i], scale);
      q[(size_t)blockIdx.x * d + i] = v;
      s += v;
    }
  } else {
    const int half = d / 2;
    for (int i = threadIdx.x; i < planes * 128; i += kQuantThreads) {
      const int p = i / 128, col = p / 2 * 128 + i % 128;
      const int8_t v =
          col < half ? quantize_one(row[p % 2 * half + col], scale) : 0;
      q[((size_t)p * gridDim.x + blockIdx.x) * 128 + i % 128] = v;
      s += v;
    }
  }
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
  if (lane == 0) red_s[warp] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    s = 0;
#pragma unroll
    for (int w = 0; w < kQuantThreads / 32; ++w) s += red_s[w];
    q_scale[blockIdx.x] = scale;
    q_off[blockIdx.x] = 8 * s;
  }
}

cudaError_t launch_quantize(const void* x, void* q, void* q_scale,
                            void* q_off, int b, int d, int planes,
                            cudaStream_t stream) {
  quantize_query_rows<<<b, kQuantThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<int8_t*>(q),
      static_cast<float*>(q_scale), static_cast<int*>(q_off), d, planes);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The launch sequence's first kernel alone: x [b, d] f32 -> q [b, d] int8,
// q_scale [b] f32, q_off [b] int32 (8 * the row's sum). Returns the CUDA
// error code (0 = launched).
int isf_quantize_rows(const void* x, void* q, void* q_scale, void* q_off,
                      int b, int d, void* stream_ptr) {
  if (b <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  return (int)launch_quantize(x, q, q_scale, q_off, b, d, 0,
                              static_cast<cudaStream_t>(stream_ptr));
}

// x: int8 rows [n, d] (int4 = 0) or packed nibble pairs [n, d / 2]
// (int4 = 1), 16-byte aligned; x_scale [n] f32; q [b, d] f32, the query;
// q_i8, q_scale [b] and q_off [b], scratch for its quantization, q_i8
// 16-byte aligned and of b * d bytes (int8) or b * 256 * ceil(d / 256)
// (int4, its planes); d % 16 == 0 (int8) or d % 32 == 0 (int4);
// rows_per_slice a multiple of 256, qb in {8, 16, 32, 64, 128}. mask may be
// null. cand_s/cand_i hold b * num_slices * k entries, twice that at
// qb = 8 (each slice's two consumers keep lists of their own). Launches the
// quantization, pass 1 and pass 2 on the stream; returns the CUDA error
// code (0 = launched), or -1 (hopper::kNoEncoder) if libcuda has no
// tensor-map encoder and -2 (kMapRefused) if it refuses x or the query,
// pass 1 and pass 2 then not launched.
int isf_topk_matmul_int(const void* x, const void* x_scale, const void* q,
                        void* q_i8, void* q_scale, void* q_off,
                        const void* mask, void* out_s, void* out_i,
                        void* cand_s, void* cand_i, int n, int d, int b, int k,
                        int num_valid, int int4, int qb, int rows_per_slice,
                        int num_slices, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (bad_plan(n, d, b, k, rows_per_slice, num_slices) ||
      d % (int4 ? 32 : 16) != 0)
    return (int)cudaErrorInvalidValue;
  const int planes = int4 ? 2 * WgInt<true>::chunks(d) : 0;
  cudaError_t err =
      launch_quantize(q, q_i8, q_scale, q_off, b, d, planes, stream);
  if (err != cudaSuccess) return (int)err;
  const float* xs = static_cast<const float*>(x_scale);
  const float* qs = static_cast<const float*>(q_scale);
  const int* qo = static_cast<const int*>(q_off);
  const int rc =
      int4 ? run_wgmma(qb, WgInt<true>{xs, qs, qo}, x, q_i8, mask, cand_s,
                       cand_i, n, d, b, k, num_valid, rows_per_slice,
                       num_slices, stream)
           : run_wgmma(qb, WgInt<false>{xs, qs, qo}, x, q_i8, mask, cand_s,
                       cand_i, n, d, b, k, num_valid, rows_per_slice,
                       num_slices, stream);
  if (rc != 0) return rc;
  const int lists =
      int4 ? wg_candidate_lists<WgInt<true>>(qb, num_slices)
           : wg_candidate_lists<WgInt<false>>(qb, num_slices);
  return (int)launch_pass2(cand_s, cand_i, out_s, out_i, b, k, lists,
                           stream);
}

}  // extern "C"
