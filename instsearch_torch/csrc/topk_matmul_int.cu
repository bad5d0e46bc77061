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
// bytes still bound both (0.069 ms of products at B = 128).
//
// What the design does about it. One launch sequence on the caller's stream:
//   1. quantize_query_rows: the query rows to int8 in scratch, bit for bit as
//      quantize_rows, with each row's scale and, for int4, the offset
//      8 * sum(q);
//   2. topk_mma.cuh's tensor-core pass 1 (K1's bf16 one), with IntTile
//      below: the staged query block is int8 [QB][D_pad + 16] beside each
//      query's scale and offset. A 128-byte chunk of int8 rows is 4 k-steps
//      of mma.sync m16n8k32 s8 x s8; of int4 rows, 8 of u8 x s8: the A
//      fragment of one ldmatrix splits in registers into w & 0x0F0F0F0F
//      (lo + 8, components c..) and ((w >> 4) & 0x0F0F0F0F) ^ 0x08080808
//      (hi + 8, components D/2 + c..), both in [0, 15], against query
//      columns c.. and D/2 + c..; the offset comes off each sum once. A
//      zero-filled byte past the row unpacks to lo + 8 = 0 and hi + 8 = 8,
//      which adds nothing since the staged query is zero past D. The score
//      float(acc - offset) * q_scale * x_scale[row] is formed in the C
//      fragment, each thread's two rows' x_scale loaded at the tile's first
//      chunk;
//   3. topk_common.cuh's pass 2.
// Not yet: wgmma, TMA, a persistent grid.

#include "topk_common.cuh"
#include "topk_mma.cuh"

namespace {

// The tile policy of K2 (kInt4 = false) and K3 (kInt4 = true). The staged
// query block: int8 rows of query_stride bytes, then each query's Factor.
// d is the logical width: int8 rows hold d bytes, int4 rows d / 2.
template <bool kInt4>
struct IntTile {
  using Acc = int;
  struct Factor {            // staged per query after the rows
    float scale;
    int off;
  };
  const int8_t* x;
  const float* x_scale;
  const int8_t* q;          // [b, d] int8, the quantized query
  const float* q_scale;     // [b]
  const int* q_off;         // [b], 8 * sum of the row (int4)

  __host__ __device__ static int row_bytes(int d) {
    return kInt4 ? d / 2 : d;
  }
  // the staged columns: every chunk's c.. and, for int4, D/2 + c..
  __host__ __device__ static int query_cols(int d) {
    const int chunks = (row_bytes(d) + kMmaBytes - 1) / kMmaBytes;
    return (kInt4 ? 2 : 1) * chunks * kMmaBytes;
  }
  __host__ __device__ static int query_stride(int d) {
    return query_cols(d) + 16;
  }
  __host__ __device__ static size_t query_bytes(int qb, int d) {
    return (size_t)qb * query_stride(d) + sizeof(Factor) * qb;
  }
  __device__ const char* rows() const {
    return reinterpret_cast<const char*>(x);
  }
  __device__ void load_query(char* qs, int qb, int q0, int b, int d,
                             int tid) const {
    stage_query_rows(qs, reinterpret_cast<const char*>(q), d,
                     query_stride(d), query_cols(d), qb, q0, b, tid);
    Factor* f = reinterpret_cast<Factor*>(qs + (size_t)qb * query_stride(d));
    for (int i = tid; i < qb; i += kThreads) {
      const bool ok = q0 + i < b;
      f[i] = {ok ? q_scale[q0 + i] : 0.f, ok && kInt4 ? q_off[q0 + i] : 0};
    }
  }
  template <int NT>
  __device__ void products(int (&acc)[NT][4], const uint32_t (&a)[4],
                           const char* qp, int qstride, int d,
                           int lane) const {
    if constexpr (!kInt4) {
      for_b_fragments<NT>(qp, qstride, lane,
                          [&](int j, uint32_t b0, uint32_t b1) {
                            mma_s8(acc[j], a, b0, b1);
                          });
    } else {
      uint32_t lo[4], hi[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        lo[r] = a[r] & 0x0F0F0F0Fu;                           // lo + 8
        hi[r] = ((a[r] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;   // hi + 8
      }
      for_b_fragments<NT>(qp, qstride, lane,
                          [&](int j, uint32_t b0, uint32_t b1) {
                            mma_u8s8(acc[j], lo, b0, b1);
                          });
      for_b_fragments<NT>(qp + d / 2, qstride, lane,
                          [&](int j, uint32_t b0, uint32_t b1) {
                            mma_u8s8(acc[j], hi, b0, b1);
                          });
    }
  }
  __device__ void row_scales(float (&rs)[2], int row, int valid_end) const {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      rs[h] = row + 8 * h < valid_end ? __ldg(x_scale + row + 8 * h) : 0.f;
  }
  __device__ Factor factor(int qi, const char* qmeta) const {
    return reinterpret_cast<const Factor*>(qmeta)[qi];
  }
  __device__ float score(int v, const Factor& f, float rs) const {
    return (float)(v - f.off) * f.scale * rs;
  }
};

// One block a query row: max |x| by a block reduction, then each thread
// quantizes its columns as ops/quantize.py::quantize_rows does
// (scale = max(max |row|, 1e-12) * f32(1/127), a product with the f32
// reciprocal as the reference's compiled program has it; rint(x / scale)
// with IEEE division, halves to even; clamped to +-127) and the block sums
// them for the int4 offset 8 * sum(q).
constexpr int kQuantThreads = 128;

__global__ void __launch_bounds__(kQuantThreads)
quantize_query_rows(const float* __restrict__ x, int8_t* __restrict__ q,
                    float* __restrict__ q_scale, int* __restrict__ q_off,
                    int d) {
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
  for (int i = threadIdx.x; i < d; i += kQuantThreads) {
    const float v =
        fminf(fmaxf(rintf(__fdiv_rn(row[i], scale)), -127.f), 127.f);
    q[(size_t)blockIdx.x * d + i] = static_cast<int8_t>(v);
    s += static_cast<int>(v);
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
                            void* q_off, int b, int d, cudaStream_t stream) {
  quantize_query_rows<<<b, kQuantThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<int8_t*>(q),
      static_cast<float*>(q_scale), static_cast<int*>(q_off), d);
  return cudaGetLastError();
}

template <bool kInt4>
cudaError_t run_int(const void* x, const void* x_scale, const void* q,
                    const void* q_scale, const void* q_off, const void* mask,
                    void* cand_s, void* cand_i, int n, int d, int b, int k,
                    int num_valid, int qb, int rows_per_slice, int num_slices,
                    cudaStream_t stream) {
  const IntTile<kInt4> tile{static_cast<const int8_t*>(x),
                            static_cast<const float*>(x_scale),
                            static_cast<const int8_t*>(q),
                            static_cast<const float*>(q_scale),
                            static_cast<const int*>(q_off)};
  return run_mma(qb, tile, mask, cand_s, cand_i, n, d, b, k, num_valid,
                 rows_per_slice, num_slices, stream);
}

}  // namespace

extern "C" {

// Shared memory pass 1 needs for a query block of qb in {8, 16, 32, 64,
// 128} rows of logical width d (int4 = 0 or 1); the wrapper sizes qb with
// it.
long long isf_topk_int_mma_smem(int int4, int qb, int d, int k) {
  return (long long)(int4 ? mma_smem<IntTile<true>>(qb, d, k)
                          : mma_smem<IntTile<false>>(qb, d, k));
}

// The launch sequence's first kernel alone: x [b, d] f32 -> q [b, d] int8,
// q_scale [b] f32, q_off [b] int32 (8 * the row's sum). Returns the CUDA
// error code (0 = launched).
int isf_quantize_rows(const void* x, void* q, void* q_scale, void* q_off,
                      int b, int d, void* stream_ptr) {
  if (b <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  return (int)launch_quantize(x, q, q_scale, q_off, b, d,
                              static_cast<cudaStream_t>(stream_ptr));
}

// x: int8 rows [n, d] (int4 = 0) or packed nibble pairs [n, d / 2]
// (int4 = 1), 16-byte aligned; x_scale [n] f32; q [b, d] f32, the query;
// q_i8 [b, d], q_scale [b] and q_off [b], scratch for its quantization,
// q_i8 16-byte aligned; d % 16 == 0 (int8) or d % 32 == 0 (int4). mask may
// be null. cand_s/cand_i hold b * num_slices * k entries. Launches the
// quantization, pass 1 and pass 2 on the stream; returns the CUDA error
// code (0 = launched).
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
  cudaError_t err = launch_quantize(q, q_i8, q_scale, q_off, b, d, stream);
  if (err != cudaSuccess) return (int)err;
  err = int4 ? run_int<true>(x, x_scale, q_i8, q_scale, q_off, mask, cand_s,
                             cand_i, n, d, b, k, num_valid, qb,
                             rows_per_slice, num_slices, stream)
             : run_int<false>(x, x_scale, q_i8, q_scale, q_off, mask, cand_s,
                              cand_i, n, d, b, k, num_valid, qb,
                              rows_per_slice, num_slices, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_pass2(cand_s, cand_i, out_s, out_i, b, k, num_slices,
                           stream);
}

}  // extern "C"
