// Fused brute-force top-k over quantized row stores, for Hopper (sm_90a):
// K2 over int8 rows and K3 over packed int4 rows.
//
// Replaces the TPU kernels instsearch_tpu/kernels/topk_matmul.py::
// topk_matmul_int8 (Pallas body `_kernel_int8`) and ::topk_matmul_int4
// (`_kernel_int4`), which share K1's epilogue `_fold_tile`. Same functions:
//   K2  x [N, D] int8, x_scale [N] f32, q [B, D] int8 (the query quantized
//       per row by the wrapper, ops/quantize.py::quantize_rows), q_scale [B];
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
// What bounds it on the card. At B = 1 both are pure streams of the store:
// int8 at 1M x 512 reads 512 MiB of rows and 4 MiB of scales, a floor of
// about 0.16 ms at the H100's published 3.35 TB/s; int4 reads 256 MiB + 4
// MiB, about 0.08 ms. The products are 2*N*D integer operations per query,
// which __dp4a (four int8 products and a sum per instruction) covers on the
// CUDA cores far below the stream's time at small B.
//
// What the design does about it. K1's split-N passes and selection, shared
// through topk_common.cuh, with a row-scoring policy of its own:
//   * each lane reads 16 bytes of a row per load: 16 int8 components, or 32
//     int4 components;
//   * the query block stays in shared memory as int8 [QB, D], beside each
//     query's scale and (int4) offset;
//   * int8: four __dp4a per 16-byte vector and query, int32 accumulators,
//     reduced across lanes in int32;
//   * int4: unpacked in registers with no per-byte shift: the low nibbles
//     (w & 0x0F0F0F0F) are lo + 8 and ((w >> 4) & 0x0F0F0F0F) ^ 0x08080808
//     is hi + 8, both in [0, 15], so they enter __dp4a as they are and the
//     offset 8 * sum(q) is taken off the total once per query.
// At D = 512 an int4 row is 16 vectors, so half of a warp's lanes idle
// while it reads a row (at D = 128, 28 of 32): simple first, no tensor
// cores (wgmma int8), TMA or sub-warp row groups yet.
//
// Prediction, written before the first run on the card (1M x 512, k = 10,
// B = 1): K2 0.20-0.30 ms (K1 reached 73% of the stream bound; the
// per-row reduction and selection cost is the same for half the bytes);
// K3 0.15-0.30 ms (half the lanes idle, the same per-row costs); both
// faster than their plain versions (f64 matmul plus a sort of [B, N]) by
// more than 3x at B = 1. At B = 128 both below K1's 12.9 ms, since a
// __dp4a does four products.

#include "topk_common.cuh"

namespace {

// Row scoring for K2 (kInt4 = false) and K3 (kInt4 = true). d is the
// logical width: int8 rows hold d bytes, int4 rows d / 2.
template <bool kInt4>
struct IntRows {
  using Acc = int;
  const int8_t* x;
  const float* x_scale;
  const int8_t* q;          // [b, d] int8
  const float* q_scale;     // [b]
  int d;

  // int8 query block [qb, d], then per query: scale (f32), offset (int)
  __host__ __device__ static size_t query_bytes(int qb, int d) {
    return align16((size_t)qb * d) + align16(8 * (size_t)qb);
  }
  __device__ int vecs() const { return (kInt4 ? d / 2 : d) / 16; }
  __device__ uint4 load(int row, int v) const {
    const int8_t* p = x + (size_t)row * (kInt4 ? d / 2 : d);
    return __ldg(reinterpret_cast<const uint4*>(p) + v);
  }
  __device__ void load_query(char* qsm, int qb, int q0, int b, int tid,
                             int lane, int warp) const {
    const int nv = qb * d / 16;                   // d % 16 == 0
    uint4* qs = reinterpret_cast<uint4*>(qsm);
    const uint4* qg = reinterpret_cast<const uint4*>(q + (size_t)q0 * d);
    for (int i = tid; i < nv; i += kThreads)
      qs[i] = (q0 + i * 16 / d < b) ? qg[i] : make_uint4(0, 0, 0, 0);
    float* qscale = reinterpret_cast<float*>(qsm + align16((size_t)qb * d));
    int* qoff = reinterpret_cast<int*>(qscale + qb);
    for (int j = warp; j < qb; j += kWarps) {
      int s = 0;
      if (kInt4 && q0 + j < b)
        for (int i = lane; i < d; i += 32) s += q[(size_t)(q0 + j) * d + i];
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1)
        s += __shfl_xor_sync(kFull, s, off);
      if (lane == 0) {
        qoff[j] = 8 * s;
        qscale[j] = q0 + j < b ? q_scale[q0 + j] : 0.f;
      }
    }
  }
  template <int QB, int R>
  __device__ void accumulate(int (&acc)[R][QB], const uint4 (&raw)[R],
                             const char* qsm, int v) const {
#pragma unroll
    for (int j = 0; j < QB; ++j) {
      const char* qrow = qsm + (size_t)j * d;
      const uint4 qa = reinterpret_cast<const uint4*>(qrow)[v];
      if (!kInt4) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          acc[r][j] = __dp4a((int)raw[r].x, (int)qa.x, acc[r][j]);
          acc[r][j] = __dp4a((int)raw[r].y, (int)qa.y, acc[r][j]);
          acc[r][j] = __dp4a((int)raw[r].z, (int)qa.z, acc[r][j]);
          acc[r][j] = __dp4a((int)raw[r].w, (int)qa.w, acc[r][j]);
        }
      } else {
        const uint4 qh = reinterpret_cast<const uint4*>(qrow + d / 2)[v];
#pragma unroll
        for (int r = 0; r < R; ++r) {
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const unsigned w = (&raw[r].x)[t];
            const int lo8 = (int)(w & 0x0F0F0F0Fu);               // lo + 8
            const int hi8 = (int)(((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u);
            acc[r][j] = __dp4a(lo8, (int)(&qa.x)[t], acc[r][j]);
            acc[r][j] = __dp4a(hi8, (int)(&qh.x)[t], acc[r][j]);
          }
        }
      }
    }
  }
  template <int QB>
  __device__ float score(int tot, int qi, int row, const char* qsm) const {
    const float* qscale =
        reinterpret_cast<const float*>(qsm + align16((size_t)QB * d));
    const int* qoff = reinterpret_cast<const int*>(qscale + QB);
    const int acc = kInt4 ? tot - qoff[qi] : tot;
    return (float)acc * qscale[qi] * x_scale[row];
  }
};

template <bool kInt4>
cudaError_t run_int(const void* x, const void* x_scale, const void* q,
                    const void* q_scale, const void* mask, void* cand_s,
                    void* cand_i, int n, int d, int b, int k, int num_valid,
                    int qb, int rows_per_slice, int num_slices,
                    cudaStream_t stream) {
  const IntRows<kInt4> rows{static_cast<const int8_t*>(x),
                            static_cast<const float*>(x_scale),
                            static_cast<const int8_t*>(q),
                            static_cast<const float*>(q_scale), d};
  return dispatch_qb(qb, rows, mask, n, d, b, k, num_valid, rows_per_slice,
                     num_slices, cand_s, cand_i, stream);
}

}  // namespace

extern "C" {

// Shared memory pass 1 needs for a query block of qb rows of logical width
// d (int4 = 0 or 1); the wrapper sizes qb with it.
long long isf_topk_int_pass1_smem(int int4, int qb, int d, int k) {
  return (long long)(int4 ? pass1_smem<IntRows<true>>(qb, d, k)
                          : pass1_smem<IntRows<false>>(qb, d, k));
}

// x: int8 rows [n, d] (int4 = 0) or packed nibble pairs [n, d / 2]
// (int4 = 1); x_scale [n] f32; q [b, d] int8 and q_scale [b] f32, the query
// quantized per row; d % 16 == 0 (int8) or d % 32 == 0 (int4); all pointers
// 16-byte aligned. mask may be null. cand_s/cand_i hold b * num_slices * k
// entries. Returns the CUDA error code (0 = launched).
int isf_topk_matmul_int(const void* x, const void* x_scale, const void* q,
                        const void* q_scale, const void* mask, void* out_s,
                        void* out_i, void* cand_s, void* cand_i, int n, int d,
                        int b, int k, int num_valid, int int4, int qb,
                        int rows_per_slice, int num_slices,
                        void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (bad_plan(n, d, b, k, rows_per_slice, num_slices) ||
      d % (int4 ? 32 : 16) != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err =
      int4 ? run_int<true>(x, x_scale, q, q_scale, mask, cand_s, cand_i, n, d,
                           b, k, num_valid, qb, rows_per_slice, num_slices,
                           stream)
           : run_int<false>(x, x_scale, q, q_scale, mask, cand_s, cand_i, n,
                            d, b, k, num_valid, qb, rows_per_slice,
                            num_slices, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_pass2(cand_s, cand_i, out_s, out_i, b, k, num_slices,
                           stream);
}

}  // extern "C"
