// Fused PQ-ADC top-k over 4-bit product-quantization codes, for Hopper
// (sm_90a): K4.
//
// Replaces the TPU kernel instsearch_tpu/kernels/pq_scan.py::pq_topk (Pallas
// body `_kernel_pq`, its one-hot construction `_onehot_half`, and K1's
// epilogue `_fold_tile`). Same function:
//   codes [N, M/2] int8: byte j holds the code of subspace j in its low
//         nibble (byte - 16 * (byte >> 4)) and of subspace j + M/2 in its
//         high nibble ((byte >> 4) + 8), ops/pq.py::encode_pq;
//   lut   [B, M, 16] f32: ops/pq.py::pq_lut(q, codebook), rounded to bf16 by
//         the wrapper;
//   ->    scores [B, k] f32 = s_lo + s_hi, where s_lo is the f32 sum of
//         lut[b, m, code_m] over m < M/2 in ascending m, from 0, and s_hi
//         the same over m >= M/2; sorted descending, with row positions
//         [B, k] int32.
// That order of additions is the plain version's
// (instsearch_torch/kernels/pq_scan.py::pq_topk_reference), so the two agree
// bit for bit. Rows >= num_valid or with mask <= 0 are never returned; ties
// go to the lowest row position; slots past the count of valid rows come
// back as (-inf, -1).
//
// What bounds it on the card. Bytes: N * M/2 of codes plus the LUT, each
// read once: at 1M rows and M = 64, 32 MiB, about 0.010 ms at the H100's
// published 3.35 TB/s; at 64M rows 2 GiB, about 0.64 ms. Operations: B * N
// * M f32 additions, each of a LUT entry looked up in shared memory: at B =
// 128 over 1M rows 8.6e9, about 0.13 ms at the published 67 TFLOP/s f32
// rate, and the lookups (one per addition, 32 per SM and clock) are
// tighter still. So from a few queries up K4 is bound by its lookups and
// by selection, not by bytes; only B = 1 over many rows is a stream.
//
// What the design does about it. The TPU has no fast gather, so its kernel
// turns the lookup into a matmul against a one-hot expansion of the codes.
// Hopper gathers from shared memory at one lookup per lane and clock, so
// this kernel looks the entries up directly:
//   * K1's split-N passes and selection (topk_common.cuh), with a policy
//     that scores a whole chunk (kScoresChunk): each of a block's 256
//     threads scores one row of the 256-row chunk for all QB queries of the
//     block, so a warp scores 32 rows. The f32 store's scoring (a warp per
//     row, its lanes over the row's 16-byte vectors, then a warp
//     reduction) would leave 30 of 32 lanes idle on a 32-byte row, and its
//     reduction would cost more than the lookups;
//   * each thread loads its row's M/2 bytes as 4-byte words and unpacks the
//     nibbles in registers: the low nibble as it is, the high one as
//     (nibble ^ 8), the same codes as the reference's arithmetic;
//   * the LUT block [QB, M, 16] f32 sits in shared memory (4 KB per query
//     at M = 64, 32 KB at QB = 8). The lanes of a warp read entries of one
//     (query, subspace) at a time: at most 16 distinct words in 16 distinct
//     banks, so there are no bank conflicts.
// Simple first: no one-hot wgmma, no TMA, no several rows per thread.

#include "topk_common.cuh"

namespace {

struct PQRows {
  static constexpr bool kScoresChunk = true;
  const int8_t* codes;      // [n, m / 2]
  const float* lut;         // [b, m, 16]
  int m;

  // the LUT block [qb, m, 16] f32
  __host__ __device__ static size_t query_bytes(int qb, int m) {
    return align16((size_t)qb * m * 16 * sizeof(float));
  }
  __device__ void load_query(char* qsm, int qb, int q0, int b, int tid,
                             int lane, int warp) const {
    float* l = reinterpret_cast<float*>(qsm);
    const int per = m * 16;
    for (int i = tid; i < qb * per; i += kThreads)
      l[i] = q0 + i / per < b ? lut[(size_t)q0 * per + i] : 0.f;
  }
  template <int QB>
  __device__ void score_chunk(float* sc, int chunk, int valid_end,
                              const int8_t* mask, const char* qsm,
                              int tid) const {
    const float* l = reinterpret_cast<const float*>(qsm);
    const int row = chunk + tid;
    const int groups = m / 2;
    const int per = m * 16;
    const bool ok = row < valid_end && (mask == nullptr || mask[row] > 0);
    float s_lo[QB], s_hi[QB];
#pragma unroll
    for (int j = 0; j < QB; ++j) s_lo[j] = s_hi[j] = 0.f;
    if (ok) {
      const unsigned* p =
          reinterpret_cast<const unsigned*>(codes + (size_t)row * groups);
      for (int w = 0; w < groups / 4; ++w) {
        const unsigned word = __ldg(p + w);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int g = 4 * w + t;                          // subspace g
          const int lo = (word >> (8 * t)) & 15;
          const int hi = ((word >> (8 * t + 4)) & 15) ^ 8;  // of g + M/2
          const float* e_lo = l + g * 16 + lo;
          const float* e_hi = l + (g + groups) * 16 + hi;
#pragma unroll
          for (int j = 0; j < QB; ++j) {
            s_lo[j] += e_lo[j * per];
            s_hi[j] += e_hi[j * per];
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < QB; ++j)
      sc[j * kChunk + tid] = ok ? s_lo[j] + s_hi[j] : neg_inf();
  }
};

}  // namespace

extern "C" {

// Shared memory pass 1 needs for a query block of qb rows with m subspaces;
// the wrapper sizes qb with it.
long long isf_pq_pass1_smem(int qb, int m, int k) {
  return (long long)pass1_smem<PQRows>(qb, m, k);
}

// codes: [n, m / 2] int8, 4-byte aligned, m % 8 == 0; lut [b, m, 16] f32
// holding bf16 values; mask may be null. cand_s/cand_i hold b * num_slices
// * k entries. Returns the CUDA error code (0 = launched).
int isf_pq_topk(const void* codes, const void* lut, const void* mask,
                void* out_s, void* out_i, void* cand_s, void* cand_i, int n,
                int m, int b, int k, int num_valid, int qb,
                int rows_per_slice, int num_slices, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (bad_plan(n, m, b, k, rows_per_slice, num_slices) || m % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const PQRows rows{static_cast<const int8_t*>(codes),
                    static_cast<const float*>(lut), m};
  cudaError_t err = dispatch_qb(qb, rows, mask, n, m, b, k, num_valid,
                                rows_per_slice, num_slices, cand_s, cand_i,
                                stream);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_pass2(cand_s, cand_i, out_s, out_i, b, k, num_slices,
                           stream);
}

}  // extern "C"
