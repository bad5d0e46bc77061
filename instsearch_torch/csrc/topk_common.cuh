// Split-N fused top-k, shared by the port's top-k kernels (K1 topk_matmul,
// K2 topk_matmul_int8, K3 topk_matmul_int4, K4 pq_topk): the selection
// code and pass 2 for all four. Every pass 1 lies elsewhere: K1's bf16 and
// f32 stores and K2/K3's int8 and int4 stores take the TMA + wgmma pass 1
// of topk_wgmma.cuh, K4 its own in pq_scan.cu (which keeps warp_insert).
//
// Pass 1: block (qblock, slice) scores rows [slice * rows_per_slice, ...)
// against a block of queries and keeps each query's top-k of its slice in
// shared memory. Pass 2 merges each query's candidate lists. The TPU
// kernels carry one running top-k across a sequential grid; Hopper runs
// blocks in parallel, hence the split.
//
// Ranking rules, the TPU kernels' own: (score desc, position asc); rows at
// or past num_valid, or whose mask entry is not > 0, never enter; slots
// past the count of valid rows come back as (-inf, -1).
//
// Everything here has internal linkage: each source that includes it gets
// its own copy of the kernels.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                    // K4's pass 1: scoring warps
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 256;                  // K4's rows a chunk; slices are
                                             // multiples of it
constexpr int kMergeMaxWarps = 32;           // pass 2: warps per query
constexpr int kMergeSmem = 96 * 1024;        // pass 2: bytes of lists a block keeps
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr size_t align16(size_t v) {
  return (v + 15) / 16 * 16;
}

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ bool better(float s1, int p1, float s2, int p2) {
  // (score desc, position asc); NaN never wins
  return s1 > s2 || (s1 == s2 && p1 < p2);
}

// Insert (s, p) into the sorted list ls/li of length k; the caller has
// checked that it beats ls[k-1]. Warp-cooperative; lists live in shared
// memory and are private to the calling warp.
__device__ void warp_insert(float* ls, int* li, int k, float s, int p,
                            int lane) {
  int rank = 0;
  for (int base = 0; base < k; base += 32) {
    const int i = base + lane;
    const bool b = i < k && better(ls[i], li[i], s, p);
    rank += __popc(__ballot_sync(kFull, b));
  }
  // shift [rank, k - 1) up by one slot, the highest group of 32 first, so a
  // group reads its left neighbour before that neighbour is overwritten
  const int lo = (rank / 32) * 32;
  for (int base = ((k - 1) / 32) * 32; base >= lo; base -= 32) {
    const int i = base + lane;
    const bool mv = i > rank && i < k;
    float vs = 0.f;
    int vi = 0;
    if (mv) {
      vs = ls[i - 1];
      vi = li[i - 1];
    }
    __syncwarp();
    if (mv) {
      ls[i] = vs;
      li[i] = vi;
    }
    __syncwarp();
  }
  if (lane == 0) {
    ls[rank] = s;
    li[rank] = p;
  }
  __syncwarp();
}

// Number of entries of the sorted list ls/li (length k) that are better
// than (s, p): they form a prefix, found by binary search.
__device__ __forceinline__ int count_better(const float* ls, const int* li,
                                            int k, float s, int p) {
  int lo = 0, hi = k;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (better(ls[mid], li[mid], s, p))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// a <- top k of the sorted lists a and b (each of length k, in shared
// memory; c is scratch of the same size). Every element's rank in the
// union is its index plus the count of better elements in the other list;
// valid entries are distinct (row positions are unique), so the ranks of
// valid entries are a permutation, and the (-inf, -1) fillers land past
// them. Warp-cooperative.
__device__ void warp_merge(float* a_s, int* a_i, const float* b_s,
                           const int* b_i, float* c_s, int* c_i, int k,
                           int lane) {
  for (int i = lane; i < k; i += 32) {
    const int r = i + count_better(b_s, b_i, k, a_s[i], a_i[i]);
    if (r < k) {
      c_s[r] = a_s[i];
      c_i[r] = a_i[i];
    }
  }
  for (int j = lane; j < k; j += 32) {
    const int r = j + count_better(a_s, a_i, k, b_s[j], b_i[j]);
    if (r < k) {
      c_s[r] = b_s[j];
      c_i[r] = b_i[j];
    }
  }
  __syncwarp();
  for (int i = lane; i < k; i += 32) {
    a_s[i] = c_s[i];
    a_i[i] = c_i[i];
  }
  __syncwarp();
}

// Pass 2: one block per query. Warp w merges the sorted lists of slices
// w, w + W, ... into its own list (slices whose best entry cannot beat the
// list's k-th are skipped), then the warps' lists merge pairwise in a tree.
__global__ void __launch_bounds__(kMergeMaxWarps * 32)
topk_pass2(const float* __restrict__ cand_s, const int* __restrict__ cand_i,
           int k, int num_slices, float* __restrict__ out_s,
           int* __restrict__ out_i) {
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int qi = blockIdx.x;
  // per warp: list a, incoming list b, scratch c; each k scores + k ids
  float* base = reinterpret_cast<float*>(smem4) + (size_t)warp * 6 * k;
  float* a_s = base;
  int* a_i = reinterpret_cast<int*>(base + k);
  float* b_s = base + 2 * k;
  int* b_i = reinterpret_cast<int*>(base + 3 * k);
  float* c_s = base + 4 * k;
  int* c_i = reinterpret_cast<int*>(base + 5 * k);
  for (int i = lane; i < k; i += 32) {
    a_s[i] = neg_inf();
    a_i[i] = -1;
  }
  __syncwarp();
  for (int sl = warp; sl < num_slices; sl += nwarps) {
    const size_t g = ((size_t)qi * num_slices + sl) * k;
    if (!better(cand_s[g], cand_i[g], a_s[k - 1], a_i[k - 1])) continue;
    for (int j = lane; j < k; j += 32) {
      b_s[j] = cand_s[g + j];
      b_i[j] = cand_i[g + j];
    }
    __syncwarp();
    warp_merge(a_s, a_i, b_s, b_i, c_s, c_i, k, lane);
  }
  for (int step = 1; step < nwarps; step *= 2) {
    __syncthreads();
    if (warp % (2 * step) == 0 && warp + step < nwarps) {
      const float* o_s = a_s + (size_t)step * 6 * k;
      const int* o_i = reinterpret_cast<const int*>(o_s + k);
      if (better(o_s[0], o_i[0], a_s[k - 1], a_i[k - 1]))
        warp_merge(a_s, a_i, o_s, o_i, c_s, c_i, k, lane);
    }
  }
  if (warp == 0) {
    for (int i = lane; i < k; i += 32) {
      out_s[(size_t)qi * k + i] = a_s[i];
      out_i[(size_t)qi * k + i] = a_i[i];
    }
  }
}

bool bad_plan(int n, int d, int b, int k, int rows_per_slice,
              int num_slices) {
  return n <= 0 || b <= 0 || k <= 0 || d <= 0 || num_slices <= 0 ||
         rows_per_slice <= 0 || rows_per_slice % kChunk != 0;
}

cudaError_t launch_pass2(const void* cand_s, const void* cand_i, void* out_s,
                         void* out_i, int b, int k, int num_slices,
                         cudaStream_t stream) {
  int nwarps = kMergeSmem / (6 * k * (int)sizeof(float));
  nwarps = nwarps < kMergeMaxWarps ? nwarps : kMergeMaxWarps;
  nwarps = nwarps < num_slices ? nwarps : num_slices;
  nwarps = nwarps > 1 ? nwarps : 1;
  const size_t smem2 = (size_t)nwarps * 6 * k * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      topk_pass2, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem2);
  if (err != cudaSuccess) return err;
  topk_pass2<<<b, nwarps * 32, smem2, stream>>>(
      static_cast<const float*>(cand_s), static_cast<const int*>(cand_i), k,
      num_slices, static_cast<float*>(out_s), static_cast<int*>(out_i));
  return cudaGetLastError();
}

}  // namespace
