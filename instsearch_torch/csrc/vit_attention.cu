// Forward multi-head attention for the ViT backbones, for Hopper (sm_90a):
// K6 `mha` (the softmax normalised over whole key rows) and K5 `flash_mha`
// (key/value tiles with the online softmax).
//
// Replaces the TPU kernels of instsearch_tpu/kernels/vit_attention.py:
//   * K6 `mha` (:103, Pallas body `_attn_kernel`): q, k, v [B, h, N, hd] ->
//     o of the same shape. f32 logits q.k * (1/sqrt(hd)), the softmax
//     normalised in f32 over the N valid keys, p ROUNDED to the input dtype
//     after the normalisation, p.v summed in f32, the result cast to the
//     input dtype.
//   * K5 `flash_mha` (:190, Pallas body `_flash_kernel` at :116): the same
//     attention over key/value tiles of 128 keys (the reference's kv_block;
//     in bf16 the tiling is part of the result, see below), the TPU's
//     sequential kv grid axis becoming a loop inside the block. Per tile:
//     logits masked past N with the finite -1e30 (a fully masked tile then
//     cannot NaN the rescale), m_new = max(m, tile max), p = exp(logits -
//     m_new), corr = exp(m - m_new), l = corr * l + sum(p) of the UNROUNDED
//     p, acc = corr * acc + p.v with p ROUNDED to the input dtype first;
//     o = acc / l at the end. In bf16 K5 and K6 therefore differ: K5 rounds
//     p before it is normalised, K6 after; and K5's rounded p depends on
//     m_new, so on where the tiles split. The f32 K5 keeps tiles of 64
//     keys: in f32 the tiling moves only the order of the sums.
// hd = 64 only, the head dim of ViT-B/16 and ViT-L/16.
//
// What bounds it on the card. The work is 4 * B * h * N^2 * hd operations
// (two products of N x N x hd per head), the bytes only q, k, v and o: at
// 16,385 tokens (2048 px) 824 GFLOP against 101 MB per layer, bound by
// operations (0.834 ms at the tensor cores' 989 TFLOP/s in bf16); at 197
// tokens and B = 64, 7.6 GFLOP against 77.5 MB (q, k, v and o, 19.4 MB
// each), bound by bytes (0.0231 ms at 3.35 TB/s). Neither kernel writes the
// [N, N] logits to device memory.
//
// What the designs do about it.
//   * K5 in bf16 (the served high-resolution path), bound by operations,
//     takes Hopper's full tensor-core route (flash_kernel_tma; PTX in
//     hopper.cuh): both products by wgmma, q, K and V tiles by TMA
//     (128-byte swizzle, the layout wgmma reads; rows past N zero-filled)
//     into three mbarrier-guarded stages that one producer thread keeps
//     full, two consumer warpgroups of 64 query rows each with the
//     registers setmaxnreg moves to them. The logits of a 128-key tile stay
//     in registers and become p.v's A operand there; V is read MN-major by
//     the instruction's transpose bit. At hd = 64 the softmax costs as much
//     as the products (one exponential per 128 operations; the card's
//     special-function units do 16 a cycle an SM against 4,096 operations
//     on the tensor cores), so the consumer issues tile j's q.k^T beside
//     tile j - 1's p.v before its softmax, and keeps the softmax's chains
//     short (online_softmax). One departure from the letter of the
//     reference: K5 works in base-2 units, p = 2^(s log2(e) / sqrt(hd) -
//     m2) by one FFMA and one ex2 (flushing subnormal p to 0), the function
//     e^(s - m) in another f32 order; p may land one bf16 step away from
//     the plain version's (tests/test_torch_vit_attention.py::
//     test_flash_exp2_form_moves_p_by_at_most_one_bf16_step bounds that).
//   * K6 in bf16 (the 224 px route), bound by bytes at 197 tokens, is one
//     kernel on K5's machinery (mha_kernel_tma): q, K and V boxes of 128
//     rows by TMA through K5's tensor maps, mbarriers, a producer warpgroup
//     demoted by setmaxnreg, two consumer warpgroups of 64 query rows, both
//     products by wgmma (S = q K^T from shared memory, p.V with p from
//     registers and V MN-major), and o written back by TMA from a q tile
//     the products are done with. Its blocks are persistent, one an SM,
//     over work items, so the producer loads the next item while the
//     consumers work on this one. K6 normalises p before it rounds it, so a
//     row's max and sum must be known before any p.v:
//       - At N <= 256 an item is a whole head: its q, K and V (one or two
//         boxes each, 48 or 96 KB) come into the SM once for all its query
//         rows, into one of two item buffers, V behind a barrier of its own
//         so that S need not wait for it; consumer warpgroup w takes the
//         head's 64-row sub-tiles w, w + 2 and skips those wholly past N.
//         The softmax is one pass (form a, mha_one_pass): a sub-tile's
//         64 x 256 f32 logits stay in registers (128 of the 168 ptxas gives
//         a thread of a 384-thread block), the rows' exact max and sum come
//         from quad shuffles, and p is rounded to bf16 pairs in place, the A
//         fragments of p.v. The other form, (b), two passes over the
//         resident K (QK^T twice, the max and sum online in the first, as
//         past 256 tokens), took 0.062-0.065 ms at [64, 12, 197, 64]
//         against (a)'s 0.043 on an H100 80GB HBM3 at 700 W
//         (tools/k6_profile.py builds it; PERF.md §6). There the softmax
//         sets the pace, not the bytes: the products, the waits for loads
//         and the stores take about 20, 13 and 6% of a consumer warp's
//         cycles.
//       - Past 256 tokens an item is 128 query rows of a head, and the two
//         passes stream its keys in boxes of 128 through a ring of
//         kMhaStages stages: pass 1 K alone, for each row's max and sum
//         online; pass 2 K and V, for p and p.v.
//     Either way p = 2^(t - m2) (1 / l) in f32, t the logits in base-2
//     units (t = q.k log2(e) / sqrt(hd) - m2 by one FFMA, then one
//     ex2.approx.ftz a logit, as K5: exp(s - m) / l in another f32 order,
//     subnormal terms 0), rounded to bf16 after the normalisation, as the
//     reference does; keys past N are masked by position (their
//     zero-filled logits are 0, not masked) and rows past N are never
//     written. tests/test_torch_vit_attention.py emulates both forms and
//     bounds what the base-2 form moves p by
//     (test_one_pass_ftz_form_moves_p_by_at_most_one_bf16_step).
//   * f32: K5's plan and K6's first one (16 query rows, their whole f32
//     logit rows in shared memory, so the wrapper refuses N past what 227 KB
//     holds, about 3,264 tokens) on CUDA cores, plain FMA (f32 inputs are
//     never rounded to TF32), each thread a register tile (8 rows x 4 keys
//     in K5, 2 x 4 in K6) fed by 16-byte shared loads; q, k and v tiles
//     staged in shared memory with padded rows. f32 is off the served path.
//
// Layout: q, k and v are [B, h, N, hd] views with any element strides over
// B, h and N (shared by the three) and hd contiguous, so the model passes
// its qkv projection [B, N, 3, h, hd] as it is (row stride 3 h hd, head
// offset hd) and nothing is transposed or copied; o has strides of its own
// (the wrapper gives it [B, N, h, hd] memory, so merging the heads is free).
//
// The wrappers (instsearch_torch/kernels/vit_attention.py) allocate the
// output and check shapes, dtypes, devices, strides and alignment; this file
// allocates nothing and launches on the caller's stream.

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kHd = 64;            // head dim the kernels are built for
constexpr int kThreads = 128;
constexpr int kStride = kHd + 4;   // f32 row stride of a staged tile: 272
                                   // bytes, so 8 rows' 16-byte loads fall
                                   // in 8 distinct bank groups
constexpr int kMhaRows = 16;       // K6 f32: query rows per block
constexpr int kMhaKeys = 64;       // K6 f32: keys staged per chunk
constexpr int kFlashRows = 64;     // K5 f32: query rows per block
constexpr int kFlashKeys = 64;     // K5 f32: keys per key/value tile
constexpr int kTmaRows = 128;      // K5 bf16: query rows per block
constexpr int kTmaKeys = 128;      // K5 bf16: keys per key/value tile, the
                                   // reference's kv_block
constexpr int kTmaStages = 3;      // K5 bf16: K/V stages in the ring
constexpr float kFlashNeg = -1e30f;
constexpr float kLog2e = 1.44269504088896340736f;   // base-2 logits
constexpr int kMhaBox = 128;       // K6 bf16: rows of a q, K or V box
constexpr int kMhaBoxElems = kMhaBox * kHd;   // 16 KB of bf16
constexpr int kMhaResident = 2;    // K6 bf16: key boxes a resident head
                                   // holds at most (N <= 256)
constexpr int kMhaStages = 5;      // K6 bf16 past 256 tokens: ring stages

// Element strides of a [B, h, N, hd] operand over B, h and N (hd is
// contiguous).
struct Layout {
  long long b, h, n;
};

// Offset of block (batch x head) blockIdx.y's head in an operand.
__device__ __forceinline__ size_t head_base(const Layout& s, int heads) {
  return (size_t)(blockIdx.y / heads) * s.b + (size_t)(blockIdx.y % heads) * s.h;
}

// Rows [row0, row0 + rows) of one head's f32 [n, kHd] matrix (row stride
// ld) into shared memory as [rows][kStride]; rows at or past n are zeros.
__device__ __forceinline__ void stage_f32(float* dst, const float* src,
                                          size_t ld, int row0, int rows,
                                          int n) {
  for (int i = threadIdx.x; i < rows * (kHd / 4); i += kThreads) {
    const int r = i / (kHd / 4);
    const int c = (i % (kHd / 4)) * 4;
    *reinterpret_cast<float4*>(dst + r * kStride + c) = row0 + r < n
        ? __ldg(reinterpret_cast<const float4*>(src + (row0 + r) * ld + c))
        : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Over each half-warp of 16 lanes; every lane ends with the same bits (a
// butterfly adds the same two values on both partners at every step).
__device__ __forceinline__ float half_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void fma4(float& acc, const float4& a,
                                     const float4& b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  acc = fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float (&acc)[4], float p,
                                      const float4& v) {
  acc[0] = fmaf(p, v.x, acc[0]);
  acc[1] = fmaf(p, v.y, acc[1]);
  acc[2] = fmaf(p, v.z, acc[2]);
  acc[3] = fmaf(p, v.w, acc[3]);
}

__device__ __forceinline__ void store_row4(float* dst, const float (&acc)[4],
                                           float div) {
  *reinterpret_cast<float4*>(dst) =
      make_float4(acc[0] / div, acc[1] / div, acc[2] / div, acc[3] / div);
}

// K6's f32 softmax over the n valid keys of each of its kMhaRows logit rows
// in shared memory, one warp per row: exp(x - max) / sum; the padding up to
// npad becomes 0.
__device__ __forceinline__ void softmax_rows(float* s, int sstride, int n,
                                             int npad) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kMhaRows; r += kThreads / 32) {
    float* row = s + r * sstride;
    float m = -INFINITY;
    for (int j = lane; j < n; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < npad; j += 32) {
      row[j] = j < n ? row[j] / sum : 0.f;
    }
  }
}

// K6 in f32. Block (query tile, batch x head); thread t owns query rows
// 2 (t / 16) and 2 (t / 16) + 1 and, in the logits, keys t % 16 + 16 j of a
// chunk; in p.v, dims 4 (t % 16) .. + 3.
__global__ void __launch_bounds__(kThreads)
    mha_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ o,
                   Layout in, Layout out, int heads, int n, int npad,
                   float scale) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // [kMhaRows][kStride]
  float* kv = qs + kMhaRows * kStride;           // [kMhaKeys][kStride]
  float* s = kv + kMhaKeys * kStride;            // [kMhaRows][sstride]
  const int sstride = npad + 4;
  const size_t base = head_base(in, heads);
  const int q0 = blockIdx.x * kMhaRows;
  const int t = threadIdx.x;
  const int r0 = 2 * (t / 16);
  const int g = t % 16;

  stage_f32(qs, q + base, in.n, q0, kMhaRows, n);
  for (int c0 = 0; c0 < npad; c0 += kMhaKeys) {
    __syncthreads();                 // kv free (and qs staged)
    stage_f32(kv, k + base, in.n, c0, kMhaKeys, n);
    __syncthreads();
    float acc[2][4] = {};
#pragma unroll 4
    for (int d = 0; d < kHd; d += 4) {
      const float4 qa = *reinterpret_cast<const float4*>(qs + r0 * kStride + d);
      const float4 qb =
          *reinterpret_cast<const float4*>(qs + (r0 + 1) * kStride + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 kk =
            *reinterpret_cast<const float4*>(kv + (g + 16 * j) * kStride + d);
        fma4(acc[0][j], qa, kk);
        fma4(acc[1][j], qb, kk);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        s[(r0 + i) * sstride + c0 + g + 16 * j] = acc[i][j] * scale;
  }
  __syncthreads();

  softmax_rows(s, sstride, n, npad);

  float acc[2][4] = {};
  for (int c0 = 0; c0 < npad; c0 += kMhaKeys) {
    __syncthreads();                 // kv free, s normalised
    stage_f32(kv, v + base, in.n, c0, kMhaKeys, n);
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < kMhaKeys; j += 4) {
      const float4 pa =
          *reinterpret_cast<const float4*>(s + r0 * sstride + c0 + j);
      const float4 pb =
          *reinterpret_cast<const float4*>(s + (r0 + 1) * sstride + c0 + j);
      const float pav[4] = {pa.x, pa.y, pa.z, pa.w};
      const float pbv[4] = {pb.x, pb.y, pb.z, pb.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float4 vv =
            *reinterpret_cast<const float4*>(kv + (j + e) * kStride + 4 * g);
        axpy4(acc[0], pav[e], vv);
        axpy4(acc[1], pbv[e], vv);
      }
    }
  }
  const size_t obase = head_base(out, heads);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + i;
    if (row < n) store_row4(o + obase + row * out.n + 4 * g, acc[i], 1.f);
  }
}

// K5 in f32. Block (query tile, batch x head); thread t owns query rows
// 8 (t / 16) .. + 7 and, in the logits, keys t % 16 + 16 j of a tile; in
// p.v, dims 4 (t % 16) .. + 3 of the same rows, so m, l and the rescale
// stay in its registers.
__global__ void __launch_bounds__(kThreads)
    flash_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     Layout in, Layout out, int heads, int n, float scale) {
  constexpr int KB = kFlashKeys;
  constexpr int RPT = kFlashRows / 8;   // rows per thread
  constexpr int KPT = KB / 16;          // keys per thread in a tile
  constexpr int PS = KB + 4;            // row stride of the p tile
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // [kFlashRows][kStride]
  float* ks = qs + kFlashRows * kStride;         // [KB][kStride]
  float* vs = ks + KB * kStride;                 // [KB][kStride]
  float* ps = vs + KB * kStride;                 // [kFlashRows][PS]
  const size_t base = head_base(in, heads);
  const int q0 = blockIdx.x * kFlashRows;
  const int t = threadIdx.x;
  const int r0 = RPT * (t / 16);
  const int g = t % 16;

  float m[RPT], l[RPT], acc[RPT][4];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = kFlashNeg;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  }

  stage_f32(qs, q + base, in.n, q0, kFlashRows, n);
  for (int c0 = 0; c0 < n; c0 += KB) {
    __syncthreads();                 // ks, vs, ps free (and qs staged)
    stage_f32(ks, k + base, in.n, c0, KB, n);
    stage_f32(vs, v + base, in.n, c0, KB, n);
    __syncthreads();

    float sc[RPT][KPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) sc[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < kHd; d += 4) {
      float4 kk[KPT];
#pragma unroll
      for (int j = 0; j < KPT; ++j)
        kk[j] = *reinterpret_cast<const float4*>(ks + (g + 16 * j) * kStride
                                                 + d);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float4 qq =
            *reinterpret_cast<const float4*>(qs + (r0 + i) * kStride + d);
#pragma unroll
        for (int j = 0; j < KPT; ++j) fma4(sc[i][j], qq, kk[j]);
      }
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      float mx = kFlashNeg;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        sc[i][j] = c0 + g + 16 * j < n ? sc[i][j] * scale : kFlashNeg;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], half_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const float p = expf(sc[i][j] - m_new);
        sum += p;
        ps[(r0 + i) * PS + g + 16 * j] = p;
      }
      l[i] = corr * l[i] + half_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] *= corr;
    }
    __syncthreads();                 // the p tile is complete

#pragma unroll 2
    for (int j = 0; j < KB; j += 4) {
      float4 vv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        vv[e] = *reinterpret_cast<const float4*>(vs + (j + e) * kStride
                                                 + 4 * g);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float4 pp =
            *reinterpret_cast<const float4*>(ps + (r0 + i) * PS + j);
        axpy4(acc[i], pp.x, vv[0]);
        axpy4(acc[i], pp.y, vv[1]);
        axpy4(acc[i], pp.z, vv[2]);
        axpy4(acc[i], pp.w, vv[3]);
      }
    }
  }
  const size_t obase = head_base(out, heads);
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + r0 + i;
    if (row < n) store_row4(o + obase + row * out.n + 4 * g, acc[i], l[i]);
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores (wgmma; accumulator and fragment layouts:
// hopper.cuh).
// ---------------------------------------------------------------------------

// two floats rounded to bf16 (to nearest, ties to even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// K5 in bf16, warp-specialised (FlashAttention-3's shape): a block of
// kTmaRows query rows of one (batch, head) and 384 threads. Warpgroups 0 and
// 1 consume, 64 query rows each; warpgroup 2 produces: one of its threads
// loads the q tile once and streams the K and V tiles of kTmaKeys keys by TMA
// into a ring of kTmaStages stages, each guarded by a "full" barrier (the
// TMA transactions of one K and one V box) and an "empty" one (every
// consumer thread arrives when its p.v has read the stage). TMA zero-fills
// the rows at or past n. A consumer, per key tile j:
//   S = q K_j^T by wgmma m64n128k16 from shared memory (4 steps over hd),
//   f32, issued together with the p.v of tile j - 1;
//   the online softmax on S in registers (online_softmax: each thread 2
//   rows x 32 keys), keys at or past n masked by position (their
//   zero-filled logits are 0, not masked);
//   O = corr O + bf16(p) V_j by wgmma m64n64k16, p from registers (the
//   accumulator of S packed to bf16 pairs is the A fragment, hopper.cuh)
//   and V MN-major from shared memory (the transpose bit; no V transpose
//   in software).
// o = O / l, rounded to bf16, is stored from registers, rows past n
// skipped.
struct FlashTmaSmem {
  bf16 q[kTmaRows * kHd];                   // 1,024-aligned tiles
  bf16 k[kTmaStages][kTmaKeys * kHd];
  bf16 v[kTmaStages][kTmaKeys * kHd];
  uint64_t q_full, full[kTmaStages], empty[kTmaStages];
};

__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One key tile's online softmax for a consumer thread's two rows, in base-2
// units: sc holds the tile's q.k sums (sc[4 jj + e]: row e >> 1, key c0 +
// 8 jj + c + (e & 1)), scale2 = log2(e) / sqrt(hd), m2 the running max of
// sc scale2. On return sc holds p = 2^(sc scale2 - m2_new) (one FFMA and one
// ex2 a logit: e^(s - m) with s = sc / sqrt(hd), in another f32 order), m2
// is updated, corr = 2^(m2_old - m2_new), and l = corr l + sum p over this
// thread's 32 keys of the row: the quad's four shares of a row scale by the
// same corr, so they are added once, at the end. Both reductions run over
// two partial chains each, which halves their dependency chains (the
// softmax, not the products, sets K5's pace).
__device__ __forceinline__ void online_softmax(float (&sc)[kTmaKeys / 2],
                                               float (&m2)[2], float (&l)[2],
                                               float (&corr)[2], int c0,
                                               int c, int n, float scale2) {
  if (c0 + kTmaKeys > n) {                 // the ragged last tile
#pragma unroll
    for (int i = 0; i < kTmaKeys / 2; ++i)
      if (c0 + 8 * (i / 4) + c + (i & 1) >= n) sc[i] = -INFINITY;
  }
  float part[2][2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      part[r][h] = fmaxf(sc[4 * h + 2 * r], sc[4 * h + 2 * r + 1]);
#pragma unroll
  for (int jj = 2; jj < kTmaKeys / 8; ++jj)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      part[r][jj & 1] = fmaxf(part[r][jj & 1], fmaxf(sc[4 * jj + 2 * r],
                                                     sc[4 * jj + 2 * r + 1]));
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float rmax = quad_max(fmaxf(part[r][0], part[r][1]));
    const float m_new = fmaxf(m2[r], rmax * scale2);
    corr[r] = ex2_ftz(m2[r] - m_new);
    m2[r] = m_new;
    part[r][0] = part[r][1] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < kTmaKeys / 2; ++i) {
    const int r = (i >> 1) & 1;
    sc[i] = ex2_ftz(fmaf(sc[i], scale2, -m2[r]));
    part[r][(i >> 2) & 1] += sc[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    l[r] = corr[r] * l[r] + (part[r][0] + part[r][1]);
}

__global__ void __launch_bounds__(3 * 128, 1)
    flash_kernel_tma(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     bf16* __restrict__ o, Layout out, int heads, int n,
                     float scale2) {
  using namespace hopper;
  constexpr int S = kTmaStages;
  extern __shared__ uint8_t smem_raw[];
  FlashTmaSmem& sm = *reinterpret_cast<FlashTmaSmem*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  const int tiles = (n + kTmaKeys - 1) / kTmaKeys;
  const int q0 = blockIdx.x * kTmaRows;
  const int batch = blockIdx.y / heads, head = blockIdx.y % heads;
  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 2 * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 2 * 128) {            // ---- producer warpgroup
    setmaxnreg_dec<40>();
    if (threadIdx.x == 2 * 128) {
      mbar_expect_tx(&sm.q_full, sizeof(sm.q));
      tma_load_4d(sm.q, &tq, &sm.q_full, 0, q0, head, batch);
      for (int j = 0; j < tiles; ++j) {
        const int s = j % S;
        mbar_wait(&sm.empty[s], ((j / S) & 1) ^ 1);
        mbar_expect_tx(&sm.full[s], sizeof(sm.k[s]) + sizeof(sm.v[s]));
        tma_load_4d(sm.k[s], &tk, &sm.full[s], 0, j * kTmaKeys, head, batch);
        tma_load_4d(sm.v[s], &tv, &sm.full[s], 0, j * kTmaKeys, head, batch);
      }
    }
    return;
  }
  // ---- consumer warpgroups: 232 registers a thread (128 x 40 + 256 x 232
  // of the SM's 65,536 with one block)
  setmaxnreg_inc<232>();
  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int c = 2 * (lane % 4);
  const uint64_t dq = desc_sw128(sm.q + wg * 64 * kHd);
  float m2[2] = {kFlashNeg, kFlashNeg}, l[2] = {0.f, 0.f}, corr[2];
  float acc[kHd / 2];                      // O, the m64n64 accumulator
#pragma unroll
  for (int i = 0; i < kHd / 2; ++i) acc[i] = 0.f;
  float sc[kTmaKeys / 2];                  // S, then p, the m64n128 one
  uint32_t pa[kTmaKeys / 4], pb[kTmaKeys / 4];   // p as bf16 pairs: the
                                                // A of p.v, two buffers
  mbar_wait(&sm.q_full, 0);

  // The registers an in-flight wgmma reads or writes are pinned around it
  // (reg_fence), so the compiler neither moves nor copies them.
  auto issue_s = [&](int j) {              // S = q K_j^T, committed
    const int s = j % S;
    mbar_wait(&sm.full[s], (j / S) & 1);
#pragma unroll
    for (int i = 0; i < kTmaKeys / 2; ++i) reg_fence(sc[i]);
    wgmma_fence();
    const uint64_t dk = desc_sw128(sm.k[s]);
#pragma unroll
    for (int kk = 0; kk < kHd / 16; ++kk)
      wgmma_m64n128k16_ss(sc, dq + 2 * kk, dk + 2 * kk, kk);
    wgmma_commit();
  };
  auto issue_pv = [&](int j, uint32_t (&p)[kTmaKeys / 4]) {
#pragma unroll                             // O *= corr, then O += p V_j
    for (int i = 0; i < kHd / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
#pragma unroll
    for (int i = 0; i < kHd / 2; ++i) reg_fence(acc[i]);
#pragma unroll
    for (int i = 0; i < kTmaKeys / 4; ++i) reg_fence(p[i]);
    wgmma_fence();
    const uint64_t dv = desc_sw128(sm.v[j % S]);
#pragma unroll
    for (int kk = 0; kk < kTmaKeys / 16; ++kk)
      wgmma_m64n64k16_rs_tb(acc, p + 4 * kk, dv + 128 * kk, 1);
    wgmma_commit();
  };
  auto settle = [&]() {                    // after a wait
#pragma unroll
    for (int i = 0; i < kTmaKeys / 2; ++i) reg_fence(sc[i]);
#pragma unroll
    for (int i = 0; i < kHd / 2; ++i) reg_fence(acc[i]);
#pragma unroll
    for (int i = 0; i < kTmaKeys / 4; ++i) reg_fence(pa[i]);
#pragma unroll
    for (int i = 0; i < kTmaKeys / 4; ++i) reg_fence(pb[i]);
  };
  auto softmax_pack = [&](int j, uint32_t (&p)[kTmaKeys / 4]) {
    online_softmax(sc, m2, l, corr, j * kTmaKeys, c, n, scale2);
#pragma unroll
    for (int i = 0; i < kTmaKeys / 4; ++i)   // p rounded to bf16
      p[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
  };
  // Step j (FlashAttention-3's order): S_j is issued, then O, which holds
  // acc_{j-2}, is scaled by corr_{j-1} and p_{j-1} V_{j-1} issued, so O
  // becomes acc_{j-1} = corr_{j-1} acc_{j-2} + p_{j-1} V_{j-1}, the plain
  // version's recurrence; both products run on the tensor cores while the
  // softmax of tile j waits for S_j alone (wgmma groups complete in order:
  // wait<1> is S_j) and packs p_j into the other buffer, since p.v still
  // reads this one. The steps alternate the buffers.
  auto step = [&](int j, uint32_t (&cur)[kTmaKeys / 4],
                  uint32_t (&nxt)[kTmaKeys / 4]) {
    issue_s(j);
    issue_pv(j - 1, cur);
    wgmma_wait<1>();
    settle();
    softmax_pack(j, nxt);
    wgmma_wait<0>();
    settle();
    mbar_arrive(&sm.empty[(j - 1) % S]);
  };
  issue_s(0);
  wgmma_wait<0>();
  settle();
  softmax_pack(0, pa);                     // corr_0 = 0 scales O = 0
  int j = 1;
  for (; j + 1 < tiles; j += 2) {
    step(j, pa, pb);
    step(j + 1, pb, pa);
  }
  if (j < tiles) {
    step(j, pa, pb);
    issue_pv(tiles - 1, pb);
  } else {
    issue_pv(tiles - 1, pa);
  }
  wgmma_wait<0>();
  settle();
  mbar_arrive(&sm.empty[(tiles - 1) % S]);

  const size_t obase = (size_t)batch * out.b + (size_t)head * out.h;
  const int row0 = q0 + 64 * wg + 16 * (t / 32) + lane / 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const float lr = quad_sum(l[r]);       // before the skip: all lanes
    if (row >= n) continue;
#pragma unroll
    for (int d = 0; d < kHd / 8; ++d)
      *reinterpret_cast<uint32_t*>(o + obase + row * out.n + 8 * d + c) =
          pack_bf16(acc[4 * d + 2 * r] / lr, acc[4 * d + 2 * r + 1] / lr);
  }
}

// K6 in bf16 (mha_kernel_tma), warp-specialised and persistent: 384
// threads, one block an SM walking work items (blockIdx.x, then a grid
// further, ...). Warpgroup 2 produces: one of its threads loads each item's
// boxes of 128 rows by TMA, rows past n zero-filled. Warpgroups 0 and 1
// consume, 64 query rows at a time: S = q K^T by wgmma from shared memory
// (4 steps over hd, one m64n128 accumulator per 128 keys), the keys at or
// past n masked by position, p = 2^(t - m2) (1 / l) in f32 with t = S
// scale2, p rounded to bf16 pairs in registers (the A fragments of p.v),
// then O += p V by wgmma m64n64k16 with V MN-major from shared memory (the
// transpose bit); O goes back by TMA from the q tile the product no longer
// needs (mha_store), rows past n left out.
//   KT = 1, 2 (n <= 128 KT): an item is a whole head, q, K and V KT boxes
//     each, into one of two item buffers guarded by a "full" barrier (the
//     TMA transactions of q and K), a "vfull" one (V's, which S does not
//     wait for) and an "empty" one (every consumer thread arrives when it
//     is done with the item). Consumer w takes the head's 64-row sub-tiles
//     w, w + 2 below n, each in one pass over its whole rows (form a).
//   KT = 0 (n > 256): an item is 128 query rows of a head (qtiles a head),
//     its q into one of two buffers; its key boxes stream through a ring of
//     kMhaStages stages, once for pass 1 (K) and once for pass 2 (K and V),
//     each stage guarded as K5's are. Consumer w takes rows 64 w.. of the
//     item; wholly past n, it issues no products but still releases every
//     stage.
template <int KT>
struct MhaTmaSmem {                     // 1,024-aligned boxes
  bf16 q[2][KT * kMhaBoxElems];
  bf16 k[2][KT * kMhaBoxElems];
  bf16 v[2][KT * kMhaBoxElems];
  uint64_t full[2], vfull[2], empty[2];
};

template <>
struct MhaTmaSmem<0> {
  bf16 q[2][kMhaBoxElems];
  bf16 k[kMhaStages][kMhaBoxElems];
  bf16 v[kMhaStages][kMhaBoxElems];
  uint64_t q_full[2], q_empty[2], full[kMhaStages], empty[kMhaStages];
};

// Keys at or past n of the box of keys c0.. out of the softmax: -inf, so
// that 2^(t - m2) is an exact 0 there (sc[4 jj + e] holds key c0 + 8 jj + c
// + (e & 1)).
__device__ __forceinline__ void mha_mask(float (&sc)[64], int c0, int c,
                                         int n) {
  if (c0 + kMhaBox > n) {
#pragma unroll
    for (int i = 0; i < 64; ++i)
      if (c0 + 8 * (i / 4) + c + (i & 1) >= n) sc[i] = -INFINITY;
  }
}

// S = q K^T over `boxes` boxes of 128 keys, waited for: sc[x] from the 64
// query rows that dq describes and the x-th K box from kb.
template <int boxes>
__device__ __forceinline__ void mha_logits(float (&sc)[boxes][64],
                                           uint64_t dq, const bf16* kb) {
  using namespace hopper;
#pragma unroll
  for (int x = 0; x < boxes; ++x)
#pragma unroll
    for (int i = 0; i < 64; ++i) reg_fence(sc[x][i]);
  wgmma_fence();
#pragma unroll
  for (int x = 0; x < boxes; ++x) {
    const uint64_t dk = desc_sw128(kb + x * kMhaBoxElems);
#pragma unroll
    for (int kk = 0; kk < kHd / 16; ++kk)
      wgmma_m64n128k16_ss(sc[x], dq + 2 * kk, dk + 2 * kk, kk);
  }
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int x = 0; x < boxes; ++x)
#pragma unroll
    for (int i = 0; i < 64; ++i) reg_fence(sc[x][i]);
}

// acc += p V over `boxes` boxes of 128 keys, waited for: pa[x] is the x-th
// box's p as bf16 pairs (pa[x][q] = entries 2q, 2q + 1 of the accumulator
// layout, so pa[x] + 4 kk is the A fragment of keys 16 kk..), the V boxes
// from vb.
template <int boxes>
__device__ __forceinline__ void mha_pv(float (&acc)[kHd / 2],
                                       uint32_t (&pa)[boxes][32],
                                       const bf16* vb) {
  using namespace hopper;
#pragma unroll
  for (int i = 0; i < kHd / 2; ++i) reg_fence(acc[i]);
#pragma unroll
  for (int x = 0; x < boxes; ++x)
#pragma unroll
    for (int i = 0; i < 32; ++i) reg_fence(pa[x][i]);
  wgmma_fence();
#pragma unroll
  for (int x = 0; x < boxes; ++x) {
    const uint64_t dv = desc_sw128(vb + x * kMhaBoxElems);
#pragma unroll
    for (int kk = 0; kk < kMhaBox / 16; ++kk)
      wgmma_m64n64k16_rs_tb(acc, pa[x] + 4 * kk, dv + 128 * kk, 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < kHd / 2; ++i) reg_fence(acc[i]);
#pragma unroll
  for (int x = 0; x < boxes; ++x)
#pragma unroll
    for (int i = 0; i < 32; ++i) reg_fence(pa[x][i]);
}

// The thread's two rows' largest raw logit over `boxes` boxes (two chains
// a row), then over the quad: the row's max, the same bits in all four.
template <int boxes>
__device__ __forceinline__ void mha_row_max(const float (&sc)[boxes][64],
                                            float (&mx)[2]) {
  float part[2][2] = {{-INFINITY, -INFINITY}, {-INFINITY, -INFINITY}};
#pragma unroll
  for (int x = 0; x < boxes; ++x)
#pragma unroll
    for (int jj = 0; jj < 16; ++jj)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        part[r][jj & 1] = fmaxf(part[r][jj & 1],
                                fmaxf(sc[x][4 * jj + 2 * r],
                                      sc[x][4 * jj + 2 * r + 1]));
#pragma unroll
  for (int r = 0; r < 2; ++r)
    mx[r] = quad_max(fmaxf(part[r][0], part[r][1]));
}

// Pass 1 past 256 tokens (form b) on one box: the rows' max m2 (base-2
// units) and this thread's share of l = sum 2^(t - m2), online: l = l
// 2^(m2 - m2_new) + sum 2^(t - m2_new); the quad's four shares scale alike
// and are added at the end.
__device__ __forceinline__ void mha_stats(const float (&sc)[1][64],
                                          float (&m2)[2], float (&l)[2],
                                          float scale2) {
  float mx[2], m_new[2], part[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  mha_row_max<1>(sc, mx);
#pragma unroll
  for (int r = 0; r < 2; ++r) m_new[r] = fmaxf(m2[r], mx[r] * scale2);
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int r = (i >> 1) & 1;
    part[r][(i >> 2) & 1] += ex2_ftz(fmaf(sc[0][i], scale2, -m_new[r]));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = l[r] * ex2_ftz(m2[r] - m_new[r]) + (part[r][0] + part[r][1]);
    m2[r] = m_new[r];
  }
}

// Pass 2 past 256 tokens (form b) on one box: p = 2^(t - m2) (1 / l),
// rounded to bf16 pairs, then acc += p V.
__device__ __forceinline__ void mha_pass2(float (&acc)[kHd / 2],
                                          const float (&sc)[1][64],
                                          const float (&m2)[2],
                                          const float (&inv)[2],
                                          const bf16* vb, float scale2) {
  uint32_t pa[1][32];
#pragma unroll
  for (int q = 0; q < 32; ++q) {
    const int r = q & 1;
    pa[0][q] = pack_bf16(
        ex2_ftz(fmaf(sc[0][2 * q], scale2, -m2[r])) * inv[r],
        ex2_ftz(fmaf(sc[0][2 * q + 1], scale2, -m2[r])) * inv[r]);
  }
  mha_pv<1>(acc, pa, vb);
}

// Form (a) for 64 query rows over KT resident boxes: S over the whole rows
// in registers, their exact max and sum, p = 2^(t - m2) (1 / l) rounded to
// bf16 pairs in place, acc = p V once the V boxes are in (vfull, phase).
template <int KT>
__device__ __forceinline__ void mha_one_pass(float (&acc)[kHd / 2],
                                             uint64_t dq, const bf16* kb,
                                             const bf16* vb, uint64_t* vfull,
                                             uint32_t phase, int c, int n,
                                             float scale2) {
  constexpr int c0 = (KT - 1) * kMhaBox;   // the last box's first key
  float sc[KT][64];
  mha_logits<KT>(sc, dq, kb);
  mha_mask(sc[KT - 1], c0, c, n);
  float m2[2], sum[2][2] = {{0.f, 0.f}, {0.f, 0.f}}, inv[2];
  mha_row_max<KT>(sc, m2);
#pragma unroll
  for (int r = 0; r < 2; ++r) m2[r] *= scale2;
#pragma unroll
  for (int x = 0; x < KT; ++x)
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int r = (i >> 1) & 1;
      sc[x][i] = ex2_ftz(fmaf(sc[x][i], scale2, -m2[r]));
      sum[r][(i >> 2) & 1] += sc[x][i];
    }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    inv[r] = 1.f / quad_sum(sum[r][0] + sum[r][1]);
  uint32_t pa[KT][32];
#pragma unroll
  for (int x = 0; x < KT; ++x)
#pragma unroll
    for (int q = 0; q < 32; ++q)
      pa[x][q] = pack_bf16(sc[x][2 * q] * inv[q & 1],
                           sc[x][2 * q + 1] * inv[q & 1]);
#pragma unroll
  for (int i = 0; i < kHd / 2; ++i) acc[i] = 0.f;
  hopper::mbar_wait(vfull, phase);
  mha_pv<KT>(acc, pa, vb);
}

// 64 rows of o from the m64n64 accumulators of consumer warpgroup wg, by
// TMA: each thread writes its rows (rowt, rowt + 8), rounded to bf16, into
// `tile` (a free 64 x 64 q tile) in the 128-byte-swizzled layout the map
// `to` reads (16-byte chunk j of row r at j ^ (r % 8): conflict-free), the
// warpgroup syncs on named barrier 3 + wg, and its first thread stores the
// box at (query row row0, head, batch), the rows past n left out by TMA, in
// a bulk group it waits for (bulk_wait_read) before the tile is reused.
__device__ __forceinline__ void mha_store(const CUtensorMap& to, bf16* tile,
                                          int wg, int t, int rowt, int c,
                                          int row0, int head, int batch,
                                          const float (&acc)[kHd / 2]) {
  using namespace hopper;
  uint8_t* base = reinterpret_cast<uint8_t*>(tile);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = rowt + 8 * r;
#pragma unroll
    for (int d = 0; d < kHd / 8; ++d)
      *reinterpret_cast<uint32_t*>(base + row * 128 + ((d ^ (row & 7)) << 4)
                                   + 2 * c) =
          pack_bf16(acc[4 * d + 2 * r], acc[4 * d + 2 * r + 1]);
  }
  fence_proxy_async();
  named_barrier_sync(3 + wg, 128);
  if (t == 0) {
    tma_store_4d(&to, tile, 0, row0, head, batch);
    bulk_commit();
  }
}

template <int KT>
__global__ void __launch_bounds__(3 * 128, 1)
    mha_kernel_tma(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap to, int heads, int n,
                   int items, int qtiles, float scale2) {
  using namespace hopper;
  constexpr int S = kMhaStages;
  constexpr uint32_t kBox = kMhaBoxElems * sizeof(bf16);
  extern __shared__ uint8_t smem_raw[];
  MhaTmaSmem<KT>& sm = *reinterpret_cast<MhaTmaSmem<KT>*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  const int tiles = (n + kMhaBox - 1) / kMhaBox;
  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      if constexpr (KT > 0) {
        mbar_init(&sm.full[b], 1);
        mbar_init(&sm.vfull[b], 1);
        mbar_init(&sm.empty[b], 2 * 128);
      } else {
        mbar_init(&sm.q_full[b], 1);
        mbar_init(&sm.q_empty[b], 2 * 128);
      }
    }
    if constexpr (KT == 0) {
      for (int s = 0; s < S; ++s) {
        mbar_init(&sm.full[s], 1);
        mbar_init(&sm.empty[s], 2 * 128);
      }
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 2 * 128) {            // ---- producer warpgroup
    setmaxnreg_dec<40>();
    if (threadIdx.x == 2 * 128) {
      int it = 0, load = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x, ++it) {
        const int bh = item / qtiles, b = it & 1;
        const int batch = bh / heads, head = bh % heads;
        if constexpr (KT > 0) {
          mbar_wait(&sm.empty[b], ((it >> 1) & 1) ^ 1);
          mbar_expect_tx(&sm.full[b], 2 * KT * kBox);
          for (int x = 0; x < KT; ++x) {
            const int off = x * kMhaBoxElems, row = x * kMhaBox;
            tma_load_4d(sm.q[b] + off, &tq, &sm.full[b], 0, row, head, batch);
            tma_load_4d(sm.k[b] + off, &tk, &sm.full[b], 0, row, head, batch);
          }
          mbar_expect_tx(&sm.vfull[b], KT * kBox);
          for (int x = 0; x < KT; ++x)
            tma_load_4d(sm.v[b] + x * kMhaBoxElems, &tv, &sm.vfull[b], 0,
                        x * kMhaBox, head, batch);
        } else {
          mbar_wait(&sm.q_empty[b], ((it >> 1) & 1) ^ 1);
          mbar_expect_tx(&sm.q_full[b], kBox);
          tma_load_4d(sm.q[b], &tq, &sm.q_full[b], 0,
                      item % qtiles * kMhaBox, head, batch);
          for (int pass = 0; pass < 2; ++pass)
            for (int j = 0; j < tiles; ++j, ++load) {
              const int s = load % S;
              mbar_wait(&sm.empty[s], ((load / S) & 1) ^ 1);
              mbar_expect_tx(&sm.full[s], (pass + 1) * kBox);
              tma_load_4d(sm.k[s], &tk, &sm.full[s], 0, j * kMhaBox, head,
                          batch);
              if (pass)
                tma_load_4d(sm.v[s], &tv, &sm.full[s], 0, j * kMhaBox, head,
                            batch);
            }
        }
      }
    }
    return;
  }
  // ---- consumer warpgroups: 232 registers a thread (128 x 40 + 256 x 232
  // of the SM's 65,536 with one block). wg comes through a shuffle so that
  // ptxas sees it warp-uniform: a product under a branch it cannot prove
  // uniform serialises every wgmma of the kernel.
  setmaxnreg_inc<232>();
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int c = 2 * (lane % 4);
  const int rowt = 16 * (t / 32) + lane / 4;   // the thread's first row
  int it = 0, load = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++it) {
    const int bh = item / qtiles, b = it & 1;
    const int batch = bh / heads, head = bh % heads;
    float acc[kHd / 2];                    // O, the m64n64 accumulator
    if constexpr (KT > 0) {
      mbar_wait(&sm.full[b], (it >> 1) & 1);
      for (int st = wg; st < 2 * KT && 64 * st < n; st += 2) {
        bf16* qt = sm.q[b] + st * 64 * kHd;   // free once S is in
        const uint64_t dq = desc_sw128(qt);
        mha_one_pass<KT>(acc, dq, sm.k[b], sm.v[b], &sm.vfull[b],
                         (it >> 1) & 1, c, n, scale2);
        mha_store(to, qt, wg, t, rowt, c, 64 * st, head, batch, acc);
      }
      if (t == 0) bulk_wait_read<0>();
      mbar_arrive(&sm.empty[b]);
    } else {
      const int q0 = item % qtiles * kMhaBox + 64 * wg;
      const bool active = q0 < n;          // warpgroup-uniform
      mbar_wait(&sm.q_full[b], (it >> 1) & 1);
      const uint64_t dq = desc_sw128(sm.q[b] + wg * 64 * kHd);
      float m2[2] = {kFlashNeg, kFlashNeg}, l[2] = {0.f, 0.f};
      for (int j = 0; j < tiles; ++j, ++load) {     // pass 1: m2 and l
        const int s = load % S;
        mbar_wait(&sm.full[s], (load / S) & 1);
        if (active) {
          float sc[1][64];
          mha_logits<1>(sc, dq, sm.k[s]);
          mha_mask(sc[0], j * kMhaBox, c, n);
          mha_stats(sc, m2, l, scale2);
        }
        mbar_arrive(&sm.empty[s]);
      }
      const float inv[2] = {1.f / quad_sum(l[0]), 1.f / quad_sum(l[1])};
#pragma unroll
      for (int i = 0; i < kHd / 2; ++i) acc[i] = 0.f;
      for (int j = 0; j < tiles; ++j, ++load) {     // pass 2: p and p.v
        const int s = load % S;
        mbar_wait(&sm.full[s], (load / S) & 1);
        if (active) {
          float sc[1][64];
          mha_logits<1>(sc, dq, sm.k[s]);
          mha_mask(sc[0], j * kMhaBox, c, n);
          mha_pass2(acc, sc, m2, inv, sm.v[s], scale2);
        }
        mbar_arrive(&sm.empty[s]);
      }
      if (active) {
        mha_store(to, sm.q[b] + wg * 64 * kHd, wg, t, rowt, c, q0, head,
                  batch, acc);
        if (t == 0) bulk_wait_read<0>();
      }
      mbar_arrive(&sm.q_empty[b]);
    }
  }
  if (t == 0) bulk_wait_all();
}

// K6's bf16 form at n tokens: KT = 1 or 2 resident key boxes, or 0, the
// ring past 256 tokens.
int mha_form(int n) {
  return n <= kMhaBox ? 1 : n <= kMhaResident * kMhaBox ? 2 : 0;
}

size_t mha_smem(int n, int dtype) {
  if (dtype == 1) {   // + the 1,024 alignment
    const int kt = mha_form(n);
    return 1024 + (kt == 1 ? sizeof(MhaTmaSmem<1>)
                           : kt == 2 ? sizeof(MhaTmaSmem<2>)
                                     : sizeof(MhaTmaSmem<0>));
  }
  const size_t npad = (size_t)(n + kMhaKeys - 1) / kMhaKeys * kMhaKeys;
  return sizeof(float) * ((size_t)(kMhaRows + kMhaKeys) * kStride +
                          (size_t)kMhaRows * (npad + 4));
}

size_t flash_smem_f32() {
  return sizeof(float) * ((size_t)(kFlashRows + 2 * kFlashKeys) * kStride
                          + (size_t)kFlashRows * (kFlashKeys + 4));
}

float softmax_scale(int hd) { return (float)(1.0 / sqrt((double)hd)); }

// One launch of an f32 kernel (plain FMA) over a (query tiles, batch x
// head) grid with `smem` bytes of shared memory.
template <typename T, typename... Args>
cudaError_t launch(void (*kernel)(const T*, const T*, const T*, T*, Args...),
                   int rows, int bh, int n, size_t smem, cudaStream_t stream,
                   const void* q, const void* k, const void* v, void* o,
                   Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + rows - 1) / rows, bh);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), args...);
  return cudaGetLastError();
}

// A bf16 operand of K5 or K6 as a TMA tensor map: dims (hd, n, h, b)
// innermost first with the operand's byte strides, boxes of `rows` rows x
// hd (kTmaKeys for q, k and v; K6's o goes back 64 rows at a time),
// 128-byte swizzle (a row is 128 bytes), rows past n zero-filled on a load
// and left out on a store. False if the encoder refuses the strides.
bool tensor_map(CUtensorMap* map, hopper::EncodeTiled encode,
                const void* base, int b, int h, int n, const Layout& s,
                int rows = kTmaKeys) {
  static_assert(kTmaRows == kTmaKeys && kMhaBox == kTmaKeys,
                "q and k/v share the box");
  const cuuint64_t dims[4] = {kHd, (cuuint64_t)n, (cuuint64_t)h,
                              (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)s.n * sizeof(bf16),
                                 (cuuint64_t)s.h * sizeof(bf16),
                                 (cuuint64_t)s.b * sizeof(bf16)};
  const cuuint32_t box[4] = {kHd, (cuuint32_t)rows, 1, 1};
  return hopper::tensor_map_bf16(map, encode, base, 4, dims, strides, box);
}

// One launch of K6's bf16 kernel of form KT: a block an SM (at most one an
// item), persistent. The shared-memory attribute and the SM count are asked
// once per device.
template <int KT>
int launch_mha_tma(const CUtensorMap& tq, const CUtensorMap& tk,
                   const CUtensorMap& tv, const CUtensorMap& to, int b,
                   int h, int n, cudaStream_t stream) {
  constexpr int kDevices = 64;
  static int sms[kDevices];                // 0 until asked
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kDevices) return (int)cudaErrorInvalidDevice;
  const size_t smem = sizeof(MhaTmaSmem<KT>) + 1024;
  if (sms[dev] == 0) {
    err = cudaFuncSetAttribute(mha_kernel_tma<KT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    int count;
    err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return (int)err;
    sms[dev] = count;
  }
  const int qtiles = KT > 0 ? 1 : (n + kMhaBox - 1) / kMhaBox;
  const long long items = (long long)b * h * qtiles;
  if (items > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int grid = items < sms[dev] ? (int)items : sms[dev];
  mha_kernel_tma<KT><<<grid, 3 * 128, smem, stream>>>(
      tq, tk, tv, to, h, n, (int)items, qtiles, softmax_scale(kHd) * kLog2e);
  return (int)cudaGetLastError();
}

int run_mha(const void* q, const void* k, const void* v, void* o, Layout in,
            Layout out, int b, int h, int n, int dtype, cudaStream_t stream) {
  if (dtype == 0)
    return (int)launch(mha_kernel_f32, kMhaRows, b * h, n, mha_smem(n, 0),
                       stream, q, k, v, o, in, out, h, n,
                       (n + kMhaKeys - 1) / kMhaKeys * kMhaKeys,
                       softmax_scale(kHd));
  const hopper::EncodeTiled encode = hopper::encode_tiled();
  if (encode == nullptr) return hopper::kNoEncoder;
  CUtensorMap tq, tk, tv, to;
  if (!tensor_map(&tq, encode, q, b, h, n, in) ||
      !tensor_map(&tk, encode, k, b, h, n, in) ||
      !tensor_map(&tv, encode, v, b, h, n, in) ||
      !tensor_map(&to, encode, o, b, h, n, out, 64))
    return hopper::kMapRefused;
  switch (mha_form(n)) {
    case 1: return launch_mha_tma<1>(tq, tk, tv, to, b, h, n, stream);
    case 2: return launch_mha_tma<2>(tq, tk, tv, to, b, h, n, stream);
    default: return launch_mha_tma<0>(tq, tk, tv, to, b, h, n, stream);
  }
}

int run_flash(const void* q, const void* k, const void* v, void* o,
              Layout in, Layout out, int b, int h, int n, int dtype,
              cudaStream_t stream) {
  const float scale = softmax_scale(kHd);
  if (dtype == 0)
    return (int)launch(flash_kernel_f32, kFlashRows, b * h, n,
                       flash_smem_f32(), stream, q, k, v, o, in, out, h, n,
                       scale);
  const hopper::EncodeTiled encode = hopper::encode_tiled();
  if (encode == nullptr) return hopper::kNoEncoder;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, encode, q, b, h, n, in) ||
      !tensor_map(&tk, encode, k, b, h, n, in) ||
      !tensor_map(&tv, encode, v, b, h, n, in))
    return hopper::kMapRefused;
  const size_t smem = sizeof(FlashTmaSmem) + 1024;   // + the 1,024 alignment
  const cudaError_t err = cudaFuncSetAttribute(
      flash_kernel_tma, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + kTmaRows - 1) / kTmaRows, b * h);
  flash_kernel_tma<<<grid, 3 * 128, smem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), out, h, n, scale * kLog2e);
  return (int)cudaGetLastError();
}

bool bad_shape(int b, int h, int n, int hd, int dtype) {
  return hd != kHd || n < 1 || b < 1 || h < 1 || (long long)b * h > 65535 ||
         (dtype != 0 && dtype != 1);
}

}  // namespace

extern "C" {

// Shared memory K6 needs at n tokens of `dtype`: in bf16 two item buffers
// (97 KB at n <= 128, 193 KB at n <= 256) or q buffers and the ring (193
// KB); in f32 it grows with n, and the wrapper refuses n past 227 KB.
long long isf_mha_smem(int n, int dtype) {
  return (long long)mha_smem(n, dtype);
}

// q, k, v: [b, h, n, hd] with element strides (sb, sh, sn) over b, h, n,
// shared by the three, hd = 64 contiguous; o: the same shape with strides
// (ob, oh, on). Every row starts 16-byte aligned. dtype 0 = float32,
// 1 = bfloat16. Returns the CUDA error code (0 = launched); bf16 goes by
// TMA and returns -1 (kNoEncoder) if libcuda has no tensor-map encoder and
// -2 (kMapRefused) if the encoder refuses the operands' strides, launching
// nothing.
int isf_mha(const void* q, const void* k, const void* v, void* o, int b,
            int h, int n, int hd, int dtype, long long sb, long long sh,
            long long sn, long long ob, long long oh, long long on,
            void* stream_ptr) {
  if (bad_shape(b, h, n, hd, dtype)) return (int)cudaErrorInvalidValue;
  return run_mha(q, k, v, o, Layout{sb, sh, sn}, Layout{ob, oh, on}, b, h, n,
                 dtype, static_cast<cudaStream_t>(stream_ptr));
}

// The most registers a thread and local memory (spills) in bytes a thread
// over the bf16 K6 kernel's three forms, from cudaFuncGetAttributes.
// Returns the CUDA error code.
int isf_mha_attrs(int* regs, int* local_bytes) {
  *regs = *local_bytes = 0;
  const void* forms[3] = {(const void*)mha_kernel_tma<0>,
                          (const void*)mha_kernel_tma<1>,
                          (const void*)mha_kernel_tma<2>};
  for (const void* f : forms) {
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, f);
    if (err != cudaSuccess) return (int)err;
    *regs = attr.numRegs > *regs ? attr.numRegs : *regs;
    *local_bytes = (int)attr.localSizeBytes > *local_bytes
                       ? (int)attr.localSizeBytes : *local_bytes;
  }
  return 0;
}

// As isf_mha for K5.
int isf_flash_mha(const void* q, const void* k, const void* v, void* o,
                  int b, int h, int n, int hd, int dtype, long long sb,
                  long long sh, long long sn, long long ob, long long oh,
                  long long on, void* stream_ptr) {
  if (bad_shape(b, h, n, hd, dtype)) return (int)cudaErrorInvalidValue;
  return run_flash(q, k, v, o, Layout{sb, sh, sn}, Layout{ob, oh, on}, b, h,
                   n, dtype, static_cast<cudaStream_t>(stream_ptr));
}

}  // extern "C"
