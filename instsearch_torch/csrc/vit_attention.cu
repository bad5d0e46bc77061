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
// tokens and B = 64, 7.6 GFLOP against 39 MB, bound by bytes (0.012 ms).
// Neither kernel writes the [N, N] logits to device memory.
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
//   * K6 in bf16, bound by bytes at 197 tokens: mma.sync m16n8k16 (bf16
//     operands, f32 sums; warp_mma.cuh), 128 threads, each warp 16 of the
//     block's 64 query rows, q fragments, m, l and the 16 x 64 accumulator
//     in registers (FlashAttention-2's layout). K6 normalises p before it
//     rounds it, so it walks the key tiles twice: pass A keeps each row's
//     max m and sum l online, pass B recomputes the tile's logits, forms
//     p = exp(s - m) / l in f32 (as 2^(t - m2) times 1 / l, t the logits
//     in base-2 units: one exp2 and one product a logit, within f32 steps
//     of the plain version's), rounds it to bf16 and multiplies it into v.
//     The second q.k^T is 1.5x the operations, but at 197 tokens the work
//     is bound by bytes, and no f32 logit row is kept, so K6's shared
//     memory does not grow with N: its K and V tiles go in by cp.async,
//     double-buffered and streamed in each pass (46 KB a block: keeping all
//     of a 197-token head's K and V for both passes, 81 KB, fits fewer
//     blocks an SM and ran slower); V stays as it lies and ldmatrix.trans
//     reads it as p.v's B operand.
//   * f32: K5's plan and K6's old one (16 query rows, their whole f32
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
#include "warp_mma.cuh"

namespace {

constexpr int kHd = 64;            // head dim the kernels are built for
constexpr int kThreads = 128;
constexpr int kStride = kHd + 4;   // f32 row stride of a staged tile: 272
                                   // bytes, so 8 rows' 16-byte loads fall
                                   // in 8 distinct bank groups
constexpr int kMhaRows = 16;       // K6 f32: query rows per block
constexpr int kMhaKeys = 64;       // K6: keys staged per chunk
constexpr int kMhaRowsMma = 64;    // K6 bf16: query rows per block
constexpr int kFlashRows = 64;     // K5 f32: query rows per block
constexpr int kFlashKeys = 64;     // K5 f32: keys per key/value tile
constexpr int kTmaRows = 128;      // K5 bf16: query rows per block
constexpr int kTmaKeys = 128;      // K5 bf16: keys per key/value tile, the
                                   // reference's kv_block
constexpr int kTmaStages = 3;      // K5 bf16: K/V stages in the ring
constexpr float kFlashNeg = -1e30f;
constexpr float kLog2e = 1.44269504088896340736f;   // K6's base-2 logits
constexpr int kBStride = kHd + 8;  // bf16 row stride of a staged tile: 144
                                   // bytes, so the 8 rows x 4 words of an
                                   // mma fragment load hit 32 banks

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
// bf16 on the tensor cores: mma.sync m16n8k16, bf16 operands, f32 sums
// (fragment layouts: warp_mma.cuh). A C fragment of two neighbouring key
// tiles is the A fragment of p over those 16 keys.
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

// Rows [row0, row0 + 64) of one head's bf16 [n, kHd] matrix (row stride ld)
// into shared memory as [64][kBStride] by cp.async, zeros past n; the caller
// commits.
__device__ __forceinline__ void stage_async(bf16* dst, const bf16* src,
                                            size_t ld, int row0, int n) {
  for (int i = threadIdx.x; i < kMhaKeys * (kHd / 8); i += kThreads) {
    const int r = i / (kHd / 8);
    const int c = (i % (kHd / 8)) * 8;
    const bool ok = row0 + r < n;
    cp_async16(dst + r * kBStride + c, ok ? src + (row0 + r) * ld + c : src,
               ok ? 16 : 0);
  }
}

// 16 query rows (a warp's) x 64 keys of logits from q fragments qa and a
// staged K tile kt [64][kBStride], times `scale`, keys at or past n masked
// with kFlashNeg (exp gives an exact 0 there).
__device__ __forceinline__ void logits_tile(float (&sc)[8][4],
                                            const uint32_t (&qa)[kHd / 16][4],
                                            const bf16* kt, int c0, int n,
                                            float scale) {
  const int lane = threadIdx.x % 32;
  const int c = 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
  for (int i = 0; i < kHd / 16; ++i)
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      uint32_t kb[4];
      ldmatrix_x4(kb, kt + (8 * j + (lane & 7) + (lane >> 4) * 8) * kBStride +
                          16 * i + ((lane >> 3) & 1) * 8);
      mma_bf16(sc[j], qa[i], kb[0], kb[1]);
      mma_bf16(sc[j + 1], qa[i], kb[2], kb[3]);
    }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      sc[j][e] = c0 + 8 * j + c + (e & 1) < n ? sc[j][e] * scale : kFlashNeg;
}

// K6 in bf16. Block (64 query rows, batch x head), 16 rows a warp in
// registers. The logits are kept in base-2 units, t = q.k (log2(e) /
// sqrt(hd)), so each exponential is one exp2: e^(s - m) = 2^(t - m2). Pass
// A: each row's max m2 and sum l over the n keys, online (l = l 2^(m2 -
// m2_new) + sum 2^(t - m2_new)). Pass B: p = 2^(t - m2) (1 / l) in f32,
// rounded to bf16, times v. K tiles (pass A) and K and V tiles (pass B) are
// double-buffered in shared memory by cp.async, the next tile's copy in
// flight while the warps work on this one.
__global__ void __launch_bounds__(kThreads)
    mha_kernel_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ o,
                   Layout in, Layout out, int heads, int n, float scale2) {
  extern __shared__ float4 smem4[];
  constexpr int kTile = kMhaKeys * kBStride;
  bf16* qs = reinterpret_cast<bf16*>(smem4);     // [64][kBStride]
  bf16* ks = qs + kTile;                         // [2][64][kBStride]
  bf16* vs = ks + 2 * kTile;                     // [2][64][kBStride]
  const size_t base = head_base(in, heads);
  const bf16* kh = k + base;
  const bf16* vh = v + base;
  const int q0 = blockIdx.x * kMhaRowsMma;
  const int t = threadIdx.x;
  const int lane = t % 32;
  const int g = lane / 4, c = 2 * (lane % 4);
  const int wr = 16 * (t / 32);
  const int tiles = (n + kMhaKeys - 1) / kMhaKeys;

  // ---- pass A: m2 and l -----------------------------------------------
  stage_async(qs, q + base, in.n, q0, n);
  stage_async(ks, kh, in.n, 0, n);
  cp_async_commit();
  uint32_t qa[kHd / 16][4];
  float m[2] = {kFlashNeg, kFlashNeg}, l[2] = {0.f, 0.f};
  for (int j = 0; j < tiles; ++j) {
    if (j + 1 < tiles) {
      stage_async(ks + ((j + 1) & 1) * kTile, kh, in.n, (j + 1) * kMhaKeys,
                  n);
      cp_async_commit();
      cp_async_wait<1>();            // q and K tile j are in
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int i = 0; i < kHd / 16; ++i)
        ldmatrix_x4(qa[i], qs + (wr + (lane & 15)) * kBStride + 16 * i +
                               (lane >> 4) * 8);
    }
    float sc[8][4];
    logits_tile(sc, qa, ks + (j & 1) * kTile, j * kMhaKeys, n, scale2);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kFlashNeg;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        mx = fmaxf(mx, fmaxf(sc[jj][2 * r], sc[jj][2 * r + 1]));
      const float m_new = fmaxf(m[r], quad_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        sum += exp2f(sc[jj][2 * r] - m_new) +
               exp2f(sc[jj][2 * r + 1] - m_new);
      l[r] = l[r] * exp2f(m[r] - m_new) + quad_sum(sum);
      m[r] = m_new;
    }
    __syncthreads();                 // slot j & 1 is reloaded next
  }
  const float inv_l[2] = {1.f / l[0], 1.f / l[1]};

  // ---- pass B: p = 2^(t - m2) (1 / l), rounded, times v ----------------
  stage_async(ks, kh, in.n, 0, n);
  stage_async(vs, vh, in.n, 0, n);
  cp_async_commit();
  float acc[kHd / 8][4] = {};
  for (int j = 0; j < tiles; ++j) {
    if (j + 1 < tiles) {
      const int slot = (j + 1) & 1;
      stage_async(ks + slot * kTile, kh, in.n, (j + 1) * kMhaKeys, n);
      stage_async(vs + slot * kTile, vh, in.n, (j + 1) * kMhaKeys, n);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float sc[8][4];
    logits_tile(sc, qa, ks + (j & 1) * kTile, j * kMhaKeys, n, scale2);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sc[jj][e] = exp2f(sc[jj][e] - m[e >> 1]) * inv_l[e >> 1];
    const bf16* vt = vs + (j & 1) * kTile;
#pragma unroll
    for (int i = 0; i < kMhaKeys / 16; ++i) {
      const uint32_t pa[4] = {pack_bf16(sc[2 * i][0], sc[2 * i][1]),
                              pack_bf16(sc[2 * i][2], sc[2 * i][3]),
                              pack_bf16(sc[2 * i + 1][0], sc[2 * i + 1][1]),
                              pack_bf16(sc[2 * i + 1][2], sc[2 * i + 1][3])};
#pragma unroll
      for (int d = 0; d < kHd / 8; d += 2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vt + (16 * i + (lane & 7) +
                                    ((lane >> 3) & 1) * 8) * kBStride +
                                  8 * d + (lane >> 4) * 8);
        mma_bf16(acc[d], pa, vb[0], vb[1]);
        mma_bf16(acc[d + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();                 // slot j & 1 is reloaded next
  }
  const size_t obase = head_base(out, heads);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wr + g + 8 * r;
    if (row >= n) continue;
#pragma unroll
    for (int d = 0; d < kHd / 8; ++d)
      *reinterpret_cast<uint32_t*>(o + obase + row * out.n + 8 * d + c) =
          pack_bf16(acc[d][2 * r], acc[d][2 * r + 1]);
  }
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

size_t mha_smem(int n, int dtype) {
  if (dtype == 1)   // q, then two K and two V tiles
    return sizeof(bf16) * (size_t)5 * kMhaKeys * kBStride;
  const size_t npad = (size_t)(n + kMhaKeys - 1) / kMhaKeys * kMhaKeys;
  return sizeof(float) * ((size_t)(kMhaRows + kMhaKeys) * kStride +
                          (size_t)kMhaRows * (npad + 4));
}

size_t flash_smem_f32() {
  return sizeof(float) * ((size_t)(kFlashRows + 2 * kFlashKeys) * kStride
                          + (size_t)kFlashRows * (kFlashKeys + 4));
}

float softmax_scale(int hd) { return (float)(1.0 / sqrt((double)hd)); }

// One launch of `kernel` (f32: the FMA kernels; bf16: the mma ones) over a
// (query tiles, batch x head) grid with `smem` bytes of shared memory.
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

cudaError_t run_mha(const void* q, const void* k, const void* v, void* o,
                    Layout in, Layout out, int heads, int bh, int n,
                    int dtype, cudaStream_t stream) {
  const int npad = (n + kMhaKeys - 1) / kMhaKeys * kMhaKeys;
  const size_t smem = mha_smem(n, dtype);
  const float scale = softmax_scale(kHd);
  if (dtype == 1)   // logits in base-2 units (mha_kernel_mma)
    return launch(mha_kernel_mma, kMhaRowsMma, bh, n, smem, stream, q, k, v,
                  o, in, out, heads, n, scale * kLog2e);
  return launch(mha_kernel_f32, kMhaRows, bh, n, smem, stream, q, k, v, o, in,
                out, heads, n, npad, scale);
}

// K5's bf16 operand as a TMA tensor map: dims (hd, n, h, b) innermost
// first with the operand's byte strides, boxes of kTmaKeys rows x hd (the
// q box has as many rows), 128-byte swizzle (a row is 128 bytes), rows past
// n zero-filled. False if the encoder refuses the strides.
bool tensor_map(CUtensorMap* map, hopper::EncodeTiled encode,
                const void* base, int b, int h, int n, const Layout& s) {
  static_assert(kTmaRows == kTmaKeys, "q and k/v share the box");
  const cuuint64_t dims[4] = {kHd, (cuuint64_t)n, (cuuint64_t)h,
                              (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)s.n * sizeof(bf16),
                                 (cuuint64_t)s.h * sizeof(bf16),
                                 (cuuint64_t)s.b * sizeof(bf16)};
  const cuuint32_t box[4] = {kHd, kTmaKeys, 1, 1};
  return hopper::tensor_map_bf16(map, encode, base, 4, dims, strides, box);
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

// Shared memory K6 needs at n tokens of `dtype`: 46 KB in bf16 at any n;
// in f32 it grows with n, and the wrapper refuses n past 227 KB.
long long isf_mha_smem(int n, int dtype) {
  return (long long)mha_smem(n, dtype);
}

// q, k, v: [b, h, n, hd] with element strides (sb, sh, sn) over b, h, n,
// shared by the three, hd = 64 contiguous; o: the same shape with strides
// (ob, oh, on). Every row starts 16-byte aligned. dtype 0 = float32,
// 1 = bfloat16. Returns the CUDA error code (0 = launched).
int isf_mha(const void* q, const void* k, const void* v, void* o, int b,
            int h, int n, int hd, int dtype, long long sb, long long sh,
            long long sn, long long ob, long long oh, long long on,
            void* stream_ptr) {
  if (bad_shape(b, h, n, hd, dtype)) return (int)cudaErrorInvalidValue;
  return (int)run_mha(q, k, v, o, Layout{sb, sh, sn}, Layout{ob, oh, on}, h,
                      b * h, n, dtype, static_cast<cudaStream_t>(stream_ptr));
}

// As isf_mha for K5. bf16 goes by TMA: returns -1 (kNoEncoder) if libcuda
// has no tensor-map encoder and -2 (kMapRefused) if the encoder refuses
// the operands' strides, launching nothing.
int isf_flash_mha(const void* q, const void* k, const void* v, void* o,
                  int b, int h, int n, int hd, int dtype, long long sb,
                  long long sh, long long sn, long long ob, long long oh,
                  long long on, void* stream_ptr) {
  if (bad_shape(b, h, n, hd, dtype)) return (int)cudaErrorInvalidValue;
  return run_flash(q, k, v, o, Layout{sb, sh, sn}, Layout{ob, oh, on}, b, h,
                   n, dtype, static_cast<cudaStream_t>(stream_ptr));
}

}  // extern "C"
