// K7 `fused_identity_blocks` for Hopper (sm_90a): the stride-1 ("identity")
// bottleneck blocks of a ResNet stage, BatchNorm folded into the convs.
//
// Replaces the TPU kernel instsearch_tpu/kernels/fused_resnet.py:138
// `fused_identity_blocks` (Pallas body `_identity_blocks_kernel`). One block
// on an activation h [B, H*W, C] bf16 (NHWC memory, one pixel per row):
//   y1 = bf16(relu(h . w1 + b1))                    1x1, C -> M
//   y2 = bf16(relu(sum_t tap_t(y1) . w2[t] + b2))   3x3, M -> M: 9 taps into
//        one f32 sum; a tap outside the image reads an exact 0
//   h  = relu(bf16(bf16(y2 . w3 + b3) + h))         1x1, M -> C
// Every product takes bf16 operands into f32 sums. The roundings are the TPU
// body's, point for point, two of them at the end (y3, then the residual sum).
// w1 is [C, M], w2 [9 M, M] (tap t = 3 ky + kx, then [in, out]), w3 [M, C],
// the biases f32.
//
// What bounds it on this card. A block is 2 B HW (C M + 9 M^2 + M C)
// operations against the bytes of h in and out and of the weights. For
// ResNet-50 at 224 px and B = 64 that is bound by bytes in layer 1 (0.061 ms
// for its two blocks at 3.35 TB/s) and by the tensor cores' bf16 rate in
// layers 2-4 (0.085, 0.141 and 0.057 ms per stage at 989 TFLOP/s). Either
// way y1 and y2 must never reach device memory: they are the 3x3's input and
// output, three quarters of a block's activation traffic.
//
// What the design does about it, simple first. One launch per block: the
// wrapper walks the n blocks with two output buffers in turn, since a tile's
// 3x3 halo reads rows that a neighbouring tile of the same launch would
// otherwise already have overwritten. A thread block of 8 warps owns T image
// rows of one image:
//   1. y1s, a bf16 [(T + 2) x (W + 2) x M] tile in shared memory with a ring
//      of one pixel around it, is zeroed: the ring and any halo row outside
//      the image stay exact zeros, which is what the TPU body's masks did (a
//      row's end never reads the next row's first pixel);
//   2. conv1 runs on the tile's rows and its halo rows inside the image (the
//      halo is recomputed: +2/T on conv1), x streamed in 64-channel chunks;
//      relu(. + b1) rounded to bf16 lands in y1s;
//   3. conv2 is one GEMM of depth 9 M whose A rows ldmatrix gathers from y1s
//      at each tap's offset (no im2col); relu(. + b2) rounded to bf16 lands
//      in y2s, which reuses conv1's staging space;
//   4. conv3 reads y2s; bias, the residual read from h, both roundings and
//      the ReLU run in the epilogue, which writes the output.
// Products are mma.sync m16n8k16 (bf16 in, f32 sums), a warp owning 16 rows
// by 64 output channels of a 128-row m-tile. Weights stream from L2 in 64 x
// 64 chunks by cp.async, two buffers in turn, and so does x in conv1.
// isf_fused_block picks T (tile_rows below, the one place that knows the
// shared-memory layout): the most rows that keep T W <= 256 pixels and the
// shared memory within 227 KB, evened out over the image.
// Not yet: wgmma and TMA, warp specialisation, clusters sharing a layer's
// weights, the n blocks in one launch. Layers 3-4 at 224 px give one or two
// tiles per image, so at B = 64 the grid is 128 or 64 blocks on 132 SMs.
//
// The wrapper (instsearch_torch/kernels/fused_resnet.py) allocates the
// output and checks dtypes, shapes, devices, contiguity and alignment; this
// file allocates nothing and launches on the caller's stream.

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

constexpr int kThreads = 256;   // 8 warps
constexpr int kBM = 128;        // rows of an m-tile, 16 per warp
constexpr int kBN = 64;         // output channels of an n-tile
constexpr int kBK = 64;         // depth of a staged chunk
constexpr int kTS = kBK + 8;    // row stride of a staged chunk: 144 bytes, so
                                // ldmatrix's 8 rows fall in 8 bank groups
constexpr int kMaxSmem = 232448;
constexpr int kWeightElems = 2 * kBK * kTS;

// Shared memory in bf16 elements: y1s with its ring, then y2s (whose space
// conv1's two x stages share), then the two weight stages. Rows of y1s and
// y2s have M + 8 elements: 2 M + 16 bytes, 16 more than a multiple of 128
// when M % 64 == 0, so ldmatrix's 8 rows fall in 8 bank groups there too.
__host__ __device__ inline int y1_elems(int W, int M, int T) {
  return (T + 2) * (W + 2) * (M + 8);
}

__host__ __device__ inline int y2_elems(int W, int M, int T) {
  const int y2 = (T * W + 15) / 16 * 16 * (M + 8);
  return y2 > 2 * kBM * kTS ? y2 : 2 * kBM * kTS;
}

size_t smem_bytes(int W, int M, int T) {
  return sizeof(bf16) * ((size_t)y1_elems(W, M, T) + y2_elems(W, M, T) +
                         kWeightElems);
}

constexpr int kTilePixels = 256;  // output pixels a thread block aims to own

// Image rows a thread block owns: the most that keep at most kTilePixels
// pixels (one row at least) and the shared memory within kMaxSmem, then
// evened out over the image. 0 when even one row does not fit.
int tile_rows(int H, int W, int M) {
  int t = 0;
  for (int rows = 1; rows <= H; ++rows) {
    if (rows > 1 && rows * W > kTilePixels) break;
    if (smem_bytes(W, M, rows) <= (size_t)kMaxSmem) t = rows;
  }
  if (!t) return 0;
  const int tiles = (H + t - 1) / t;
  return (H + tiles - 1) / tiles;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait for every group but the newest
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// ldmatrix: lane l gives the address of row l % 8 of matrix l / 8; without
// .trans lane t receives row t / 4, columns 2 (t % 4) and + 1 of each
// matrix, with .trans column t / 4, rows 2 (t % 4) and + 1.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)) : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)) : "memory");
}

// d += a . b; fragment layouts (PTX ISA), g = lane / 4, c = 2 (lane % 4): A
// (16 x 16) rows g, g + 8 at columns c, c + 1 and c + 8, c + 9; B (16 x 8)
// k = c, c + 1 and c + 8, c + 9 of column g; D (16 x 8, f32) rows g, g + 8 at
// columns c, c + 1.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rows [k0, k0 + 64) x columns [n0, n0 + 64) of a row-major bf16 [K, ld]
// weight matrix into a [64][kTS] stage.
__device__ __forceinline__ void stage_weights(bf16* dst, const bf16* src,
                                              int ld, int k0, int n0) {
  for (int i = threadIdx.x; i < kBK * (kBN / 8); i += kThreads) {
    const int r = i / (kBN / 8), c = i % (kBN / 8) * 8;
    cp_async16(dst + r * kTS + c, src + (size_t)(k0 + r) * ld + n0 + c);
  }
}

// acc[j] += the warp's 16 A rows times columns 8 j .. 8 j + 7 of a staged
// 64 x 64 weight chunk, over the chunk's depth of 64. `a` is the lane's A
// row (row lane % 16 of the warp's 16) at the chunk's first column: rows of
// one ldmatrix may lie anywhere in shared memory, which is what lets conv2
// gather its taps.
__device__ __forceinline__ void mma_chunk(float (&acc)[kBN / 8][4],
                                          const bf16* a, const bf16* w) {
  const int lane = threadIdx.x % 32;
  const bf16* wl = w + (lane % 16) * kTS + 8 * (lane / 16);
  a += 8 * (lane / 16);
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 16) {
    uint32_t af[4];
    ldsm_x4(af, a + kk);
#pragma unroll
    for (int j = 0; j < kBN / 16; ++j) {
      uint32_t bf[4];
      ldsm_x4_trans(bf, wl + kk * kTS + 16 * j);
      mma_bf16(acc[2 * j], af, bf[0], bf[1]);
      mma_bf16(acc[2 * j + 1], af, bf[2], bf[3]);
    }
  }
}

// One m-tile of a GEMM against a row-major bf16 weight matrix w [K, ldw]:
// n_tiles output tiles of 64 channels, each summed over n_chunks chunks of
// 64 depth. Steps run over (n-tile, chunk); step s + 1's copies are in
// flight while step s computes. stage_a(buf, kc) issues the A copies of
// chunk kc into buffer buf (conv1) or nothing; a_row(buf, kc) is the lane's
// A row for chunk kc; epi(nt, acc) takes a finished n-tile. A warp whose 16
// rows all lie past the m-tile's rows (`active` false) copies and
// synchronises but computes nothing.
template <class StageA, class RowA, class Epi>
__device__ __forceinline__ void gemm(const bf16* w, int ldw, int n_tiles,
                                     int n_chunks, bf16* ws, bool active,
                                     StageA stage_a, RowA a_row, Epi epi) {
  const int steps = n_tiles * n_chunks;
  auto issue = [&](int s) {
    stage_weights(ws + (s & 1) * kBK * kTS, w, ldw, s % n_chunks * kBK,
                  s / n_chunks * kBN);
    stage_a(s & 1, s % n_chunks);
    cp_async_commit();
  };
  float acc[kBN / 8][4];
  issue(0);
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps)
      issue(s + 1);
    else
      cp_async_commit();             // an empty group keeps the count
    cp_async_wait_prior();
    __syncthreads();                 // step s's stages are complete
    const int kc = s % n_chunks;
    if (kc == 0) {
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    }
    if (active) {
      mma_chunk(acc, a_row(s & 1, kc), ws + (s & 1) * kBK * kTS);
      if (kc == n_chunks - 1) epi(s / n_chunks, acc);
    }
    __syncthreads();                 // buffer s & 1 is free again
  }
}

struct Shape {
  int H, W, C, M, T;
};

// One identity block over a tile of T image rows (blockIdx.x) of one image
// (blockIdx.y); see the header.
__global__ void __launch_bounds__(kThreads, 1)
    identity_block_kernel(const bf16* __restrict__ x,
                          const bf16* __restrict__ w1,
                          const float* __restrict__ b1,
                          const bf16* __restrict__ w2,
                          const float* __restrict__ b2,
                          const bf16* __restrict__ w3,
                          const float* __restrict__ b3,
                          bf16* __restrict__ out, Shape s) {
  extern __shared__ uint4 smem[];
  const int W = s.W, C = s.C, M = s.M;
  const int YS = M + 8;             // row stride of y1s and y2s
  const int WP = W + 2;             // pixels in a row of y1s, ring included
  bf16* y1s = reinterpret_cast<bf16*>(smem);
  bf16* y2s = y1s + y1_elems(W, M, s.T);
  bf16* ws = y2s + y2_elems(W, M, s.T);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = 2 * (lane % 4);

  const int r0 = blockIdx.x * s.T;            // the tile's first image row
  const int rows = min(s.T, s.H - r0);
  const int P = rows * W;                     // the tile's output pixels
  const size_t image = (size_t)blockIdx.y * s.H * W * C;
  const bf16* xi = x + image;
  bf16* oi = out + image;

  // 1. zero y1s: the ring and halo rows outside the image stay zero
  for (int i = threadIdx.x; i < y1_elems(W, M, s.T) / 8; i += kThreads)
    smem[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  // 2. conv1 over image rows [ra, rb): the tile's and its halo inside the
  //    image; image row ra is y1s row ra - r0 + 1
  const int ra = max(r0 - 1, 0), rb = min(r0 + rows + 1, s.H);
  const int n1 = (rb - ra) * W;
  const bf16* xa = xi + (size_t)ra * W * C;
  bf16* xs = y2s;                             // [2][kBM][kTS] x stages
  for (int m0 = 0; m0 < n1; m0 += kBM) {
    gemm(w1, M, M / kBN, C / kBK, ws, m0 + 16 * warp < n1,
         [&](int buf, int kc) {
           for (int i = threadIdx.x; i < kBM * (kBK / 8); i += kThreads) {
             const int r = i / (kBK / 8), cc = i % (kBK / 8) * 8;
             const int p = min(m0 + r, n1 - 1);   // rows past n1: discarded
             cp_async16(xs + (buf * kBM + r) * kTS + cc,
                        xa + (size_t)p * C + kc * kBK + cc);
           }
         },
         [&](int buf, int) {
           return xs + (buf * kBM + 16 * warp + lane % 16) * kTS;
         },
         [&](int nt, float (&acc)[kBN / 8][4]) {
#pragma unroll
           for (int h = 0; h < 2; ++h) {
             const int p = m0 + 16 * warp + g + 8 * h;
             if (p >= n1) continue;
             bf16* dst = y1s + ((ra - r0 + 1 + p / W) * WP + p % W + 1) * YS
                         + nt * kBN + c;
#pragma unroll
             for (int j = 0; j < kBN / 8; ++j) {
               const float* bias = b1 + nt * kBN + 8 * j + c;
               *reinterpret_cast<bf162*>(dst + 8 * j) = __floats2bfloat162_rn(
                   fmaxf(acc[j][2 * h] + bias[0], 0.f),
                   fmaxf(acc[j][2 * h + 1] + bias[1], 0.f));
             }
           }
         });
  }

  // 3. conv2, depth 9 M: tap t = (dy, dx) = (t / 3 - 1, t % 3 - 1) of output
  //    pixel p reads y1s pixel (p / W + 1 + dy, p % W + 1 + dx); a chunk of
  //    64 lies within one tap
  for (int m0 = 0; m0 < P; m0 += kBM) {
    const int p = min(m0 + 16 * warp + lane % 16, P - 1);
    const bf16* centre = y1s + ((p / W + 1) * WP + p % W + 1) * YS;
    gemm(w2, M, M / kBN, 9 * M / kBK, ws, m0 + 16 * warp < P,
         [](int, int) {},
         [&](int, int kc) {
           const int k = kc * kBK, t = k / M;
           return centre + ((t / 3 - 1) * WP + t % 3 - 1) * YS + k % M;
         },
         [&](int nt, float (&acc)[kBN / 8][4]) {
#pragma unroll
           for (int h = 0; h < 2; ++h) {
             const int q = m0 + 16 * warp + g + 8 * h;
             if (q >= P) continue;
             bf16* dst = y2s + q * YS + nt * kBN + c;
#pragma unroll
             for (int j = 0; j < kBN / 8; ++j) {
               const float* bias = b2 + nt * kBN + 8 * j + c;
               *reinterpret_cast<bf162*>(dst + 8 * j) = __floats2bfloat162_rn(
                   fmaxf(acc[j][2 * h] + bias[0], 0.f),
                   fmaxf(acc[j][2 * h + 1] + bias[1], 0.f));
             }
           }
         });
  }

  // 4. conv3 with bias, residual and ReLU: h = relu(bf16(bf16(y3 + b3) + h))
  const bf162 zero = __floats2bfloat162_rn(0.f, 0.f);
  for (int m0 = 0; m0 < P; m0 += kBM) {
    // rows up to the next multiple of 16 past P exist in y2s; theirs are
    // discarded
    const bf16* arow = y2s + (m0 + 16 * warp + lane % 16) * YS;
    gemm(w3, C, C / kBN, M / kBK, ws, m0 + 16 * warp < P,
         [](int, int) {},
         [&](int, int kc) { return arow + kc * kBK; },
         [&](int nt, float (&acc)[kBN / 8][4]) {
#pragma unroll
           for (int h = 0; h < 2; ++h) {
             const int q = m0 + 16 * warp + g + 8 * h;
             if (q >= P) continue;
             const size_t off = (size_t)(r0 * W + q) * C + nt * kBN + c;
#pragma unroll
             for (int j = 0; j < kBN / 8; ++j) {
               const float* bias = b3 + nt * kBN + 8 * j + c;
               const float2 y3 = __bfloat1622float2(__floats2bfloat162_rn(
                   acc[j][2 * h] + bias[0], acc[j][2 * h + 1] + bias[1]));
               const float2 res = __bfloat1622float2(
                   *reinterpret_cast<const bf162*>(xi + off + 8 * j));
               *reinterpret_cast<bf162*>(oi + off + 8 * j) = __hmax2(
                   __floats2bfloat162_rn(y3.x + res.x, y3.y + res.y), zero);
             }
           }
         });
  }
}

}  // namespace

extern "C" {

// Image rows of a launch's tiles at H x W pixels and bottleneck width M; 0
// when one row's tile does not fit the shared memory (the wrapper refuses).
int isf_fused_block_tile(int H, int W, int M) {
  return H < 1 || W < 1 || M < kBN || M % kBN ? 0 : tile_rows(H, W, M);
}

// One identity block: x [B, H*W, C] bf16 -> out (the same shape, another
// buffer); w1 [C, M], w2 [9 M, M], w3 [M, C] bf16, b1 [M], b2 [M], b3 [C]
// f32, all contiguous and 16-byte aligned; C and M multiples of 64. Tiles
// of isf_fused_block_tile(H, W, M) image rows. Returns the CUDA error code
// (0 = launched).
int isf_fused_block(const void* x, const void* w1, const void* b1,
                    const void* w2, const void* b2, const void* w3,
                    const void* b3, void* out, int B, int H, int W, int C,
                    int M, void* stream_ptr) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || C < kBN || C % kBN ||
      M < kBN || M % kBN || x == out)
    return (int)cudaErrorInvalidValue;
  const int T = tile_rows(H, W, M);
  if (!T) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(W, M, T);
  cudaError_t err = cudaFuncSetAttribute(
      identity_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((H + T - 1) / T, B);
  identity_block_kernel<<<grid, kThreads, smem,
                          static_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<const bf16*>(w3),
      static_cast<const float*>(b3), static_cast<bf16*>(out),
      Shape{H, W, C, M, T});
  return (int)cudaGetLastError();
}

}  // extern "C"
