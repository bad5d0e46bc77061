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
// output, three quarters of a block's activation traffic. Within a thread
// block the weights are the stream: every 64 x 64 chunk of w1, w2 and w3
// passes through shared memory once per row group, so what a step costs is
// set by how well the chunks' arrival is hidden behind the products.
//
// What the design does about it. One launch per block: the wrapper walks
// the n blocks with two output buffers in turn, since a tile's 3x3 halo
// reads rows that a neighbouring tile of the same launch would otherwise
// already have overwritten. A thread block owns T image rows of one image
// and is warp-specialised (K5's skeleton, PTX in hopper.cuh), 384 threads:
//   * a producer warpgroup, one thread of which streams the weights by TMA
//     (one tensor map per operand per launch, 64 x 64 boxes, 128-byte
//     swizzle, one or two a stage) into a ring of kStages stages, each
//     behind a "full" and an "empty" mbarrier, and conv1's x likewise
//     (step 2 below). It walks the same (convolution, row group, n-tile,
//     chunk) steps as the consumers (walk() below, the one place that
//     orders them), so it loads conv2's first chunks while the consumers
//     finish conv1;
//   * two consumer warpgroups, which apply each stage to all the rows of a
//     row group (up to kGroupRows = 256: each warpgroup two m64 sub-tiles,
//     sub-tile u of warpgroup wg at rows 128 u + 64 wg, so a group of 128
//     rows or fewer still splits between them) before they release it.
//     Where a convolution's groups hold 128 rows or fewer (layers 3-4 at
//     224 px), a stage is two boxes, 128 output channels, wide, so that
//     each warpgroup still keeps two 64 x 64 accumulators busy a step.
//     Products are wgmma m64n64k16 with A in registers and B, the weight
//     stage, MN-major in shared memory (the transpose bit reads w's [k][n]
//     rows as they lie). A is ldmatrix-loaded, 16 rows a warp, from
//     addresses each lane computes, which is what lets conv2 gather its taps
//     without an im2col. A stage's products go out in two groups of half
//     its depth, each followed by a wait for the group before it (wgmma
//     groups complete in order): one group is always queued behind the
//     other, and a stage is released as soon as its last group is done.
// The tile:
//   1. y1s, a bf16 [(T + 2) x (W + 2) x M] tile in shared memory with a ring
//      of one pixel around it, is zeroed: the ring and any halo row outside
//      the image stay exact zeros, which is what the TPU body's masks did (a
//      row's end never reads the next row's first pixel);
//   2. conv1 runs on the tile's rows and its halo rows inside the image (the
//      halo is recomputed: +2/T on conv1), x in 64-channel chunks that the
//      producer also loads by TMA, into two x stages of their own with
//      their own mbarriers; relu(. + b1) rounded to bf16 lands in y1s;
//   3. conv2 is one GEMM of depth 9 M whose A rows are gathered from y1s at
//      each tap's offset; relu(. + b2) rounded to bf16 lands in y2s, which
//      reuses conv1's x stages;
//   4. conv3 reads y2s; bias, the residual read from h, both roundings and
//      the ReLU run in the epilogue, which writes the output.
// Between the convolutions the consumers sync on a named barrier of their
// own; the producer never waits there. isf_fused_block picks T (tile_rows
// below; smem_plan is the one place that knows the shared-memory layout):
// the most rows that keep T W <= 256 pixels and the shared memory within
// 227 KB, evened out over the image.
// Not yet: clusters sharing a layer's weights, layer 4's output channels
// split across SMs, the n blocks in one launch. Layers 3-4 at 224 px give
// one or two tiles per image, so at B = 64 the grid is 128 or 64 blocks on
// 132 SMs.
//
// The wrapper (instsearch_torch/kernels/fused_resnet.py) allocates the
// output and checks dtypes, shapes, devices, contiguity and alignment; this
// file allocates nothing and launches on the caller's stream.

#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

constexpr int kConsumers = 256;             // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
constexpr int kGroupRows = 256;   // rows of a row group: two warpgroups x
                                  // two m64 sub-tiles
constexpr int kBN = 64;           // output channels of an n-tile
constexpr int kBK = 64;           // depth of a weight stage
constexpr int kStages = 4;        // weight stages in the ring
constexpr int kParts = 2;         // wgmma groups a stage is issued in
                                  // (4, with wait_group 3, made ptxas
                                  // serialize every wgmma)
constexpr int kBoxBytes = kBK * kBN * 2;    // a 64 x 64 weight box: 8 KB,
                                            // 1,024-aligned
constexpr int kXStages = 2;       // conv1's x stages (128-byte rows,
                                  // 128-byte swizzle)
constexpr int kConsumerBar = 1;   // the consumers' named barrier
constexpr int kMaxSmem = 232448;

// Shared memory, in bytes from a 1,024-aligned base: the weight ring of
// kStages stages of `boxes` 64 x 64 boxes (conv_boxes); y1s with its ring
// of zeros; y2s, 1,024-aligned, whose space conv1's kXStages x stages of
// `x_rows` rows (conv1's sub-tiles x 128) share; the barriers. Rows of y1s
// and y2s have M + 8 elements: 2 M + 16 bytes, 16 more than a multiple of
// 128 when M % 64 == 0, so ldmatrix's 8 rows fall in 8 bank groups.
struct Smem {
  int y1, y2, bars, total;
  int x_bytes;   // an x stage
};

__host__ __device__ inline Smem smem_plan(int W, int M, int T, int boxes,
                                          int x_rows) {
  Smem p;
  const int ys = 2 * (M + 8);
  p.x_bytes = x_rows * kBK * 2;
  const int y2 = T * W * ys, xs = kXStages * p.x_bytes;
  p.y1 = kStages * boxes * kBoxBytes;
  p.y2 = (p.y1 + (T + 2) * (W + 2) * ys + 1023) / 1024 * 1024;
  p.bars = p.y2 + (y2 > xs ? y2 : xs);
  p.total = p.bars + 2 * (kStages + kXStages) * 8 + 1024;   // + the base's
  return p;                                                 // alignment
}

constexpr int kTilePixels = 256;  // output pixels a thread block aims to own

// The most A rows convolution v has in a tile of T image rows: conv1 the
// tile's and its halo's inside the image, conv2 and conv3 the tile's.
int conv_rows(int H, int W, int T, int v) {
  return (v == 0 ? (T + 2 < H ? T + 2 : H) : T) * W;
}

// The m64 sub-tiles a consumer warpgroup computes in each row group of a
// convolution with `rows` A rows: 2 once a group holds more than 128 rows;
// else 1, and then each stage is two boxes wide (128 output channels), so
// that a warpgroup still keeps two accumulators busy and a step carries
// twice the products, which the convolution's output tiles must pair up
// for (`paired`: 64-channel tiles in an even number).
int conv_pairs(int rows, bool paired) {
  return rows > kGroupRows / 2 || !paired ? 2 : 1;
}

// Boxes a ring stage holds: 2 if a convolution may run one sub-tile wide
// (conv_pairs with the output width even in 64-channel tiles), else 1.
int conv_boxes(int H, int W, int M, int T) {
  const bool paired = M % (2 * kBN) == 0;
  return conv_pairs(conv_rows(H, W, T, 0), paired) == 1 ||
                 conv_pairs(conv_rows(H, W, T, 1), paired) == 1
             ? 2 : 1;
}

// Image rows a thread block owns: the most that keep at most kTilePixels
// pixels (one row at least) and the shared memory within kMaxSmem, then
// evened out over the image. 0 when even one row does not fit.
int tile_rows(int H, int W, int M) {
  int t = 0;
  for (int rows = 1; rows <= H; ++rows) {
    if (rows > 1 && rows * W > kTilePixels) break;
    const int x_rows = 128 * conv_pairs(conv_rows(H, W, rows, 0),
                                        M % (2 * kBN) == 0);
    if (smem_plan(W, M, rows, conv_boxes(H, W, M, rows), x_rows).total <=
        kMaxSmem)
      t = rows;
  }
  if (!t) return 0;
  const int tiles = (H + t - 1) / t;
  return (H + tiles - 1) / tiles;
}

// A launch's shape; groups[v] is convolution v's row groups (conv_rows).
struct Shape {
  int H, W, C, M, T;
  int groups[3];
};

// Image rows [r0, r0 + rows) of the tile of blockIdx.x, and [ra, rb), the
// same with the halo rows inside the image.
struct Tile {
  int r0, rows, ra, rb;
};

__device__ Tile tile_of(const Shape& s) {
  Tile t;
  t.r0 = blockIdx.x * s.T;
  t.rows = min(s.T, s.H - t.r0);
  t.ra = max(t.r0 - 1, 0);
  t.rb = min(t.r0 + t.rows + 1, s.H);
  return t;
}

// Convolution v of a tile as GEMM steps: `groups` row groups of kGroupRows
// A rows (the tile's own `rows` and, in its last group, rows past them),
// n_tiles output tiles of `boxes` x 64 channels (one stage wide), each
// summed over n_chunks weight stages of depth 64. Steps go (group, n-tile,
// chunk), chunk fastest. How many groups, and how many m64 sub-tiles and
// boxes a step carries (the kernel's template arguments), is the
// launch's, the same for every tile: whether a wgmma is issued must not
// depend on blockIdx (walk()). A tile with fewer rows computes the rows
// past its own from clamped addresses, and its epilogue drops them.
struct Conv {
  int rows, n_tiles, n_chunks, groups;
};

__device__ Conv conv_of(const Shape& s, const Tile& t, int v, int boxes) {
  const int n = boxes * kBN;
  if (v == 0) return {(t.rb - t.ra) * s.W, s.M / n, s.C / kBK, s.groups[0]};
  if (v == 1) return {t.rows * s.W, s.M / n, 9 * s.M / kBK, s.groups[1]};
  return {t.rows * s.W, s.C / n, s.M / kBK, s.groups[2]};
}

// Every n-tile of a convolution, in order: f(i, g, nt), i the index of
// its first step (steps i .. i + n_chunks - 1 are its chunks). The
// producer and the consumers both walk it, so they cannot disagree on
// which weight chunk a stage holds. Its loops run over the launch's
// parameters alone, so ptxas can see that the whole warpgroup takes the
// same branches around its wgmmas: a wgmma under a branch it cannot prove
// uniform is serialized, with every other wgmma of the kernel (ptxas
// warning C7518).
template <class F>
__device__ __forceinline__ void walk(const Conv cv, F f) {
  int i = 0;
  for (int g = 0; g < cv.groups; ++g)
    for (int nt = 0; nt < cv.n_tiles; ++nt, i += cv.n_chunks) f(i, g, nt);
}

// bf16(relu(lo)), bf16(relu(hi)) as one bf16 pair, lo in the low half
__device__ __forceinline__ uint32_t relu_bf16(float lo, float hi) {
  const bf162 y = __floats2bfloat162_rn(fmaxf(lo, 0.f), fmaxf(hi, 0.f));
  return *reinterpret_cast<const uint32_t*>(&y);
}

// The consumers' side of one convolution. For each chunk kc of each
// n-tile: wait for the weight stage, then for each of its kParts parts
// (k16 steps of its depth of 64): load the A fragments of the warpgroup's
// kPairs sub-tiles (sub-tile u is rows 128 u + 64 wg of the group; the
// lane's A row r of group g lies at shared address a_row(g, r) +
// a_chunk(i, kc) at chunk kc's first column: a_row per lane, once an
// n-tile, a_chunk the same for every lane, once a chunk; its k16 step ks
// at a_col(ks) past that, ldmatrix's column half included), issue their
// products as one group and wait until at most kParts - 1 groups are in
// flight; once that leaves none of the previous chunk's (after part
// kParts - 2), its stage is released. After the n-tile's last chunk:
// drain, release, and for each sub-tile pack the lane's sums plus the
// n-tile's bias, v[h][j] = pack(acc + b) at row g8 + 8 h and columns
// 8 j + c, c + 1, and hand them to epi(g, col0, row0, v): the sub-tile's
// rows from group row row0, the box's output channels from col0. With one
// sub-tile a stage is two boxes wide and each box has its accumulator.
// before(i, g, nt, kc) runs at the top of each step i (conv1's x stage);
// `step` counts the steps of the kernel, which pick the stage and its
// phase.
// Registers. A wgmma reads its A registers until it completes, so each
// part's fragments have a buffer of their own, refilled kParts parts
// later, when the wait has completed the group that read them: 16
// registers a sub-tile whatever kParts is, besides its 32 accumulators,
// and up to kParts groups in flight. ptxas compiles the kernel within 168
// registers a thread (384 threads a block), and where the wgmmas in flight
// and the epilogue do not fit it serializes every wgmma of the kernel with
// no warning (the SASS shows a wait after each): with two buffers of whole
// chunks (32 A registers a sub-tile) it did so at two sub-tiles, and so it
// did at kParts = 4. The accumulators are read only where the whole
// warpgroup goes, never under epi's per-row tests, for the same reason.
template <int kPairs, int kSlotBytes, class Before, class RowA,
          class ChunkA, class ColA, class Pack, class Epi>
__device__ __forceinline__ void consume(const Conv cv, const uint8_t* ring,
                                        uint64_t* full, uint64_t* empty,
                                        int& step, const float* bias,
                                        Before before, RowA a_row,
                                        ChunkA a_chunk, ColA a_col, Pack pack,
                                        Epi epi) {
  using namespace hopper;
  constexpr int kSteps = kBK / 16 / kParts;   // k16 steps a part
  constexpr int kWide = 3 - kPairs;           // boxes a step: kPairs x kWide
                                              // = 2 accumulators
  const int wg = threadIdx.x / 128;
  const int lane_row = threadIdx.x % 128 / 32 * 16 + threadIdx.x % 16;
  const int c = 2 * (threadIdx.x % 4);
  float acc[kPairs * kWide][32];
  uint32_t a[kParts][kPairs][4 * kSteps];     // by part
  auto settle = [&]() {
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      reg_fence(acc[0][e]);
      reg_fence(acc[1][e]);
    }
#pragma unroll
    for (int u = 0; u < kPairs; ++u) {
#pragma unroll
      for (int p = 0; p < kParts; ++p)
#pragma unroll
        for (int e = 0; e < 4 * kSteps; ++e) reg_fence(a[p][u][e]);
    }
  };
  walk(cv, [&](int i, int g, int nt) {
    uint32_t row[kPairs];
#pragma unroll
    for (int u = 0; u < kPairs; ++u)
      row[u] = a_row(g, 128 * u + 64 * wg + lane_row);
    for (int kc = 0; kc < cv.n_chunks; ++kc, ++step) {
      before(i + kc, g, nt, kc);
      const uint32_t chunk = a_chunk(i + kc, kc);
      const int st = step % kStages;
      mbar_wait(&full[st], (step / kStages) & 1);
      const uint64_t db = desc_sw128(ring + st * kSlotBytes);
#pragma unroll
      for (int p = 0; p < kParts; ++p) {
#pragma unroll
        for (int u = 0; u < kPairs; ++u)
#pragma unroll
          for (int k = 0; k < kSteps; ++k)
            ldsm_x4(&a[p][u][4 * k], row[u] + chunk + a_col(kSteps * p + k));
        settle();
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < kSteps; ++k)
#pragma unroll
          for (int u = 0; u < kPairs; ++u)
#pragma unroll
            for (int n = 0; n < kWide; ++n)   // box n: + kBoxBytes / 16
              wgmma_m64n64k16_rs_tb(acc[u * kWide + n], &a[p][u][4 * k],
                                    db + n * (kBoxBytes >> 4) +
                                        128 * (kSteps * p + k),
                                    kc > 0 || p > 0 || k > 0);
        wgmma_commit();
        wgmma_wait<kParts - 1>();
        settle();
        if (p == kParts - 2 && kc > 0)
          mbar_arrive(&empty[(step + kStages - 1) % kStages]);
      }
    }
    wgmma_wait<0>();
    settle();
    mbar_arrive(&empty[(step + kStages - 1) % kStages]);
#pragma unroll
    for (int n = 0; n < kWide; ++n) {
      const int col0 = (nt * kWide + n) * kBN;
      float2 b[kBN / 8];
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
        b[j] = *reinterpret_cast<const float2*>(bias + col0 + 8 * j + c);
#pragma unroll
      for (int u = 0; u < kPairs; ++u) {
        const float (&d)[32] = acc[u * kWide + n];
        uint32_t v[2][kBN / 8];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < kBN / 8; ++j) {
            v[h][j] = pack(d[4 * j + 2 * h] + b[j].x,
                           d[4 * j + 2 * h + 1] + b[j].y);
            reg_fence(v[h][j]);
          }
        epi(g, col0, 128 * u + 64 * wg, v);
      }
    }
  });
}

// One identity block over a tile of T image rows (blockIdx.x) of one image
// (blockIdx.y); see the header. tx: x's tensor map (x_map); tw1, tw2,
// tw3: the weights' (weight_map).
// kP1, kP23: conv_pairs of conv1 and of conv2 and conv3; a convolution
// one sub-tile wide takes stages two boxes wide.
template <int kP1, int kP23>
__global__ void __launch_bounds__(kThreads, 1)
    identity_block_kernel(const __grid_constant__ CUtensorMap tx,
                          const __grid_constant__ CUtensorMap tw1,
                          const __grid_constant__ CUtensorMap tw2,
                          const __grid_constant__ CUtensorMap tw3,
                          const bf16* __restrict__ x,
                          const float* __restrict__ b1,
                          const float* __restrict__ b2,
                          const float* __restrict__ b3,
                          bf16* __restrict__ out, Shape s) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  constexpr int kBoxes1 = 3 - kP1, kBoxes23 = 3 - kP23;
  constexpr int kSlotBytes =
      (kBoxes1 > kBoxes23 ? kBoxes1 : kBoxes23) * kBoxBytes;
  const Smem plan = smem_plan(s.W, s.M, s.T, kSlotBytes / kBoxBytes,
                              128 * kP1);
  bf16* y1s = reinterpret_cast<bf16*>(base + plan.y1);
  bf16* y2s = reinterpret_cast<bf16*>(base + plan.y2);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + plan.bars);
  uint64_t* empty = full + kStages;
  uint64_t* x_full = empty + kStages;       // conv1's x stages
  uint64_t* x_empty = x_full + kXStages;
  const Tile tile = tile_of(s);
  const Conv convs[3] = {conv_of(s, tile, 0, kBoxes1),
                         conv_of(s, tile, 1, kBoxes23),
                         conv_of(s, tile, 2, kBoxes23)};

  // 1. zero y1s: the ring and halo rows outside the image stay zero
  for (int i = threadIdx.x; i < (plan.y2 - plan.y1) / 16; i += kThreads)
    reinterpret_cast<uint4*>(y1s)[i] = make_uint4(0u, 0u, 0u, 0u);
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], kConsumers);
    }
    for (int b = 0; b < kXStages; ++b) {
      mbar_init(&x_full[b], 1);
      mbar_init(&x_empty[b], kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {          // ---- producer warpgroup
    setmaxnreg_dec<40>();
    if (threadIdx.x == kConsumers) {
      const int x_row0 = (blockIdx.y * s.H + tile.ra) * s.W;   // in tx
      int step = 0;
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        const CUtensorMap* map = v == 0 ? &tw1 : v == 1 ? &tw2 : &tw3;
        const int boxes = v == 0 ? kBoxes1 : kBoxes23;
        walk(convs[v], [&](int i, int g, int nt) {
          for (int kc = 0; kc < convs[v].n_chunks; ++kc, ++step) {
            if (v == 0) {                    // conv1's x chunk: step i + kc
              const int b = (i + kc) % kXStages;
              mbar_wait(&x_empty[b], ((i + kc) / kXStages & 1) ^ 1);
              mbar_expect_tx(&x_full[b], plan.x_bytes);
              tma_load_4d(base + plan.y2 + b * plan.x_bytes, &tx, &x_full[b],
                          kc * kBK, x_row0 + g * kGroupRows, 0, 0);
            }
            const int st = step % kStages;
            mbar_wait(&empty[st], ((step / kStages) & 1) ^ 1);
            mbar_expect_tx(&full[st], boxes * kBoxBytes);
            for (int n = 0; n < boxes; ++n)
              tma_load_4d(base + st * kSlotBytes + n * kBoxBytes, map,
                          &full[st], (nt * boxes + n) * kBN, kc * kBK, 0, 0);
          }
        });
      }
    }
    return;
  }
  // ---- consumer warpgroups: setmaxnreg moves the producer's registers to
  // them at run time (128 x 40 + 256 x 232 of the SM's 65,536), as in K5;
  // the code itself is compiled within 168 a thread (consume())
  setmaxnreg_inc<232>();
  const int W = s.W, C = s.C, M = s.M;
  const int YS = M + 8;             // row stride of y1s and y2s
  const int WP = W + 2;             // pixels in a row of y1s, ring included
  const int lane = threadIdx.x % 32;
  const int g8 = threadIdx.x % 128 / 32 * 16 + lane / 4;  // accumulator row
  const int c = 2 * (lane % 4);
  const size_t image = (size_t)blockIdx.y * s.H * W * C;
  const bf16* xi = x + image;
  bf16* oi = out + image;
  const int P = tile.rows * W;
  int step = 0;
  // a lane's k16 step ks in a padded row of y1s or y2s (ldmatrix's column
  // half included)
  const auto a_col = [&](int ks) { return 32 * ks + 16 * (lane / 16); };

  // 2. conv1 over image rows [ra, rb): image row ra is y1s row ra - r0 + 1.
  //    The producer loads step i's x chunk by TMA into x stage i % kXStages
  //    (128 * kP1 rows from the group's first: rows past the group are the
  //    next ones in x, or zeros past its end, and their sums are dropped);
  //    a step waits for its stage and gives back the one before.
  {
    const Conv cv = convs[0];
    const uint32_t xs = smem_u32(base + plan.y2);
    consume<kP1, kSlotBytes>(
        cv, base, full, empty, step, b1,
        [&](int i, int, int, int) {
          if (i > 0) mbar_arrive(&x_empty[(i - 1) % kXStages]);
          mbar_wait(&x_full[i % kXStages], i / kXStages & 1);
        },
        [&](int, int r) { return xs + r * kBK * 2; },
        [&](int i, int) { return i % kXStages * plan.x_bytes; },
        [&](int ks) {   // 16-byte chunk j of row r lies at chunk j ^ (r % 8)
          return ((2 * ks + lane / 16) ^ (lane % 8)) * 16;   // (r % 8 is
        },                                                   // lane % 8)
        [](float lo, float hi) { return relu_bf16(lo, hi); },
        [&](int g, int col0, int row0, const uint32_t (&v)[2][kBN / 8]) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int p = g * kGroupRows + row0 + g8 + 8 * h;
            if (p >= cv.rows) continue;
            bf16* dst = y1s + ((tile.ra - tile.r0 + 1 + p / W) * WP + p % W
                               + 1) * YS + col0 + c;
#pragma unroll
            for (int j = 0; j < kBN / 8; ++j)
              *reinterpret_cast<uint32_t*>(dst + 8 * j) = v[h][j];
          }
        });
  }
  named_barrier_sync(kConsumerBar, kConsumers);   // y1s complete

  // 3. conv2, depth 9 M: tap t = (dy, dx) = (t / 3 - 1, t % 3 - 1) of output
  //    pixel q reads y1s pixel (q / W + 1 + dy, q % W + 1 + dx); a chunk of
  //    64 lies within one tap
  {
    const Conv cv = convs[1];
    const uint32_t y1 = smem_u32(y1s);
    consume<kP23, kSlotBytes>(
        cv, base, full, empty, step, b2, [](int, int, int, int) {},
        [&](int g, int r) {            // the output pixel's own tap
          const int q = min(g * kGroupRows + r, P - 1);
          return y1 + ((q / W + 1) * WP + q % W + 1) * YS * 2;
        },
        [&](int, int kc) {             // tap t's offset, then the channels
          const int k = kc * kBK, t = k / M;
          return (((t / 3 - 1) * WP + t % 3 - 1) * YS + k % M) * 2;
        },
        a_col,
        [](float lo, float hi) { return relu_bf16(lo, hi); },
        [&](int g, int col0, int row0, const uint32_t (&v)[2][kBN / 8]) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int q = g * kGroupRows + row0 + g8 + 8 * h;
            if (q >= P) continue;
            bf16* dst = y2s + q * YS + col0 + c;
#pragma unroll
            for (int j = 0; j < kBN / 8; ++j)
              *reinterpret_cast<uint32_t*>(dst + 8 * j) = v[h][j];
          }
        });
  }
  named_barrier_sync(kConsumerBar, kConsumers);   // y2s complete

  // 4. conv3 with bias, residual and ReLU: h = relu(bf16(bf16(y3 + b3) + h))
  {
    const Conv cv = convs[2];
    const uint32_t y2 = smem_u32(y2s);
    const bf162 zero = __floats2bfloat162_rn(0.f, 0.f);
    consume<kP23, kSlotBytes>(
        cv, base, full, empty, step, b3, [](int, int, int, int) {},
        [&](int g, int r) {
          return y2 + min(g * kGroupRows + r, P - 1) * YS * 2;
        },
        [](int, int kc) { return kc * kBK * 2; },
        a_col,
        [](float lo, float hi) {   // y3 = bf16(. + b3)
          const bf162 y = __floats2bfloat162_rn(lo, hi);
          return *reinterpret_cast<const uint32_t*>(&y);
        },
        [&](int g, int col0, int row0, const uint32_t (&v)[2][kBN / 8]) {
          // every residual load goes out before the first store: the
          // compiler cannot tell that x and out never overlap, and would
          // otherwise wait for each load in turn (rows past the tile read
          // its last row)
          size_t off[2];
          bf162 res[2][kBN / 8];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int q = g * kGroupRows + row0 + g8 + 8 * h;
            off[h] = (size_t)(tile.r0 * W + min(q, P - 1)) * C + col0 + c;
#pragma unroll
            for (int j = 0; j < kBN / 8; ++j)
              res[h][j] = *reinterpret_cast<const bf162*>(xi + off[h] + 8 * j);
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (g * kGroupRows + row0 + g8 + 8 * h >= P) continue;
#pragma unroll
            for (int j = 0; j < kBN / 8; ++j) {
              const float2 y3 = __bfloat1622float2(
                  *reinterpret_cast<const bf162*>(&v[h][j]));
              const float2 r = __bfloat1622float2(res[h][j]);
              *reinterpret_cast<bf162*>(oi + off[h] + 8 * j) = __hmax2(
                  __floats2bfloat162_rn(y3.x + r.x, y3.y + r.y), zero);
            }
          }
        });
  }
}

// x [B H W, C] as a TMA tensor map: dims (C, B H W, 1, 1), boxes of 64
// channels x x_rows rows (an x stage), 128-byte swizzle.
bool x_map(CUtensorMap* map, hopper::EncodeTiled encode, const void* x,
           int rows, int C, int x_rows) {
  const cuuint64_t row = (cuuint64_t)C * sizeof(bf16);
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)rows, 1, 1};
  const cuuint64_t strides[3] = {row, row * rows, row * rows};
  const cuuint32_t box[4] = {kBK, (cuuint32_t)x_rows, 1, 1};
  return hopper::tensor_map_bf16(map, encode, x, 4, dims, strides, box);
}

// The tensor map of a row-major bf16 weight matrix [K, N]: dims (N, K, 1, 1)
// innermost first, 64 x 64 boxes (one weight stage), 128-byte swizzle.
bool weight_map(CUtensorMap* map, hopper::EncodeTiled encode,
                const void* w, int K, int N) {
  const cuuint64_t row = (cuuint64_t)N * sizeof(bf16);
  const cuuint64_t dims[4] = {(cuuint64_t)N, (cuuint64_t)K, 1, 1};
  const cuuint64_t strides[3] = {row, row * K, row * K};
  const cuuint32_t box[4] = {kBN, kBK, 1, 1};
  return hopper::tensor_map_bf16(map, encode, w, 4, dims, strides, box);
}

// The kernel's four forms, by conv_pairs of conv1 and of conv2 and conv3.
// tile_rows plans the shared memory for conv_boxes, the most a form of the
// shape may take.
using Kernel = decltype(&identity_block_kernel<1, 1>);
const Kernel kKernels[2][2] = {
    {identity_block_kernel<1, 1>, identity_block_kernel<1, 2>},
    {identity_block_kernel<2, 1>, identity_block_kernel<2, 2>}};

}  // namespace

extern "C" {

// Image rows of a launch's tiles at H x W pixels and bottleneck width M; 0
// when one row's tile does not fit the shared memory (the wrapper refuses).
int isf_fused_block_tile(int H, int W, int M) {
  return H < 1 || W < 1 || M < kBN || M % kBN ? 0 : tile_rows(H, W, M);
}

// The most registers a thread and local memory (spills) in bytes a thread
// over the kernel's compiled forms, from cudaFuncGetAttributes. Returns
// the CUDA error code.
int isf_fused_block_attrs(int* regs, int* local_bytes) {
  *regs = *local_bytes = 0;
  for (const auto& row : kKernels)
    for (Kernel k : row) {
      cudaFuncAttributes attr;
      const cudaError_t err = cudaFuncGetAttributes(&attr, k);
      if (err != cudaSuccess) return (int)err;
      *regs = attr.numRegs > *regs ? attr.numRegs : *regs;
      *local_bytes = (int)attr.localSizeBytes > *local_bytes
                         ? (int)attr.localSizeBytes : *local_bytes;
    }
  return 0;
}

// One identity block: x [B, H*W, C] bf16 -> out (the same shape, another
// buffer); w1 [C, M], w2 [9 M, M], w3 [M, C] bf16, b1 [M], b2 [M], b3 [C]
// f32, all contiguous and 16-byte aligned; C and M multiples of 64. Tiles
// of isf_fused_block_tile(H, W, M) image rows. Returns the CUDA error code
// (0 = launched), or -1 (kNoEncoder) if libcuda has no tensor-map encoder
// and -2 (kMapRefused) if it refuses a weight, launching nothing.
int isf_fused_block(const void* x, const void* w1, const void* b1,
                    const void* w2, const void* b2, const void* w3,
                    const void* b3, void* out, int B, int H, int W, int C,
                    int M, void* stream_ptr) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || C < kBN || C % kBN ||
      M < kBN || M % kBN || x == out)
    return (int)cudaErrorInvalidValue;
  const int T = tile_rows(H, W, M);
  if (!T) return (int)cudaErrorInvalidValue;
  const hopper::EncodeTiled encode = hopper::encode_tiled();
  if (encode == nullptr) return hopper::kNoEncoder;
  Shape s{H, W, C, M, T, {}};
  for (int v = 0; v < 3; ++v)
    s.groups[v] = (conv_rows(H, W, T, v) + kGroupRows - 1) / kGroupRows;
  const bool paired = M % (2 * kBN) == 0;   // conv1's and conv2's tiles
  const int p1 = conv_pairs(conv_rows(H, W, T, 0), paired);
  const int p23 = conv_pairs(conv_rows(H, W, T, 1),
                             paired && C % (2 * kBN) == 0);
  CUtensorMap tx, tw1, tw2, tw3;
  if (!x_map(&tx, encode, x, B * H * W, C, 128 * p1) ||
      !weight_map(&tw1, encode, w1, C, M) ||
      !weight_map(&tw2, encode, w2, 9 * M, M) ||
      !weight_map(&tw3, encode, w3, M, C))
    return hopper::kMapRefused;
  const Kernel kernel = kKernels[p1 - 1][p23 - 1];
  const int smem =
      smem_plan(W, M, T, p1 == 1 || p23 == 1 ? 2 : 1, 128 * p1).total;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((H + T - 1) / T, B);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream_ptr)>>>(
      tx, tw1, tw2, tw3, static_cast<const bf16*>(x),
      static_cast<const float*>(b1), static_cast<const float*>(b2),
      static_cast<const float*>(b3), static_cast<bf16*>(out), s);
  return (int)cudaGetLastError();
}

}  // extern "C"
