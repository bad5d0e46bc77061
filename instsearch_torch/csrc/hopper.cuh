// PTX wrappers for Hopper's asynchronous machinery (sm_90a only), shared by
// the port's warp-specialised kernels (K5's and K6's bf16 kernels in
// vit_attention.cu, K7 in fused_resnet.cu, K4 in pq_scan.cu, the pass 1 of
// K1's bf16 and f32 and K2/K3's int8 and int4 stores in topk_wgmma.cuh):
//
//   * mbarriers: init, arrive, arrive with an expected transaction count,
//     and the wait on a phase's parity;
//   * TMA: a 4-D tile load (cp.async.bulk.tensor) that completes on an
//     mbarrier, from a CUtensorMap passed as a __grid_constant__ parameter,
//     its store form (shared to global, in bulk groups, with the proxy
//     fence the writers of the tile need before it), and a 1-D bulk copy of
//     contiguous bytes (cp.async.bulk), which needs no tensor map;
//   * wgmma: the shared-memory matrix descriptor of a tile that TMA wrote
//     with CU_TENSOR_MAP_SWIZZLE_128B, the m64nNk16 product with both
//     operands in shared memory (N = 8 to 64, and 128), the m64n64k16
//     product with A in registers, their integer forms m64nNk32 (s8 x s8
//     with both operands in shared memory, u8 x s8 with A in registers;
//     N = 8 to 64, s32 sums), the TF32 form m64nNk8 with A in registers
//     (N = 8 to 64, f32 sums) and the round to TF32 (cvt.rna) that feeds
//     it, the fence, commit and wait around them, and ldmatrix, which
//     gathers a register A fragment from shared memory;
//   * setmaxnreg, which moves registers from a producer warpgroup to the
//     consumer warpgroups, and the named barrier that syncs the consumers
//     without the producer (and its bar.red form, which also ORs a
//     predicate over the threads);
//   * on the host, the tensor-map encoder (a libcuda function reached
//     through the runtime, so the library needs no -lcuda) and a bf16,
//     f32 or uint8 map of any rank with a 128-byte swizzle.
//
// Phases. A barrier starts in phase 0. wait(bar, parity) returns once the
// phase of that parity has completed: a consumer waits on round r's "full"
// barrier with parity r & 1, and a producer on round r's "empty" barrier
// with parity (r & 1) ^ 1, which passes at once in round 0 (the stage
// starts empty).
//
// Swizzled tiles. A 128-byte-swizzled tile holds rows of 128 bytes (64
// bf16) whose 16-byte chunks are permuted by XOR with the row's index
// within its group of 8 rows; a group is 1,024 bytes, and the tile's base
// must be 1,024-aligned. desc_sw128 describes such a tile for wgmma with a
// stride of 1,024 bytes between 8-row groups (SBO); the other offset (LBO)
// is unused, because one product reads 32 bytes of a K-major row, or 64
// elements of an MN-major row, inside one 128-byte atom. The hardware
// applies the XOR to the address it computes, so:
//   * K-major (the reduction dim contiguous, as q and k rows are): step k16
//     starts 32 bytes further, desc + 2 (the address field counts 16-byte
//     units);
//   * MN-major (the output dim contiguous, as v rows are for p.v): step k16
//     reads the next 16 rows, 2,048 bytes further, desc + 128, with the
//     instruction's transpose bit set for that operand.
//
// Accumulators (m64nN, f32): in a warpgroup, thread t = 32 w + l holds
// d[4 j + e] at row 16 w + l / 4 + 8 (e >> 1), column 8 j + 2 (l % 4) +
// (e & 1): mma.sync's C layout, repeated over N / 8 column tiles. The A
// register fragment of an m64k16 step holds rows 16 w + l / 4 (+ 8) and
// columns 2 (l % 4) (+ 1, + 8, + 9) in four bf16 pairs, so accumulator
// entries 8 i .. 8 i + 7, packed to bf16 pairs in order, are the A fragment
// of columns 16 i .. 16 i + 15. The integer sums (s32) lie as the f32 ones.
// The A register fragment of an 8-bit m64k32 step holds, in its four
// registers, rows 16 w + l / 4, + 8, + 0, + 8 and bytes 4 (l % 4) .. + 3,
// the same, + 16, + 16: mma.sync m16n8k32's A fragment, which ldmatrix.x4
// gathers from the four 8 x 16-byte matrices (rows 0-7 | 8-15) x (bytes
// 0-15 | 16-31), lane l giving the address of row l % 16, half l / 16.
// The TF32 A fragment of an m64k8 step is the same four registers of 4
// bytes: rows 16 w + l / 4, + 8, + 0, + 8 and f32 columns l % 4, the same,
// + 4, + 4 (mma.sync m16n8k8's), which the same ldmatrix.x4 gathers from
// rows of f32 (a 16-byte half is 4 columns).
//
// Everything here has internal linkage.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// makes the inits visible to the async proxy (TMA); the block syncs after
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// one arrival that also expects `bytes` of TMA transactions this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Waits for the phase of `parity` to complete. A wait that never ends (a
// barrier no one completes) traps after 2^26 polls, seconds at least, so a
// fault ends the kernel with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}

// ---- TMA -------------------------------------------------------------------

// The box of `map` at coordinates (c0, c1, c2, c3), innermost first, into
// shared memory at dst; completes `bar`'s transactions with the box's full
// size (out-of-bounds elements are zero-filled and counted).
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// The box of `map` at coordinates (c0, c1, c2, c3) written from shared
// memory at src (a tile in the layout the map describes); elements out of
// the tensor's bounds are not written. The copy joins the thread's current
// bulk group (bulk_commit, then bulk_wait_read before src is rewritten).
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// waits until at most N of the thread's committed bulk groups still read
// their shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(N) : "memory");
}

// waits until the thread's committed bulk groups are complete (their
// writes done), before the block ends
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// makes this thread's writes to shared memory visible to the async proxy
// (a TMA store that reads them); the writers then sync before the store
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// `bytes` contiguous bytes from global memory at src into shared memory at
// dst; completes `bar`'s transactions with `bytes`. dst, src and bytes must
// be multiples of 16.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)),
         "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---- registers -------------------------------------------------------------

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(R));
}

// bar.sync on barrier `id` (1-15; 0 is __syncthreads) for `threads`
// threads, a multiple of 32: the consumer warpgroups sync among themselves
// while the producer goes on loading
__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// named_barrier_sync that also returns, to every thread, whether `pred` was
// true in any of them (bar.red.or): one barrier for a decision the threads
// must take together
__device__ __forceinline__ bool named_barrier_or(int id, int threads,
                                                 bool pred) {
  uint32_t any;
  asm volatile(
      "{\n.reg .pred p, q;\nsetp.ne.u32 p, %1, 0;\n"
      "bar.red.or.pred q, %2, %3, p;\nselp.u32 %0, 1, 0, q;\n}\n"
      : "=r"(any) : "r"((uint32_t)pred), "r"(id), "r"(threads) : "memory");
  return any != 0;
}

// Pins a register that an in-flight wgmma reads or writes: the compiler
// may not move or copy it across this point.
__device__ __forceinline__ void reg_fence(float& r) {
  asm volatile("" : "+f"(r) :: "memory");
}

__device__ __forceinline__ void reg_fence(uint32_t& r) {
  asm volatile("" : "+r"(r) :: "memory");
}

__device__ __forceinline__ void reg_fence(int& r) {
  asm volatile("" : "+r"(r) :: "memory");
}

// ldmatrix.x4 from a 32-bit shared address: lanes 8 i .. 8 i + 7 give the
// rows of matrix i, register i of lane l gets 4 bytes of its row l / 4 at
// byte 4 (l % 4)
__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr) : "memory");
}

// ---- wgmma -----------------------------------------------------------------

__device__ __forceinline__ uint64_t desc_sw128(const void* tile) {
  return (uint64_t)((smem_u32(tile) & 0x3FFFF) >> 4)
       | (uint64_t)1 << 16                  // LBO: unused (see above)
       | (uint64_t)(1024 >> 4) << 32        // SBO: 8-row groups
       | (uint64_t)1 << 62;                 // 128-byte swizzle
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// d (+)= a b: a 64 x 16 K-major and b 16 x 128 K-major (stored [n][k]), both
// bf16 in shared memory; d 64 x 128 f32. scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64],
                                                    uint64_t da, uint64_t db,
                                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (+)= a b: a 64 x 16 bf16 in registers (four bf16 pairs a thread, the
// layout above), b 16 x 64 MN-major (stored [k][n]) bf16 in shared memory;
// d 64 x 64 f32. scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n64k16_rs_tb(float (&d)[32],
                                                      const uint32_t* a,
                                                      uint64_t db,
                                                      int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (+)= a b for N = 8, 16, 32 or 64: as wgmma_m64n128k16_ss, with b
// 16 x N and d 64 x N (N / 2 registers a thread, the layout above).
template <int N>
struct WgmmaSS;

template <>
struct WgmmaSS<8> {
  __device__ __forceinline__ static void run(float (&d)[4], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3"
        "}, %4, %5, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaSS<16> {
  __device__ __forceinline__ static void run(float (&d)[8], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaSS<32> {
  __device__ __forceinline__ static void run(float (&d)[16], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaSS<64> {
  __device__ __forceinline__ static void run(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

// ---- integer wgmma ---------------------------------------------------------
//
// d (+)= a b in exact s32 sums, m64nNk32 for N = 8, 16, 32 or 64 (N / 2
// registers a thread, the layout above); a 64 x 32 bytes and b 32 x N, both
// K-major, the only order integer wgmma takes. WgmmaS8: s8 x s8, both from
// shared memory (descriptors); WgmmaU8S8: u8 x s8, a from registers (its
// four registers, the layout above). scale_d = 0 overwrites d.

#define ISF_D4 "%0, %1, %2, %3"
#define ISF_D8 ISF_D4 ", %4, %5, %6, %7"
#define ISF_D16 ISF_D8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define ISF_D32                                                              \
  ISF_D16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "  \
          "%28, %29, %30, %31"
#define ISF_O4(i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3])
#define ISF_O8(i) ISF_O4(i), ISF_O4(i + 4)
#define ISF_O16(i) ISF_O8(i), ISF_O8(i + 8)
#define ISF_O32 ISF_O16(0), ISF_O16(16)

template <int N>
struct WgmmaS8;
template <int N>
struct WgmmaU8S8;

#define ISF_INT_WGMMA(N, DS, OUTS, SS_TAIL, RS_TAIL)                         \
  template <>                                                                \
  struct WgmmaS8<N> {                                                        \
    __device__ __forceinline__ static void run(int (&d)[N / 2], uint64_t da, \
                                               uint64_t db, int scale_d) {   \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " SS_TAIL             \
                   : OUTS : "l"(da), "l"(db), "r"(scale_d));                \
    }                                                                        \
  };                                                                         \
  template <>                                                                \
  struct WgmmaU8S8<N> {                                                      \
    __device__ __forceinline__ static void run(int (&d)[N / 2],             \
                                               const uint32_t* a,           \
                                               uint64_t db, int scale_d) {   \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " RS_TAIL             \
                   : OUTS                                                    \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),  \
                     "r"(scale_d));                                          \
    }                                                                        \
  };

ISF_INT_WGMMA(8, ISF_D4, ISF_O4(0),
              "%6, 0;\nwgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {"
              ISF_D4 "}, %4, %5, p;\n}\n",
              "%9, 0;\nwgmma.mma_async.sync.aligned.m64n8k32.s32.u8.s8 {"
              ISF_D4 "}, {%4, %5, %6, %7}, %8, p;\n}\n")
ISF_INT_WGMMA(16, ISF_D8, ISF_O8(0),
              "%10, 0;\nwgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
              ISF_D8 "}, %8, %9, p;\n}\n",
              "%13, 0;\nwgmma.mma_async.sync.aligned.m64n16k32.s32.u8.s8 {"
              ISF_D8 "}, {%8, %9, %10, %11}, %12, p;\n}\n")
ISF_INT_WGMMA(32, ISF_D16, ISF_O16(0),
              "%18, 0;\nwgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
              ISF_D16 "}, %16, %17, p;\n}\n",
              "%21, 0;\nwgmma.mma_async.sync.aligned.m64n32k32.s32.u8.s8 {"
              ISF_D16 "}, {%16, %17, %18, %19}, %20, p;\n}\n")
ISF_INT_WGMMA(64, ISF_D32, ISF_O32,
              "%34, 0;\nwgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
              ISF_D32 "}, %32, %33, p;\n}\n",
              "%37, 0;\nwgmma.mma_async.sync.aligned.m64n64k32.s32.u8.s8 {"
              ISF_D32 "}, {%32, %33, %34, %35}, %36, p;\n}\n")

#undef ISF_INT_WGMMA

// ---- TF32 wgmma ------------------------------------------------------------
//
// d (+)= a b in f32 sums, m64nNk8 for N = 8, 16, 32 or 64, a 64 x 8 TF32
// from registers (four registers a thread, the layout above), b 8 x N TF32
// K-major in shared memory (a k8 step is 32 bytes of a row, as a bf16 k16
// step), the only order TF32 wgmma takes. A TF32 operand is an f32 whose
// 13 low mantissa bits are zero (tf32_rna); the products are exact.

// x rounded to TF32 (10 stored mantissa bits), to nearest with ties away
// from zero, as the f32 bit pattern with the 13 low bits zero
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

template <int N>
struct WgmmaTF32;

#define ISF_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define ISF_F8(i) ISF_F4(i), ISF_F4(i + 4)
#define ISF_F16(i) ISF_F8(i), ISF_F8(i + 8)
#define ISF_F32 ISF_F16(0), ISF_F16(16)
#define ISF_TF32_WGMMA(N, OUTS, TAIL)                                        \
  template <>                                                                \
  struct WgmmaTF32<N> {                                                      \
    __device__ __forceinline__ static void run(float (&d)[N / 2],           \
                                               const uint32_t* a,           \
                                               uint64_t db, int scale_d) {   \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " TAIL               \
                   : OUTS                                                    \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),  \
                     "r"(scale_d));                                          \
    }                                                                        \
  };

ISF_TF32_WGMMA(8, ISF_F4(0),
               "%9, 0;\nwgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
               ISF_D4 "}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n")
ISF_TF32_WGMMA(16, ISF_F8(0),
               "%13, 0;\nwgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
               ISF_D8 "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n")
ISF_TF32_WGMMA(32, ISF_F16(0),
               "%21, 0;\nwgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
               ISF_D16 "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n")
ISF_TF32_WGMMA(64, ISF_F32,
               "%37, 0;\nwgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
               ISF_D32 "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n")

#undef ISF_TF32_WGMMA
#undef ISF_F32
#undef ISF_F16
#undef ISF_F8
#undef ISF_F4
#undef ISF_O32
#undef ISF_O16
#undef ISF_O8
#undef ISF_O4
#undef ISF_D32
#undef ISF_D16
#undef ISF_D8
#undef ISF_D4

// ---- host: tensor maps -----------------------------------------------------

// What a C entry returns, past the CUDA error codes, when it launches
// nothing: libcuda has no tensor-map encoder, or the encoder refuses an
// operand.
constexpr int kNoEncoder = -1;
constexpr int kMapRefused = -2;

// cuTensorMapEncodeTiled, a libcuda function, through the runtime's entry
// point query, so the library links against the runtime alone; null if
// libcuda has none.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
        ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// A tensor of `rank` dims of `type` at `base` as a TMA tensor map: dims[0]
// the contiguous one, strides[i] the byte stride of dim i + 1, boxes of
// box[i] elements (box[0] at most 128 bytes), 128-byte swizzle (the layout
// desc_sw128 describes), elements out of bounds zero-filled. False if the
// encoder refuses the strides or the base's alignment.
bool tensor_map_sw128(CUtensorMap* map, EncodeTiled encode,
                      CUtensorMapDataType type, const void* base, int rank,
                      const cuuint64_t* dims, const cuuint64_t* strides,
                      const cuuint32_t* box) {
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  return encode(map, type, (cuuint32_t)rank, const_cast<void*>(base), dims,
                strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// tensor_map_sw128 of bf16 elements (box[0] at most 64)
bool tensor_map_bf16(CUtensorMap* map, EncodeTiled encode, const void* base,
                     int rank, const cuuint64_t* dims,
                     const cuuint64_t* strides, const cuuint32_t* box) {
  return tensor_map_sw128(map, encode, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base,
                          rank, dims, strides, box);
}

}  // namespace hopper
}  // namespace
