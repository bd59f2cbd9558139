// Hopper (sm_90a) building blocks of the flash-attention kernels
// (flash_attention.cu): warpgroup products (wgmma.mma_async, bf16 in, fp32
// accumulate), their shared-memory descriptors for 128-byte-swizzled tiles,
// TMA tile loads (cp.async.bulk.tensor) and bulk copies of fp32 rows
// (cp.async.bulk) completing on mbarriers, and the register split between
// a producer warpgroup and its consumers (setmaxnreg).
//
// Tiles. Every bf16 tile in shared memory is [rows][64] with 128-byte rows
// (one D = 64 head row), written by TMA with CU_TENSOR_MAP_SWIZZLE_128B:
// the 16-byte chunk c of row r lands at chunk c ^ (r % 8). A tile starts on
// a 1024-byte boundary, so every group of 8 rows is one swizzle atom of 1024
// bytes. Such a tile is read by wgmma either K-major (the contraction runs
// along the row: A = Q or K in S = Q K^T, B = K in the same product) or
// MN-major (the contraction runs down the rows: B = V in O += P V, dO in
// dV += P^T dO, Q in dK += dS^T Q, K in dQ += dS K); one descriptor form
// serves both, stepped by 32 bytes per k16 slice along a row and by 16 rows
// (2048 bytes) down.
//
// Fragments. The accumulator of an m64n64k16 product is float[8][4] a
// thread (m64n128k16: float[16][4], n-tiles 8-15 the next 64 columns): warp
// w of the warpgroup holds rows 16 w + lane / 4 (elements 0, 1)
// and 16 w + lane / 4 + 8 (elements 2, 3) at columns 8 j + 2 (lane % 4) + {0,
// 1} of n-tile j, the score-accumulator layout of attention_mma.cuh with
// four warps stacked. A register A operand of k16 slice kk is the packed
// bf16 of n-tiles 2 kk and 2 kk + 1 of such an accumulator (pack_a).

#pragma once

#include <cuda.h>

#include "attention_mma.cuh"

// wgmma shared-memory descriptor of a 128-byte-swizzled tile starting at p:
// start address >> 4 in bits 0-13; leading and stride byte offsets (>> 4) in
// bits 16-29 and 32-45, both 1024 bytes, the distance between 8-row swizzle
// atoms (the only stride either major order uses at N = 64); layout type 1
// (128-byte swizzle) in bits 62-63
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFFull) >> 4) | (64ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous products that own it
template <int J>
__device__ __forceinline__ void fence_acc(float (&d)[J][4]) {
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

// the same for register A operands (the packed bf16 of P or dS)
template <int K>
__device__ __forceinline__ void fence_frag(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[k][e])::"memory");
}

#define HOPPER_ACC32(d) \
      "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), \
      "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), \
      "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), \
      "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), \
      "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), \
      "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), \
      "+f"(d[7][2]), "+f"(d[7][3])

#define HOPPER_ACC64(d) \
      "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), \
      "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), \
      "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), \
      "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), \
      "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), \
      "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), \
      "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), \
      "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), \
      "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), \
      "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]), \
      "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), \
      "+f"(d[13][3]), "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), \
      "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])

#define HOPPER_D32 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

#define HOPPER_D64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, " \
  "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, " \
  "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d[64 x 64] (+)= a[64 x 16] b[16 x 64], both from shared memory; a is
// K-major, b K-major (kTransB = 0) or MN-major (1); d is overwritten when
// accumulate == 0
template <int kTransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_D32
      ", %32, %33, p, 1, 1, 0, %35;\n}\n"
      : HOPPER_ACC32(d)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(kTransB));
}

// d[64 x N] (+)= a[64 x 16] b[16 x N], N = 8 J = 64 or 128, a from
// registers (pack_a or load_a_sw128), b from shared memory, K-major (kTransB
// = 0) or MN-major (1); d is overwritten when accumulate == 0
template <int kTransB, int J>
__device__ __forceinline__ void wgmma_rs(float (&d)[J][4], const uint32_t (&a)[4],
                                         uint64_t desc_b, int accumulate = 1) {
  if constexpr (J == 8) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_D32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, %37;\n}\n"
        : HOPPER_ACC32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "n"(kTransB),
          "r"(accumulate));
  } else {
    static_assert(J == 16, "m64n64 or m64n128");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %70, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_D64
        ", {%64, %65, %66, %67}, %68, p, 1, 1, %69;\n}\n"
        : HOPPER_ACC64(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "n"(kTransB),
          "r"(accumulate));
  }
}

#undef HOPPER_ACC32
#undef HOPPER_ACC64
#undef HOPPER_D32
#undef HOPPER_D64

// 2^x in one MUFU.EX2, subnormal results flushed to zero (exp2f without
// fast math adds the instructions that keep them); a probability below
// 2^-126 is 0 either way once it is rounded to bf16 or added to a row sum
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the bf16 register A operand of k16 slice kk of an accumulator x
template <int J>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&x)[J][4], int kk) {
  a[0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
  a[1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
  a[2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
  a[3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
}

// the register A operand of k16 slice kk of rows [16 w, 16 w + 16) of a
// 128-byte-swizzled [64, 64] tile (warp w of the warpgroup), by ldmatrix:
// lanes 0-15 address the rows' first 8 columns of the slice, lanes 16-31
// the next 8, each 16-byte chunk where the swizzle put it
__device__ __forceinline__ void load_a_sw128(uint32_t (&a)[4], const bf16* tile, int w,
                                             int lane, int kk) {
  const int row = w * 16 + (lane & 15);
  const int chunk = (kk * 2 + (lane >> 4)) ^ (row & 7);
  ldmatrix_x4(a, tile + row * 64 + chunk * 8);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// one arrival that also expects `bytes` of TMA transactions this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// one arrival per warp that expects the bytes its lanes are about to copy
// into this phase (summed over the warp; a plain arrival when none)
__device__ __forceinline__ void warp_expect_tx(uint64_t* bar, uint32_t bytes, int lane) {
  const uint32_t total = __reduce_add_sync(0xffffffffu, bytes);
  if (lane == 0) {
    if (total != 0)
      mbar_expect_tx(bar, total);
    else
      mbar_arrive(bar);
  }
  __syncwarp();
}

// named barrier id (1-15) over `count` threads: wait for all of them, or
// arrive without waiting
__device__ __forceinline__ void named_barrier_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void named_barrier_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// wait until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: the box at coordinates (c0, c1, c2, c3) of a 4-d tensor map into
// shared memory, completing `bar`'s transactions; coordinates past the
// tensor's extent read as zeros
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}

// bulk copy (no tensor map) of `bytes` (a multiple of 16) from a 16-byte
// aligned global address into shared memory, completing `bar`'s transactions
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The 16-byte-aligned span of global memory that covers n floats from p,
// for a bulk copy of fp32 rows whose pitch is not a multiple of 16 bytes
// (N = 4097): the copy lands the floats span_shift(p) into its destination.
// The span reads at most 12 bytes on either side of the n floats, inside
// the 16-byte chunks that hold the first and the last of them, so it never
// leaves a mapped page.
struct Span {
  const void* src;
  uint32_t bytes;
};
__device__ __forceinline__ Span aligned_span(const float* p, int n) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uintptr_t lo = a & ~uintptr_t{15};
  const uintptr_t hi = (a + 4u * static_cast<uintptr_t>(n) + 15u) & ~uintptr_t{15};
  return Span{reinterpret_cast<const void*>(lo), static_cast<uint32_t>(hi - lo)};
}

// where aligned_span's copy of the floats from p starts in its destination
__device__ __forceinline__ int span_shift(const float* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3u);
}

// the registers of every thread of this warpgroup, from here on
template <int N>
__device__ __forceinline__ void warpgroup_regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void warpgroup_regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// p rounded up to a 1024-byte boundary of shared memory (TMA's 128-byte
// swizzle repeats every 1024 bytes, and wgmma's descriptors assume it)
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}
