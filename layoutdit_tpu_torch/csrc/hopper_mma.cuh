// Hopper (sm_90a) building blocks of the attention kernels
// (flash_attention.cu, short_attention.cu at D = 64) and the fused RoIAlign
// kernels (roi_fused.cu):
// warpgroup products (wgmma.mma_async, bf16 in, fp32 accumulate), their
// shared-memory descriptors for 128-byte-swizzled tiles, TMA tile loads
// (cp.async.bulk.tensor) and bulk copies of fp32 rows (cp.async.bulk)
// completing on mbarriers, TMA tile stores in bulk groups, the register
// split between a producer warpgroup and its consumers (setmaxnreg), and on
// the host the tensor maps' encoder and a device guard.
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

#define HOPPER_ACC28(d) \
      "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), \
      "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), \
      "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), \
      "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), \
      "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), \
      "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), \
      "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3])

#define HOPPER_D28 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27}"

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

// the same at N = 128: d[64 x 128] (+)= a[64 x 16] b[16 x 128]
template <int kTransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[16][4], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_D64
      ", %64, %65, p, 1, 1, 0, %67;\n}\n"
      : HOPPER_ACC64(d)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(kTransB));
}

// d[64 x N] (+)= a[64 x 16] b[16 x N], N = 8 J = 56, 64 or 128, a from
// registers (pack_a or load_a_sw128), b from shared memory, K-major (kTransB
// = 0) or MN-major (1); d is overwritten when accumulate == 0
template <int kTransB, int J>
__device__ __forceinline__ void wgmma_rs(float (&d)[J][4], const uint32_t (&a)[4],
                                         uint64_t desc_b, int accumulate = 1) {
  if constexpr (J == 7) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n56k16.f32.bf16.bf16 " HOPPER_D28
        ", {%28, %29, %30, %31}, %32, p, 1, 1, %33;\n}\n"
        : HOPPER_ACC28(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "n"(kTransB),
          "r"(accumulate));
  } else if constexpr (J == 8) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_D32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, %37;\n}\n"
        : HOPPER_ACC32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "n"(kTransB),
          "r"(accumulate));
  } else {
    static_assert(J == 16, "m64n56, m64n64 or m64n128");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %70, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_D64
        ", {%64, %65, %66, %67}, %68, p, 1, 1, %69;\n}\n"
        : HOPPER_ACC64(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "n"(kTransB),
          "r"(accumulate));
  }
}

#undef HOPPER_ACC28
#undef HOPPER_ACC32
#undef HOPPER_ACC64
#undef HOPPER_D28
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

// The 16-byte-aligned span of global memory that covers n bytes from p (a
// key mask's row, or the part of it under a key tile), for one bulk copy; it
// lands the bytes (p & 15) into its destination, and reads at most 15 bytes
// on either side inside the 16-byte chunks that hold the first and the last
// byte.
__device__ __forceinline__ Span byte_span(const uint8_t* p, int n) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uintptr_t lo = a & ~uintptr_t{15};
  const uintptr_t hi = (a + static_cast<uintptr_t>(n) + 15u) & ~uintptr_t{15};
  return Span{reinterpret_cast<const void*>(lo), static_cast<uint32_t>(hi - lo)};
}

// The keys kv0 + 32 i + [0, 32) that take part (below N and, with use_mask,
// kept by the mask: keep[key] != 0), one ballot a word, each word shifted
// right by 2 quad: then bit 8 (j % 4) + e of word j / 4 is this lane's key
// kv0 + 8 j + 2 quad + e (the score-accumulator layout's columns). Every lane
// of the warp calls it; keep[key] is read for keys below N only. -> whether
// any of the 32 kWords keys drops out (the same answer in every lane).
template <int kWords>
__device__ __forceinline__ bool kept_words(uint32_t (&w)[kWords], const uint8_t* keep,
                                           bool use_mask, int kv0, int N, int lane, int quad) {
  uint32_t all = 0xffffffffu;
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    const int key = kv0 + 32 * i + lane;
    const uint32_t word = __ballot_sync(0xffffffffu, key < N && (!use_mask || keep[key]));
    all &= word;
    w[i] = word >> (2 * quad);
  }
  return all != 0xffffffffu;
}

__device__ __forceinline__ bool kept_bit(const uint32_t* w, int j, int e) {
  return (w[j >> 2] >> (8 * (j & 3) + (e & 1))) & 1u;
}

// the row of batch element b in a key mask [mask_rows, N] (row b % mask_rows)
__device__ __forceinline__ const uint8_t* mask_row(const uint8_t* mask, int mask_rows, int b,
                                                   int N) {
  return mask + static_cast<long long>(b % mask_rows) * N;
}

// TMA: the box at coordinates (c0, c1) of a 2-d tensor map, or (c0, c1, c2)
// of a 3-d one, into shared memory, completing `bar`'s transactions;
// coordinates past the tensor's extent read as zeros
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

// an L2 policy that evicts first what it covers (1.0: everything), for
// stores that stream past L2 and should not push out what is read again
__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

// TMA store: a shared-memory tile to the box at (c0, c1, c2) of a 3-d tensor
// map, or (c0, c1, c2, c3) of a 4-d one, in this thread's bulk group, under
// an L2 cache policy (l2_evict_first); elements past the tensor's extent
// are not written. The threads that wrote the tile call fence_proxy_async
// first, and a barrier orders them before the one thread that stores.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group.L2::cache_hint "
      "[%0, {%2, %3, %4}], [%1], %5;\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "l"(policy)
      : "memory");
}

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group.L2::cache_hint "
      "[%0, {%2, %3, %4, %5}], [%1], %6;\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "l"(policy)
      : "memory");
}

// makes this thread's writes to shared memory visible to the async proxy
// (the TMA store that reads them)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// closes this thread's bulk group of TMA stores
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// waits until at most N of this thread's bulk groups are still reading
// shared memory (their tiles may then be overwritten) ...
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// ... or are still incomplete
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
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

// Makes the device that holds p current in this thread while the guard
// lives, and the thread's previous device current again after it, as
// c10's DeviceGuard does. cudaSetDevice also makes the device's primary
// context current: cuTensorMapEncodeTiled needs a current context, and a
// thread may have none yet (autograd's worker thread runs a backward with
// none where every tensor it allocated came from PyTorch's cache).
class DeviceOf {
 public:
  explicit DeviceOf(const void* p) {
    cudaPointerAttributes attr;
    err_ = cudaPointerGetAttributes(&attr, p);
    if (err_ == cudaSuccess) err_ = cudaGetDevice(&prev_);
    if (err_ == cudaSuccess) err_ = cudaSetDevice(attr.device);
    if (err_ == cudaSuccess) device_ = attr.device;
  }
  ~DeviceOf() {
    if (device_ >= 0 && device_ != prev_) cudaSetDevice(prev_);
  }
  DeviceOf(const DeviceOf&) = delete;
  DeviceOf& operator=(const DeviceOf&) = delete;
  cudaError_t error() const { return err_; }
  int device() const { return device_; }  // the device of p; -1 on an error

 private:
  cudaError_t err_;
  int prev_ = -1;
  int device_ = -1;
};

// cuTensorMapEncodeTiled, a driver function, found through the runtime so
// the library needs no link against libcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A tiled bf16 tensor map over `rank` dims (innermost first) with byte
// strides of dims 1..rank-1, box `box`, zeros past the extent. TMA needs a
// 16-byte-aligned base and strides that are multiples of 16 bytes, and with
// a swizzle a box row of at most its span (128 bytes).
inline bool encode_bf16(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                        const cuuint64_t* strides, const cuuint32_t* box,
                        CUtensorMapSwizzle swizzle, CUtensorMapL2promotion promotion) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, static_cast<cuuint32_t>(rank),
            const_cast<void*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle, promotion, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}
