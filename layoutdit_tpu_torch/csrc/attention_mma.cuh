// Device helpers shared by the attention kernels (flash_attention.cu,
// short_attention.cu): bf16 products on the tensor cores (mma.sync
// m16n8k16, fp32 accumulate) with operands from ldmatrix, in the
// arrangement where a warp owns 16 rows and a score tile spans kChunk (64)
// keys or queries. Shared memory tiles have a row pitch of D + 8 elements,
// so the eight rows an ldmatrix reads land on distinct banks.
//
// Fragment layout of an m16n8k16 accumulator, the "score-accumulator
// layout" below: lane l holds rows l/4 (elements 0, 1) and l/4 + 8
// (elements 2, 3) at columns 2 (l % 4) and 2 (l % 4) + 1 of its n-tile of
// 8 columns.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstdint>

using bf16 = __nv_bfloat16;

struct Strides {
  long long b, n, h;
};

constexpr int kChunk = 64;  // keys (or queries) of one score tile
constexpr float kNegInf = -1e30f;  // the TPU kernels' finite NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// c[16x8] += a[16x16] b[16x8], bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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

// sum over d of a[d] * b[d] for one row of D bf16, split over the four
// lanes of a quad (D/4 contiguous elements each) and reduced over them;
// every lane of the warp must call it (zero when !valid)
template <int D>
__device__ __forceinline__ float quad_row_dot(const bf16* a, const bf16* b, bool valid,
                                              int quad) {
  float s = 0.f;
  if (valid) {
#pragma unroll
    for (int c = 0; c < D / 32; ++c) {
      const uint4 av = *reinterpret_cast<const uint4*>(a + quad * (D / 4) + c * 8);
      const uint4 bv = *reinterpret_cast<const uint4*>(b + quad * (D / 4) + c * 8);
      const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&av);
      const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&bv);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 x = __bfloat1622float2(a2[e]);
        const float2 y = __bfloat1622float2(b2[e]);
        s = fmaf(x.x, y.x, s);
        s = fmaf(x.y, y.y, s);
      }
    }
  }
  return quad_sum(s);
}

// A fragments of rows [16 w, 16 w + 16) of a staged [rows, D] tile
template <int D>
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[D / 16][4], const bf16* tile,
                                             int w, int lane) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldmatrix_x4(f[kk], tile + (w * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
}

// x[16 x 64] = a[16 x D] t^T, where t is a staged [64, D] tile (rows are
// the 64 output columns). Only t's first `rows` rows (a multiple of 16)
// are read; the columns past them stay 0.
template <int D>
__device__ __forceinline__ void mma_abt(float (&x)[kChunk / 8][4],
                                        const uint32_t (&a)[D / 16][4], const bf16* t, int lane,
                                        int rows = kChunk) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int j = 0; j < kChunk / 8; ++j) x[j][0] = x[j][1] = x[j][2] = x[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < kChunk / 8; j += 2) {
      if (j * 8 >= rows) break;
      uint32_t bt[4];
      ldmatrix_x4(bt, t + (j * 8 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                          ((lane >> 3) & 1) * 8);
      mma_bf16(x[j], a[kk], bt[0], bt[1]);
      mma_bf16(x[j + 1], a[kk], bt[2], bt[3]);
    }
  }
}

// acc[16 x D] += x[16 x 64] t, where x is in score-accumulator layout
// (rounded to bf16 here) and t is a staged [64, D] tile, of which only the
// first `rows` rows (a multiple of 16) are read
template <int D>
__device__ __forceinline__ void mma_xt(float (&acc)[D / 8][4], const float (&x)[kChunk / 8][4],
                                       const bf16* t, int lane, int rows = kChunk) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int kk = 0; kk < kChunk / 16; ++kk) {
    if (kk * 16 >= rows) break;
    const uint32_t xa[4] = {
        pack_bf16(x[2 * kk][0], x[2 * kk][1]), pack_bf16(x[2 * kk][2], x[2 * kk][3]),
        pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
        pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
    for (int nt = 0; nt < D / 8; nt += 2) {
      uint32_t bt[4];
      ldmatrix_x4_trans(bt, t + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + nt * 8 +
                                (lane >> 4) * 8);
      mma_bf16(acc[nt], xa, bt[0], bt[1]);
      mma_bf16(acc[nt + 1], xa, bt[2], bt[3]);
    }
  }
}

// rows r0 (acc[.][0..1]) and r0 + 8 (acc[.][2..3]) of a warp's 16 x D
// accumulator, times mul, as bf16 into a strided [N, D] slice
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, long long stride_n,
                                           const float (&acc)[D / 8][4], int r0, int n, int quad,
                                           float mul) {
  if (r0 < n) {
    bf16* g = dst + r0 * stride_n + 2 * quad;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(g + nt * 8) =
          __floats2bfloat162_rn(acc[nt][0] * mul, acc[nt][1] * mul);
  }
  if (r0 + 8 < n) {
    bf16* g = dst + (r0 + 8) * stride_n + 2 * quad;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(g + nt * 8) =
          __floats2bfloat162_rn(acc[nt][2] * mul, acc[nt][3] * mul);
  }
}
