// Float32 attention forward for Hopper (sm_90a) on the CUDA cores (FFMA),
// shared by short_attention.cu (kernel-table row 1) and flash_attention.cu
// (row 3): each source includes this header and exposes its own launcher
// (short_attention_fwd_f32, flash_attention_fwd_f32) over one template,
// fwd_kernel<D>. It replaces, in float32, the Pallas forwards those rows
// replace in bf16: layoutdit_tpu/ops/short_attention.py::_fwd_kernel (via
// _short_fwd) and layoutdit_tpu/ops/flash_attention.py::_fwd_kernel /
// _fwd_kernel_nobias (via _flash_fwd), whose outputs take q's dtype.
//
//   o = softmax(Q K^T * scale + bias) V, lse = the row's log-sum-exp,
//
// over q, k, v fp32 [B, N, H, D] read through their (B, N, H) element
// strides (the fused QKV projection's slices in place; D contiguous, base
// and strides 16-byte aligned), an optional fp32 bias [H, N, N] shared by
// the batch, an optional key mask uint8 [mask_rows, N] (row b % mask_rows
// for batch b; 0 drops the key) and a valid-key count nk <= N (keys at index
// >= nk dropped). A dropped key's score is -inf, so its P is exactly 0; every
// row must keep at least one key (not checked). o goes out through its
// strides, lse (optional; fp32 [B*H, N], which is [B, H, N]) contiguous.
//
// Full fp32 arithmetic: every product is an FFMA, and the softmax uses
// IEEE expf and logf. TF32 tensor-core products (wgmma or mma.sync with
// tf32 operands) keep about three decimal digits and would not hold the
// plain version's 2e-5 of max |o|; this kernel keeps fp32's.
//
// Shape: one block of 256 threads per (batch * head, 64 query rows), a
// 16 x 16 thread grid in which thread (ty, tx) owns query rows ty + 16 i
// (i < 4) and, of each 64-key tile, score columns tx + 16 j (j < 4) and,
// of the output, head-dim columns tx + 16 j (j < D / 16). The block's Q
// stays in shared memory ([64][D + 1]: the two rows a warp reads sit on
// neighbouring banks). It sweeps the keys in tiles of 64, up to nk: the
// block loads K transposed ([D][65], so a warp's 16 score columns read 16
// banks), V ([64][D]), the bias tile (64 x 64, coalesced along the keys,
// into the P buffer) and the tile's 64 mask bytes once, all with the whole
// block; S = Q K^T by FFMA (4 x 4 a thread), scale, bias and mask applied,
// the online softmax (running max and sum a row, as the Pallas kernel's
// flash_attention.py:64-103; the row's 16 threads reduce by xor shuffles,
// so all hold the same bits), P written to shared memory, O = O * alpha +
// P V by FFMA. Rows past N read as zeros and are not stored; keys past N
// are dropped.
//
// Bound on the H100: operations, 4 N nk D flops a head at the fp32 rate
// (67 TFLOP/s): at B=4, H=12, N=4097, D=64 about 206 GFLOP, 3.1 ms, against
// 100 MB of Q, K, V, O (0.03 ms). The kernel is simple first: two shared
// loads for each four FFMAs in the products, no pipelining of the tiles'
// loads. Shared memory: 41,856 bytes at D = 32, 66,560 at 64, 115,968 at
// 128 (above 48 KB by cudaFuncSetAttribute, once a device and head dim).

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include <atomic>
#include <cstdint>

#include "hopper_mma.cuh"  // DeviceOf

namespace attention_f32 {

constexpr int kRows = 64;          // query rows of a block
constexpr int kKeys = 64;          // keys of a tile
constexpr int kThreads = 256;      // 16 x 16
constexpr int kPitch = kKeys + 1;  // row pitch of the transposed K tile and of P

struct Rows {
  long long b, n, h;  // element strides of a [B, N, H, D] tensor
};

template <int D>
constexpr int smem_bytes() {
  return static_cast<int>(sizeof(float)) *
         (kRows * (D + 1) + D * kPitch + kKeys * D + kRows * kPitch + kKeys);
}

template <int D>
__global__ void __launch_bounds__(kThreads) fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ bias, const uint8_t* __restrict__ mask, int mask_rows,
    float* __restrict__ o, float* __restrict__ lse, int H, int N, int nk, Rows sq, Rows sk,
    Rows sv, Rows so, float scale) {
  constexpr int J = D / 16;  // output columns a thread
  constexpr int Q4 = D / 4;  // float4s a row
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kRows][D + 1]
  float* kt = qs + kRows * (D + 1);             // [D][kPitch]
  float* vs = kt + D * kPitch;                  // [kKeys][D], 16-byte aligned
  float* ps = vs + kKeys * D;                   // [kRows][kPitch]: bias tile, then P
  float* keep = ps + kRows * kPitch;            // [kKeys]: 1 kept, 0 dropped

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.y * kRows;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const uint8_t* mrow =
      mask == nullptr ? nullptr : mask + static_cast<long long>(b % mask_rows) * N;
  const float* bias_h = bias == nullptr ? nullptr : bias + static_cast<long long>(h) * N * N;

  for (int i = tid; i < kRows * Q4; i += kThreads) {
    const int r = i / Q4;
    const int c = (i - r * Q4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < N) x = *reinterpret_cast<const float4*>(qb + (q0 + r) * sq.n + c);
    float* dst = qs + r * (D + 1) + c;
    dst[0] = x.x;
    dst[1] = x.y;
    dst[2] = x.z;
    dst[3] = x.w;
  }

  float m[4], l[4], acc[4][J];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j) acc[i][j] = 0.f;
  }

  const int tiles = (nk + kKeys - 1) / kKeys;
  for (int t = 0; t < tiles; ++t) {
    const int k0 = t * kKeys;
    __syncthreads();  // the previous tile's readers of kt, vs, ps are done
    for (int i = tid; i < kKeys * Q4; i += kThreads) {
      const int r = i / Q4;
      const int c = (i - r * Q4) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 y = x;
      if (k0 + r < N) {
        x = *reinterpret_cast<const float4*>(kb + (k0 + r) * sk.n + c);
        y = *reinterpret_cast<const float4*>(vb + (k0 + r) * sv.n + c);
      }
      kt[(c + 0) * kPitch + r] = x.x;
      kt[(c + 1) * kPitch + r] = x.y;
      kt[(c + 2) * kPitch + r] = x.z;
      kt[(c + 3) * kPitch + r] = x.w;
      *reinterpret_cast<float4*>(vs + r * D + c) = y;
    }
    if (tid < kKeys) {
      const int key = k0 + tid;
      keep[tid] = key < nk && (mrow == nullptr || mrow[key] != 0) ? 1.f : 0.f;
    }
    if (bias_h != nullptr) {
      for (int i = tid; i < kRows * kKeys; i += kThreads) {
        const int r = i / kKeys;
        const int c = i - r * kKeys;
        const int row = q0 + r;
        const int key = k0 + c;
        ps[r * kPitch + c] =
            row < N && key < N ? bias_h[static_cast<long long>(row) * N + key] : 0.f;
      }
    }
    __syncthreads();

    // S = Q K^T, this thread's 4 x 4
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = kt[d * kPitch + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }

    // scale, bias, mask; the online softmax
    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        float x = s[i][j] * scale;
        if (bias_h != nullptr) x += ps[(ty + 16 * i) * kPitch + c];
        x = keep[c] != 0.f ? x : -CUDART_INF_F;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[i], mx);
      const float base = mn == -CUDART_INF_F ? 0.f : mn;  // a row with no kept key yet
      alpha[i] = expf(m[i] - base);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - base);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha[i] + sum;
      m[i] = mn;
    }
    __syncthreads();  // every thread's reads of the bias tile are done
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) ps[(ty + 16 * i) * kPitch + tx + 16 * j] = s[i][j];
    __syncthreads();

    // O = O * alpha + P V
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < J; ++j) acc[i][j] *= alpha[i];
#pragma unroll 4
    for (int key = 0; key < kKeys; ++key) {
      float p[4], w[J];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty + 16 * i) * kPitch + key];
#pragma unroll
      for (int j = 0; j < J; ++j) w[j] = vs[key * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < J; ++j) acc[i][j] = fmaf(p[i], w[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= N) continue;
    float* orow = o + b * so.b + row * so.n + h * so.h;
#pragma unroll
    for (int j = 0; j < J; ++j) orow[tx + 16 * j] = acc[i][j] / l[i];
    if (lse != nullptr && tx == 0) lse[static_cast<long long>(bh) * N + row] = m[i] + logf(l[i]);
  }
}

constexpr int kMaxDevices = 64;  // devices whose raised limit a process keeps

// fwd_kernel<D>'s shared-memory limit raised at its first launch on
// device dev and not again (the attribute holds for the process), so
// that a launch costs the host only the launch itself. Static: each
// library that includes this header has a kernel and flags of its own (a
// static local of a function with external linkage would be one object
// for every library of the process, and the second library's kernel
// would launch with its limit never raised)
template <int D>
static cudaError_t allow_smem_once(int dev) {
  static std::atomic<bool> raised[kMaxDevices];
  if (dev < kMaxDevices && raised[dev].load(std::memory_order_acquire)) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<D>());
  if (err == cudaSuccess && dev < kMaxDevices)
    raised[dev].store(true, std::memory_order_release);
  return err;
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, const float* bias,
                   const uint8_t* mask, int mask_rows, float* o, float* lse, int B, int N, int H,
                   int nk, const Rows (&s)[4], float scale, int dev, cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  const cudaError_t err = allow_smem_once<D>(dev);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (N + kRows - 1) / kRows);
  fwd_kernel<D><<<grid, kThreads, smem, stream>>>(q, k, v, bias, mask, mask_rows, o, lse, H, N,
                                                  nk, s[0], s[1], s[2], s[3], scale);
  return cudaGetLastError();
}

inline bool aligned16(const void* p) { return reinterpret_cast<unsigned long long>(p) % 16 == 0; }

// The forward's host side: checks what the kernel relies on, makes q's
// device current, launches. strides[0..11]: (b, n, h) element strides of
// q, k, v and o, each a multiple of 4 (16 bytes); the data 16-byte aligned;
// D 32, 64 or 128; 1 <= nk <= N. Returns a cudaError_t code.
inline int forward(const void* q, const void* k, const void* v, const void* bias,
                   const void* mask, int mask_rows, void* o, void* lse, int B, int N, int H,
                   int D, int nk, const long long* strides, float scale, void* stream) {
  if (B < 1 || H < 1 || N < 1 || nk < 1 || nk > N || (mask != nullptr && mask_rows < 1) ||
      !(D == 32 || D == 64 || D == 128) || !aligned16(q) || !aligned16(k) || !aligned16(v) ||
      !aligned16(o))
    return static_cast<int>(cudaErrorInvalidValue);
  Rows s[4];
  for (int t = 0; t < 4; ++t) {
    s[t] = Rows{strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
    if (s[t].b % 4 || s[t].n % 4 || s[t].h % 4) return static_cast<int>(cudaErrorInvalidValue);
  }
  const DeviceOf device(q);
  if (device.error() != cudaSuccess) return static_cast<int>(device.error());
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* bf = static_cast<const float*>(bias);
  const auto* mk = static_cast<const uint8_t*>(mask);
  auto* of = static_cast<float*>(o);
  auto* lf = static_cast<float*>(lse);
  const auto st = static_cast<cudaStream_t>(stream);
  const int dev = device.device();
  cudaError_t err;
  if (D == 32)
    err = launch<32>(qf, kf, vf, bf, mk, mask_rows, of, lf, B, N, H, nk, s, scale, dev, st);
  else if (D == 64)
    err = launch<64>(qf, kf, vf, bf, mk, mask_rows, of, lf, B, N, H, nk, s, scale, dev, st);
  else
    err = launch<128>(qf, kf, vf, bf, mk, mask_rows, of, lf, B, N, H, nk, s, scale, dev, st);
  return static_cast<int>(err);
}

}  // namespace attention_f32
