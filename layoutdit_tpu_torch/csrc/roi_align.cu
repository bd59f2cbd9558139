// Multiscale RoIAlign, forward and backward, for Hopper (sm_90a), plain C
// interface. The backward's notes are above its kernel below.
//
// Replaces layoutdit_tpu/ops/roi_align_pallas.py::_fwd_kernel (via _fwd
// and pooled_atlas_pallas). The TPU kernel contracts a level atlas
// [C, H_atlas, W_max] with level-masked separable bilinear weights
// Wy [K, P, H_atlas] and Wx [K, P, W_max]; at 1024 px that atlas alone is
// 65 MB against 227 KB of shared memory, and each weight row has at most
// two non-zeros per sample. So this kernel samples directly: one block per
// RoI, threads over (bin, channel), each output the average of the
// sampling_ratio^2 bilinear samples of the RoI's assigned level, four
// taps each, accumulated in fp32. That is the same function as the
// separable product: the weights reproduce roi_align.py's
// _bilinear_weight_matrix / build_roi_weights (samples outside
// [-1, size] give 0, coordinates clamp at 0, the top edge collapses to
// the last cell, roi sizes floor at 1, sample offsets (i % g + 0.5) / g),
// and a RoI with level -1 (masked or invalid) gives zeros.
//
// Bound on the H100: bytes. It reads the feature pixels the RoIs touch
// and writes K * P * P * C bf16; the arithmetic (16 multiply-adds per
// output) is far below the tensor-free FP32 rate. Per-sample row/column
// taps are computed once per block into shared memory; consecutive
// threads take consecutive channels, so with channels-last features
// (stride 1 over C) every tap is one coalesced 2-byte-per-thread read.
// Output layout is [K, Px, Py, C] (roi_align.py native_layout).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxSamples = 64;  // output_size * sampling_ratio per axis
constexpr int kThreads = 256;

using bf16 = __nv_bfloat16;

struct Level {
  const bf16* data;  // [B, C, H, W] with element strides below
  long long sb, sc, sy, sx;
  int h, w;
  float scale;
};

struct Levels {
  Level l[kMaxLevels];
};

struct GradLevels {
  float* data[kMaxLevels];  // fp32 [B, H_l, W_l, C] scratch per level
};

struct Taps {
  int lo[2][kMaxSamples];
  int hi[2][kMaxSamples];
  float wlo[2][kMaxSamples];
  float whi[2][kMaxSamples];
};

// Per-sample bilinear row (axis 0) and column (axis 1) taps of RoI r on
// level L, one thread per sample and axis; the caller synchronises. Plain
// rounding, no FMA contraction, to keep the coordinates of
// build_roi_weights. The forward and the backward share it, so the
// backward scatters through exactly the taps the forward gathered.
__device__ __forceinline__ void compute_taps(Taps& t, const Level& L, const float* box,
                                             int P, int G) {
  const int S = P * G;
  if (threadIdx.x >= 2 * S) return;
  const int axis = threadIdx.x >= S;
  const int i = threadIdx.x - axis * S;
  const float start = __fmul_rn(box[axis ? 0 : 1], L.scale);
  const float end = __fmul_rn(box[axis ? 2 : 3], L.scale);
  const float extent = fmaxf(__fsub_rn(end, start), 1.f);
  const float bin = __fdiv_rn(extent, static_cast<float>(P));
  const float grid = static_cast<float>(i / G) +
                     __fdiv_rn(static_cast<float>(i % G) + 0.5f, static_cast<float>(G));
  float c = __fadd_rn(start, __fmul_rn(grid, bin));
  const int size = axis ? L.w : L.h;
  const bool in_range = (c >= -1.f) && (c <= static_cast<float>(size));
  c = fmaxf(c, 0.f);
  float low = floorf(c);
  const bool top = low >= static_cast<float>(size - 1);
  low = fminf(low, static_cast<float>(size - 1));
  const float frac = top ? 0.f : __fsub_rn(c, low);
  t.lo[axis][i] = static_cast<int>(low);
  t.hi[axis][i] = top ? static_cast<int>(low) : static_cast<int>(low) + 1;
  t.wlo[axis][i] = in_range ? 1.f - frac : 0.f;
  t.whi[axis][i] = in_range ? frac : 0.f;
}

__global__ void __launch_bounds__(kThreads) roi_align_fwd_kernel(
    Levels levels, const float* __restrict__ rois, const int* __restrict__ roi_level,
    bf16* __restrict__ out, int K, int C, int P, int G) {
  __shared__ Taps taps;
  const auto& lo_s = taps.lo;
  const auto& hi_s = taps.hi;
  const auto& wlo_s = taps.wlo;
  const auto& whi_s = taps.whi;

  const int r = blockIdx.x;
  const int lvl = roi_level[r];
  const int total = P * P * C;
  bf16* o = out + static_cast<long long>(r) * total;
  if (lvl < 0) {
    for (int i = threadIdx.x; i < total; i += blockDim.x) o[i] = __float2bfloat16(0.f);
    return;
  }
  const Level L = levels.l[lvl];
  compute_taps(taps, L, rois + 4LL * r, P, G);
  __syncthreads();

  const float norm = 1.f / static_cast<float>(G * G);
  const bf16* f = L.data + static_cast<long long>(r / K) * L.sb;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int c = idx % C;
    const int bin = idx / C;
    const int px = bin / P;
    const int py = bin - px * P;
    const bf16* fc = f + c * L.sc;
    float acc = 0.f;
    for (int iy = 0; iy < G; ++iy) {
      const int sy = py * G + iy;
      const bf16* rlo = fc + lo_s[0][sy] * L.sy;
      const bf16* rhi = fc + hi_s[0][sy] * L.sy;
      const float wyl = wlo_s[0][sy];
      const float wyh = whi_s[0][sy];
      for (int ix = 0; ix < G; ++ix) {
        const int sx = px * G + ix;
        const long long xl = lo_s[1][sx] * L.sx;
        const long long xh = hi_s[1][sx] * L.sx;
        const float wxl = wlo_s[1][sx];
        const float wxh = whi_s[1][sx];
        acc += wyl * (wxl * __bfloat162float(rlo[xl]) + wxh * __bfloat162float(rlo[xh])) +
               wyh * (wxl * __bfloat162float(rhi[xl]) + wxh * __bfloat162float(rhi[xh]));
      }
    }
    o[idx] = __float2bfloat16(acc * norm);
  }
}

// Backward. Replaces layoutdit_tpu/ops/roi_align_pallas.py::_bwd_kernel
// (via _bwd): dF_l = sum over the RoIs assigned to level l of
// Wy^T . dout . Wx. The TPU kernel contracts the level atlas with the
// transposed weight matrices, W-block by W-block, into a VMEM accumulator
// that the sequential grid carries across RoI blocks; blocks on the H100
// run in no order, so this kernel mirrors the forward instead: one block
// per RoI, threads over (bin, channel), the same taps (compute_taps), and
// each bin's gradient, times its bilinear weight and 1/G^2, added into the
// level's fp32 channels-last scratch [B, H_l, W_l, C] with atomicAdd
// (consecutive threads take consecutive channels, so each tap's atomics
// are one coalesced 4-byte-per-thread burst). The wrapper zeroes the
// scratch and casts it once to the features' dtype and layout. RoIs with
// level -1 (masked or invalid) add nothing. Taps with zero weight are
// skipped.
//
// Determinism: fp32 atomics commit in an order that changes from run to
// run, so the fp32 sums differ between runs in their last bits, and an
// element whose sum lies near a bf16 rounding boundary can round to the
// neighbouring bf16 value (one bf16 ulp). The on-card check against the
// plain version allows a few bf16 roundings; a deterministic form (sorted
// segments or a gather over RoIs per pixel) is later work.
//
// Bound on the H100: bytes. It reads dout (R * P * P * C bf16, 205 MB at
// B=16, K=512, C=256) and writes dF (the pyramid, 34 MB in bf16); its
// 16 fp32 atomic adds per dout element (1.6 G at that shape) are what it
// actually waits on.
__global__ void __launch_bounds__(kThreads) roi_align_bwd_kernel(
    Levels levels, GradLevels grads, const float* __restrict__ rois,
    const int* __restrict__ roi_level, const bf16* __restrict__ dout, int K, int C, int P,
    int G) {
  __shared__ Taps taps;
  const int r = blockIdx.x;
  const int lvl = roi_level[r];
  if (lvl < 0) return;
  const Level L = levels.l[lvl];
  compute_taps(taps, L, rois + 4LL * r, P, G);
  __syncthreads();

  const int total = P * P * C;
  const float norm = 1.f / static_cast<float>(G * G);
  const bf16* g = dout + static_cast<long long>(r) * total;
  float* df = grads.data[lvl] + static_cast<long long>(r / K) * L.h * L.w * C;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int c = idx % C;
    const int bin = idx / C;
    const int px = bin / P;
    const int py = bin - px * P;
    const float gv = __bfloat162float(g[idx]) * norm;
    if (gv == 0.f) continue;
    for (int iy = 0; iy < G; ++iy) {
      const int sy = py * G + iy;
      const int ys[2] = {taps.lo[0][sy], taps.hi[0][sy]};
      const float wy[2] = {taps.wlo[0][sy], taps.whi[0][sy]};
      for (int ix = 0; ix < G; ++ix) {
        const int sx = px * G + ix;
        const int xs[2] = {taps.lo[1][sx], taps.hi[1][sx]};
        const float wx[2] = {taps.wlo[1][sx], taps.whi[1][sx]};
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          if (wy[a] == 0.f) continue;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (wx[e] == 0.f) continue;
            atomicAdd(df + (static_cast<long long>(ys[a]) * L.w + xs[e]) * C + c,
                      gv * wy[a] * wx[e]);
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// level_ptrs[l]: bf16 [B, C, H_l, W_l] feature maps; level_strides[4l..4l+3]:
// their (b, c, y, x) element strides; level_hw[2l..2l+1]: (H_l, W_l);
// level_scales[l]: spatial scale. rois: fp32 [R, 4] (R = B * K, image b =
// r / K); roi_level: int32 [R], -1 = zeros; out: bf16 [R, P, P, C] in
// (px, py, c) order. Returns a cudaError_t code.
int roi_align_fwd(const void* const* level_ptrs, const long long* level_strides,
                  const int* level_hw, const float* level_scales, int num_levels,
                  const void* rois, const void* roi_level, void* out, int R, int K, int C,
                  int P, int G, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || R < 0 || K < 1 || C < 1 || P < 1 ||
      G < 1 || P * G > kMaxSamples)
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return 0;
  Levels levels{};
  for (int l = 0; l < num_levels; ++l) {
    levels.l[l].data = static_cast<const bf16*>(level_ptrs[l]);
    levels.l[l].sb = level_strides[4 * l + 0];
    levels.l[l].sc = level_strides[4 * l + 1];
    levels.l[l].sy = level_strides[4 * l + 2];
    levels.l[l].sx = level_strides[4 * l + 3];
    levels.l[l].h = level_hw[2 * l + 0];
    levels.l[l].w = level_hw[2 * l + 1];
    levels.l[l].scale = level_scales[l];
  }
  roi_align_fwd_kernel<<<R, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      levels, static_cast<const float*>(rois), static_cast<const int*>(roi_level),
      static_cast<bf16*>(out), K, C, P, G);
  return static_cast<int>(cudaGetLastError());
}

// The forward's geometry (level_hw, level_scales) and RoIs; dout: bf16
// [R, P, P, C] in (px, py, c) order, contiguous; grad_ptrs[l]: zeroed fp32
// [B, H_l, W_l, C] scratch, contiguous, to which the kernel adds dF.
// Returns a cudaError_t code.
int roi_align_bwd(void* const* grad_ptrs, const int* level_hw, const float* level_scales,
                  int num_levels, const void* rois, const void* roi_level, const void* dout,
                  int R, int K, int C, int P, int G, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || R < 0 || K < 1 || C < 1 || P < 1 ||
      G < 1 || P * G > kMaxSamples)
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return 0;
  Levels levels{};
  GradLevels grads{};
  for (int l = 0; l < num_levels; ++l) {
    levels.l[l].h = level_hw[2 * l + 0];
    levels.l[l].w = level_hw[2 * l + 1];
    levels.l[l].scale = level_scales[l];
    grads.data[l] = static_cast<float*>(grad_ptrs[l]);
  }
  roi_align_bwd_kernel<<<R, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      levels, grads, static_cast<const float*>(rois), static_cast<const int*>(roi_level),
      static_cast<const bf16*>(dout), K, C, P, G);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
