// Multiscale RoIAlign forward for Hopper (sm_90a), plain C interface.
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

__global__ void __launch_bounds__(kThreads) roi_align_fwd_kernel(
    Levels levels, const float* __restrict__ rois, const int* __restrict__ roi_level,
    bf16* __restrict__ out, int K, int C, int P, int G) {
  __shared__ int lo_s[2][kMaxSamples];
  __shared__ int hi_s[2][kMaxSamples];
  __shared__ float wlo_s[2][kMaxSamples];
  __shared__ float whi_s[2][kMaxSamples];

  const int r = blockIdx.x;
  const int lvl = roi_level[r];
  const int total = P * P * C;
  bf16* o = out + static_cast<long long>(r) * total;
  if (lvl < 0) {
    for (int i = threadIdx.x; i < total; i += blockDim.x) o[i] = __float2bfloat16(0.f);
    return;
  }
  const Level L = levels.l[lvl];
  const int S = P * G;

  if (threadIdx.x < 2 * S) {
    // axis 0 = y (rows), axis 1 = x (columns); plain rounding, no FMA
    // contraction, to keep the coordinates of build_roi_weights
    const int axis = threadIdx.x >= S;
    const int i = threadIdx.x - axis * S;
    const float* box = rois + 4LL * r;
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
    lo_s[axis][i] = static_cast<int>(low);
    hi_s[axis][i] = top ? static_cast<int>(low) : static_cast<int>(low) + 1;
    wlo_s[axis][i] = in_range ? 1.f - frac : 0.f;
    whi_s[axis][i] = in_range ? frac : 0.f;
  }
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

}  // extern "C"
