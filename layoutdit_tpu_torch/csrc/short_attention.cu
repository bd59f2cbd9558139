// Short-sequence attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces layoutdit_tpu/ops/short_attention.py::_fwd_kernel (via
// _short_fwd): softmax(Q K^T * scale) V for one head whose whole sequence
// fits one tile (N <= 256; the 224 px bucket has N = 197, D = 64).
//
// Bound on the H100: bytes. At B=4, H=12, N=197, D=64 the function reads
// 3.6 MB and writes 1.2 MB, while its 0.48 GFLOP are tiny, so it should take
// microseconds; the cost is launch and latency. The design stages the
// head's K and V once in shared memory (<= 2 x 33 KB), reads Q/K/V straight
// from the [B, N, H, D] strides of the fused QKV projection (no transpose
// copies), and keeps every score in shared memory: one warp per query
// row, scores in fp32, a single-pass softmax (the row fits, so no running
// max), then P V. K rows are padded by two elements so lanes reading
// different keys hit different banks. Output is bf16 [B, N, H, D].

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kRowsPerBlock = 64;
constexpr int kWarps = 8;
constexpr int kMaxN = 256;
constexpr int kMaxD = 128;

struct Strides {
  long long b, n, h;
};

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kWarps * 32) short_attention_fwd_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    int H, int N, int D, Strides qs, Strides ks, Strides vs, Strides os,
    float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int kst = D + 2;  // padded K row: conflict-free column reads
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* v_s = k_s + N * kst;
  float* q_s = reinterpret_cast<float*>(v_s + N * D);  // [kWarps][D]
  float* p_s = q_s + kWarps * D;                        // [kWarps][N]

  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const __nv_bfloat16* kb = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + h * vs.h;
  for (int idx = threadIdx.x; idx < N * D; idx += blockDim.x) {
    const int j = idx / D;
    const int d = idx - j * D;
    k_s[j * kst + d] = kb[j * ks.n + d];
    v_s[j * D + d] = vb[j * vs.n + d];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* qw = q_s + warp * D;
  float* pw = p_s + warp * N;
  const int row_end = min(N, (int)(blockIdx.y + 1) * kRowsPerBlock);
  for (int r = blockIdx.y * kRowsPerBlock + warp; r < row_end; r += kWarps) {
    const __nv_bfloat16* qr = q + b * qs.b + r * qs.n + h * qs.h;
    for (int d = lane; d < D; d += 32) qw[d] = __bfloat162float(qr[d]);
    __syncwarp();

    float m = -1e30f;
    for (int j = lane; j < N; j += 32) {
      const __nv_bfloat162* kr = reinterpret_cast<const __nv_bfloat162*>(k_s + j * kst);
      float s = 0.f;
      for (int d2 = 0; d2 < D / 2; ++d2) {
        const float2 kv = __bfloat1622float2(kr[d2]);
        s = fmaf(qw[2 * d2], kv.x, s);
        s = fmaf(qw[2 * d2 + 1], kv.y, s);
      }
      s *= scale;
      pw[j] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < N; j += 32) {
      const float p = expf(pw[j] - m);
      pw[j] = p;
      l += p;
    }
    l = warp_sum(l);
    __syncwarp();

    const float inv = 1.f / l;
    __nv_bfloat16* orow = o + b * os.b + r * os.n + h * os.h;
    for (int d = lane; d < D; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < N; ++j) acc = fmaf(pw[j], __bfloat162float(v_s[j * D + d]), acc);
      orow[d] = __float2bfloat16(acc * inv);
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q, k, v: bf16 [B, N, H, D] with the given element strides (last dim
// contiguous); o: bf16 [B, N, H, D]. Returns a cudaError_t code.
int short_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int B, int N, int H, int D,
                        long long q_sb, long long q_sn, long long q_sh,
                        long long k_sb, long long k_sn, long long k_sh,
                        long long v_sb, long long v_sn, long long v_sh,
                        long long o_sb, long long o_sn, long long o_sh,
                        float scale, void* stream) {
  if (B < 1 || H < 1 || N < 1 || N > kMaxN || D < 2 || D > kMaxD || (D & 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(N) * (D + 2) * 2 + static_cast<size_t>(N) * D * 2 +
                      static_cast<size_t>(kWarps) * D * 4 + static_cast<size_t>(kWarps) * N * 4;
  cudaError_t err = cudaFuncSetAttribute(
      short_attention_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (N + kRowsPerBlock - 1) / kRowsPerBlock);
  short_attention_fwd_kernel<<<grid, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), H, N, D,
      Strides{q_sb, q_sn, q_sh}, Strides{k_sb, k_sn, k_sh}, Strides{v_sb, v_sn, v_sh},
      Strides{o_sb, o_sn, o_sh}, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
