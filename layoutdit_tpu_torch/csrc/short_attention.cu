// Short-sequence attention, forward and backward, for Hopper (sm_90a),
// plain C interface. The backward's notes are above its kernel below.
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

// Backward. Replaces layoutdit_tpu/ops/short_attention.py::_bwd_kernel (via
// _short_bwd): from the residuals q, k, v, o and the output gradient dO it
// recomputes P = softmax(Q K^T * scale) and emits
//   dV = P^T dO,  dS = P o (dO V^T - rowsum(dO o O)),
//   dQ = dS K * scale,  dK = dS^T Q * scale,
// with every product accumulated in fp32 and no N x N tensor in device
// memory.
//
// Bound on the H100: bytes (8 tensors of B*N*H*D bf16 cross device memory,
// against ~10*N^2*D FLOPs per head). One block per (b, h) stages Q, K, V
// and dO in shared memory (4 x N x (D+2) bf16, 104 KB at N=197, D=64; rows
// padded by two elements so lanes reading different rows hit different
// banks) and runs two phases without atomics or fp32 accumulators in
// shared memory:
//   A. one warp per query row i: scores s_i. and dP_i. = dO_i V^T into
//      per-warp buffers, the row's softmax, delta_i = rowsum(dO_i o O_i),
//      dS_i., then dQ_i; lse_i and delta_i stay in shared memory;
//   B. one warp per key row j: P_.j = exp(s_.j - lse) and dS_.j again from
//      the staged rows, then dV_j = sum_i P_ij dO_i and
//      dK_j = scale * sum_i dS_ij Q_i.
// The scores are computed twice (tiny next to the bytes); each gradient row
// is written once, as bf16, straight into the fused [B, N, 3*H*D] gradient
// of the QKV projection through the strides given for dq, dk and dv.
constexpr int kBwdWarps = 16;

__device__ __forceinline__ float dot_row(const float* __restrict__ x,
                                         const __nv_bfloat16* __restrict__ row, int D) {
  const __nv_bfloat162* r2 = reinterpret_cast<const __nv_bfloat162*>(row);
  float s = 0.f;
  for (int d2 = 0; d2 < D / 2; ++d2) {
    const float2 v = __bfloat1622float2(r2[d2]);
    s = fmaf(x[2 * d2], v.x, s);
    s = fmaf(x[2 * d2 + 1], v.y, s);
  }
  return s;
}

__global__ void __launch_bounds__(kBwdWarps * 32) short_attention_bwd_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ o,
    const __nv_bfloat16* __restrict__ dout, __nv_bfloat16* __restrict__ dq,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int H, int N, int D,
    Strides qs, Strides ks, Strides vs, Strides os, Strides dos, Strides dqs,
    Strides dks, Strides dvs, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int st = D + 2;  // padded row
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* k_s = q_s + N * st;
  __nv_bfloat16* v_s = k_s + N * st;
  __nv_bfloat16* do_s = v_s + N * st;
  float* lse_s = reinterpret_cast<float*>(do_s + N * st);  // [N]
  float* delta_s = lse_s + N;                              // [N]
  float* warp_s = delta_s + N;  // per warp: x0[D], x1[D], b0[N], b1[N]

  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + h * vs.h;
  const __nv_bfloat16* dob = dout + b * dos.b + h * dos.h;
  for (int idx = threadIdx.x; idx < N * D; idx += blockDim.x) {
    const int j = idx / D;
    const int d = idx - j * D;
    q_s[j * st + d] = qb[j * qs.n + d];
    k_s[j * st + d] = kb[j * ks.n + d];
    v_s[j * st + d] = vb[j * vs.n + d];
    do_s[j * st + d] = dob[j * dos.n + d];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* x0 = warp_s + warp * (2 * D + 2 * N);
  float* x1 = x0 + D;
  float* b0 = x1 + D;
  float* b1 = b0 + N;

  // phase A: dQ, lse and delta per query row
  for (int i = warp; i < N; i += kBwdWarps) {
    const __nv_bfloat16* orow = o + b * os.b + i * os.n + h * os.h;
    float dl = 0.f;
    for (int d = lane; d < D; d += 32) {
      x0[d] = __bfloat162float(q_s[i * st + d]);
      const float g = __bfloat162float(do_s[i * st + d]);
      x1[d] = g;
      dl = fmaf(g, __bfloat162float(orow[d]), dl);
    }
    dl = warp_sum(dl);
    __syncwarp();
    float m = -1e30f;
    for (int j = lane; j < N; j += 32) {
      const float s = dot_row(x0, k_s + j * st, D) * scale;
      b0[j] = s;
      b1[j] = dot_row(x1, v_s + j * st, D);
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < N; j += 32) l += expf(b0[j] - m);
    l = warp_sum(l);
    const float inv = 1.f / l;
    for (int j = lane; j < N; j += 32) {
      const float p = expf(b0[j] - m) * inv;
      b0[j] = p * (b1[j] - dl);  // dS_ij
    }
    if (lane == 0) {
      lse_s[i] = m + logf(l);
      delta_s[i] = dl;
    }
    __syncwarp();
    __nv_bfloat16* dqrow = dq + b * dqs.b + i * dqs.n + h * dqs.h;
    for (int d = lane; d < D; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < N; ++j) acc = fmaf(b0[j], __bfloat162float(k_s[j * st + d]), acc);
      dqrow[d] = __float2bfloat16(acc * scale);
    }
    __syncwarp();
  }
  __syncthreads();

  // phase B: dK and dV per key row
  for (int j = warp; j < N; j += kBwdWarps) {
    for (int d = lane; d < D; d += 32) {
      x0[d] = __bfloat162float(k_s[j * st + d]);
      x1[d] = __bfloat162float(v_s[j * st + d]);
    }
    __syncwarp();
    for (int i = lane; i < N; i += 32) {
      const float p = expf(dot_row(x0, q_s + i * st, D) * scale - lse_s[i]);
      b0[i] = p;
      b1[i] = p * (dot_row(x1, do_s + i * st, D) - delta_s[i]);  // dS_ij
    }
    __syncwarp();
    __nv_bfloat16* dvrow = dv + b * dvs.b + j * dvs.n + h * dvs.h;
    __nv_bfloat16* dkrow = dk + b * dks.b + j * dks.n + h * dks.h;
    for (int d = lane; d < D; d += 32) {
      float av = 0.f, ak = 0.f;
      for (int i = 0; i < N; ++i) {
        av = fmaf(b0[i], __bfloat162float(do_s[i * st + d]), av);
        ak = fmaf(b1[i], __bfloat162float(q_s[i * st + d]), ak);
      }
      dvrow[d] = __float2bfloat16(av);
      dkrow[d] = __float2bfloat16(ak * scale);
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Shared memory the backward needs for (N, D); the wrapper checks it
// against the card's limit before launching.
long long short_attention_bwd_smem(int N, int D) {
  return 4LL * N * (D + 2) * 2 + 2LL * N * 4 + static_cast<long long>(kBwdWarps) * (2 * D + 2 * N) * 4;
}

// q, k, v, o, dout: bf16 [B, N, H, D] with the given element strides (last
// dim contiguous); dq, dk, dv: bf16 [B, N, H, D] outputs, likewise strided
// (the wrapper points them into one fused [B, N, 3*H*D] gradient). Returns
// a cudaError_t code.
int short_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, void* dq, void* dk, void* dv,
                        int B, int N, int H, int D, const long long* strides,
                        float scale, void* stream) {
  if (B < 1 || H < 1 || N < 1 || N > kMaxN || D < 2 || D > kMaxD || (D & 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(short_attention_bwd_smem(N, D));
  cudaError_t err = cudaFuncSetAttribute(
      short_attention_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  Strides s[8];
  for (int t = 0; t < 8; ++t) s[t] = Strides{strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
  short_attention_bwd_kernel<<<B * H, kBwdWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), static_cast<__nv_bfloat16*>(dq),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), H, N, D, s[0], s[1],
      s[2], s[3], s[4], s[5], s[6], s[7], scale);
  return static_cast<int>(cudaGetLastError());
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
