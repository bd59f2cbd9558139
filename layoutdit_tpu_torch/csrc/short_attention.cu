// Short-sequence attention, forward and backward, for Hopper (sm_90a),
// plain C interface, on the tensor cores. The backward's notes are above
// its kernel below; the products and tile helpers are in attention_mma.cuh,
// shared with the flash kernels.
//
// Forward. Replaces layoutdit_tpu/ops/short_attention.py::_fwd_kernel (via
// _short_fwd): softmax(Q K^T * scale) V for one head whose whole sequence
// fits on the chip (N <= 256). The paths run it at D = 64 with N = 197 (224
// px), 256 (16 x 16 windows) and 1 (the CLS token of a windowed layer).
//
// Bound on the H100: bytes, barely. At B=64, H=12, N=256, D=64 the function
// moves 100 MB (Q, K, V in, O out: 0.030 ms at 3.35 TB/s) and does 12.9
// GFLOP (0.013 ms at the bf16 peak), so it needs the tensor cores at a third
// of their peak to reach the bytes. The design:
//   - A block owns 128 query rows of one head (8 warps x 16 rows) and stages
//     the head's whole K and V once in shared memory (N rounded up to 16
//     rows, pitch D + 8: 74 KB at N = 256, D = 64) with cp.async, 16 bytes a
//     thread, one commit group per 64-key chunk, so the first chunk's
//     products start while the others land. The blocks of one head are
//     adjacent in the grid and read K and V from L2 after the first. (64
//     rows a block re-read K and V twice as often and were slower at N =
//     256; 256 rows, one block a head, were slower at both shapes.)
//   - Each warp holds its Q fragments (loaded straight from device memory
//     in mma.sync's A layout), a 16 x 64 fp32 score tile and its 16 x D
//     fp32 output accumulator in registers. S = Q K^T and O += P V run on
//     mma.sync m16n8k16 (bf16 in, fp32 accumulate; K and V through
//     ldmatrix), and P is the score accumulators rounded to bf16 as the A
//     operand, as in the flash forward. The softmax is the online one over
//     at most four 64-key chunks of the resident K/V (a single pass over a
//     16 x 256 fp32 row block would take 128 registers a thread for the
//     scores alone), in the exp2 domain, with few instructions beside the
//     products: the scale folded into one FFMA per score, ex2.approx, the
//     mask only in the chunk that crosses N.
//   - The ragged edge is masked in the kernel: K/V rows past N are
//     zero-filled in shared memory and their scores set to -1e30, the TPU
//     kernel's finite NEG_INF; the products skip the 16-key steps past the
//     last one holding a key; query rows past N are zero and not written.
//   - Q, K, V are read through the [B, N, H, D] strides of the fused QKV
//     projection, O is written in that layout. D is a template parameter:
//     32, 64 and 128 are compiled.
//   - An optional key mask, uint8 [mask_rows, N] (row b % mask_rows for
//     batch b, as the JAX encoder tiles its window mask over the pages),
//     drops the keys it holds 0 for from every softmax row: the padded
//     slots of windows that do not divide the patch grid, and the padded
//     tokens of pad_tokens_to (the Pallas _probs masks only keys past
//     n_valid, the ragged edge). It is a second instantiation
//     (Masked = true), so the unmasked kernels are unchanged: the head's
//     row of the mask is staged in shared memory (zero past N, so it
//     covers the ragged edge too) and every 64-key chunk is masked by it,
//     to -inf rather than the finite -1e30: the running max then starts at
//     -1e30 and stays there through a chunk with no real key, which adds
//     exactly 0, wherever it lies. A masked key has P = 0 exactly. Every
//     row must keep one real key (a window always does: its padding is
//     narrower than the window); it is not checked.
// Occupancy (ptxas, D = 64): 125 registers, no spill; two blocks (16 warps)
// an SM, bound by registers (74 KB of shared memory at N = 256, 60 KB at
// 197). Not done yet: wgmma, TMA, warp specialisation.

#include <math_constants.h>

#include "attention_mma.cuh"

namespace {

constexpr int kMaxN = 256;
constexpr int kFwdWarps = 8;
constexpr int kFwdThreads = kFwdWarps * 32;
constexpr int kFwdRows = kFwdWarps * 16;
constexpr int kBwdWarps = 4;
constexpr int kBwdThreads = kBwdWarps * 32;

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  // src-size 0 fills the 16 bytes with zeros and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `pending` (0-3) of this thread's commit groups are in
// flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// 2^x in one MUFU instruction (exp2f adds a denormal range fix); 0 for the
// -1e30-scaled scores of masked keys
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// rows [r0, r0 + rows) of a strided [N, D] slice -> rows [r0, r0 + rows)
// of a shared memory buffer (pitch D + 8) with cp.async, zero rows >= n;
// Threads threads of the block take part
template <int D, int Threads>
__device__ __forceinline__ void stage_rows(bf16* buf, const bf16* src, long long stride_n,
                                           int r0, int rows, int n) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < rows * kChunks; i += Threads) {
    const int rr = r0 + i / kChunks;
    const int cc = i % kChunks;
    const bool valid = rr < n;
    cp_async16(buf + rr * (D + 8) + cc * 8, src + (valid ? rr * stride_n : 0) + cc * 8, valid);
  }
}

// A fragments of rows [r0, r0 + 16) of a strided [N, D] slice, read straight
// from device memory (zero rows >= n): lane l holds rows r0 + l/4 and
// r0 + l/4 + 8 at columns 2 (l % 4) and 2 (l % 4) + 8 of each 16 columns
template <int D>
__device__ __forceinline__ void load_a_frags_global(uint32_t (&f)[D / 16][4], const bf16* src,
                                                    long long stride_n, int r0, int n,
                                                    int lane) {
  const int ra = r0 + (lane >> 2);
  const int rb = ra + 8;
  const uint32_t* pa = reinterpret_cast<const uint32_t*>(src + ra * stride_n + 2 * (lane & 3));
  const uint32_t* pb = reinterpret_cast<const uint32_t*>(src + rb * stride_n + 2 * (lane & 3));
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    f[kk][0] = ra < n ? pa[kk * 8] : 0u;
    f[kk][1] = rb < n ? pb[kk * 8] : 0u;
    f[kk][2] = ra < n ? pa[kk * 8 + 4] : 0u;
    f[kk][3] = rb < n ? pb[kk * 8 + 4] : 0u;
  }
}

// scores of keys >= n in a 64-key chunk from kv0 (score-accumulator
// layout) -> -1e30, the TPU kernel's finite NEG_INF
__device__ __forceinline__ void mask_keys(float (&s)[kChunk / 8][4], int kv0, int n, int quad) {
#pragma unroll
  for (int j = 0; j < kChunk / 8; ++j) {
    const int key = kv0 + j * 8 + 2 * quad;
    if (key >= n) s[j][0] = s[j][2] = kNegInf;
    if (key + 1 >= n) s[j][1] = s[j][3] = kNegInf;
  }
}

// scores of the keys that keep (a staged mask row, 0 past N) holds 0 for
// in a 64-key chunk from kv0 -> -inf
__device__ __forceinline__ void mask_keys_by(float (&s)[kChunk / 8][4], const uint8_t* keep,
                                             int kv0, int quad) {
#pragma unroll
  for (int j = 0; j < kChunk / 8; ++j) {
    const int key = kv0 + j * 8 + 2 * quad;
    if (!keep[key]) s[j][0] = s[j][2] = -CUDART_INF_F;
    if (!keep[key + 1]) s[j][1] = s[j][3] = -CUDART_INF_F;
  }
}

// row b % mask_rows of a uint8 [mask_rows, N] key mask -> keep[0, kMaxN),
// zero past N; Threads threads of the block take part
template <int Threads>
__device__ __forceinline__ void stage_keep(uint8_t* keep, const uint8_t* mask, int mask_rows,
                                           int b, int N) {
  const uint8_t* row = mask + static_cast<long long>(b % mask_rows) * N;
  for (int i = threadIdx.x; i < kMaxN; i += Threads) keep[i] = i < N ? row[i] : 0;
}

template <int D, bool Masked>
__global__ void __launch_bounds__(kFwdThreads) short_attention_fwd_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, const uint8_t* __restrict__ mask, int mask_rows, int H, int N,
    Strides qs, Strides ks, Strides vs, Strides os, float scale) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n16 = (N + 15) & ~15;
  bf16* k_s = reinterpret_cast<bf16*>(smem);
  bf16* v_s = k_s + n16 * LD;
  uint8_t* keep_s = reinterpret_cast<uint8_t*>(v_s + n16 * LD);  // Masked only

  // the blocks of one head are adjacent: they share K and V through L2
  const int tiles = (N + kFwdRows - 1) / kFwdRows;
  const int bh = blockIdx.x / tiles;
  const int q0 = (blockIdx.x - bh * tiles) * kFwdRows;
  const int b = bh / H;
  const int h = bh - b * H;
  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h;

  // K and V of the head, one commit group per 64-key chunk; always four
  // groups (empty ones complete at once), so chunk c waits for 3 - c
  const int chunks = (N + kChunk - 1) / kChunk;
  for (int c = 0; c < kMaxN / kChunk; ++c) {
    if (c < chunks) {
      const int rows = min(kChunk, n16 - c * kChunk);
      stage_rows<D, kFwdThreads>(k_s, kb, ks.n, c * kChunk, rows, N);
      stage_rows<D, kFwdThreads>(v_s, vb, vs.n, c * kChunk, rows, N);
    }
    cp_async_commit();
  }
  if constexpr (Masked) stage_keep<kFwdThreads>(keep_s, mask, mask_rows, b, N);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int quad = lane & 3;
  const int t0 = q0 + warp * 16;  // this warp's first query row
  const int row0 = t0 + (lane >> 2);
  const bool active = t0 < N;
  const float scale2 = scale * kLog2e;

  uint32_t qf[D / 16][4];
  load_a_frags_global<D>(qf, q + b * qs.b + h * qs.h, qs.n, t0, N, lane);
  float acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  for (int c = 0; c < chunks; ++c) {
    cp_async_wait(kMaxN / kChunk - 1 - c);
    __syncthreads();  // chunk c of K and V has landed, from every thread
    if (!active) continue;
    const int kv0 = c * kChunk;
    const int rows = min(kChunk, n16 - kv0);

    float s[kChunk / 8][4];
    mma_abt<D>(s, qf, k_s + kv0 * LD, lane, rows);  // S = Q K^T
    // mask the ragged edge (the last chunk only) or, Masked, every chunk
    // by the mask; online softmax in the exp2 domain with the scale folded
    // into one FFMA (scale > 0, so the raw scores' max is the scaled
    // scores' max)
    if constexpr (Masked) {
      mask_keys_by(s, keep_s, kv0, quad);
    } else if (kv0 + kChunk > N) {
      mask_keys(s, kv0, N, quad);
    }
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < kChunk / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0) * scale2);
    const float mn1 = fmaxf(m1, quad_max(mx1) * scale2);
    const float corr0 = ex2(m0 - mn0);
    const float corr1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < kChunk / 8; ++j) {
      s[j][0] = ex2(fmaf(s[j][0], scale2, -m0));
      s[j][1] = ex2(fmaf(s[j][1], scale2, -m0));
      s[j][2] = ex2(fmaf(s[j][2], scale2, -m1));
      s[j][3] = ex2(fmaf(s[j][3], scale2, -m1));
      ps0 += s[j][0] + s[j][1];
      ps1 += s[j][2] + s[j][3];
    }
    l0 = l0 * corr0 + ps0;  // per-lane partial; reduced over the quad at the end
    l1 = l1 * corr1 + ps1;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      acc[nt][0] *= corr0;
      acc[nt][1] *= corr0;
      acc[nt][2] *= corr1;
      acc[nt][3] *= corr1;
    }
    mma_xt<D>(acc, s, v_s + kv0 * LD, lane, rows);  // O += P V
  }
  if (!active) return;

  const float inv0 = 1.f / fmaxf(quad_sum(l0), 1e-30f);
  const float inv1 = 1.f / fmaxf(quad_sum(l1), 1e-30f);
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    acc[nt][0] *= inv0;
    acc[nt][1] *= inv0;
    acc[nt][2] *= inv1;
    acc[nt][3] *= inv1;
  }
  store_rows<D>(o + b * os.b + h * os.h, os.n, acc, row0, N, quad, 1.f);
}

// Backward. Replaces layoutdit_tpu/ops/short_attention.py::_bwd_kernel (via
// _short_bwd): from the residuals q, k, v, o and the output gradient dO it
// recomputes P = softmax(Q K^T * scale) and emits
//   dV = P^T dO,  dS = P o (dO V^T - rowsum(dO o O)),
//   dQ = dS K * scale,  dK = dS^T Q * scale,
// with every product on the tensor cores and no N x N tensor in device
// memory.
//
// Bound on the H100: bytes, barely. At B=64, N=256, H=12, D=64 it moves 8
// tensors of B*N*H*D bf16 (201 MB: 0.060 ms at 3.35 TB/s) and does 8
// products of 2*N^2*D a head (51.5 GFLOP: 0.052 ms at the bf16 peak). The
// design: one block per (b, h), 4 warps, two phases, every gradient row
// summed in one block and written once as bf16: no atomics, the same bits
// every run.
//   Staged once with cp.async (N rounded up to 16 rows, pitch D + 8, rows
//   past N zero): K, V and Q of the head, 3 x 37 KB at N = 256, D = 64
//   (plus 2 KB of lse and delta), so two blocks fit an SM; 208 KB at D = 128.
//   A. per 16-row query tile (a warp each, in turn): Q fragments by
//      ldmatrix, dO fragments straight from device memory, delta =
//      rowsum(dO o O) from O and dO rows; a first sweep of the 64-key
//      chunks forms S = Q K^T for the row's max and sum (lse), a second
//      forms S and dP = dO V^T again, dS = P o (dP - delta), and
//      dQ += dS K. lse and delta go to shared memory.
//   Then dO is staged where V was.
//   B. per 16-row key tile: K fragments by ldmatrix, V fragments from
//      device memory; per 64-query chunk S^T = K Q^T and dP^T = V dO^T,
//      P^T = exp(S^T - lse) and dS^T, dV += P^T dO and dK += dS^T Q.
// P and dS are rounded to bf16 as A operands, as in the flash backward;
// the accumulators are fp32 registers. The ragged edge: keys past N get
// P = 0, query rows past N are zero (dO too, so dS = 0) and masked in B.
// Masked: the keys the mask drops get P = 0 in both phases (scores -inf
// in A, the key rows' P^T and dS^T zeroed in B), so their dK and dV rows
// are 0; the queries the mask drops are real rows in both.
// Q, K, V, O and dO are read through their [B, N, H, D] strides and dq,
// dk, dv written through the strides given (the slices of one fused
// [B, N, 3*H*D] gradient). The lse costs an eighth product (the TPU
// kernel's single-pass softmax keeps the whole [Np, Np] tile in VMEM);
// taking it from the forward would change the forward's interface.
// Occupancy (ptxas, D = 64): 224 registers, no spill, and 113 KB of shared
// memory at N = 256: two blocks (8 warps) an SM. D = 128 keeps twice the
// fragments and accumulators in phase B and spills (255 registers, a
// 152-byte stack). Not done yet: wgmma, TMA, warp specialisation, the
// forward's lse (saves the eighth product), a head split over blocks (at
// B=16, N=197 the 192 blocks run in one wave, each one head's whole
// backward).
template <int D, bool Masked>
__global__ void __launch_bounds__(kBwdThreads) short_attention_bwd_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ o, const bf16* __restrict__ dout, bf16* __restrict__ dq,
    bf16* __restrict__ dk, bf16* __restrict__ dv, const uint8_t* __restrict__ mask,
    int mask_rows, int H, int N, Strides qs, Strides ks, Strides vs, Strides os, Strides dos,
    Strides dqs, Strides dks, Strides dvs, float scale) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n16 = (N + 15) & ~15;
  bf16* k_s = reinterpret_cast<bf16*>(smem);
  bf16* v_s = k_s + n16 * LD;  // V in phase A, dO in phase B
  bf16* q_s = v_s + n16 * LD;
  // lse (exp2 domain) and delta per query row; kMaxN entries, zero past N,
  // so a 64-query chunk never indexes past them nor reads garbage
  float* lse_s = reinterpret_cast<float*>(q_s + n16 * LD);
  float* dl_s = lse_s + kMaxN;
  uint8_t* keep_s = reinterpret_cast<uint8_t*>(dl_s + kMaxN);  // Masked only

  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h;
  const bf16* ob = o + b * os.b + h * os.h;
  const bf16* dob = dout + b * dos.b + h * dos.h;
  stage_rows<D, kBwdThreads>(k_s, kb, ks.n, 0, n16, N);
  stage_rows<D, kBwdThreads>(v_s, vb, vs.n, 0, n16, N);
  stage_rows<D, kBwdThreads>(q_s, qb, qs.n, 0, n16, N);
  cp_async_commit();
  for (int i = threadIdx.x; i < 2 * kMaxN; i += kBwdThreads) lse_s[i] = 0.f;
  if constexpr (Masked) stage_keep<kBwdThreads>(keep_s, mask, mask_rows, b, N);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int quad = lane & 3;
  const int tiles = n16 / 16;
  const float scale2 = scale * kLog2e;
  cp_async_wait(0);
  __syncthreads();

  // phase A: lse, delta and dQ per 16-row query tile
  for (int t = warp; t < tiles; t += kBwdWarps) {
    const int row0 = t * 16 + (lane >> 2);
    const int row1 = row0 + 8;
    uint32_t qf[D / 16][4], df[D / 16][4];
    load_a_frags<D>(qf, q_s, t, lane);
    load_a_frags_global<D>(df, dob, dos.n, t * 16, N, lane);
    const float dl0 = quad_row_dot<D>(ob + row0 * os.n, dob + row0 * dos.n, row0 < N, quad);
    const float dl1 = quad_row_dot<D>(ob + row1 * os.n, dob + row1 * dos.n, row1 < N, quad);

    // the row's max and sum over every key
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
    for (int kv0 = 0; kv0 < n16; kv0 += kChunk) {
      const int rows = min(kChunk, n16 - kv0);
      float s[kChunk / 8][4];
      mma_abt<D>(s, qf, k_s + kv0 * LD, lane, rows);
      if constexpr (Masked) {
        mask_keys_by(s, keep_s, kv0, quad);
      } else if (kv0 + kChunk > N) {
        mask_keys(s, kv0, N, quad);
      }
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int j = 0; j < kChunk / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
        mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
      }
      const float mn0 = fmaxf(m0, quad_max(mx0) * scale2);
      const float mn1 = fmaxf(m1, quad_max(mx1) * scale2);
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int j = 0; j < kChunk / 8; ++j) {
        ps0 += ex2(fmaf(s[j][0], scale2, -mn0)) + ex2(fmaf(s[j][1], scale2, -mn0));
        ps1 += ex2(fmaf(s[j][2], scale2, -mn1)) + ex2(fmaf(s[j][3], scale2, -mn1));
      }
      l0 = l0 * ex2(m0 - mn0) + ps0;
      l1 = l1 * ex2(m1 - mn1) + ps1;
      m0 = mn0;
      m1 = mn1;
    }
    const float lse0 = m0 + log2f(quad_sum(l0));
    const float lse1 = m1 + log2f(quad_sum(l1));

    float acc[D / 8][4];
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
    for (int kv0 = 0; kv0 < n16; kv0 += kChunk) {
      const int rows = min(kChunk, n16 - kv0);
      float s[kChunk / 8][4], dp[kChunk / 8][4];
      mma_abt<D>(s, qf, k_s + kv0 * LD, lane, rows);   // S = Q K^T
      mma_abt<D>(dp, df, v_s + kv0 * LD, lane, rows);  // dP = dO V^T
      // dS = P o (dP - delta), P = exp(S * scale - lse), 0 past N and,
      // Masked, where the mask drops the key
      if constexpr (Masked) {
        mask_keys_by(s, keep_s, kv0, quad);
      } else if (kv0 + kChunk > N) {
        mask_keys(s, kv0, N, quad);
      }
#pragma unroll
      for (int j = 0; j < kChunk / 8; ++j) {
        s[j][0] = ex2(fmaf(s[j][0], scale2, -lse0)) * (dp[j][0] - dl0);
        s[j][1] = ex2(fmaf(s[j][1], scale2, -lse0)) * (dp[j][1] - dl0);
        s[j][2] = ex2(fmaf(s[j][2], scale2, -lse1)) * (dp[j][2] - dl1);
        s[j][3] = ex2(fmaf(s[j][3], scale2, -lse1)) * (dp[j][3] - dl1);
      }
      mma_xt<D>(acc, s, k_s + kv0 * LD, lane, rows);  // dQ += dS K
    }
    store_rows<D>(dq + b * dqs.b + h * dqs.h, dqs.n, acc, row0, N, quad, scale);
    if (quad == 0) {
      lse_s[row0] = row0 < N ? lse0 : 0.f;
      lse_s[row1] = row1 < N ? lse1 : 0.f;
      dl_s[row0] = dl0;  // 0 past N
      dl_s[row1] = dl1;
    }
  }
  __syncthreads();  // lse and delta written; V no longer read

  stage_rows<D, kBwdThreads>(v_s, dob, dos.n, 0, n16, N);  // dO where V was
  cp_async_commit();
  cp_async_wait(0);
  __syncthreads();
  const bf16* do_s = v_s;

  // phase B: dK and dV per 16-row key tile
  for (int t = warp; t < tiles; t += kBwdWarps) {
    const int key0 = t * 16 + (lane >> 2);
    const int key1 = key0 + 8;
    // the key rows that take part: below N and, Masked, kept by the mask
    const bool keep0 = Masked ? keep_s[key0] != 0 : key0 < N;
    const bool keep1 = Masked ? keep_s[key1] != 0 : key1 < N;
    uint32_t kf[D / 16][4], vf[D / 16][4];
    load_a_frags<D>(kf, k_s, t, lane);
    load_a_frags_global<D>(vf, vb, vs.n, t * 16, N, lane);
    float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      dka[nt][0] = dka[nt][1] = dka[nt][2] = dka[nt][3] = 0.f;
      dva[nt][0] = dva[nt][1] = dva[nt][2] = dva[nt][3] = 0.f;
    }
    for (int q0 = 0; q0 < n16; q0 += kChunk) {
      const int rows = min(kChunk, n16 - q0);
      float s[kChunk / 8][4], dp[kChunk / 8][4];
      mma_abt<D>(s, kf, q_s + q0 * LD, lane, rows);    // S^T = K Q^T
      mma_abt<D>(dp, vf, do_s + q0 * LD, lane, rows);  // dP^T = V dO^T
      // P^T and dS^T = P^T o (dP^T - delta), 0 past N on either side
      // (queries: the masked chunk; keys: this tile's rows past N or
      // dropped by the mask)
      if (q0 + kChunk > N) mask_keys(s, q0, N, quad);
#pragma unroll
      for (int j = 0; j < kChunk / 8; ++j) {
        const int qi = q0 + j * 8 + 2 * quad;
        const float2 ls = *reinterpret_cast<const float2*>(lse_s + qi);
        const float2 dl = *reinterpret_cast<const float2*>(dl_s + qi);
        s[j][0] = keep0 ? ex2(fmaf(s[j][0], scale2, -ls.x)) : 0.f;
        s[j][1] = keep0 ? ex2(fmaf(s[j][1], scale2, -ls.y)) : 0.f;
        s[j][2] = keep1 ? ex2(fmaf(s[j][2], scale2, -ls.x)) : 0.f;
        s[j][3] = keep1 ? ex2(fmaf(s[j][3], scale2, -ls.y)) : 0.f;
        dp[j][0] = s[j][0] * (dp[j][0] - dl.x);
        dp[j][1] = s[j][1] * (dp[j][1] - dl.y);
        dp[j][2] = s[j][2] * (dp[j][2] - dl.x);
        dp[j][3] = s[j][3] * (dp[j][3] - dl.y);
      }
      mma_xt<D>(dva, s, do_s + q0 * LD, lane, rows);  // dV += P^T dO
      mma_xt<D>(dka, dp, q_s + q0 * LD, lane, rows);  // dK += dS^T Q
    }
    store_rows<D>(dk + b * dks.b + h * dks.h, dks.n, dka, key0, N, quad, scale);
    store_rows<D>(dv + b * dvs.b + h * dvs.h, dvs.n, dva, key0, N, quad, 1.f);
  }
}

// dynamic shared memory: K and V (and Q in the backward) of the head, the
// backward's lse and delta, and, Masked, the head's mask row
size_t fwd_smem(int N, int D, bool masked) {
  return 2ull * ((N + 15) & ~15) * (D + 8) * sizeof(bf16) + (masked ? kMaxN : 0);
}

size_t bwd_smem(int N, int D, bool masked) {
  return 3ull * ((N + 15) & ~15) * (D + 8) * sizeof(bf16) + 2ull * kMaxN * sizeof(float) +
         (masked ? kMaxN : 0);
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o, const void* mask,
               int mask_rows, int B, int N, int H, Strides qs, Strides ks, Strides vs,
               Strides os, float scale, cudaStream_t stream) {
  const bool masked = mask != nullptr;
  auto kernel = masked ? short_attention_fwd_kernel<D, true>
                       : short_attention_fwd_kernel<D, false>;
  const size_t smem = fwd_smem(N, D, masked);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (N + kFwdRows - 1) / kFwdRows;
  kernel<<<B * H * tiles, kFwdThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), static_cast<const uint8_t*>(mask), mask_rows, H, N, qs, ks, vs, os,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
               void* dq, void* dk, void* dv, const void* mask, int mask_rows, int B, int N,
               int H, const Strides (&s)[8], float scale, cudaStream_t stream) {
  const bool masked = mask != nullptr;
  auto kernel = masked ? short_attention_bwd_kernel<D, true>
                       : short_attention_bwd_kernel<D, false>;
  const size_t smem = bwd_smem(N, D, masked);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B * H, kBwdThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), static_cast<bf16*>(dq),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), static_cast<const uint8_t*>(mask),
      mask_rows, H, N, s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], scale);
  return static_cast<int>(cudaGetLastError());
}

bool valid_shape(int B, int N, int H, int D, const void* mask, int mask_rows) {
  return B >= 1 && H >= 1 && N >= 1 && N <= kMaxN && (D == 32 || D == 64 || D == 128) &&
         (mask == nullptr || mask_rows >= 1);
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q, k, v, o, dout: bf16 [B, N, H, D] with the given element strides (last
// dim contiguous, rows 16-byte aligned); dq, dk, dv: bf16 [B, N, H, D]
// outputs, likewise strided (the wrapper points them into one fused
// [B, N, 3*H*D] gradient). strides: three per tensor in that order. mask:
// null, or a contiguous uint8 [mask_rows, N] key mask (row b % mask_rows
// for batch b; 0 drops the key). D is 32, 64 or 128, N at most 256.
// Returns a cudaError_t code.
int short_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, void* dq, void* dk, void* dv, const void* mask,
                        int mask_rows, int B, int N, int H, int D, const long long* strides,
                        float scale, void* stream) {
  if (!valid_shape(B, N, H, D, mask, mask_rows)) return static_cast<int>(cudaErrorInvalidValue);
  Strides s[8];
  for (int t = 0; t < 8; ++t) s[t] = Strides{strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 32)
    return launch_bwd<32>(q, k, v, o, dout, dq, dk, dv, mask, mask_rows, B, N, H, s, scale, st);
  if (D == 64)
    return launch_bwd<64>(q, k, v, o, dout, dq, dk, dv, mask, mask_rows, B, N, H, s, scale, st);
  return launch_bwd<128>(q, k, v, o, dout, dq, dk, dv, mask, mask_rows, B, N, H, s, scale, st);
}

// q, k, v: bf16 [B, N, H, D] with the given element strides (last dim
// contiguous, rows 16-byte aligned); o: bf16 [B, N, H, D]; mask: as for
// the backward. D is 32, 64 or 128, N at most 256. Returns a cudaError_t
// code.
int short_attention_fwd(const void* q, const void* k, const void* v, void* o, const void* mask,
                        int mask_rows, int B, int N, int H, int D,
                        long long q_sb, long long q_sn, long long q_sh,
                        long long k_sb, long long k_sn, long long k_sh,
                        long long v_sb, long long v_sn, long long v_sh,
                        long long o_sb, long long o_sn, long long o_sh,
                        float scale, void* stream) {
  if (!valid_shape(B, N, H, D, mask, mask_rows)) return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_sb, q_sn, q_sh}, ks{k_sb, k_sn, k_sh}, vs{v_sb, v_sn, v_sh},
      os{o_sb, o_sn, o_sh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 32)
    return launch_fwd<32>(q, k, v, o, mask, mask_rows, B, N, H, qs, ks, vs, os, scale, st);
  if (D == 64)
    return launch_fwd<64>(q, k, v, o, mask, mask_rows, B, N, H, qs, ks, vs, os, scale, st);
  return launch_fwd<128>(q, k, v, o, mask, mask_rows, B, N, H, qs, ks, vs, os, scale, st);
}

}  // extern "C"
