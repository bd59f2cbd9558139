// Blockwise (flash) attention, forward and backward, for Hopper (sm_90a),
// plain C interface. The backward's notes are above its kernels below.
//
// Forward. Replaces layoutdit_tpu/ops/flash_attention.py::_fwd_kernel and
// _fwd_kernel_nobias (via _flash_fwd): online-softmax attention over
// kv tiles with an optional additive bias [H, N, N], emitting o and the
// per-row log-sum-exp. The 1024 px bucket runs it at B=4, H=12, N=4097,
// D=64 without bias.
//
// Bound on the H100: operations. 4*B*H*N^2*D = 206 GFLOP against 100 MB
// of Q/K/V/O, so the tensor cores are the limit (0.21 ms at the bf16
// peak). The design keeps the whole online softmax in registers, in the
// FlashAttention-2 arrangement: a block owns 64 query rows (4 warps x 16
// rows) and loops over 64-key tiles of K and V staged in shared memory;
// each warp holds its Q fragments, its 16x64 fp32 score tile and its
// 16xD fp32 output accumulator in registers, computes S = Q K^T and
// O += P V with mma.sync m16n8k16 (bf16 in, fp32 accumulate; operands
// from ldmatrix, V through its transposing form), and reuses the score
// accumulators as the bf16 P operand without a trip through shared
// memory. Softmax runs in the exp2 domain; row max and sum are reduced
// over the four lanes that share a row. The ragged edge is masked in the
// kernel (key rows past N are zero-filled and their scores set to -1e30,
// the TPU kernel's finite NEG_INF), with no padded copies. Q/K/V are read
// straight from [B, N, H, D] strides, o is written in that layout, and
// lse is fp32 [B*H, N]. Still simple: no TMA, no wgmma, no pipelining of
// the tile loads.

#include "attention_mma.cuh"

namespace {

constexpr int kBq = 64;
constexpr int kBk = 64;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
static_assert(kBq == kChunk && kBk == kChunk, "the helpers' score tiles are kChunk wide");

template <int D, bool kBias>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ bias, bf16* __restrict__ o, float* __restrict__ lse,
    int H, int N, Strides qs, Strides ks, Strides vs, Strides os, float scale) {
  constexpr int LD = D + 8;  // smem row pitch: ldmatrix rows land on distinct banks
  __shared__ __align__(16) bf16 k_s[kBk * LD];
  __shared__ __align__(16) bf16 v_s[kBk * LD];

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.y * kBq;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int quad = lane & 3;
  // this lane's two query rows (fragment rows lane/4 and lane/4 + 8)
  const int row0 = q0 + warp * 16 + (lane >> 2);
  const int row1 = row0 + 8;
  const float scale2 = scale * kLog2e;

  // Q fragments, staged through k_s
  load_tile<D, kThreads>(k_s, q + b * qs.b + h * qs.h, qs.n, q0, N);
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldmatrix_x4(qf[kk], k_s + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);

  float acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h;
  for (int kv0 = 0; kv0 < N; kv0 += kBk) {
    __syncthreads();  // Q staging / previous tile fully read
    load_tile<D, kThreads>(k_s, kb, ks.n, kv0, N);
    load_tile<D, kThreads>(v_s, vb, vs.n, kv0, N);
    __syncthreads();

    // S = Q K^T: 16 rows x 64 keys per warp, 8 n-tiles of 8 keys
    float s[kBk / 8][4];
#pragma unroll
    for (int j = 0; j < kBk / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < kBk / 8; j += 2) {
        uint32_t bk[4];
        ldmatrix_x4(bk, k_s + (j * 8 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                            ((lane >> 3) & 1) * 8);
        mma_bf16(s[j], qf[kk], bk[0], bk[1]);
        mma_bf16(s[j + 1], qf[kk], bk[2], bk[3]);
      }
    }

    // scale (+ bias), mask the ragged edge, online softmax (exp2 domain)
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < kBk / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kv0 + j * 8 + 2 * quad + (e & 1);
        const int row = e < 2 ? row0 : row1;
        float x = s[j][e] * scale2;
        if (kBias && row < N && key < N)
          x += bias[(static_cast<long long>(h) * N + row) * N + key] * kLog2e;
        x = key < N ? x : kNegInf;
        s[j][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    const float corr0 = exp2f(m0 - mn0);
    const float corr1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < kBk / 8; ++j) {
      s[j][0] = exp2f(s[j][0] - m0);
      s[j][1] = exp2f(s[j][1] - m0);
      s[j][2] = exp2f(s[j][2] - m1);
      s[j][3] = exp2f(s[j][3] - m1);
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

    // O += P V: the score accumulators of n-tiles 2kk, 2kk+1 are the A
    // fragment of keys [16kk, 16kk + 16)
#pragma unroll
    for (int kk = 0; kk < kBk / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int nt = 0; nt < D / 8; nt += 2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, v_s + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                  nt * 8 + (lane >> 4) * 8);
        mma_bf16(acc[nt], pa, bv[0], bv[1]);
        mma_bf16(acc[nt + 1], pa, bv[2], bv[3]);
      }
    }
  }

  l0 = fmaxf(quad_sum(l0), 1e-30f);
  l1 = fmaxf(quad_sum(l1), 1e-30f);
  const float inv0 = 1.f / l0;
  const float inv1 = 1.f / l1;
  if (row0 < N) {
    bf16* og = o + b * os.b + row0 * os.n + h * os.h + 2 * quad;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(og + nt * 8) =
          __floats2bfloat162_rn(acc[nt][0] * inv0, acc[nt][1] * inv0);
    if (quad == 0) lse[static_cast<long long>(bh) * N + row0] = (m0 + log2f(l0)) * kLn2;
  }
  if (row1 < N) {
    bf16* og = o + b * os.b + row1 * os.n + h * os.h + 2 * quad;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(og + nt * 8) =
          __floats2bfloat162_rn(acc[nt][2] * inv1, acc[nt][3] * inv1);
    if (quad == 0) lse[static_cast<long long>(bh) * N + row1] = (m1 + log2f(l1)) * kLn2;
  }
}

// Backward. Replaces layoutdit_tpu/ops/flash_attention.py::_bwd_dq_kernel /
// _bwd_dq_nobias and _bwd_dkdv_kernel / _bwd_dkdv_nobias (via _flash_bwd):
// from q, k, v, o, the forward's lse and dO, with P recomputed blockwise as
//   P = exp(Q K^T * scale (+ bias) - lse),  delta = rowsum(dO o O),
//   dP = dO V^T,  dS = P o (dP - delta),
//   dQ = dS K * scale,  dK = dS^T Q * scale,  dV = P^T dO.
// The high-res train step runs it at B=4, H=12, N=4097, D=64 without bias.
//
// Bound on the H100: operations. The five N x N x D products are
// 10*B*H*N^2*D = 516 GFLOP against about 0.2 GB of inputs and gradients
// (0.52 ms at the bf16 peak). Two kernels split the work as the TPU kernels
// do, so every gradient row is summed inside one block and written once:
// no atomics, and the gradients are the same bits from run to run. (The
// FlashAttention-2 single kernel adds dQ across key blocks with fp32
// atomics, whose order, and so whose last bits, change between runs.) The
// price is that S and dP are computed in both kernels: 7 products, not 5.
//   dq kernel: a block owns 64 query rows (4 warps x 16) and sweeps the
//     64-key tiles: S = Q K^T and dP = dO V^T from Q and dO fragments held
//     in registers, dS in registers, dQ += dS K. It also computes
//     delta = rowsum(dO o O) for its rows (the TPU's _dvec) and writes it
//     to a [B*H, N] fp32 buffer for the dkdv kernel, launched after it on
//     the same stream, so O is read once.
//   dkdv kernel: a block owns 64 keys (4 warps x 16) and sweeps the
//     64-query tiles: S^T = K Q^T and dP^T = V dO^T from K and V fragments
//     held in registers, P^T and dS^T in registers, dV += P^T dO and
//     dK += dS^T Q.
// Every product is mma.sync m16n8k16 (bf16 in, fp32 accumulate) with
// operands from ldmatrix; the score accumulators are reused as the bf16 A
// operand of the next product, as in the forward. The gradients accumulate
// in fp32 registers and are rounded to bf16 once. Inputs are read through
// the [B, N, H, D] strides of the fused projection, and dq, dk, dv are
// written through the strides the caller gives (the slices of one fused
// [B, N, 3*H*D] gradient). The ragged edge is masked as in the forward:
// key columns past N get P = 0 (the forward's -1e30 score), and query rows
// past N are zero-filled with lse = delta = 0, so they add nothing. Still
// simple: no TMA, no wgmma, no pipelining of the tile loads. The products
// and tile helpers are in attention_mma.cuh.

template <int D, bool kBias>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ o, const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ bias, float* __restrict__ delta, bf16* __restrict__ dq, int H,
    int N, Strides qs, Strides ks, Strides vs, Strides os, Strides dos, Strides dqs,
    float scale) {
  constexpr int LD = D + 8;
  __shared__ __align__(16) bf16 k_s[kBk * LD];
  __shared__ __align__(16) bf16 v_s[kBk * LD];

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.y * kBq;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int quad = lane & 3;
  const int row0 = q0 + warp * 16 + (lane >> 2);
  const int row1 = row0 + 8;
  const float scale2 = scale * kLog2e;

  // delta and lse (exp2 domain) of this lane's two rows; zero past N
  const float dl0 = quad_row_dot<D>(o + b * os.b + row0 * os.n + h * os.h,
                                    dout + b * dos.b + row0 * dos.n + h * dos.h, row0 < N, quad);
  const float dl1 = quad_row_dot<D>(o + b * os.b + row1 * os.n + h * os.h,
                                    dout + b * dos.b + row1 * dos.n + h * dos.h, row1 < N, quad);
  const float* lse_bh = lse + static_cast<long long>(bh) * N;
  const float lse0 = row0 < N ? lse_bh[row0] * kLog2e : 0.f;
  const float lse1 = row1 < N ? lse_bh[row1] * kLog2e : 0.f;
  if (quad == 0) {
    if (row0 < N) delta[static_cast<long long>(bh) * N + row0] = dl0;
    if (row1 < N) delta[static_cast<long long>(bh) * N + row1] = dl1;
  }

  // Q and dO fragments, staged through k_s and v_s
  load_tile<D, kThreads>(k_s, q + b * qs.b + h * qs.h, qs.n, q0, N);
  load_tile<D, kThreads>(v_s, dout + b * dos.b + h * dos.h, dos.n, q0, N);
  __syncthreads();
  uint32_t qf[D / 16][4], df[D / 16][4];
  load_a_frags<D>(qf, k_s, warp, lane);
  load_a_frags<D>(df, v_s, warp, lane);

  float acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h;
  for (int kv0 = 0; kv0 < N; kv0 += kBk) {
    __syncthreads();  // staging / previous tile fully read
    load_tile<D, kThreads>(k_s, kb, ks.n, kv0, N);
    load_tile<D, kThreads>(v_s, vb, vs.n, kv0, N);
    __syncthreads();

    float s[kBk / 8][4], dp[kBk / 8][4];
    mma_abt<D>(s, qf, k_s, lane);   // S = Q K^T
    mma_abt<D>(dp, df, v_s, lane);  // dP = dO V^T
    // dS = P o (dP - delta), P = exp(S * scale (+ bias) - lse), 0 past N
#pragma unroll
    for (int j = 0; j < kBk / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kv0 + j * 8 + 2 * quad + (e & 1);
        const int row = e < 2 ? row0 : row1;
        float x = s[j][e] * scale2;
        if (kBias && row < N && key < N)
          x += bias[(static_cast<long long>(h) * N + row) * N + key] * kLog2e;
        const float p = key < N ? exp2f(x - (e < 2 ? lse0 : lse1)) : 0.f;
        s[j][e] = p * (dp[j][e] - (e < 2 ? dl0 : dl1));
      }
    }
    mma_xt<D>(acc, s, k_s, lane);  // dQ += dS K
  }
  store_rows<D>(dq + b * dqs.b + h * dqs.h, dqs.n, acc, row0, N, quad, scale);
}

template <int D, bool kBias>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const float* __restrict__ bias, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int H, int N, Strides qs, Strides ks, Strides vs, Strides dos,
    Strides dks, Strides dvs, float scale) {
  constexpr int LD = D + 8;
  __shared__ __align__(16) bf16 q_s[kBq * LD];
  __shared__ __align__(16) bf16 do_s[kBq * LD];
  __shared__ float lse_s[kBq];
  __shared__ float dl_s[kBq];

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.y * kBk;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int quad = lane & 3;
  // this lane's two keys (fragment rows lane/4 and lane/4 + 8)
  const int key0 = k0 + warp * 16 + (lane >> 2);
  const int key1 = key0 + 8;
  const float scale2 = scale * kLog2e;

  // K and V fragments, staged through q_s and do_s
  load_tile<D, kThreads>(q_s, k + b * ks.b + h * ks.h, ks.n, k0, N);
  load_tile<D, kThreads>(do_s, v + b * vs.b + h * vs.h, vs.n, k0, N);
  __syncthreads();
  uint32_t kf[D / 16][4], vf[D / 16][4];
  load_a_frags<D>(kf, q_s, warp, lane);
  load_a_frags<D>(vf, do_s, warp, lane);

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    dka[nt][0] = dka[nt][1] = dka[nt][2] = dka[nt][3] = 0.f;
    dva[nt][0] = dva[nt][1] = dva[nt][2] = dva[nt][3] = 0.f;
  }

  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* dob = dout + b * dos.b + h * dos.h;
  const float* lse_bh = lse + static_cast<long long>(bh) * N;
  const float* dl_bh = delta + static_cast<long long>(bh) * N;
  for (int q0 = 0; q0 < N; q0 += kBq) {
    __syncthreads();  // staging / previous tile fully read
    load_tile<D, kThreads>(q_s, qb, qs.n, q0, N);
    load_tile<D, kThreads>(do_s, dob, dos.n, q0, N);
    for (int i = threadIdx.x; i < kBq; i += kThreads) {
      const int r = q0 + i;
      lse_s[i] = r < N ? lse_bh[r] * kLog2e : 0.f;
      dl_s[i] = r < N ? dl_bh[r] : 0.f;
    }
    __syncthreads();

    float s[kBq / 8][4], dp[kBq / 8][4];
    mma_abt<D>(s, kf, q_s, lane);    // S^T = K Q^T
    mma_abt<D>(dp, vf, do_s, lane);  // dP^T = V dO^T
    // P^T and dS^T = P^T o (dP^T - delta), 0 past N on either side
#pragma unroll
    for (int j = 0; j < kBq / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = j * 8 + 2 * quad + (e & 1);
        const int query = q0 + qi;
        const int key = e < 2 ? key0 : key1;
        float x = s[j][e] * scale2;
        if (kBias && query < N && key < N)
          x += bias[(static_cast<long long>(h) * N + query) * N + key] * kLog2e;
        const float p = (query < N && key < N) ? exp2f(x - lse_s[qi]) : 0.f;
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - dl_s[qi]);
      }
    }
    mma_xt<D>(dva, s, do_s, lane);  // dV += P^T dO
    mma_xt<D>(dka, dp, q_s, lane);  // dK += dS^T Q
  }
  store_rows<D>(dk + b * dks.b + h * dks.h, dks.n, dka, key0, N, quad, scale);
  store_rows<D>(dv + b * dvs.b + h * dvs.h, dvs.n, dva, key0, N, quad, 1.f);
}

// Bias gradient. Replaces layoutdit_tpu/ops/flash_attention.py::_dbias_kernel
// (via _flash_bwd): dbias[h, i, j] = sum_b dS[b, h, i, j], dS as above, for
// a bias [H, N, N] shared by the batch (BEiT's relative-position bias). The
// high-res rel-pos train step runs it at B=4, N=4097 (the global layers) and
// at B=64, N=256 (16 x 16 windows), H=12, D=64.
//
// Bound on the H100: bytes. The fp32 bias read and dbias written are
// 2*H*N^2*4 = 1.61 GB at N=4097 (0.48 ms at 3.35 TB/s) against 4*B*H*N^2*D
// = 206 GFLOP for S and dP (0.21 ms at the bf16 peak). The design reads
// each bias element once and writes each dbias element once: a block owns
// one 64 x 64 (query, key) tile of one head (4 warps x 16 query rows), holds
// its bias tile in registers and its dbias tile in fp32 registers, and loops
// over the batch as the TPU kernel's innermost grid dimension does. For each
// batch element it stages the Q, dO, K and V tiles in shared memory, forms
// S = Q K^T and dP = dO V^T with mma.sync (the dq kernel's arithmetic, from
// the forward's lse and the delta the dq kernel writes, launched before it on
// the same stream), and adds dS = P o (dP - delta) in fp32. No atomics: the
// batch sum runs in a fixed order, so dbias is the same bits every run (a
// dS added from the dq kernel with atomics would not be). Still simple: the
// Q/dO/K/V tiles are reloaded by every key or query tile that needs them
// (from L2), and the bias is a materialised [H, N, N] tensor.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dbias_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const float* __restrict__ bias,
    float* __restrict__ dbias, int B, int H, int N, Strides qs, Strides ks, Strides vs,
    Strides dos, float scale) {
  constexpr int LD = D + 8;
  __shared__ __align__(16) bf16 q_s[kBq * LD];
  __shared__ __align__(16) bf16 do_s[kBq * LD];
  __shared__ __align__(16) bf16 k_s[kBk * LD];
  __shared__ __align__(16) bf16 v_s[kBk * LD];

  const int kv0 = blockIdx.x * kBk;
  const int q0 = blockIdx.y * kBq;
  const int h = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int quad = lane & 3;
  const int row0 = q0 + warp * 16 + (lane >> 2);
  const int row1 = row0 + 8;
  const float scale2 = scale * kLog2e;

  // this lane's bias (exp2 domain) and dbias accumulators, in the score
  // accumulators' layout: element e of n-tile j is (row e < 2 ? row0 : row1,
  // key kv0 + 8j + 2 quad + (e & 1))
  const float* bias_h = bias + static_cast<long long>(h) * N * N;
  float bl[kBk / 8][4], acc[kBk / 8][4];
#pragma unroll
  for (int j = 0; j < kBk / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = kv0 + j * 8 + 2 * quad + (e & 1);
      const int row = e < 2 ? row0 : row1;
      bl[j][e] = (row < N && key < N) ? bias_h[static_cast<long long>(row) * N + key] * kLog2e
                                      : 0.f;
      acc[j][e] = 0.f;
    }
  }

  for (int b = 0; b < B; ++b) {
    const long long bh = static_cast<long long>(b) * H + h;
    __syncthreads();  // previous batch element's tiles fully read
    load_tile<D, kThreads>(q_s, q + b * qs.b + h * qs.h, qs.n, q0, N);
    load_tile<D, kThreads>(do_s, dout + b * dos.b + h * dos.h, dos.n, q0, N);
    load_tile<D, kThreads>(k_s, k + b * ks.b + h * ks.h, ks.n, kv0, N);
    load_tile<D, kThreads>(v_s, v + b * vs.b + h * vs.h, vs.n, kv0, N);
    // lse (exp2 domain) and delta of this lane's two rows; zero past N
    const float lse0 = row0 < N ? lse[bh * N + row0] * kLog2e : 0.f;
    const float lse1 = row1 < N ? lse[bh * N + row1] * kLog2e : 0.f;
    const float dl0 = row0 < N ? delta[bh * N + row0] : 0.f;
    const float dl1 = row1 < N ? delta[bh * N + row1] : 0.f;
    __syncthreads();

    uint32_t qf[D / 16][4], df[D / 16][4];
    load_a_frags<D>(qf, q_s, warp, lane);
    load_a_frags<D>(df, do_s, warp, lane);
    float s[kBk / 8][4], dp[kBk / 8][4];
    mma_abt<D>(s, qf, k_s, lane);   // S = Q K^T
    mma_abt<D>(dp, df, v_s, lane);  // dP = dO V^T
#pragma unroll
    for (int j = 0; j < kBk / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kv0 + j * 8 + 2 * quad + (e & 1);
        const float p =
            key < N ? exp2f(s[j][e] * scale2 + bl[j][e] - (e < 2 ? lse0 : lse1)) : 0.f;
        acc[j][e] += p * (dp[j][e] - (e < 2 ? dl0 : dl1));
      }
    }
  }

  float* dbias_h = dbias + static_cast<long long>(h) * N * N;
#pragma unroll
  for (int j = 0; j < kBk / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = kv0 + j * 8 + 2 * quad + (e & 1);
      const int row = e < 2 ? row0 : row1;
      if (row < N && key < N) dbias_h[static_cast<long long>(row) * N + key] = acc[j][e];
    }
  }
}

template <int D, bool kBias>
int launch(const void* q, const void* k, const void* v, const void* bias, void* o, void* lse,
           int B, int N, int H, Strides qs, Strides ks, Strides vs, Strides os, float scale,
           cudaStream_t stream) {
  const dim3 grid(B * H, (N + kBq - 1) / kBq);
  flash_fwd_kernel<D, kBias><<<grid, kThreads, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(bias), static_cast<bf16*>(o), static_cast<float*>(lse), H, N,
      qs, ks, vs, os, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int dispatch_bias(const void* q, const void* k, const void* v, const void* bias, void* o,
                  void* lse, int B, int N, int H, Strides qs, Strides ks, Strides vs, Strides os,
                  float scale, cudaStream_t stream) {
  if (bias != nullptr)
    return launch<D, true>(q, k, v, bias, o, lse, B, N, H, qs, ks, vs, os, scale, stream);
  return launch<D, false>(q, k, v, bias, o, lse, B, N, H, qs, ks, vs, os, scale, stream);
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q, k, v: bf16 [B, N, H, D] with the given element strides (last dim
// contiguous, 16-byte aligned rows); bias: fp32 [H, N, N] or null;
// o: bf16 [B, N, H, D]; lse: fp32 [B*H, N]. Returns a cudaError_t code.
int flash_attention_fwd(const void* q, const void* k, const void* v, const void* bias,
                        void* o, void* lse, int B, int N, int H, int D,
                        long long q_sb, long long q_sn, long long q_sh,
                        long long k_sb, long long k_sn, long long k_sh,
                        long long v_sb, long long v_sn, long long v_sh,
                        long long o_sb, long long o_sn, long long o_sh,
                        float scale, void* stream) {
  if (B < 1 || H < 1 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_sb, q_sn, q_sh}, ks{k_sb, k_sn, k_sh}, vs{v_sb, v_sn, v_sh},
      os{o_sb, o_sn, o_sh};
  if (D != 64) return static_cast<int>(cudaErrorInvalidValue);  // dit-base's head width
  return dispatch_bias<64>(q, k, v, bias, o, lse, B, N, H, qs, ks, vs, os, scale,
                           static_cast<cudaStream_t>(stream));
}

// The dq kernel of the backward. q, k, v, o, dout: bf16 [B, N, H, D] with
// the element strides in strides[0..14] (three each, in that order; last
// dim contiguous, 16-byte aligned rows); dq: bf16 [B, N, H, D] with
// strides[15..17]; lse: fp32 [B*H, N] from the forward; bias: fp32
// [H, N, N] or null; delta: fp32 [B*H, N], written. Returns a cudaError_t
// code.
int flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                           const void* dout, const void* lse, const void* bias, void* delta,
                           void* dq, int B, int N, int H, int D, const long long* strides,
                           float scale, void* stream) {
  if (B < 1 || H < 1 || N < 1 || D != 64) return static_cast<int>(cudaErrorInvalidValue);
  Strides s[6];
  for (int t = 0; t < 6; ++t)
    s[t] = Strides{strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
  const dim3 grid(B * H, (N + kBq - 1) / kBq);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto kernel = bias != nullptr ? flash_bwd_dq_kernel<64, true>
                                      : flash_bwd_dq_kernel<64, false>;
  kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(bias),
      static_cast<float*>(delta), static_cast<bf16*>(dq), H, N, s[0], s[1], s[2], s[3], s[4],
      s[5], scale);
  return static_cast<int>(cudaGetLastError());
}

// The dkdv kernel of the backward, launched after the dq kernel (it reads
// the delta that one wrote). q, k, v, dout: bf16 [B, N, H, D] with
// strides[0..11]; dk, dv: bf16 [B, N, H, D] with strides[12..17]; lse,
// delta: fp32 [B*H, N]; bias: fp32 [H, N, N] or null. Returns a
// cudaError_t code.
int flash_attention_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, const void* bias, void* dk,
                             void* dv, int B, int N, int H, int D, const long long* strides,
                             float scale, void* stream) {
  if (B < 1 || H < 1 || N < 1 || D != 64) return static_cast<int>(cudaErrorInvalidValue);
  Strides s[6];
  for (int t = 0; t < 6; ++t)
    s[t] = Strides{strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
  const dim3 grid(B * H, (N + kBk - 1) / kBk);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto kernel = bias != nullptr ? flash_bwd_dkdv_kernel<64, true>
                                      : flash_bwd_dkdv_kernel<64, false>;
  kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const float*>(bias),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, N, s[0], s[1], s[2], s[3], s[4], s[5],
      scale);
  return static_cast<int>(cudaGetLastError());
}

// The dbias kernel of the backward, launched after the dq kernel (it reads
// the delta that one wrote). q, k, v, dout: bf16 [B, N, H, D] with
// strides[0..11]; lse, delta: fp32 [B*H, N]; bias: fp32 [H, N, N], not
// null; dbias: fp32 [H, N, N], written. Returns a cudaError_t code.
int flash_attention_bwd_dbias(const void* q, const void* k, const void* v, const void* dout,
                              const void* lse, const void* delta, const void* bias, void* dbias,
                              int B, int N, int H, int D, const long long* strides, float scale,
                              void* stream) {
  if (B < 1 || H < 1 || N < 1 || D != 64 || bias == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Strides s[4];
  for (int t = 0; t < 4; ++t)
    s[t] = Strides{strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
  const dim3 grid((N + kBk - 1) / kBk, (N + kBq - 1) / kBq, H);
  flash_bwd_dbias_kernel<64><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const float*>(bias),
      static_cast<float*>(dbias), B, H, N, s[0], s[1], s[2], s[3], scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
