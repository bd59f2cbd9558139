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

#include "hopper_mma.cuh"

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
// The 1024 px train steps run it at B=4, H=12, N=4097, D=64, without a
// bias (windowed step) and with a [12, N, N] one (rel-pos step, which also
// runs it at B=64, N=256 in its 16 x 16 windows).
//
// Bound on the H100: operations. The five N x N x D products are
// 10*B*H*N^2*D = 516 GFLOP against about 0.2 GB of inputs and gradients
// (0.52 ms at the bf16 peak); a bias adds its 806 MB of fp32 reads to each
// kernel (0.24 ms at 3.35 TB/s). Two kernels split the work as the TPU
// kernels do, so every gradient row is summed inside one block and written
// once: no atomics, and the gradients are the same bits from run to run. (The
// FlashAttention-2 single kernel adds dQ across key blocks with fp32
// atomics, whose order, and so whose last bits, change between runs.) The
// price is that S and dP are computed in both kernels: 7 products, not 5.
//
// Both kernels have the Hopper shape: a block of three warpgroups, two
// consumers that each own 64 rows of the block's 128 and one producer
// (setmaxnreg: 232 registers a consumer thread, 40 a producer one). The
// producer keeps a ring of kBwdStages tiles in flight: its first thread
// loads the streamed bf16 tiles by TMA (4-d tensor maps over the [B, N, H,
// D] strides, so the fused projection's slices are read in place, 128-byte
// swizzled, rows past N zero-filled), and its other threads copy the fp32
// rows that no tensor map can describe (the [B*H, N] and [H, N, N] rows have
// an odd pitch at N = 4097) with one bulk copy each, of the 16-byte-aligned
// span that covers the row (aligned_span); each stage completes on a "full"
// mbarrier and is handed back on an "empty" one. The consumers run every
// product as wgmma m64n64k16 (bf16 in, fp32 accumulate): S and dP with the
// streamed tile as B (the dq kernel holds its Q and dO rows as register A
// operands for the whole sweep, the dkdv kernel reads K and V from shared
// memory), then P or dS as the register A operand of the gradient products,
// the tile as B read down its rows. They overlap the
// elementwise work of a tile with its products: P is formed while dP runs,
// and dS while the first gradient product runs. The gradients stay in fp32
// registers and are rounded to bf16 once, written through the caller's
// strides (the slices of one fused [B, N, 3*H*D] gradient).
//   dq kernel: a block owns 128 query rows (Q and dO loaded once) and
//     streams the 64-key tiles of K and V: S = Q K^T, dP = dO V^T, dS,
//     dQ += dS K. It also computes delta = rowsum(dO o O) for its rows (the
//     TPU's _dvec) and writes it to a [B*H, N] fp32 buffer for the dkdv and
//     dbias kernels, launched after it on the same stream.
//   dkdv kernel: a block owns 128 keys (K and V loaded once) and streams the
//     64-query tiles of Q and dO with their lse and delta: S^T = K Q^T,
//     dP^T = V dO^T, P^T and dS^T, dV += P^T dO, dK += dS^T Q.
// With a bias, each stage also carries the bias tile the block needs, one
// row per copy, in a shared-memory pitch that spreads the consumers' reads
// over the banks (the dkdv kernel reads it transposed). The grid runs b
// fastest, so the B blocks that read one head's tile run together and L2
// serves all but the first: the bias crosses HBM about once a kernel. The
// ragged edge is masked as in the forward: key columns past N get P = 0 (the
// forward's -1e30 score). Query rows past N read as zeros (TMA): in the dq
// kernel their dS reaches only their own dQ rows, which are not stored; in
// the dkdv kernel their P and delta are set to 0, so they add nothing. No
// other fp32 value a span copies beyond a row is used.

constexpr int kBwdStages = 3;
constexpr int kBwdRows = 2 * kChunk;               // rows of a block: two consumers
constexpr int kBwdThreads = 3 * 128;               // two consumer warpgroups, one producer
constexpr int kTileBytes = kChunk * 64 * 2;        // one bf16 [64, 64] tile
constexpr int kDqBiasLd = kChunk + 8;              // [128 queries][64 keys] fp32 bias tile
constexpr int kDkdvBiasLd = kBwdRows + 4;          // [64 queries][128 keys], read transposed
constexpr int kDqBiasBytes = kBwdRows * kDqBiasLd * 4;
constexpr int kVecLd = kChunk + 8;                 // lse or delta of a query tile, fp32
constexpr int kDkdvBiasBytes = kChunk * kDkdvBiasLd * 4;
constexpr int kConsumerRegs = 232;
constexpr int kProducerRegs = 40;

// dynamic shared memory of each kernel, 1024 bytes of alignment slack
// included: the block's own 128 rows of two operands, then the ring
constexpr int dq_smem_bytes(bool bias) {
  return 1024 + 4 * kTileBytes + kBwdStages * (2 * kTileBytes + (bias ? kDqBiasBytes : 0));
}
constexpr int dkdv_smem_bytes(bool bias) {
  return 1024 + 4 * kTileBytes +
         kBwdStages * (2 * kTileBytes + 2 * kVecLd * 4 + (bias ? kDkdvBiasBytes : 0));
}

// block -> (b, h, row tile), b fastest, then the tile, then the head
struct BwdBlock {
  int b, h, tile;
};
__device__ __forceinline__ BwdBlock bwd_block(int B, int N) {
  const int tiles = (N + kBwdRows - 1) / kBwdRows;
  const int x = blockIdx.x;
  const int rest = x / B;
  return BwdBlock{x - rest * B, rest / tiles, rest - (rest / tiles) * tiles};
}

// The two consumers take turns to issue their S and dP products (named
// barriers 1 and 2 over both warpgroups), so one forms its P and dS while
// the other's products run, rather than both waiting on the tensor cores at
// once and then both leaving them idle.
__device__ __forceinline__ void consumer_turn(int c) { named_barrier_sync(1 + c, 256); }
__device__ __forceinline__ void pass_turn(int c) { named_barrier_arrive(2 - c, 256); }

template <bool kBias>
__global__ void __launch_bounds__(kBwdThreads, 1) flash_bwd_dq_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
    const bf16* __restrict__ o, const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ bias, float* __restrict__ delta, bf16* __restrict__ dq, int B,
    int H, int N, Strides os, Strides dos, Strides dqs, float scale) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kBwdStages], empty[kBwdStages], once;
  uint8_t* sm = align1024(smem_raw);
  bf16* q_s = reinterpret_cast<bf16*>(sm);                   // [128, 64]
  bf16* do_s = reinterpret_cast<bf16*>(sm + 2 * kTileBytes);  // [128, 64]
  uint8_t* ring = sm + 4 * kTileBytes;
  // stage s: K tile, V tile, bias tile
  auto k_s = [&](int s) { return reinterpret_cast<bf16*>(ring + s * kTileBytes); };
  auto v_s = [&](int s) {
    return reinterpret_cast<bf16*>(ring + (kBwdStages + s) * kTileBytes);
  };
  auto bias_s = [&](int s) {
    return reinterpret_cast<float*>(ring + 2 * kBwdStages * kTileBytes + s * kDqBiasBytes);
  };

  const BwdBlock blk = bwd_block(B, N);
  const int r0 = blk.tile * kBwdRows;
  const int tiles = (N + kChunk - 1) / kChunk;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(&full[s], kBias ? 4 : 1);  // one arrival per producer warp that copies
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_init(&once, 1);
    mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= 8) {  // producer warpgroup
    warpgroup_regs_dec<kProducerRegs>();
    const int pt = threadIdx.x - 256;
    if (pt == 0) {
      mbar_expect_tx(&once, 4 * kTileBytes);
      tma_load_4d(q_s, &tq, 0, blk.h, r0, blk.b, &once);
      tma_load_4d(q_s + kChunk * 64, &tq, 0, blk.h, r0 + kChunk, blk.b, &once);
      tma_load_4d(do_s, &tdo, 0, blk.h, r0, blk.b, &once);
      tma_load_4d(do_s + kChunk * 64, &tdo, 0, blk.h, r0 + kChunk, blk.b, &once);
    }
    if (kBias || pt < 32) {
      // with a bias, thread pt also copies query row r0 + pt of each bias tile
      const int qr = r0 + pt;
      const float* bias_row =
          kBias && qr < N ? bias + (static_cast<long long>(blk.h) * N + qr) * N : nullptr;
      for (int it = 0; it < tiles; ++it) {
        const int s = it % kBwdStages;
        mbar_wait(&empty[s], ((it / kBwdStages) & 1) ^ 1);
        const int kv0 = it * kChunk;
        Span row{nullptr, 0};
        if (bias_row != nullptr) row = aligned_span(bias_row + kv0, min(kChunk, N - kv0));
        warp_expect_tx(&full[s], row.bytes + (pt == 0 ? 2 * kTileBytes : 0), lane);
        if (pt == 0) {
          tma_load_4d(k_s(s), &tk, 0, blk.h, kv0, blk.b, &full[s]);
          tma_load_4d(v_s(s), &tv, 0, blk.h, kv0, blk.b, &full[s]);
        }
        if (row.bytes != 0) bulk_load(bias_s(s) + pt * kDqBiasLd, row.src, row.bytes, &full[s]);
      }
    }
  } else {  // consumer warpgroups c = 0, 1: query rows r0 + 64 c + [0, 64)
    warpgroup_regs_inc<kConsumerRegs>();
    const int c = warp >> 2;
    const int w = warp & 3;
    const int quad = lane & 3;
    const int row0 = r0 + c * kChunk + w * 16 + (lane >> 2);
    const int row1 = row0 + 8;
    const int bh = blk.b * H + blk.h;
    const float scale2 = scale * kLog2e;

    // delta and lse (exp2 domain) of this lane's two rows; zero past N
    const float dl0 =
        quad_row_dot<64>(o + blk.b * os.b + row0 * os.n + blk.h * os.h,
                         dout + blk.b * dos.b + row0 * dos.n + blk.h * dos.h, row0 < N, quad);
    const float dl1 =
        quad_row_dot<64>(o + blk.b * os.b + row1 * os.n + blk.h * os.h,
                         dout + blk.b * dos.b + row1 * dos.n + blk.h * dos.h, row1 < N, quad);
    const float* lse_bh = lse + static_cast<long long>(bh) * N;
    const float lse0 = row0 < N ? lse_bh[row0] * kLog2e : 0.f;
    const float lse1 = row1 < N ? lse_bh[row1] * kLog2e : 0.f;
    if (quad == 0) {
      if (row0 < N) delta[static_cast<long long>(bh) * N + row0] = dl0;
      if (row1 < N) delta[static_cast<long long>(bh) * N + row1] = dl1;
    }

    // this lane's two rows of each bias tile (the producer's bulk copy of
    // row r lands span_shift floats in). Rows past N are not copied: they
    // read stale values, which reach only their own dS and dQ rows, never
    // stored.
    const float* brow0 = nullptr;
    const float* brow1 = nullptr;
    if (kBias) {
      const int lr = c * kChunk + w * 16 + (lane >> 2);
      const float* bias_h = bias + static_cast<long long>(blk.h) * N * N;
      brow0 = bias_s(0) + lr * kDqBiasLd + span_shift(bias_h + static_cast<long long>(row0) * N);
      brow1 = bias_s(0) + (lr + 8) * kDqBiasLd +
              span_shift(bias_h + static_cast<long long>(row1) * N);
    }

    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    // this warpgroup's Q and dO rows as register A operands, for the whole
    // sweep (S and dP then read only K and V from shared memory)
    mbar_wait(&once, 0);
    uint32_t qf[4][4], df[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      load_a_sw128(qf[kk], q_s + c * kChunk * 64, w, lane, kk);
      load_a_sw128(df[kk], do_s + c * kChunk * 64, w, lane, kk);
    }
    if (c == 1) pass_turn(c);  // consumer 0 issues first
    for (int it = 0; it < tiles; ++it) {
      const int s = it % kBwdStages;
      mbar_wait(&full[s], (it / kBwdStages) & 1);
      const bf16* kt = k_s(s);
      const bf16* vt = v_s(s);
      float sc[8][4], dp[8][4];
      consumer_turn(c);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // S = Q K^T
        wgmma_rs<0>(sc, qf[kk], sw128_desc(kt + kk * 16), kk);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // dP = dO V^T
        wgmma_rs<0>(dp, df[kk], sw128_desc(vt + kk * 16), kk);
      wgmma_commit();
      pass_turn(c);

      // P = exp(S * scale (+ bias) - lse), 0 past N, while dP runs
      wgmma_wait<1>();
      fence_acc(sc);
      const int kv0 = it * kChunk;
      const long long boff = (bias_s(s) - bias_s(0));
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j * 8 + 2 * quad + (e & 1);
          float x = sc[j][e] * scale2;
          if (kBias) x += (e < 2 ? brow0 : brow1)[boff + col] * kLog2e;
          sc[j][e] = kv0 + col < N ? exp2f(x - (e < 2 ? lse0 : lse1)) : 0.f;
        }
      }
      // dS = P o (dP - delta)
      wgmma_wait<0>();
      fence_acc(dp);
      uint32_t ds[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] *= dp[j][e] - (e < 2 ? dl0 : dl1);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) pack_a(ds[kk], sc, kk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // dQ += dS K
        wgmma_rs<1>(acc, ds[kk], sw128_desc(kt + kk * 16 * 64));
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    store_rows<64>(dq + blk.b * dqs.b + blk.h * dqs.h, dqs.n, acc, row0, N, quad, scale);
  }
}

template <bool kBias>
__global__ void __launch_bounds__(kBwdThreads, 1) flash_bwd_dkdv_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const float* __restrict__ bias, bf16* __restrict__ dk, bf16* __restrict__ dv, int B, int H,
    int N, Strides dks, Strides dvs, float scale) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kBwdStages], empty[kBwdStages], once;
  uint8_t* sm = align1024(smem_raw);
  bf16* k_s = reinterpret_cast<bf16*>(sm);                   // [128, 64]
  bf16* v_s = reinterpret_cast<bf16*>(sm + 2 * kTileBytes);  // [128, 64]
  uint8_t* ring = sm + 4 * kTileBytes;
  // stage s: Q tile, dO tile, lse and delta [2][64], bias tile
  auto q_s = [&](int s) { return reinterpret_cast<bf16*>(ring + s * kTileBytes); };
  auto do_s = [&](int s) {
    return reinterpret_cast<bf16*>(ring + (kBwdStages + s) * kTileBytes);
  };
  auto vec_s = [&](int s) {
    return reinterpret_cast<float*>(ring + 2 * kBwdStages * kTileBytes + s * 2 * kVecLd * 4);
  };
  auto bias_s = [&](int s) {
    return reinterpret_cast<float*>(ring + 2 * kBwdStages * kTileBytes +
                                    kBwdStages * 2 * kVecLd * 4 + s * kDkdvBiasBytes);
  };

  const BwdBlock blk = bwd_block(B, N);
  const int k0 = blk.tile * kBwdRows;
  const int tiles = (N + kChunk - 1) / kChunk;
  const int bh = blk.b * H + blk.h;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(&full[s], kBias ? 2 : 1);  // one arrival per producer warp that copies
      mbar_init(&empty[s], 8);
    }
    mbar_init(&once, 1);
    mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= 8) {  // producer warpgroup
    warpgroup_regs_dec<kProducerRegs>();
    const int pt = threadIdx.x - 256;
    if (pt == 0) {
      mbar_expect_tx(&once, 4 * kTileBytes);
      tma_load_4d(k_s, &tk, 0, blk.h, k0, blk.b, &once);
      tma_load_4d(k_s + kChunk * 64, &tk, 0, blk.h, k0 + kChunk, blk.b, &once);
      tma_load_4d(v_s, &tv, 0, blk.h, k0, blk.b, &once);
      tma_load_4d(v_s + kChunk * 64, &tv, 0, blk.h, k0 + kChunk, blk.b, &once);
    }
    // with a bias, thread pt < 64 copies query row q0 + pt of each bias tile
    // (the keys k0 + [0, 128)); threads 1 and 2 copy the tile's lse and delta
    if (pt < (kBias ? kChunk : 32)) {
      const float* bias_hk =
          kBias ? bias + static_cast<long long>(blk.h) * N * N + k0 : nullptr;
      const float* vec = pt == 1 ? lse : pt == 2 ? delta : nullptr;
      if (vec != nullptr) vec += static_cast<long long>(bh) * N;
      for (int it = 0; it < tiles; ++it) {
        const int s = it % kBwdStages;
        mbar_wait(&empty[s], ((it / kBwdStages) & 1) ^ 1);
        const int q0 = it * kChunk;
        Span row{nullptr, 0}, vrow{nullptr, 0};
        if (kBias && q0 + pt < N)
          row = aligned_span(bias_hk + static_cast<long long>(q0 + pt) * N, min(kBwdRows, N - k0));
        if (vec != nullptr) vrow = aligned_span(vec + q0, min(kChunk, N - q0));
        warp_expect_tx(&full[s], row.bytes + vrow.bytes + (pt == 0 ? 2 * kTileBytes : 0), lane);
        if (pt == 0) {
          tma_load_4d(q_s(s), &tq, 0, blk.h, q0, blk.b, &full[s]);
          tma_load_4d(do_s(s), &tdo, 0, blk.h, q0, blk.b, &full[s]);
        }
        if (row.bytes != 0)
          bulk_load(bias_s(s) + pt * kDkdvBiasLd, row.src, row.bytes, &full[s]);
        if (vrow.bytes != 0)
          bulk_load(vec_s(s) + (pt - 1) * kVecLd, vrow.src, vrow.bytes, &full[s]);
      }
    }
  } else {  // consumer warpgroups c = 0, 1: keys k0 + 64 c + [0, 64)
    warpgroup_regs_inc<kConsumerRegs>();
    const int c = warp >> 2;
    const int w = warp & 3;
    const int quad = lane & 3;
    // this lane's two keys (accumulator rows lane/4 and lane/4 + 8)
    const int key0 = k0 + c * kChunk + w * 16 + (lane >> 2);
    const int key1 = key0 + 8;
    const float scale2 = scale * kLog2e;

    float dka[8][4], dva[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      dka[j][0] = dka[j][1] = dka[j][2] = dka[j][3] = 0.f;
      dva[j][0] = dva[j][1] = dva[j][2] = dva[j][3] = 0.f;
    }
    const float* lse_bh = lse + static_cast<long long>(bh) * N;
    const float* dl_bh = delta + static_cast<long long>(bh) * N;
    // the bias tile's rows land span_shift(row) floats in; for query
    // q0 + qi that is (that of q0 + qi * N) mod 4, and over this lane's
    // queries qi = 8 j + 2 quad + e it takes two values, e = 0 and 1
    const float* bias_h = kBias ? bias + static_cast<long long>(blk.h) * N * N : nullptr;
    const int lk = c * kChunk + w * 16 + (lane >> 2);  // this lane's first key in the block
    // this warpgroup's K and V rows as register A operands, for the whole
    // sweep (S^T and dP^T then read only Q and dO from shared memory)
    mbar_wait(&once, 0);
    if (c == 1) pass_turn(c);  // consumer 0 issues first
    const bf16* ka = k_s + c * kChunk * 64;
    const bf16* va = v_s + c * kChunk * 64;
    for (int it = 0; it < tiles; ++it) {
      const int s = it % kBwdStages;
      mbar_wait(&full[s], (it / kBwdStages) & 1);
      const bf16* qt = q_s(s);
      const bf16* dt = do_s(s);
      float st[8][4], dpt[8][4];
      consumer_turn(c);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // S^T = K Q^T
        wgmma_ss<0>(st, sw128_desc(ka + kk * 16), sw128_desc(qt + kk * 16), kk);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // dP^T = V dO^T
        wgmma_ss<0>(dpt, sw128_desc(va + kk * 16), sw128_desc(dt + kk * 16), kk);
      wgmma_commit();
      pass_turn(c);

      const int q0 = it * kChunk;
      const float* lse_v = vec_s(s) + span_shift(lse_bh + q0);
      const float* dl_v = vec_s(s) + kVecLd + span_shift(dl_bh + q0);
      const float* bs[2] = {nullptr, nullptr};
      if (kBias) {
        const int s0 = span_shift(bias_h + static_cast<long long>(q0) * N);
#pragma unroll
        for (int e = 0; e < 2; ++e)
          bs[e] = bias_s(s) + lk + ((s0 + (2 * quad + e) * N) & 3);
      }

      // lse (exp2 domain) of this lane's queries; past N they are never used
      float ls[8][2];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        ls[j][0] = lse_v[j * 8 + 2 * quad] * kLog2e;
        ls[j][1] = lse_v[j * 8 + 2 * quad + 1] * kLog2e;
      }

      // P^T, 0 past N on either side, while dP^T runs; then dV += P^T dO
      wgmma_wait<1>();
      fence_acc(st);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = j * 8 + 2 * quad + (e & 1);
          const int key = e < 2 ? key0 : key1;
          float x = st[j][e] * scale2;
          if (kBias) x += bs[e & 1][qi * kDkdvBiasLd + (e < 2 ? 0 : 8)] * kLog2e;
          st[j][e] = (q0 + qi < N && key < N) ? exp2f(x - ls[j][e & 1]) : 0.f;
        }
      }
      uint32_t pa[4][4], da[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) pack_a(pa[kk], st, kk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // dV += P^T dO
        wgmma_rs<1>(dva, pa[kk], sw128_desc(dt + kk * 16 * 64));
      wgmma_commit();

      // dS^T = P^T o (dP^T - delta) while dV runs; then dK += dS^T Q. The
      // delta of queries past N (copied from beyond the row) is set to 0 in
      // a branch of its own: a condition on every load costs the sweep a
      // fifth of its time.
      float dl[8][2];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        dl[j][0] = dl_v[j * 8 + 2 * quad];
        dl[j][1] = dl_v[j * 8 + 2 * quad + 1];
      }
      if (q0 + kChunk > N) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (q0 + j * 8 + 2 * quad + e >= N) dl[j][e] = 0.f;
      }
      wgmma_wait<1>();
      fence_acc(dpt);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) dpt[j][e] = st[j][e] * (dpt[j][e] - dl[j][e & 1]);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) pack_a(da[kk], dpt, kk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // dK += dS^T Q
        wgmma_rs<1>(dka, da[kk], sw128_desc(qt + kk * 16 * 64));
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(dka);
      fence_acc(dva);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    store_rows<64>(dk + blk.b * dks.b + blk.h * dks.h, dks.n, dka, key0, N, quad, scale);
    store_rows<64>(dv + blk.b * dvs.b + blk.h * dvs.h, dvs.n, dva, key0, N, quad, 1.f);
  }
}

// cuTensorMapEncodeTiled, a driver function, found through the runtime so
// the library needs no link against libcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
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

// A 4-d tensor map over a bf16 [B, N, H, 64] tensor with element strides s
// (dims innermost first: d, h, n, b), box one head's [64 rows, 64], 128-byte
// swizzle, zeros past the extent. TMA needs a 16-byte-aligned base and byte
// strides that are multiples of 16 (the wrapper's _check_rows).
bool encode_rows(CUtensorMap* map, const void* base, int B, int N, int H, Strides s) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {64, static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s.h) * 2,
                                 static_cast<cuuint64_t>(s.n) * 2,
                                 static_cast<cuuint64_t>(s.b) * 2};
  const cuuint32_t box[4] = {64, 1, kChunk, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the four tensor maps of q, k, v, dout (s[0], s[1], s[2], s[dout])
bool encode_qkvdo(CUtensorMap (&m)[4], const void* q, const void* k, const void* v,
                  const void* dout, int B, int N, int H, const Strides* s, int dout_at) {
  return encode_rows(&m[0], q, B, N, H, s[0]) && encode_rows(&m[1], k, B, N, H, s[1]) &&
         encode_rows(&m[2], v, B, N, H, s[2]) && encode_rows(&m[3], dout, B, N, H, s[dout_at]);
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
// dim contiguous, 16-byte aligned base and strides: q, k, v and dout are
// read by TMA); dq: bf16 [B, N, H, D] with strides[15..17]; lse: fp32
// [B*H, N] from the forward; bias: fp32 [H, N, N] contiguous or null; delta:
// fp32 [B*H, N], written. Returns a cudaError_t code.
int flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                           const void* dout, const void* lse, const void* bias, void* delta,
                           void* dq, int B, int N, int H, int D, const long long* strides,
                           float scale, void* stream) {
  if (B < 1 || H < 1 || N < 1 || D != 64) return static_cast<int>(cudaErrorInvalidValue);
  Strides s[6];
  for (int t = 0; t < 6; ++t)
    s[t] = Strides{strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
  CUtensorMap maps[4];
  if (!encode_qkvdo(maps, q, k, v, dout, B, N, H, s, 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool with_bias = bias != nullptr;
  const auto kernel = with_bias ? flash_bwd_dq_kernel<true> : flash_bwd_dq_kernel<false>;
  const int smem = dq_smem_bytes(with_bias);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = B * H * ((N + kBwdRows - 1) / kBwdRows);
  kernel<<<blocks, kBwdThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const bf16*>(o),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(bias), static_cast<float*>(delta), static_cast<bf16*>(dq), B, H,
      N, s[3], s[4], s[5], scale);
  return static_cast<int>(cudaGetLastError());
}

// The dkdv kernel of the backward, launched after the dq kernel (it reads
// the delta that one wrote). q, k, v, dout: bf16 [B, N, H, D] with
// strides[0..11] (read by TMA, as above); dk, dv: bf16 [B, N, H, D] with
// strides[12..17]; lse, delta: fp32 [B*H, N]; bias: fp32 [H, N, N]
// contiguous or null. Returns a cudaError_t code.
int flash_attention_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, const void* bias, void* dk,
                             void* dv, int B, int N, int H, int D, const long long* strides,
                             float scale, void* stream) {
  if (B < 1 || H < 1 || N < 1 || D != 64) return static_cast<int>(cudaErrorInvalidValue);
  Strides s[6];
  for (int t = 0; t < 6; ++t)
    s[t] = Strides{strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
  CUtensorMap maps[4];
  if (!encode_qkvdo(maps, q, k, v, dout, B, N, H, s, 3))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool with_bias = bias != nullptr;
  const auto kernel = with_bias ? flash_bwd_dkdv_kernel<true> : flash_bwd_dkdv_kernel<false>;
  const int smem = dkdv_smem_bytes(with_bias);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = B * H * ((N + kBwdRows - 1) / kBwdRows);
  kernel<<<blocks, kBwdThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const float*>(bias), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), B, H, N, s[4], s[5], scale);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of the dq (which = 0) or dkdv (1) kernel, with or
// without a bias, in bytes; for the build report.
int flash_attention_bwd_smem_bytes(int which, int with_bias) {
  return which == 0 ? dq_smem_bytes(with_bias != 0) : dkdv_smem_bytes(with_bias != 0);
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
