// Blockwise (flash) attention, forward and backward, for Hopper (sm_90a),
// plain C interface: the forward, then the backward's dq, dkdv and dbias
// kernels. Each kernel's own notes are above it.
//
// Every kernel has the same Hopper shape: a block of three warpgroups, two
// consumers that each own 64 rows of the block's 128 and one producer
// (setmaxnreg: 232 registers a consumer thread, 40 a producer one). The
// producer keeps a ring of stages in flight (three; four in the forward
// without a bias): its first thread loads the streamed bf16 tiles by TMA
// (4-d tensor maps over the [B, N, H, D] strides, so the fused projection's
// slices are read in place, 128-byte swizzled, rows past N zero-filled), and
// its other threads copy the fp32 rows that no tensor map can describe (the
// [B*H, N] and [H, N, N] rows have an odd pitch at N = 4097) with one bulk
// copy each, of the 16-byte-aligned span that covers the row (aligned_span);
// each stage completes on a "full" mbarrier and is handed back on an "empty"
// one. The consumers run every product as wgmma m64n64k16 or m64n128k16
// (bf16 in, fp32 accumulate, helpers in hopper_mma.cuh); in the backward
// they take turns to issue their products (two named barriers), so one
// warpgroup's elementwise work runs while the other's products do. Sums stay
// in fp32 registers, each written once: no atomics, so every output is the
// same bits from run to run. The ragged edge is masked in the kernels, with
// no padded copies: keys past N get P = 0 (the TPU kernels' finite -1e30
// score), and query rows past N read as zeros and are never stored.

#include <type_traits>

#include "hopper_mma.cuh"

namespace {

constexpr int kStages = 3;
constexpr int kBlockRows = 2 * kChunk;             // rows of a block: two consumers
constexpr int kBlockThreads = 3 * 128;             // two consumer warpgroups, one producer
constexpr int kTileBytes = kChunk * 64 * 2;        // one bf16 [64, 64] tile
constexpr int kDkdvBiasLd = kBlockRows + 4;        // [64 queries][128 keys], read transposed
constexpr int kVecLd = kChunk + 8;                 // lse or delta of a query tile, fp32
constexpr int kDkdvBiasBytes = kChunk * kDkdvBiasLd * 4;
constexpr int kConsumerRegs = 232;
constexpr int kProducerRegs = 40;

// block -> (b, h, row tile), b fastest, then the tile, then the head: the B
// blocks that read one head's bias tiles run together, and L2 serves all but
// the first, so the bias crosses HBM about once a kernel
struct RowBlock {
  int b, h, tile;
};
__device__ __forceinline__ RowBlock row_block(int x, int B, int N) {
  const int tiles = (N + kBlockRows - 1) / kBlockRows;
  const int rest = x / B;
  return RowBlock{x - rest * B, rest / tiles, rest - (rest / tiles) * tiles};
}

// The two consumers take turns to issue their products (named barriers 1
// and 2 over both warpgroups), so one runs its elementwise work while the
// other's products run, rather than both waiting on the tensor cores at
// once and then both leaving them idle.
__device__ __forceinline__ void consumer_turn(int c) { named_barrier_sync(1 + c, 256); }
__device__ __forceinline__ void pass_turn(int c) { named_barrier_arrive(2 - c, 256); }

// The ring of a block that owns 128 query rows and streams key tiles of K
// and V (the forward, the dq kernel and, without its bias tiles, the dbias
// kernel): kSt stages, each a K and a V tile of kKeys rows (kKeys / 64 TMA
// boxes each) and, with a bias, the block's [128, kKeys] bias tile.
template <int kKeys, int kSt>
struct KvRing {
  static_assert(kKeys == 64 || kKeys == 128, "a key tile is one or two TMA boxes");
  static constexpr int kKeyTile = kKeys;
  static constexpr int kTile = kKeys * 64 * 2;  // bytes of a K or V tile
  static constexpr int kBiasLd = kKeys + 8;     // row pitch of the bias tile, floats
  static constexpr int kBiasBytes = kBlockRows * kBiasLd * 4;
  static constexpr int kDepth = kSt;
  static constexpr int bytes(bool bias) { return kSt * (2 * kTile + (bias ? kBiasBytes : 0)); }
  uint8_t* base;
  __device__ __forceinline__ bf16* k(int s) const {
    return reinterpret_cast<bf16*>(base + s * kTile);
  }
  __device__ __forceinline__ bf16* v(int s) const {
    return reinterpret_cast<bf16*>(base + (kSt + s) * kTile);
  }
  __device__ __forceinline__ float* bias(int s) const {
    return reinterpret_cast<float*>(base + 2 * kSt * kTile + s * kBiasBytes);
  }
};

// the dq and dbias kernels' ring: 64-key tiles
using DqRing = KvRing<kChunk, kStages>;

// The producer warpgroup's sweep of that ring over one row block, the ring's
// count at its first tile it0: thread 0 loads each stage's K and V tiles by
// TMA (rows past N as zeros); with a bias, thread pt also copies query row
// r0 + pt of the stage's bias tile, the 16-byte-aligned span around its keys,
// by one bulk copy (full[s] then expects one arrival per producer warp, else
// one).
template <bool kBias, int kKeys, int kSt>
__device__ __forceinline__ void produce_kv(const CUtensorMap* tk, const CUtensorMap* tv,
                                           const float* bias, RowBlock blk, int r0, int N,
                                           KvRing<kKeys, kSt> ring, uint64_t* full,
                                           uint64_t* empty, int it0, int pt, int lane) {
  if (!kBias && pt >= 32) return;
  const int tiles = (N + kKeys - 1) / kKeys;
  const int qr = r0 + pt;
  const float* bias_row =
      kBias && qr < N ? bias + (static_cast<long long>(blk.h) * N + qr) * N : nullptr;
  for (int t = 0; t < tiles; ++t) {
    const int it = it0 + t;
    const int s = it % kSt;
    mbar_wait(&empty[s], ((it / kSt) & 1) ^ 1);
    const int kv0 = t * kKeys;
    Span row{nullptr, 0};
    if (bias_row != nullptr) row = aligned_span(bias_row + kv0, min(kKeys, N - kv0));
    warp_expect_tx(&full[s], row.bytes + (pt == 0 ? 2 * ring.kTile : 0), lane);
    if (pt == 0) {
#pragma unroll
      for (int x = 0; x < kKeys; x += kChunk) {
        tma_load_4d(ring.k(s) + x * 64, tk, 0, blk.h, kv0 + x, blk.b, &full[s]);
        tma_load_4d(ring.v(s) + x * 64, tv, 0, blk.h, kv0 + x, blk.b, &full[s]);
      }
    }
    if (row.bytes != 0) bulk_load(ring.bias(s) + pt * ring.kBiasLd, row.src, row.bytes, &full[s]);
  }
}

// A consumer lane's two query rows of the bias tile in the ring's stage 0
// (the producer's bulk copy of row r lands span_shift floats in; stage s is
// ring.bias(s) - ring.bias(0) floats on). Rows past N are not copied: they
// read stale values, which reach only their own output rows, never stored.
struct BiasRows {
  const float* r0;
  const float* r1;
};
template <int kKeys, int kSt>
__device__ __forceinline__ BiasRows bias_rows(KvRing<kKeys, kSt> ring, const float* bias, int h,
                                              int N, int lr, int row0) {
  const float* bias_h = bias + static_cast<long long>(h) * N * N;
  return BiasRows{ring.bias(0) + lr * ring.kBiasLd +
                      span_shift(bias_h + static_cast<long long>(row0) * N),
                  ring.bias(0) + (lr + 8) * ring.kBiasLd +
                      span_shift(bias_h + static_cast<long long>(row0 + 8) * N)};
}

// The forward's rings, as measured (PERF.md): without a bias 128 keys a
// tile (S one m64n128 product) and four stages; with one the dq kernel's
// ring, 64 keys and three stages (the [128, 64] fp32 bias tile is the larger
// part of a stage, and 128 keys would leave room for two stages only).
template <bool kBias>
using FwdRing = std::conditional_t<kBias, DqRing, KvRing<2 * kChunk, 4>>;

// Forward. Replaces layoutdit_tpu/ops/flash_attention.py::_fwd_kernel and
// _fwd_kernel_nobias (via _flash_fwd): o = softmax(q k^T * scale (+ bias)) v
// with an optional additive bias [H, N, N], and the per-row log-sum-exp,
// fp32 [B*H, N] in the natural-log domain (the backward kernels read it).
// The 1024 px bucket and the windowed train step run it at B=4, H=12,
// N=4097, D=64 without a bias; the rel-pos step with one, there and at B=64,
// N=256 (its 16 x 16 windows).
//
// Bound on the H100: operations. 4*B*H*N^2*D = 206 GFLOP against 100 MB of
// Q/K/V/O (0.21 ms at the bf16 peak); a bias adds 806 MB of fp32 reads
// (0.24 ms at 3.35 TB/s), which the products could hide, but its copy into
// shared memory, 128 bulk copies of a row span a stage, bounds the kernel
// with a bias (PERF.md). At D = 64 the softmax's exponentials cost as much
// time on the SM's special-function units as the two products on the tensor
// cores, so the design overlaps them:
// a block owns 128 query rows (Q loaded once, held by each consumer as its
// register A operand for the whole sweep) and streams the key tiles of K and
// V, and with a bias the block's bias tile, through the ring: 128 keys a tile
// without a bias (S one m64n128 product), 64 with one (its [128, 64] fp32
// tile is the larger part of a stage, and 128 keys would leave room for two
// stages only), as measured (PERF.md). Each consumer keeps the
// online softmax of its 64 rows in registers, in the exp2 domain: S = Q K^T
// by wgmma, then P = exp2(S * scale (+ bias) - m) with the running max m and
// sum l, O rescaled, and O += P V with P packed as the register A operand
// and V read down its rows. Each step issues the next tile's S and this
// tile's P V together, so the softmax of tile t + 1 runs while P V of tile t
// is on the tensor cores. At the end each consumer normalises O, writes it as
// bf16 through the caller's strides and stores lse for rows below N. The
// grid is persistent, one block an SM looping over the row blocks: the
// producer loads the next row block's Q as soon as the consumers hold the
// last one in registers, and the ring runs on from one row block to the
// next, so each row block's start and end overlap its neighbours' sweeps.
template <bool kBias>
__global__ void __launch_bounds__(kBlockThreads, 1) flash_fwd_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const float* __restrict__ bias,
    bf16* __restrict__ o, float* __restrict__ lse, int B, int H, int N, Strides os,
    float scale) {
  using Ring = FwdRing<kBias>;
  constexpr int kSt = Ring::kDepth;
  constexpr int kKeys = Ring::kKeyTile;
  constexpr int kJ = kKeys / 8;  // n-tiles of a score tile
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kSt], empty[kSt], q_full, q_empty;
  uint8_t* sm = align1024(smem_raw);
  bf16* q_s = reinterpret_cast<bf16*>(sm);  // [128, 64]
  const Ring ring{sm + 2 * kTileBytes};

  // persistent: block x takes the row blocks x, x + gridDim.x, ..., the
  // ring's stages and phases running on from one to the next
  const int blocks = B * H * ((N + kBlockRows - 1) / kBlockRows);
  const int tiles = (N + kKeys - 1) / kKeys;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kSt; ++s) {
      mbar_init(&full[s], kBias ? 4 : 1);  // one arrival per producer warp that copies
      mbar_init(&empty[s], 8);             // one arrival per consumer warp
    }
    mbar_init(&q_full, 1);
    mbar_init(&q_empty, 8);
    mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= 8) {  // producer warpgroup
    warpgroup_regs_dec<kProducerRegs>();
    const int pt = threadIdx.x - 256;
    for (int x = blockIdx.x, n = 0; x < blocks; x += gridDim.x, ++n) {
      const RowBlock blk = row_block(x, B, N);
      const int r0 = blk.tile * kBlockRows;
      if (pt == 0) {  // Q as soon as the consumers hold the last block's
        mbar_wait(&q_empty, (n & 1) ^ 1);
        mbar_expect_tx(&q_full, 2 * kTileBytes);
        tma_load_4d(q_s, &tq, 0, blk.h, r0, blk.b, &q_full);
        tma_load_4d(q_s + kChunk * 64, &tq, 0, blk.h, r0 + kChunk, blk.b, &q_full);
      }
      produce_kv<kBias>(&tk, &tv, bias, blk, r0, N, ring, full, empty, n * tiles, pt, lane);
    }
  } else {  // consumer warpgroups c = 0, 1: query rows r0 + 64 c + [0, 64)
    warpgroup_regs_inc<kConsumerRegs>();
    const int c = warp >> 2;
    const int w = warp & 3;
    const int quad = lane & 3;
    const int lr = c * kChunk + w * 16 + (lane >> 2);  // this lane's first row in the block
    const float scale2 = scale * kLog2e;
    const bf16* qa = q_s + c * kChunk * 64;  // this warpgroup's Q rows
    // without a bias and with a positive scale the softmax takes the max of
    // the raw scores and folds the scale into the exponent's multiply-add
    const bool fold = !kBias && scale2 > 0.f;

    for (int x = blockIdx.x, n = 0; x < blocks; x += gridDim.x, ++n) {
      const RowBlock blk = row_block(x, B, N);
      const int row0 = blk.tile * kBlockRows + lr;
      const BiasRows br = kBias ? bias_rows(ring, bias, blk.h, N, lr, row0) : BiasRows{};
      const int it0 = n * tiles;  // the ring's count at this block's first tile

      float acc[8][4], sc[kJ][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      // running max (exp2 domain) and per-lane partial sum of this lane's rows
      float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, corr[2];
      uint32_t qf[4][4], pa[kJ / 2][4];
      mbar_wait(&q_full, n & 1);
      // Q into registers, its buffer back to the producer
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) load_a_sw128(qf[kk], qa, w, lane, kk);
      __syncwarp();
      if (lane == 0) mbar_arrive(&q_empty);

      // S = Q K^T of the tile in stage s (issued, not waited for)
      auto issue_s = [&](int s) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs<0>(sc, qf[kk], sw128_desc(ring.k(s) + kk * 16), kk);
        wgmma_commit();
      };
      // the softmax of the tile in stage s, keys from kv0: sc becomes P
      auto softmax = [&](int s, int kv0) {
        if (!fold) {
          const long long boff = ring.bias(s) - ring.bias(0);
#pragma unroll
          for (int j = 0; j < kJ; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float v = sc[j][e] * scale2;
              if (kBias)
                v = fmaf((e < 2 ? br.r0 : br.r1)[boff + j * 8 + 2 * quad + (e & 1)], kLog2e, v);
              sc[j][e] = v;
            }
          }
        }
        if (kv0 + kKeys > N) {  // the last tile: keys past N (a branch of its own)
#pragma unroll
          for (int j = 0; j < kJ; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (kv0 + j * 8 + 2 * quad + (e & 1) >= N) sc[j][e] = kNegInf;
        }
        float mx[2] = {kNegInf, kNegInf};
#pragma unroll
        for (int j = 0; j < kJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float mn = fmaxf(m[r], quad_max(mx[r]) * (fold ? scale2 : 1.f));
          corr[r] = exp2_ftz(m[r] - mn);
          m[r] = mn;
        }
        float ps[2] = {0.f, 0.f};
        if (fold) {
#pragma unroll
          for (int j = 0; j < kJ; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              sc[j][e] = exp2_ftz(fmaf(sc[j][e], scale2, -m[e >> 1]));
              ps[e >> 1] += sc[j][e];
            }
          }
        } else {
#pragma unroll
          for (int j = 0; j < kJ; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              sc[j][e] = exp2_ftz(sc[j][e] - m[e >> 1]);
              ps[e >> 1] += sc[j][e];
            }
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + ps[r];
      };

      // O += P V of the tile in stage s (issued, not waited for)
      auto issue_pv = [&](int s) {
#pragma unroll
        for (int kk = 0; kk < kJ / 2; ++kk)
          wgmma_rs<1>(acc, pa[kk], sw128_desc(ring.v(s) + kk * 16 * 64));
        wgmma_commit();
      };
      // the registers of the products about to be issued are final before
      // the fence (else the compiler may move their last writes past it)
      auto fence_operands = [&] {
        fence_acc(acc);
        fence_frag(pa);
        wgmma_fence();
      };

      // S of the first tile; then each step issues the next tile's S and
      // this tile's P V, and the next softmax runs while P V does. The last
      // tile's P V is issued apart, so every step of the loop commits the
      // same two groups (the compiler serialises the products when it
      // cannot tell which group a wait retires).
      mbar_wait(&full[it0 % kSt], (it0 / kSt) & 1);
      wgmma_fence();
      issue_s(it0 % kSt);
      wgmma_wait<0>();
      fence_acc(sc);
      softmax(it0 % kSt, 0);
#pragma unroll
      for (int kk = 0; kk < kJ / 2; ++kk) pack_a(pa[kk], sc, kk);
      for (int t = 0; t + 1 < tiles; ++t) {
        const int it = it0 + t;
        const int s = it % kSt;
        const int sn = (it + 1) % kSt;
        mbar_wait(&full[sn], ((it + 1) / kSt) & 1);
        fence_operands();
        issue_s(sn);
        issue_pv(s);
        wgmma_wait<1>();
        fence_acc(sc);
        softmax(sn, (t + 1) * kKeys);
        wgmma_wait<0>();
        fence_acc(acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[j][0] *= corr[0];
          acc[j][1] *= corr[0];
          acc[j][2] *= corr[1];
          acc[j][3] *= corr[1];
        }
#pragma unroll
        for (int kk = 0; kk < kJ / 2; ++kk) pack_a(pa[kk], sc, kk);
      }
      const int s_last = (it0 + tiles - 1) % kSt;
      fence_operands();
      issue_pv(s_last);
      wgmma_wait<0>();
      fence_acc(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s_last]);

      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] = fmaxf(quad_sum(l[r]), 1e-30f);
        inv[r] = 1.f / l[r];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[j][0] *= inv[0];
        acc[j][1] *= inv[0];
        acc[j][2] *= inv[1];
        acc[j][3] *= inv[1];
      }
      store_rows<64>(o + blk.b * os.b + blk.h * os.h, os.n, acc, row0, N, quad, 1.f);
      if (quad == 0) {
        float* lse_bh = lse + static_cast<long long>(blk.b * H + blk.h) * N;
        if (row0 < N) lse_bh[row0] = (m[0] + log2f(l[0])) * kLn2;
        if (row0 + 8 < N) lse_bh[row0 + 8] = (m[1] + log2f(l[1])) * kLn2;
      }
    }
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
// once: no atomics. (The FlashAttention-2 single kernel adds dQ across key
// blocks with fp32 atomics, whose order, and so whose last bits, change
// between runs.) The price is that S and dP are computed in both kernels: 7
// products, not 5. Both run S and dP with the streamed tile as B (the dq
// kernel holds its Q and dO rows as register A operands for the whole
// sweep, the dkdv kernel reads K and V from shared memory), then P or dS as
// the register A operand of the gradient products, the tile as B read down
// its rows. They overlap the elementwise work of a tile with its products:
// P is formed while dP runs, and dS while the first gradient product runs.
// The gradients are rounded to bf16 once, written through the caller's
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
// over the banks (the dkdv kernel reads it transposed). In the dq kernel
// query rows past N read as zeros and their dS reaches only their own dQ
// rows, which are not stored; in the dkdv kernel their P and delta are set
// to 0, so they add nothing. No other fp32 value a span copies beyond a row
// is used.

// dynamic shared memory of each kernel, 1024 bytes of alignment slack
// included: the block's own 128 rows of one or two operands, then the ring
constexpr int fwd_smem_bytes(bool bias) {
  return 1024 + 2 * kTileBytes + (bias ? FwdRing<true>::bytes(true) : FwdRing<false>::bytes(false));
}
constexpr int dq_smem_bytes(bool bias) {
  return 1024 + 4 * kTileBytes + DqRing::bytes(bias);
}
constexpr int dkdv_smem_bytes(bool bias) {
  return 1024 + 4 * kTileBytes +
         kStages * (2 * kTileBytes + 2 * kVecLd * 4 + (bias ? kDkdvBiasBytes : 0));
}

template <bool kBias>
__global__ void __launch_bounds__(kBlockThreads, 1) flash_bwd_dq_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
    const bf16* __restrict__ o, const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ bias, float* __restrict__ delta, bf16* __restrict__ dq, int B,
    int H, int N, Strides os, Strides dos, Strides dqs, float scale) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages], once;
  uint8_t* sm = align1024(smem_raw);
  bf16* q_s = reinterpret_cast<bf16*>(sm);                   // [128, 64]
  bf16* do_s = reinterpret_cast<bf16*>(sm + 2 * kTileBytes);  // [128, 64]
  const DqRing ring{sm + 4 * kTileBytes};

  const RowBlock blk = row_block(blockIdx.x, B, N);
  const int r0 = blk.tile * kBlockRows;
  const int tiles = (N + kChunk - 1) / kChunk;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
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
    produce_kv<kBias>(&tk, &tv, bias, blk, r0, N, ring, full, empty, 0, pt, lane);
  } else {  // consumer warpgroups c = 0, 1: query rows r0 + 64 c + [0, 64)
    warpgroup_regs_inc<kConsumerRegs>();
    const int c = warp >> 2;
    const int w = warp & 3;
    const int quad = lane & 3;
    const int lr = c * kChunk + w * 16 + (lane >> 2);  // this lane's first row in the block
    const int row0 = r0 + lr;
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

    const BiasRows br = kBias ? bias_rows(ring, bias, blk.h, N, lr, row0) : BiasRows{};

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
      const int s = it % kStages;
      mbar_wait(&full[s], (it / kStages) & 1);
      const bf16* kt = ring.k(s);
      const bf16* vt = ring.v(s);
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
      const long long boff = ring.bias(s) - ring.bias(0);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j * 8 + 2 * quad + (e & 1);
          float x = sc[j][e] * scale2;
          if (kBias) x += (e < 2 ? br.r0 : br.r1)[boff + col] * kLog2e;
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
__global__ void __launch_bounds__(kBlockThreads, 1) flash_bwd_dkdv_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const float* __restrict__ bias, bf16* __restrict__ dk, bf16* __restrict__ dv, int B, int H,
    int N, Strides dks, Strides dvs, float scale) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages], once;
  uint8_t* sm = align1024(smem_raw);
  bf16* k_s = reinterpret_cast<bf16*>(sm);                   // [128, 64]
  bf16* v_s = reinterpret_cast<bf16*>(sm + 2 * kTileBytes);  // [128, 64]
  uint8_t* ring = sm + 4 * kTileBytes;
  // stage s: Q tile, dO tile, lse and delta [2][64], bias tile
  auto q_s = [&](int s) { return reinterpret_cast<bf16*>(ring + s * kTileBytes); };
  auto do_s = [&](int s) {
    return reinterpret_cast<bf16*>(ring + (kStages + s) * kTileBytes);
  };
  auto vec_s = [&](int s) {
    return reinterpret_cast<float*>(ring + 2 * kStages * kTileBytes + s * 2 * kVecLd * 4);
  };
  auto bias_s = [&](int s) {
    return reinterpret_cast<float*>(ring + 2 * kStages * kTileBytes +
                                    kStages * 2 * kVecLd * 4 + s * kDkdvBiasBytes);
  };

  const RowBlock blk = row_block(blockIdx.x, B, N);
  const int k0 = blk.tile * kBlockRows;
  const int tiles = (N + kChunk - 1) / kChunk;
  const int bh = blk.b * H + blk.h;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
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
        const int s = it % kStages;
        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        const int q0 = it * kChunk;
        Span row{nullptr, 0}, vrow{nullptr, 0};
        if (kBias && q0 + pt < N)
          row = aligned_span(bias_hk + static_cast<long long>(q0 + pt) * N,
                             min(kBlockRows, N - k0));
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
      const int s = it % kStages;
      mbar_wait(&full[s], (it / kStages) & 1);
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
// a bias [H, N, N] shared by the batch (BEiT's relative-position bias), from
// q, k, v, dO, the forward's lse, the delta the dq kernel writes (launched
// before it on the same stream) and the bias. The high-res rel-pos train
// step runs it at B=4, N=4097 (the global layers) and at B=64, N=256 (16 x
// 16 windows), H=12, D=64.
//
// Bound on the H100: bytes. The fp32 bias read and dbias written are
// 2*H*N^2*4 = 1.61 GB at N=4097 (0.48 ms at 3.35 TB/s) against 4*B*H*N^2*D
// = 206 GFLOP for S and dP (0.21 ms at the bf16 peak). A block owns one
// head's 128 query rows (64 a consumer) and sweeps one or more 64-key tiles
// (tiles_per_block: the whole row at N = 4097, one tile at the window
// shape, so that the grid fills the card) and, inside each key tile, the
// batch in order. Where the block's Q and dO rows, lse and delta for every b
// fit in shared memory (kResident: B <= 4, 128 KB at B = 4), they are loaded
// once and only K_b and V_b stream through the ring (about 1.7 GB through
// L2 at N = 4097, against 6.6 GB when every tile reloaded all four); else
// (the window shape, B = 64) Q_b, dO_b, lse_b and delta_b stream with them.
// The bias tile comes once a key tile, by bulk copies, into a buffer of its
// own: the consumers take it into registers (exp2 domain) and hand it back
// at once, so the next tile's copy runs under this tile's batch sweep. Per b
// each consumer runs S = Q K^T and dP = dO V^T as wgmma with both operands
// in shared memory, forms P = exp2(S * scale + bias - lse) while dP runs,
// and adds dS = P o (dP - delta) into fp32 registers, b in a fixed order:
// no atomics, so dbias is the same bits every run. Each bias element is
// read once and each dbias element written once, a warp's rows as stores of
// 128 contiguous bytes (the values handed across the warp by shuffles); the
// rows and keys past N (zero K rows, stale bias and lse) are never stored.
constexpr int kVecPitch = kBlockRows + 8;  // lse or delta of a row block, span slack included
constexpr int kVecBytes = 2 * kVecPitch * 4;

// dynamic shared memory of the dbias kernel: the Q and dO rows of `slots`
// batch elements (all B when resident, else one a ring stage), the K and V
// ring, the bias tile, then lse and delta of each slot
constexpr int dbias_smem_bytes(int slots) {
  return 1024 + (4 * slots + 2 * kStages) * kTileBytes + DqRing::kBiasBytes + slots * kVecBytes;
}

template <bool kResident>
__global__ void __launch_bounds__(kBlockThreads, 1) flash_bwd_dbias_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const float* __restrict__ bias, float* __restrict__ dbias, int B, int H, int N,
    int tiles_per_block, float scale) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages], once, bias_full, bias_empty;
  uint8_t* sm = align1024(smem_raw);
  const int slots = kResident ? B : kStages;
  // slot i: Q and dO rows [128, 64] each, lse and delta [2][kVecPitch]
  auto q_s = [&](int i) { return reinterpret_cast<bf16*>(sm + i * 2 * kTileBytes); };
  auto do_s = [&](int i) { return reinterpret_cast<bf16*>(sm + (slots + i) * 2 * kTileBytes); };
  const DqRing ring{sm + 4 * slots * kTileBytes};  // K and V tiles; the bias tile apart
  constexpr int kBiasLd = DqRing::kBiasLd;
  float* bias_t = reinterpret_cast<float*>(ring.base + 2 * kStages * kTileBytes);  // [128][kBiasLd]
  auto vec_s = [&](int i) { return bias_t + kBlockRows * kBiasLd + i * 2 * kVecPitch; };

  // block -> (row block, key group, head), the row block fastest: the
  // blocks that read one head's K and V run together
  const int rbs = (N + kBlockRows - 1) / kBlockRows;
  const int tiles = (N + kChunk - 1) / kChunk;
  const int groups = (tiles + tiles_per_block - 1) / tiles_per_block;
  const int rb = blockIdx.x % rbs;
  const int g = (blockIdx.x / rbs) % groups;
  const int h = blockIdx.x / (rbs * groups);
  const int r0 = rb * kBlockRows;
  const int t0 = g * tiles_per_block;
  const int t1 = min(tiles, t0 + tiles_per_block);
  const int nrows = min(kBlockRows, N - r0);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_init(&once, 1);
    mbar_init(&bias_full, 4);  // one arrival per producer warp
    mbar_init(&bias_empty, 8);
    mbar_init_fence();
  }
  __syncthreads();

  // the first of this row block's lse (or delta) values of batch element b
  auto vec_row = [&](const float* vec, int b) {
    return vec + (static_cast<long long>(b) * H + h) * N + r0;
  };
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= 8) {  // producer warpgroup
    warpgroup_regs_dec<kProducerRegs>();
    const int pt = threadIdx.x - 256;
    // thread 0: the Q and dO rows, lse and delta of batch element b into
    // slot i, completing on bar (rows_bytes(b) bytes)
    auto rows_bytes = [&](int b) {
      return 4 * kTileBytes + aligned_span(vec_row(lse, b), nrows).bytes +
             aligned_span(vec_row(delta, b), nrows).bytes;
    };
    auto load_rows = [&](int b, int i, uint64_t* bar) {
      tma_load_4d(q_s(i), &tq, 0, h, r0, b, bar);
      tma_load_4d(q_s(i) + kChunk * 64, &tq, 0, h, r0 + kChunk, b, bar);
      tma_load_4d(do_s(i), &tdo, 0, h, r0, b, bar);
      tma_load_4d(do_s(i) + kChunk * 64, &tdo, 0, h, r0 + kChunk, b, bar);
      const Span ls = aligned_span(vec_row(lse, b), nrows);
      const Span ds = aligned_span(vec_row(delta, b), nrows);
      bulk_load(vec_s(i), ls.src, ls.bytes, bar);
      bulk_load(vec_s(i) + kVecPitch, ds.src, ds.bytes, bar);
    };
    if (kResident && pt == 0) {
      uint32_t bytes = 0;
      for (int b = 0; b < B; ++b) bytes += rows_bytes(b);
      mbar_expect_tx(&once, bytes);
      for (int b = 0; b < B; ++b) load_rows(b, b, &once);
    }
    // each key tile: every thread copies its query row of the bias tile;
    // thread 0 then streams K_b and V_b (and, not resident, the rows of b)
    const int qr = r0 + pt;
    const float* bias_row = qr < N ? bias + (static_cast<long long>(h) * N + qr) * N : nullptr;
    int it = 0;
    for (int t = t0; t < t1; ++t) {
      const int kv0 = t * kChunk;
      mbar_wait(&bias_empty, ((t - t0) & 1) ^ 1);
      Span row{nullptr, 0};
      if (bias_row != nullptr) row = aligned_span(bias_row + kv0, min(kChunk, N - kv0));
      warp_expect_tx(&bias_full, row.bytes, lane);
      if (row.bytes != 0) bulk_load(bias_t + pt * kBiasLd, row.src, row.bytes, &bias_full);
      if (pt == 0) {
        for (int b = 0; b < B; ++b, ++it) {
          const int s = it % kStages;
          mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
          mbar_expect_tx(&full[s], 2 * kTileBytes + (kResident ? 0 : rows_bytes(b)));
          tma_load_4d(ring.k(s), &tk, 0, h, kv0, b, &full[s]);
          tma_load_4d(ring.v(s), &tv, 0, h, kv0, b, &full[s]);
          if (!kResident) load_rows(b, s, &full[s]);
        }
      }
    }
  } else {  // consumer warpgroups c = 0, 1: query rows r0 + 64 c + [0, 64)
    warpgroup_regs_inc<kConsumerRegs>();
    const int c = warp >> 2;
    const int w = warp & 3;
    const int quad = lane & 3;
    const int lr = c * kChunk + w * 16 + (lane >> 2);  // this lane's first row in the block
    const int row0 = r0 + lr;
    const float scale2 = scale * kLog2e;
    const float* bias_h = bias + static_cast<long long>(h) * N * N;
    const float* brow[2] = {
        bias_t + lr * kBiasLd + span_shift(bias_h + static_cast<long long>(row0) * N),
        bias_t + (lr + 8) * kBiasLd + span_shift(bias_h + static_cast<long long>(row0 + 8) * N)};
    float* dbias_h = dbias + static_cast<long long>(h) * N * N;
    if (kResident) mbar_wait(&once, 0);
    if (c == 1) pass_turn(c);  // consumer 0 issues first
    int it = 0;
    for (int t = t0; t < t1; ++t) {
      const int kv0 = t * kChunk;
      // this lane's bias (exp2 domain) in the score accumulators' layout,
      // held for the batch sweep; the tile goes back to the producer
      mbar_wait(&bias_full, (t - t0) & 1);
      float bl[8][4], acc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          bl[j][e] = brow[e >> 1][j * 8 + 2 * quad + (e & 1)] * kLog2e;
          acc[j][e] = 0.f;
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&bias_empty);

      for (int b = 0; b < B; ++b, ++it) {
        const int s = it % kStages;
        const int i = kResident ? b : s;
        mbar_wait(&full[s], (it / kStages) & 1);
        const bf16* qa = q_s(i) + c * kChunk * 64;
        const bf16* da = do_s(i) + c * kChunk * 64;
        const bf16* kt = ring.k(s);
        const bf16* vt = ring.v(s);
        float sc[8][4], dp[8][4];
        consumer_turn(c);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // S = Q K^T
          wgmma_ss<0>(sc, sw128_desc(qa + kk * 16), sw128_desc(kt + kk * 16), kk);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // dP = dO V^T
          wgmma_ss<0>(dp, sw128_desc(da + kk * 16), sw128_desc(vt + kk * 16), kk);
        wgmma_commit();
        pass_turn(c);

        // lse (exp2 domain) and delta of this lane's two rows
        const float* lse_v = vec_s(i) + span_shift(vec_row(lse, b));
        const float* dl_v = vec_s(i) + kVecPitch + span_shift(vec_row(delta, b));
        const float ls[2] = {lse_v[lr] * kLog2e, lse_v[lr + 8] * kLog2e};
        const float dl[2] = {dl_v[lr], dl_v[lr + 8]};
        // P = exp2(S * scale + bias - lse) while dP runs
        wgmma_wait<1>();
        fence_acc(sc);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sc[j][e] = exp2_ftz(fmaf(sc[j][e], scale2, bl[j][e]) - ls[e >> 1]);
        wgmma_wait<0>();
        fence_acc(dp);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
        // dbias += P o (dP - delta)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] = fmaf(sc[j][e], dp[j][e] - dl[e >> 1], acc[j][e]);
      }

      // this warp's 16 rows of the dbias tile, each as two stores of 32
      // consecutive floats: lane L takes column 32 h + L from the quad
      // that holds the row (8 shuffles a half row, one per register the
      // 32 columns span), so every store writes 128 contiguous bytes
      const bool all_keys = kv0 + kChunk <= N;
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const int row = r0 + c * kChunk + w * 16 + r;
        float* dst = dbias_h + static_cast<long long>(row) * N + kv0;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int col = 32 * hh + lane;
          const int src = (r & 7) * 4 + ((col & 7) >> 1);  // lane of column col, row r
          float v = 0.f;
#pragma unroll
          for (int x = 0; x < 4; ++x) {
#pragma unroll
            for (int y = 0; y < 2; ++y) {
              const float t = __shfl_sync(0xffffffffu, acc[4 * hh + x][(r >> 3) * 2 + y], src);
              if (((col >> 3) & 3) == x && (col & 1) == y) v = t;
            }
          }
          if (row < N && (all_keys || kv0 + col < N)) dst[col] = v;
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

// The forward. q, k, v: bf16 [B, N, H, D] with the element strides in
// strides[0..8] (three each, in that order; last dim contiguous, 16-byte
// aligned base and strides: they are read by TMA); o: bf16 [B, N, H, D]
// with strides[9..11]; bias: fp32 [H, N, N] contiguous or null; lse: fp32
// [B*H, N], written. Returns a cudaError_t code.
int flash_attention_fwd(const void* q, const void* k, const void* v, const void* bias,
                        void* o, void* lse, int B, int N, int H, int D,
                        const long long* strides, float scale, void* stream) {
  if (B < 1 || H < 1 || N < 1 || D != 64) return static_cast<int>(cudaErrorInvalidValue);
  const DeviceOf device(q);
  if (device.error() != cudaSuccess) return static_cast<int>(device.error());
  Strides s[4];
  for (int t = 0; t < 4; ++t)
    s[t] = Strides{strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
  CUtensorMap maps[3];
  if (!(encode_rows(&maps[0], q, B, N, H, s[0]) && encode_rows(&maps[1], k, B, N, H, s[1]) &&
        encode_rows(&maps[2], v, B, N, H, s[2])))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool with_bias = bias != nullptr;
  const auto kernel = with_bias ? flash_fwd_kernel<true> : flash_fwd_kernel<false>;
  const int smem = fwd_smem_bytes(with_bias);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // one block an SM, each looping over row blocks
  const int blocks = min(B * H * ((N + kBlockRows - 1) / kBlockRows), sms);
  kernel<<<blocks, kBlockThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], static_cast<const float*>(bias), static_cast<bf16*>(o),
      static_cast<float*>(lse), B, H, N, s[3], scale);
  return static_cast<int>(cudaGetLastError());
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
  const DeviceOf device(q);
  if (device.error() != cudaSuccess) return static_cast<int>(device.error());
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
  const int blocks = B * H * ((N + kBlockRows - 1) / kBlockRows);
  kernel<<<blocks, kBlockThreads, smem, static_cast<cudaStream_t>(stream)>>>(
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
  const DeviceOf device(q);
  if (device.error() != cudaSuccess) return static_cast<int>(device.error());
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
  const int blocks = B * H * ((N + kBlockRows - 1) / kBlockRows);
  kernel<<<blocks, kBlockThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const float*>(bias), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), B, H, N, s[4], s[5], scale);
  return static_cast<int>(cudaGetLastError());
}

// The dbias kernel of the backward, launched after the dq kernel (it reads
// the delta that one wrote). q, k, v, dout: bf16 [B, N, H, D] with
// strides[0..11] (read by TMA, as above); lse, delta: fp32 [B*H, N]; bias:
// fp32 [H, N, N], not null; dbias: fp32 [H, N, N], written. Returns a
// cudaError_t code.
int flash_attention_bwd_dbias(const void* q, const void* k, const void* v, const void* dout,
                              const void* lse, const void* delta, const void* bias, void* dbias,
                              int B, int N, int H, int D, const long long* strides, float scale,
                              void* stream) {
  if (B < 1 || H < 1 || N < 1 || D != 64 || bias == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const DeviceOf device(q);
  if (device.error() != cudaSuccess) return static_cast<int>(device.error());
  Strides s[4];
  for (int t = 0; t < 4; ++t)
    s[t] = Strides{strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
  CUtensorMap maps[4];
  if (!encode_qkvdo(maps, q, k, v, dout, B, N, H, s, 3))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool resident = dbias_smem_bytes(B) <= max_smem;
  const auto kernel = resident ? flash_bwd_dbias_kernel<true> : flash_bwd_dbias_kernel<false>;
  const int smem = dbias_smem_bytes(resident ? B : kStages);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // split each row block's key tiles into as few groups as give two blocks
  // an SM (every group reloads the block's Q and dO rows)
  const int rbs = (N + kBlockRows - 1) / kBlockRows;
  const int tiles = (N + kChunk - 1) / kChunk;
  const int want = (2 * sms + H * rbs - 1) / (H * rbs);
  const int per_block = (tiles + min(max(want, 1), tiles) - 1) / min(max(want, 1), tiles);
  const int groups = (tiles + per_block - 1) / per_block;
  kernel<<<H * rbs * groups, kBlockThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const float*>(bias),
      static_cast<float*>(dbias), B, H, N, per_block, scale);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of a kernel, in bytes, for the build report: the
// forward (which = 0), dq (1) or dkdv (2) without or with a bias (arg 0 or
// 1); the dbias kernel (3) with the rows of arg batch elements resident, or
// streamed (4).
int flash_attention_smem_bytes(int which, int arg) {
  switch (which) {
    case 0: return fwd_smem_bytes(arg != 0);
    case 1: return dq_smem_bytes(arg != 0);
    case 2: return dkdv_smem_bytes(arg != 0);
    case 3: return dbias_smem_bytes(arg);
    default: return dbias_smem_bytes(kStages);
  }
}

}  // extern "C"
