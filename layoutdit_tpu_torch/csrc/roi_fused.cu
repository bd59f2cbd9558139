// Fused RoIAlign probes for Hopper (sm_90a), plain C interface: RoIAlign
// over the level atlas as two dense products, the intermediate kept on
// chip.
//
// Replaces scripts/probe_roi_fused.py::_kernel_a (variant_a, row 9 of the
// kernel table), _kernel_a0 (variant_a0, row 10) and _kernel_e
// (variant_e, row 11). From an atlas f [C, H, W] and separable weights
// wy [K, P, H], wx [K, P, W], all bf16:
//
//   t[k, py, c, w]    = bf16(sum_h wy[k, py, h] f[c, h, w])    fp32 sums
//   out[k, px, py, c] = bf16(sum_w wx[k, px, w] t[k, py, c, w])  fp32 sums
//
// Rows 9 and 11 compute out (row 11 writes it channel-major); row 10
// stores t alone. The TPU kernels needed a block-diagonal wx, cross-RoI
// products and a selector matrix because their compiler refused the
// (py, c) <-> w relayout of t; here the kernels take the real wx (rows
// padded to a multiple of 8 w). All three rows run roi_hopper_kernel.

#include "hopper_mma.cuh"

namespace {

constexpr int kP = 7;
constexpr int kHp = 112;  // contraction, zero-padded in the operands
constexpr int kMaxW = 128;

// ------------------------------------------------------------ rows 9-11
//
// Bound on the H100 at the probe's shapes (K = 8192, P = 7, C = 256,
// H = 109, W = 56): rows 9 and 11 by operations (the first product
// 1.79e11 + the second 1.15e10 = 1.91e11 a call, 0.193 ms at the bf16
// peak; out, the only large transfer, is 205 MB), row 10 by bytes (it
// writes t, 1.64 GB: 0.495 ms).
//
// Design. A persistent grid, one block of three warpgroups an SM: one
// producer, two consumers. A block walks a contiguous range of units; a
// unit belongs to one RoI block of 18 RoIs, 9 a consumer (63 rows (k, py),
// one m64 tile of the first product), so the atlas slices a block loads
// serve 18 RoIs (the old kernels' 8 or 16). The producer's first thread
// loads, by TMA with 128-byte swizzle, each RoI block's wy rows (and for
// row 9 its wx rows) once, and the atlas slices of the units through a
// ring of stages on mbarriers (4 stages for row 10, 3 for row 9): a slice
// is 128 rows (c, w) of the [C, W, 112] atlas, h as two 64-wide halves
// (h 112-127 read as zeros), one box each. The consumers hold their wy
// rows as the register A operand (7 k16 slices) for the whole RoI block
// and run the first product as wgmma m64n128k16 (B the K-major slice,
// fp32 sums), then:
//   - row 10: a unit is (RoI block, w, 128 channels), the slice one w's
//     channels (box [128 c][1 w][64 h]). t rounded to bf16 goes into a
//     128-byte-swizzled [63 rows][128 c] tile (two 64-channel halves) and
//     leaves by a TMA store: a 3-d map over out as [K * 7, W, C] for rows
//     (k, py, w), a 4-d one over [K, W, 7, C] for rows (k, w, py), the same
//     tile either way. Two tiles a consumer: the store of one unit runs
//     while the next is multiplied; nothing else waits on the writes, the
//     bound. RoIs past K are clipped by the store.
//   - row 9: a unit is (RoI block, 16 channels), eight pairs of channels,
//     each a slice [2 c][64 w][64 h] per 64 w (W <= 64: one, W <= 128:
//     two). t stays in registers: its bf16 pack is the register A operand
//     of the second product, out^T-like d2[(k, py), (k', px)] = t_c[(k, py),
//     w] wx[(k', px), w]^T, a wgmma m64n64k16 per channel and k16 slice of
//     w, with wx's [63 rows (k', px)][64 w] tile in shared memory (its rows
//     padded to a multiple of 8 w by the wrapper, for TMA). Only the
//     diagonal blocks k' == k are kept (the other 8/9 of this product,
//     6% of the function's operations, are the price of keeping it on the
//     tensor cores with no relayout through shared memory). The two
//     channels of a pair go out as one 4-byte word into a [9 k][7 px]
//     [7 py][16 c] tile, stored by TMA (4-d map over out [K, 7, 7, C]) once
//     a unit, two tiles a consumer. A consumer issues each (pair, w chunk)
//     step's second product together with the next step's first and waits
//     once, so the tensor cores run both while the other consumer packs t
//     and writes out (reading an accumulator while a product is in flight
//     would make ptxas serialize every wgmma).
// The consumers run independently, so one's epilogue overlaps the other's
// products; a stage goes back to the producer once both have multiplied
// it. K need not be a multiple of 18: the last RoI block's missing rows
// read as zeros and are never stored.
//
// Row 11 (replaces scripts/probe_roi_fused.py::_kernel_e) is row 9's
// kernel with three changes. Its out is channel-major, [K / kb, C, kb *
// 7, 7]: per channel a kb-RoI block is one run of kb * 49 values (k, px,
// py). So a consumer takes 8 RoIs (56 of its tile's 64 rows, a block 16)
// and never straddles a kb block (kb 8: a consumer's RoIs are one kb
// block; kb 16: half of one); the first product pays 64/56 rows against
// row 9's 64/63, 12% more tensor time. The second product is m64n56, the
// 8 RoIs' columns (k', px), 1/8 less than row 9's m64n64. Its epilogue
// takes, right after the wait, only the d2 elements that can lie on a
// diagonal block of the warp's rows (two or three n-tiles of seven, fixed
// at compile time per warp: Diag), packs the pair's two channels into 12
// registers, and writes the kept ones while the next step's products run,
// transposed from (k, py) x (k', px) to (k, px, py), into a [16 c][8 k][7
// px][7 py] tile (2-byte stores: the two channels of a pair lie 392
// values apart). One TMA store a unit puts the tile into out seen as a
// 4-d [K / kb][C][kb * 7 / 8][56] (box [1][16 c][7][56], rows of 112
// bytes). On the H100 at the probe's shapes, an epilogue written after
// the wait over all eight n-tiles, as row 9's, took 0.27 of 0.65 ms (the
// kernel with none ran in 0.38); narrowed to those n-tiles 0.58, moved
// under the next products 0.57, with m64n56 0.53-0.55.
// Against the earlier mma.sync kernel (a block of kb RoIs and 16 channels,
// a grid of K / kb x C / 16 blocks): (1) the grid is persistent and the
// atlas slices come through the mbarrier ring, each serving 16 RoIs
// instead of kb (the atlas crosses L2 K / 16 times, not K / 8, and the
// copies overlap the products); (2) both products run on wgmma (m64n128k16 with
// wy as the register A operand, then m64n56k16 with t's bf16 pack as the
// register A operand) in place of mma.sync m16n8k16; (3) t never enters
// shared memory, and out goes through it once, into the TMA store's tile.
// The second product keeps row 9's register form (a), not the probe's
// transposed form (b: t through a swizzled shared tile as the B operand
// against wx as A, the accumulator (k, px) x (k', py)): (b) runs the same
// products and adds t's 16 KB a step of shared stores and a barrier
// before the wgmma that reads them, to save an epilogue that now runs
// under the products; the kernel takes about row 9's time.

constexpr int kHalf = 64 * 64 * 2;        // bytes of a [64 rows][64] bf16 tile
constexpr int kStageBytes = 4 * kHalf;    // [128 rows][64] for h 0-63, then 64-127
constexpr int kUnitChannels = 16;         // rows 9, 11: channels of a unit
constexpr int kOutTilePair = 14336;       // row 9 [9][7][7][16], row 11 [16][392] bf16
constexpr int kHopperThreads = 384;
constexpr int kConsumerRegs = 232;
constexpr int kProducerRegs = 40;

// shared memory of a block, offsets from its 1024-byte-aligned base, and
// the RoI grouping
template <int kRow>
struct Layout {
  static constexpr bool kPair = kRow != 10;                   // rows 9, 11: both products
  static constexpr int kRois = kRow == 11 ? 8 : 9;            // RoIs a consumer warpgroup
  static constexpr int kRoisBlock = 2 * kRois;                // RoIs a block
  static constexpr int kRows = kRois * kP;                    // rows (k, py) of 64
  static constexpr int kStages = kPair ? 3 : 4;
  static constexpr int kRing = 0;                             // kStages stages
  static constexpr int kWy = kStages * kStageBytes;           // [consumer][h half][64][64]
  static constexpr int kWx = kWy + 4 * kHalf;                 // rows 9, 11: [consumer][wc][64][64]
  static constexpr int kOut = kWx + (kPair ? 4 * kHalf : 0);  // [consumer][2 tiles]
  static constexpr int kOutTile = kPair ? kOutTilePair : 2 * kHalf;
  static constexpr int kBytes = kOut + 4 * kOutTile + 1024;   // with the alignment slack
};

struct Unit {
  int rb;  // RoI block
  int a;   // row 10: w; rows 9, 11: 16-channel group
  int b;   // row 10: 128-channel tile
};

template <int kRow>
__device__ __forceinline__ Unit unit_of(long long u, int W, int nct, int ncg) {
  if (kRow != 10) return Unit{static_cast<int>(u / ncg), static_cast<int>(u % ncg), 0};
  const long long rest = u / nct;
  return Unit{static_cast<int>(rest / W), static_cast<int>(rest % W), static_cast<int>(u % nct)};
}

// Row 11's epilogue. A lane of warp wq holds rows R + lane / 4 of the
// accumulator d2[(k, py), (k', px)] for R = 16 wq (elements 0, 1) and 16 wq
// + 8 (elements 2, 3), columns 8 j + 2 (lane % 4) + {0, 1} of n-tile j. The
// diagonal columns of those 8 rows lie in n-tiles kJlo..kJhi (two or three
// of the seven), fixed at compile time; rows past 56 (the next RoIs'
// rows) have none.
template <int R>
struct Diag {
  static constexpr bool kLive = R < 56;
  static constexpr int kH = (R >> 3) & 1;
  static constexpr int kLast = R + 7 < 55 ? R + 7 : 55;
  static constexpr int kJlo = R / kP * kP / 8;
  static constexpr int kJhi = (kLast / kP * kP + kP - 1) / 8;
  static constexpr int kN = kLive ? 2 * (kJhi - kJlo + 1) : 0;  // candidates (j, e), <= 6
};

// the candidates of both channels of a pair as bf16 pairs, taken from d2
// right after the wait so that the next products can be issued at once
template <int R, int J>
__device__ __forceinline__ void grab_rows(uint32_t (&cand)[2][6], const float (&d2)[2][J][4]) {
  using D = Diag<R>;
#pragma unroll
  for (int x = 0; x < D::kN; ++x) {
    constexpr int h = D::kH;
    const int j = D::kJlo + x / 2, e = x % 2;
    cand[h][x] = pack_bf16(d2[0][j][2 * h + e], d2[1][j][2 * h + e]);
  }
}

// ... and the kept ones stored into the [16 c][(k, px)][py] tile (channel
// pair p, a channel's run kRun values) while those products run
template <int R>
__device__ __forceinline__ void put_rows(bf16* o, const uint32_t (&cand)[2][6], int p,
                                         int lane) {
  using D = Diag<R>;
  constexpr int kRun = 8 * kP * kP;
  const int r = R + (lane >> 2);
  const int py = r % kP, n0 = r - py;
  bf16* q = o + 2 * p * kRun + py;
#pragma unroll
  for (int x = 0; x < D::kN; ++x) {
    const int n = 8 * (D::kJlo + x / 2) + 2 * (lane & 3) + x % 2;
    if (static_cast<unsigned>(n - n0) < kP) {
      const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&cand[D::kH][x]);
      q[n * kP] = v.x;
      q[n * kP + kRun] = v.y;
    }
  }
}

template <int WQ, int J>
__device__ __forceinline__ void grab_diag(uint32_t (&cand)[2][6], const float (&d2)[2][J][4]) {
  grab_rows<16 * WQ>(cand, d2);
  grab_rows<16 * WQ + 8>(cand, d2);
}

template <int WQ>
__device__ __forceinline__ void put_diag(bf16* o, const uint32_t (&cand)[2][6], int p, int lane) {
  put_rows<16 * WQ>(o, cand, p, lane);
  put_rows<16 * WQ + 8>(o, cand, p, lane);
}

// f: the atlas as a 3-d map over bf16 [C, W, 112] (box [128 c][1 w][64 h]
// for row 10, [2 c][64 w][64 h] for rows 9 and 11); wy: a 2-d map over bf16
// [K * 7, 112] (box [64 rows][64 h]); wx (rows 9, 11): a 2-d map over bf16
// [K * 7, W rounded up to 8] (box [64 rows][64 w]); out: row 9 a 4-d map
// over [K, 7, 7, C] (box [9][7][7][16]), row 11 a 4-d map over [K / kb,
// C, kb * 7 / 8, 56] (box [1][16][7][56]), row 10 a 3-d map over
// [K * 7, W, C] (box [63][1][64]) or, with relayout, a 4-d one over
// [K, W, 7, C] (box [9][1][7][64]). Grid: at most one block an SM; 384
// threads; Layout<kRow>::kBytes of dynamic shared memory.
template <int kRow>
__global__ void __launch_bounds__(kHopperThreads, 1) roi_hopper_kernel(
    const __grid_constant__ CUtensorMap tf, const __grid_constant__ CUtensorMap twy,
    const __grid_constant__ CUtensorMap twx, const __grid_constant__ CUtensorMap tout, int K,
    int kb, int C, int W, int relayout) {
  using L = Layout<kRow>;
  constexpr bool kPair = L::kPair;
  constexpr int kRoisBlock = L::kRoisBlock;
  constexpr int kRoisWg = L::kRois;
  constexpr int kRowsWg = L::kRows;
  constexpr int kSt = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kSt], empty[kSt], op_full, op_empty;
  uint8_t* sm = align1024(smem_raw);

  const int nrb = (K + kRoisBlock - 1) / kRoisBlock;
  const int nct = (C + 127) / 128;
  const int ncg = C / kUnitChannels;
  const int nw = (W + 63) / 64;
  const long long units =
      kPair ? static_cast<long long>(nrb) * ncg : static_cast<long long>(nrb) * W * nct;
  const long long u0 = units * blockIdx.x / gridDim.x;
  const long long u1 = units * (blockIdx.x + 1) / gridDim.x;
  const int stages_per_unit = kPair ? 8 * nw : 1;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kSt; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_init(&op_full, 1);
    mbar_init(&op_empty, 8);
    mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= 8) {  // producer warpgroup: its first thread issues every load
    warpgroup_regs_dec<kProducerRegs>();
    if (threadIdx.x != 256) return;
    int it = 0, q = 0, prev = -1;
    for (long long u = u0; u < u1; ++u) {
      const Unit un = unit_of<kRow>(u, W, nct, ncg);
      if (un.rb != prev) {  // the RoI block's wy (and wx) rows, once
        mbar_wait(&op_empty, (q & 1) ^ 1);
        mbar_expect_tx(&op_full, (kPair ? 4 + 2 * nw : 4) * kHalf);
        for (int g = 0; g < 2; ++g) {
          const int m0 = (un.rb * kRoisBlock + g * kRoisWg) * kP;
          tma_load_2d(sm + L::kWy + (2 * g) * kHalf, &twy, 0, m0, &op_full);
          tma_load_2d(sm + L::kWy + (2 * g + 1) * kHalf, &twy, 64, m0, &op_full);
          if (kPair)
            for (int wc = 0; wc < nw; ++wc)
              tma_load_2d(sm + L::kWx + (2 * g + wc) * kHalf, &twx, 64 * wc, m0, &op_full);
        }
        ++q;
        prev = un.rb;
      }
      for (int i = 0; i < stages_per_unit; ++i, ++it) {
        const int s = it % kSt;
        mbar_wait(&empty[s], ((it / kSt) & 1) ^ 1);
        mbar_expect_tx(&full[s], kStageBytes);
        uint8_t* dst = sm + L::kRing + s * kStageBytes;
        // rows 9, 11: pair i / nw of the unit's channels, w chunk i % nw;
        // row 10: one w, 128 channels
        const int w0 = kPair ? 64 * (i % nw) : un.a;
        const int c0 = kPair ? un.a * kUnitChannels + 2 * (i / nw) : un.b * 128;
        tma_load_3d(dst, &tf, 0, w0, c0, &full[s]);
        tma_load_3d(dst + 2 * kHalf, &tf, 64, w0, c0, &full[s]);
      }
    }
    return;
  }

  // consumer warpgroup g: RoIs rb * kRoisBlock + kRoisWg g + [0, kRoisWg) of
  // each RoI block (18 and 9; row 11 16 and 8)
  warpgroup_regs_inc<kConsumerRegs>();
  const int g = warp >> 2;
  const int wq = warp & 3;
  const int tg = threadIdx.x & 127;
  const int r0 = wq * 16 + (lane >> 2);  // this lane's rows r0 and r0 + 8 of the m64 tile
  const bf16* wy_s = reinterpret_cast<const bf16*>(sm + L::kWy + 2 * g * kHalf);
  const bf16* wx_s = reinterpret_cast<const bf16*>(sm + L::kWx + 2 * g * kHalf);
  uint32_t wyf[7][4];
  int it = 0, q = 0, prev = -1, tiles = 0;
  // out streams past L2, which keeps the atlas the next units read
  const uint64_t store_policy = l2_evict_first();

  // t = wy f of the slice in the ring's next stage into acc (fp32), issued
  // and not waited for; -> the stage, which release() hands back to the
  // producer once the products are waited for
  auto issue_first = [&](float (&acc)[16][4]) {
    const int s = it % kSt;
    mbar_wait(&full[s], (it / kSt) & 1);
    const bf16* b = reinterpret_cast<const bf16*>(sm + L::kRing + s * kStageBytes);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 7; ++kk)
      wgmma_rs<0, 16>(acc, wyf[kk], sw128_desc(b + (kk >> 2) * 128 * 64 + (kk & 3) * 16), kk);
    wgmma_commit();
    ++it;
    return s;
  };
  auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  };

  for (long long u = u0; u < u1; ++u) {
    const Unit un = unit_of<kRow>(u, W, nct, ncg);
    if (un.rb != prev) {
      if (kPair && prev >= 0) {  // the last RoI block's wx tiles are read
        __syncwarp();
        if (lane == 0) mbar_arrive(&op_empty);
      }
      mbar_wait(&op_full, q & 1);
      ++q;
      prev = un.rb;
#pragma unroll
      for (int kk = 0; kk < 7; ++kk)
        load_a_sw128(wyf[kk], wy_s + (kk >> 2) * 64 * 64, wq, lane, kk & 3);
      if (!kPair) {  // wy lives in registers now
        __syncwarp();
        if (lane == 0) mbar_arrive(&op_empty);
      }
    }
    const int k0 = un.rb * kRoisBlock + g * kRoisWg;  // this warpgroup's first RoI
    uint8_t* tile = sm + L::kOut + (2 * g + (tiles & 1)) * L::kOutTile;
    // the store from this tile two units ago has read it (one bulk group
    // a unit, so at most the last unit's may still be reading)
    auto tile_free = [&]() {
      if (tg == 0) bulk_wait_read<1>();
      named_barrier_sync(1 + g, 128);
    };
    // the tile written: one thread stores it
    auto tile_written = [&]() {
      fence_proxy_async();
      named_barrier_sync(1 + g, 128);
    };

    if constexpr (!kPair) {
      float acc[16][4];
      const int s = issue_first(acc);
      wgmma_wait<0>();
      fence_acc(acc);
      release(s);
      tile_free();
      // t as bf16 into [2 halves][64 rows][64 c], 128-byte swizzle
      bf16* o = reinterpret_cast<bf16*>(tile);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + 8 * h;
          const int chunk = (j & 7) ^ (r & 7);
          *reinterpret_cast<uint32_t*>(o + (j >> 3) * 64 * 64 + r * 64 + chunk * 8 +
                                       2 * (lane & 3)) =
              pack_bf16(acc[j][2 * h], acc[j][2 * h + 1]);
        }
      }
      tile_written();
      if (tg == 0) {
        for (int h = 0; h < 2 && k0 < K; ++h) {
          const int c = un.b * 128 + 64 * h;
          if (c >= C) break;
          if (relayout)
            tma_store_4d(&tout, o + h * 64 * 64, c, 0, un.a, k0, store_policy);
          else
            tma_store_3d(&tout, o + h * 64 * 64, c, un.a, k0 * kP, store_policy);
        }
        bulk_commit();  // a group every unit, empty past K: tile_free counts on it
      }
    } else {
      // steps (pair p, w chunk wc), wc fastest. Each step issues its second
      // product together with the next step's first, and waits once: the
      // tensor cores run both while the other consumer packs and writes out
      // (row 11 writes out the previous pair while its own products run)
      const int steps = kUnitChannels / 2 * nw;
      // row 9: this lane's rows r0 + 8 h = (k_h, py_h); a column n = (k',
      // px) of the diagonal block k' == k_h lands at tile row (n, py_h),
      // since k' * 7 + px = n: the tile is [(k, px)][py][16 c]
      const int py0 = r0 % kP, py1 = (r0 + 8) % kP;
      const int n00 = r0 - py0, n01 = r0 + 8 - py1;  // 7 k_h, the block's first column
      bf16* o = reinterpret_cast<bf16*>(tile);
      constexpr int kJ2 = kRow == 11 ? 7 : 8;  // row 11: m64n56, its 8 RoIs' columns
      float acc[16][4], d2[2][kJ2][4];
      uint32_t ta[8][4];
      uint32_t cand[2][6];  // row 11: the diagonal candidates of pair `pending`
      int pending = 0;
      auto grab = [&]() {
        switch (wq) {
          case 0: grab_diag<0>(cand, d2); break;
          case 1: grab_diag<1>(cand, d2); break;
          case 2: grab_diag<2>(cand, d2); break;
          default: grab_diag<3>(cand, d2); break;
        }
      };
      auto put = [&]() {
        switch (wq) {
          case 0: put_diag<0>(o, cand, pending, lane); break;
          case 1: put_diag<1>(o, cand, pending, lane); break;
          case 2: put_diag<2>(o, cand, pending, lane); break;
          default: put_diag<3>(o, cand, pending, lane); break;
        }
      };
      int s = issue_first(acc);
      tile_free();
      wgmma_wait<0>();
      fence_acc(acc);
      release(s);
      for (int i = 0; i < steps; ++i) {
        const int p = i / nw;
        const int wc = i - p * nw;
        // t of channel ci, k16 slice kk of its 64 w: n-tiles 8 ci + 2 kk, + 1
#pragma unroll
        for (int x = 0; x < 8; ++x) pack_a(ta[x], acc, x);
        fence_frag(ta);
        wgmma_fence();
#pragma unroll
        for (int ci = 0; ci < 2; ++ci)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_rs<0, kJ2>(d2[ci], ta[4 * ci + kk], sw128_desc(wx_s + wc * 64 * 64 + kk * 16),
                             wc > 0 || kk > 0);
        wgmma_commit();
        const bool more = i + 1 < steps;
        if (more) s = issue_first(acc);
        if constexpr (kRow == 11)
          if (p > 0 && wc == 0) put();  // the previous pair, taken from d2 below
        wgmma_wait<0>();
        fence_acc(acc);
        fence_acc(d2[0]);
        fence_acc(d2[1]);
        if (more) release(s);
        if (wc + 1 < nw) continue;
        if constexpr (kRow == 11) {
          grab();
          pending = p;
        } else {
          // the diagonal blocks: row (k, py), column (k', px) with k' == k
#pragma unroll
          for (int j = 0; j < 8; ++j) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int n = 8 * j + 2 * (lane & 3) + e;
                const int n0 = h ? n01 : n00;
                if (r0 + 8 * h < kRowsWg && static_cast<unsigned>(n - n0) < kP)
                  *reinterpret_cast<uint32_t*>(o + (n * kP + (h ? py1 : py0)) * kUnitChannels +
                                               2 * p) =
                      pack_bf16(d2[0][j][2 * h + e], d2[1][j][2 * h + e]);
              }
            }
          }
        }
      }
      if constexpr (kRow == 11) put();  // the last pair, nothing in flight
      tile_written();
      if (tg == 0) {
        if (k0 < K) {
          if constexpr (kRow == 9)
            tma_store_4d(&tout, o, un.a * kUnitChannels, 0, 0, k0, store_policy);
          else  // the consumer's 8 RoIs: 7 rows of 56 in kb block k0 / kb
            tma_store_4d(&tout, o, 0, k0 % kb / kRoisWg * kP, un.a * kUnitChannels, k0 / kb,
                         store_policy);
        }
        bulk_commit();  // a group every unit, empty past K: tile_free counts on it
      }
    }
    ++tiles;
  }
  if (tg == 0) bulk_wait<0>();
}

template <int kRow>
int launch_hopper(const void* f, const void* wy, const void* wx, void* out, int K, int kb, int C,
                  int W, int wx_pitch, int relayout, void* stream) {
  using L = Layout<kRow>;
  const DeviceOf device(f);
  if (device.error() != cudaSuccess) return static_cast<int>(device.error());
  const cuuint64_t k = static_cast<cuuint64_t>(K), c = static_cast<cuuint64_t>(C),
                   w = static_cast<cuuint64_t>(W);
  CUtensorMap tf, twy, twx, tout;
  const cuuint64_t f_dims[3] = {kHp, w, c};
  const cuuint64_t f_strides[2] = {kHp * 2, w * kHp * 2};
  const cuuint32_t f_box[3] = {64, L::kPair ? 64u : 1u, L::kPair ? 2u : 128u};
  const cuuint64_t wy_dims[2] = {kHp, k * kP};
  const cuuint64_t wy_strides[1] = {kHp * 2};
  const cuuint32_t tile_box[2] = {64, 64};
  bool ok = encode_bf16(&tf, f, 3, f_dims, f_strides, f_box, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B) &&
            encode_bf16(&twy, wy, 2, wy_dims, wy_strides, tile_box, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B);
  if (L::kPair) {
    const cuuint64_t wx_dims[2] = {static_cast<cuuint64_t>(wx_pitch), k * kP};
    const cuuint64_t wx_strides[1] = {static_cast<cuuint64_t>(wx_pitch) * 2};
    ok = ok && encode_bf16(&twx, wx, 2, wx_dims, wx_strides, tile_box,
                           CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B);
  } else {
    twx = twy;
  }
  if (kRow == 9) {
    const cuuint64_t o_dims[4] = {c, kP, kP, k};
    const cuuint64_t o_strides[3] = {c * 2, c * 2 * kP, c * 2 * kP * kP};
    const cuuint32_t o_box[4] = {kUnitChannels, kP, kP, L::kRois};
    ok = ok && encode_bf16(&tout, out, 4, o_dims, o_strides, o_box, CU_TENSOR_MAP_SWIZZLE_NONE,
                           CU_TENSOR_MAP_L2_PROMOTION_NONE);
  } else if (kRow == 11) {  // [K / kb, C, kb * 49] as rows of 56 (112 bytes)
    const cuuint64_t run = static_cast<cuuint64_t>(kb) * kP * kP;  // a channel's values
    const cuuint64_t o_dims[4] = {56, run / 56, c, k / kb};
    const cuuint64_t o_strides[3] = {56 * 2, run * 2, c * run * 2};
    const cuuint32_t o_box[4] = {56, L::kRois * kP * kP / 56, kUnitChannels, 1};
    ok = ok && encode_bf16(&tout, out, 4, o_dims, o_strides, o_box, CU_TENSOR_MAP_SWIZZLE_NONE,
                           CU_TENSOR_MAP_L2_PROMOTION_NONE);
  } else if (relayout) {  // row 10, rows (k, w, py)
    const cuuint64_t o_dims[4] = {c, kP, w, k};
    const cuuint64_t o_strides[3] = {c * 2, c * 2 * kP, c * 2 * kP * w};
    const cuuint32_t o_box[4] = {64, kP, 1, L::kRois};
    ok = ok && encode_bf16(&tout, out, 4, o_dims, o_strides, o_box, CU_TENSOR_MAP_SWIZZLE_128B,
                           CU_TENSOR_MAP_L2_PROMOTION_NONE);
  } else {  // row 10, rows (k, py, w)
    const cuuint64_t o_dims[3] = {c, w, k * kP};
    const cuuint64_t o_strides[2] = {c * 2, c * 2 * w};
    const cuuint32_t o_box[3] = {64, 1, L::kRows};
    ok = ok && encode_bf16(&tout, out, 3, o_dims, o_strides, o_box, CU_TENSOR_MAP_SWIZZLE_128B,
                           CU_TENSOR_MAP_L2_PROMOTION_NONE);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);

  const auto kernel = roi_hopper_kernel<kRow>;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rbs = (K + L::kRoisBlock - 1) / L::kRoisBlock;
  const long long units = L::kPair ? rbs * (C / kUnitChannels) : rbs * W * ((C + 127) / 128);
  const int blocks = static_cast<int>(units < sms ? units : sms);
  kernel<<<blocks, kHopperThreads, L::kBytes, static_cast<cudaStream_t>(stream)>>>(
      tf, twy, twx, tout, K, kb, C, W, relayout);
  return static_cast<int>(cudaGetLastError());
}

// the checks every entry point shares: kb 8 or 16 dividing K, W <= 128, C a
// multiple of the channel tile
bool valid(int K, int kb, int C, int W, int ct) {
  return K >= 1 && C >= ct && C % ct == 0 && W >= 1 && W <= kMaxW && (kb == 8 || kb == 16) &&
         K % kb == 0;
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Row 9. f: bf16 [C, W, 112] (the atlas, h fastest, zero past H); wy:
// bf16 [K * 7, 112] (zero past H); wx: bf16 [K * 7, wx_pitch] (zero past
// W, wx_pitch a multiple of 8 and >= W); out: bf16 [K, 7, 7, C] as (k, px,
// py, c). kb: 8 or 16, dividing K (the kernel's own RoI block is 18); C a
// multiple of 16; W <= 128; every pointer 16-byte aligned. Returns a
// cudaError_t code.
int roi_fused_a(const void* f, const void* wy, const void* wx, void* out, int K, int kb, int C,
                int W, int wx_pitch, void* stream) {
  if (!valid(K, kb, C, W, kUnitChannels) || wx_pitch < W || wx_pitch % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_hopper<9>(f, wy, wx, out, K, kb, C, W, wx_pitch, 0, stream);
}

// Row 11: f, wy, wx as row 9; out: bf16 [K / kb, C, kb * 7, 7] as
// (block, c, (k, px), py). kb: 8 or 16, dividing K (the kernel's own RoI
// block is 16). Returns a cudaError_t code.
int roi_fused_e(const void* f, const void* wy, const void* wx, void* out, int K, int kb, int C,
                int W, int wx_pitch, void* stream) {
  if (!valid(K, kb, C, W, kUnitChannels) || wx_pitch < W || wx_pitch % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_hopper<11>(f, wy, wx, out, K, kb, C, W, wx_pitch, 0, stream);
}

// Row 10: f, wy as row 9; out: bf16 [K * 7 * W, C], rows (k, w, py) if
// relayout else (k, py, w). C a multiple of 64. Returns a cudaError_t code.
int roi_fused_a0(const void* f, const void* wy, void* out, int K, int kb, int C, int W,
                 int relayout, void* stream) {
  if (!valid(K, kb, C, W, 64)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_hopper<10>(f, wy, nullptr, out, K, kb, C, W, 0, relayout, stream);
}

}  // extern "C"
