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
// (py, c) <-> w relayout of t; here the kernels take the real wx [K, P, W].
// Rows 9 and 10 run roi_hopper_kernel, row 11 roi_fused_e_kernel; each
// kernel's note is above it.

#include "hopper_mma.cuh"

namespace {

constexpr int kP = 7;
constexpr int kHp = 112;  // contraction, zero-padded in the operands

// ------------------------------------------------------------ rows 9 and 10
//
// Bound on the H100 at the probe's shapes (K = 8192, P = 7, C = 256,
// H = 109, W = 56): row 9 by operations (the first product, 1.79e11 of
// 1.91e11, 0.193 ms at the bf16 peak; out, the only large transfer, is
// 205 MB), row 10 by bytes (it writes t, 1.64 GB: 0.495 ms).
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

constexpr int kRoisWg = 9;                // RoIs a consumer warpgroup
constexpr int kRoisBlock = 2 * kRoisWg;   // RoIs a block
constexpr int kRowsWg = kRoisWg * kP;     // 63 rows (k, py)
constexpr int kHalf = 64 * 64 * 2;        // bytes of a [64 rows][64] bf16 tile
constexpr int kStageBytes = 4 * kHalf;    // [128 rows][64] for h 0-63, then 64-127
constexpr int kUnitChannels = 16;         // row 9: channels of a unit
constexpr int kOutTile9 = 14336;          // row 9: [9][7][7][16] bf16 (14112 bytes), rounded
constexpr int kHopperThreads = 384;
constexpr int kConsumerRegs = 232;
constexpr int kProducerRegs = 40;

// shared memory of a block, offsets from its 1024-byte-aligned base
template <bool kRow9>
struct Layout {
  static constexpr int kStages = kRow9 ? 3 : 4;
  static constexpr int kRing = 0;                             // kStages stages
  static constexpr int kWy = kStages * kStageBytes;           // [consumer][h half][64][64]
  static constexpr int kWx = kWy + 4 * kHalf;                 // row 9: [consumer][w chunk][64][64]
  static constexpr int kOut = kWx + (kRow9 ? 4 * kHalf : 0);  // [consumer][2 tiles]
  static constexpr int kOutTile = kRow9 ? kOutTile9 : 2 * kHalf;
  static constexpr int kBytes = kOut + 4 * kOutTile + 1024;   // with the alignment slack
};

struct Unit {
  int rb;  // RoI block
  int a;   // row 10: w; row 9: 16-channel group
  int b;   // row 10: 128-channel tile
};

template <bool kRow9>
__device__ __forceinline__ Unit unit_of(long long u, int W, int nct, int ncg) {
  if (kRow9) return Unit{static_cast<int>(u / ncg), static_cast<int>(u % ncg), 0};
  const long long rest = u / nct;
  return Unit{static_cast<int>(rest / W), static_cast<int>(rest % W), static_cast<int>(u % nct)};
}

// f: the atlas as a 3-d map over bf16 [C, W, 112] (box [128 c][1 w][64 h]
// for row 10, [2 c][64 w][64 h] for row 9); wy: a 2-d map over bf16
// [K * 7, 112] (box [64 rows][64 h]); wx (row 9): a 2-d map over bf16
// [K * 7, W rounded up to 8] (box [64 rows][64 w]); out: row 9 a 4-d map
// over [K, 7, 7, C] (box [9][7][7][16]), row 10 a 3-d map over
// [K * 7, W, C] (box [63][1][64]) or, with relayout, a 4-d one over
// [K, W, 7, C] (box [9][1][7][64]). Grid: at most one block an SM; 384
// threads; Layout<kRow9>::kBytes of dynamic shared memory.
template <bool kRow9>
__global__ void __launch_bounds__(kHopperThreads, 1) roi_hopper_kernel(
    const __grid_constant__ CUtensorMap tf, const __grid_constant__ CUtensorMap twy,
    const __grid_constant__ CUtensorMap twx, const __grid_constant__ CUtensorMap tout, int K,
    int C, int W, int relayout) {
  using L = Layout<kRow9>;
  constexpr int kSt = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kSt], empty[kSt], op_full, op_empty;
  uint8_t* sm = align1024(smem_raw);

  const int nrb = (K + kRoisBlock - 1) / kRoisBlock;
  const int nct = (C + 127) / 128;
  const int ncg = C / kUnitChannels;
  const int nw = (W + 63) / 64;
  const long long units =
      kRow9 ? static_cast<long long>(nrb) * ncg : static_cast<long long>(nrb) * W * nct;
  const long long u0 = units * blockIdx.x / gridDim.x;
  const long long u1 = units * (blockIdx.x + 1) / gridDim.x;
  const int stages_per_unit = kRow9 ? 8 * nw : 1;

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
      const Unit un = unit_of<kRow9>(u, W, nct, ncg);
      if (un.rb != prev) {  // the RoI block's wy (and wx) rows, once
        mbar_wait(&op_empty, (q & 1) ^ 1);
        mbar_expect_tx(&op_full, (kRow9 ? 4 + 2 * nw : 4) * kHalf);
        for (int g = 0; g < 2; ++g) {
          const int m0 = (un.rb * kRoisBlock + g * kRoisWg) * kP;
          tma_load_2d(sm + L::kWy + (2 * g) * kHalf, &twy, 0, m0, &op_full);
          tma_load_2d(sm + L::kWy + (2 * g + 1) * kHalf, &twy, 64, m0, &op_full);
          if (kRow9)
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
        // row 9: pair i / nw of the unit's channels, w chunk i % nw; row 10:
        // one w, 128 channels
        const int w0 = kRow9 ? 64 * (i % nw) : un.a;
        const int c0 = kRow9 ? un.a * kUnitChannels + 2 * (i / nw) : un.b * 128;
        tma_load_3d(dst, &tf, 0, w0, c0, &full[s]);
        tma_load_3d(dst + 2 * kHalf, &tf, 64, w0, c0, &full[s]);
      }
    }
    return;
  }

  // consumer warpgroup g: RoIs rb * 18 + 9 g + [0, 9) of each RoI block
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
    const Unit un = unit_of<kRow9>(u, W, nct, ncg);
    if (un.rb != prev) {
      if (kRow9 && prev >= 0) {  // the last RoI block's wx tiles are read
        __syncwarp();
        if (lane == 0) mbar_arrive(&op_empty);
      }
      mbar_wait(&op_full, q & 1);
      ++q;
      prev = un.rb;
#pragma unroll
      for (int kk = 0; kk < 7; ++kk)
        load_a_sw128(wyf[kk], wy_s + (kk >> 2) * 64 * 64, wq, lane, kk & 3);
      if (!kRow9) {  // wy lives in registers now
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

    if constexpr (!kRow9) {
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
      const int steps = kUnitChannels / 2 * nw;
      // this lane's rows r0 + 8 h = (k_h, py_h); a column n = (k', px) of
      // the diagonal block k' == k_h lands at tile row (n, py_h), since
      // k' * 7 + px = n: the tile is [(k, px)][py][16 c]
      const int py0 = r0 % kP, py1 = (r0 + 8) % kP;
      const int n00 = r0 - py0, n01 = r0 + 8 - py1;  // 7 k_h, the block's first column
      bf16* o = reinterpret_cast<bf16*>(tile);
      float acc[16][4], d2[2][8][4];
      uint32_t ta[8][4];
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
            wgmma_rs<0, 8>(d2[ci], ta[4 * ci + kk], sw128_desc(wx_s + wc * 64 * 64 + kk * 16),
                           wc > 0 || kk > 0);
        wgmma_commit();
        const bool more = i + 1 < steps;
        if (more) s = issue_first(acc);
        wgmma_wait<0>();
        fence_acc(acc);
        fence_acc(d2[0]);
        fence_acc(d2[1]);
        if (more) release(s);
        if (wc + 1 < nw) continue;
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
      tile_written();
      if (tg == 0) {
        if (k0 < K) tma_store_4d(&tout, o, un.a * kUnitChannels, 0, 0, k0, store_policy);
        bulk_commit();  // a group every unit, empty past K: tile_free counts on it
      }
    }
    ++tiles;
  }
  if (tg == 0) bulk_wait<0>();
}

template <bool kRow9>
int launch_hopper(const void* f, const void* wy, const void* wx, void* out, int K, int C, int W,
                  int wx_pitch, int relayout, void* stream) {
  const DeviceOf device(f);
  if (device.error() != cudaSuccess) return static_cast<int>(device.error());
  const cuuint64_t k = static_cast<cuuint64_t>(K), c = static_cast<cuuint64_t>(C),
                   w = static_cast<cuuint64_t>(W);
  CUtensorMap tf, twy, twx, tout;
  const cuuint64_t f_dims[3] = {kHp, w, c};
  const cuuint64_t f_strides[2] = {kHp * 2, w * kHp * 2};
  const cuuint32_t f_box[3] = {64, kRow9 ? 64u : 1u, kRow9 ? 2u : 128u};
  const cuuint64_t wy_dims[2] = {kHp, k * kP};
  const cuuint64_t wy_strides[1] = {kHp * 2};
  const cuuint32_t tile_box[2] = {64, 64};
  bool ok = encode_bf16(&tf, f, 3, f_dims, f_strides, f_box, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B) &&
            encode_bf16(&twy, wy, 2, wy_dims, wy_strides, tile_box, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B);
  if (kRow9) {
    const cuuint64_t wx_dims[2] = {static_cast<cuuint64_t>(wx_pitch), k * kP};
    const cuuint64_t wx_strides[1] = {static_cast<cuuint64_t>(wx_pitch) * 2};
    const cuuint64_t o_dims[4] = {c, kP, kP, k};
    const cuuint64_t o_strides[3] = {c * 2, c * 2 * kP, c * 2 * kP * kP};
    const cuuint32_t o_box[4] = {kUnitChannels, kP, kP, kRoisWg};
    ok = ok &&
         encode_bf16(&twx, wx, 2, wx_dims, wx_strides, tile_box, CU_TENSOR_MAP_SWIZZLE_128B,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_128B) &&
         encode_bf16(&tout, out, 4, o_dims, o_strides, o_box, CU_TENSOR_MAP_SWIZZLE_NONE,
                     CU_TENSOR_MAP_L2_PROMOTION_NONE);
  } else if (relayout) {  // rows (k, w, py)
    twx = twy;
    const cuuint64_t o_dims[4] = {c, kP, w, k};
    const cuuint64_t o_strides[3] = {c * 2, c * 2 * kP, c * 2 * kP * w};
    const cuuint32_t o_box[4] = {64, kP, 1, kRoisWg};
    ok = ok && encode_bf16(&tout, out, 4, o_dims, o_strides, o_box, CU_TENSOR_MAP_SWIZZLE_128B,
                           CU_TENSOR_MAP_L2_PROMOTION_NONE);
  } else {  // rows (k, py, w)
    twx = twy;
    const cuuint64_t o_dims[3] = {c, w, k * kP};
    const cuuint64_t o_strides[2] = {c * 2, c * 2 * w};
    const cuuint32_t o_box[3] = {64, 1, kRowsWg};
    ok = ok && encode_bf16(&tout, out, 3, o_dims, o_strides, o_box, CU_TENSOR_MAP_SWIZZLE_128B,
                           CU_TENSOR_MAP_L2_PROMOTION_NONE);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);

  using L = Layout<kRow9>;
  const auto kernel = roi_hopper_kernel<kRow9>;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rbs = (K + kRoisBlock - 1) / kRoisBlock;
  const long long units = kRow9 ? rbs * (C / kUnitChannels) : rbs * W * ((C + 127) / 128);
  const int blocks = static_cast<int>(units < sms ? units : sms);
  kernel<<<blocks, kHopperThreads, L::kBytes, static_cast<cudaStream_t>(stream)>>>(
      tf, twy, twx, tout, K, C, W, relayout);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------------- row 11
//
// Bound on the H100 at the probe's shapes: operations, as row 9 (0.193 ms).
//
// Design (PR 5's, kept). A block takes KB RoIs (KB = 8 or 16: M = KB * 7
// rows (k, py) of the first product, padded to 64 or 112) and 16 channels,
// and loops over W in chunks of 16 w. The 3.2 MB atlas cannot sit in 227
// KB of shared memory, so each block stages, per chunk, its slice [16 c x
// 16 w rows, 112 h] (h zero-padded, the wrapper lays the atlas out as [C,
// W, 112]), and holds its RoIs' wy rows for the whole loop. Summed over
// blocks the atlas is read (K / KB) times (3.2 GB at KB = 8), from L2,
// which holds all of it; blocks of one channel tile are adjacent in the
// grid. Each warp computes 32 columns (c, w) of the first product for every
// row tile with mma.sync m16n8k16 (bf16 in, fp32 accumulate; its B
// fragments stay in registers across the row tiles), rounds t to bf16 and
// writes it to shared memory as [k][py][c][w]: the second product, per
// RoI k, is then out^T[(py, c), px] = t_k[(py, c), w] wx_k[px, w]^T, an
// m16n8k16 product with the 7 px padded to 8, summed in fp32 registers
// over the chunks. At the end the tile goes through shared memory so the
// stores are 16 bytes a thread, runs of KB * 49 (k, px, py) values per
// channel. Still simple: no TMA, no wgmma, no cp.async pipelining of the
// chunks; one block of 8 warps per SM (129-193 KB of shared memory).

constexpr int kHk = kHp / 16;   // k-steps of the first product
constexpr int kLdH = kHp + 8;   // smem pitch of wy and atlas rows (conflict-free ldmatrix)
constexpr int kN = 256;         // first-product columns (c, w) per chunk
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxW = 128;
constexpr int kCt = 16;          // channels per block
constexpr int kWc = kN / kCt;    // w per chunk
constexpr int kLdT = kWc + 8;    // t pitch

template <int KB>
struct Tile {
  static constexpr int M = KB * kP;  // rows (k, py)
  static constexpr int MP = (M + 15) / 16 * 16;
  static constexpr int T_ROWS = M * kCt;
  static constexpr int TILES2 = M / kWarps;  // second-product tiles (k, py) per warp
};

__host__ __device__ constexpr int wx_ld(int W) { return (W + 15) / 16 * 16 + 8; }

template <int KB>
constexpr size_t smem_bytes(int W) {
  using T = Tile<KB>;
  return sizeof(bf16) *
         (static_cast<size_t>(T::MP) * kLdH + kN * kLdH + T::T_ROWS * kLdT + KB * 8 * wx_ld(W));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p))
               : "memory");
}

// f: bf16 [C, W, kHp]; wy: bf16 [K * kP, kHp]; wx: bf16 [K, kP, W]; out:
// [K / KB, C, KB * kP, kP]. Grid (K / KB, C / kCt), kThreads threads,
// smem_bytes<KB>(W).
template <int KB>
__global__ void __launch_bounds__(kThreads, 1) roi_fused_e_kernel(
    const bf16* __restrict__ f, const bf16* __restrict__ wy, const bf16* __restrict__ wx,
    bf16* __restrict__ out, int C, int W) {
  using T = Tile<KB>;
  extern __shared__ __align__(16) unsigned char smem_e[];
  bf16* wy_s = reinterpret_cast<bf16*>(smem_e);  // [MP][kLdH]
  bf16* f_s = wy_s + T::MP * kLdH;               // [kN = (c, w)][kLdH]
  bf16* t_s = f_s + kN * kLdH;                   // [T_ROWS][kLdT]
  bf16* wx_s = t_s + T::T_ROWS * kLdT;           // [KB * 8 (k, px)][wx_ld]
  const int lx = wx_ld(W);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long k0 = static_cast<long long>(blockIdx.x) * KB;
  const int c0 = blockIdx.y * kCt;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  // the block's wy rows, zero past M
  for (int i = tid; i < T::MP * (kHp / 8); i += kThreads) {
    const int m = i / (kHp / 8);
    const int j = i % (kHp / 8);
    const uint4 v = m < T::M ? reinterpret_cast<const uint4*>(wy + (k0 * kP + m) * kHp)[j] : zero;
    *reinterpret_cast<uint4*>(wy_s + m * kLdH + j * 8) = v;
  }
  // the block's wx as [k][px 0..7][w], zero for px = 7 and past W
  {
    const int wp = lx - 8;
    for (int i = tid; i < KB * 8 * wp; i += kThreads) {
      const int w = i % wp;
      const int r = i / wp;
      const int px = r % 8;
      bf16 v = __float2bfloat16(0.f);
      if (px < kP && w < W) v = wx[((k0 + r / 8) * kP + px) * W + w];
      wx_s[r * lx + w] = v;
    }
  }

  float acc2[T::TILES2][4];
#pragma unroll
  for (int j = 0; j < T::TILES2; ++j) acc2[j][0] = acc2[j][1] = acc2[j][2] = acc2[j][3] = 0.f;

  const int n0 = warp * 32;  // this warp's first-product columns
  for (int w0 = 0; w0 < W; w0 += kWc) {
    __syncthreads();  // the previous chunk's readers of f_s and t_s are done
    // atlas slice: row n = c * kWc + w holds f[c0 + c, :, w0 + w], zero past W
    for (int i = tid; i < kN * (kHp / 8); i += kThreads) {
      const int n = i / (kHp / 8);
      const int j = i % (kHp / 8);
      const int w = w0 + n % kWc;
      const uint4 v =
          w < W ? reinterpret_cast<const uint4*>(
                      f + (static_cast<long long>(c0 + n / kWc) * W + w) * kHp)[j]
                : zero;
      *reinterpret_cast<uint4*>(f_s + n * kLdH + j * 8) = v;
    }
    __syncthreads();

    // first product: t[(k, py), (c, w)], B fragments held across row tiles
    uint32_t bfr[kHk][4][2];
#pragma unroll
    for (int kk = 0; kk < kHk; ++kk) {
#pragma unroll
      for (int jj = 0; jj < 4; jj += 2) {
        uint32_t r[4];
        ldmatrix_x4(r, f_s + (n0 + jj * 8 + (lane & 7) + ((lane >> 4) << 3)) * kLdH +
                           kk * 16 + ((lane >> 3) & 1) * 8);
        bfr[kk][jj][0] = r[0];
        bfr[kk][jj][1] = r[1];
        bfr[kk][jj + 1][0] = r[2];
        bfr[kk][jj + 1][1] = r[3];
      }
    }
    for (int mt = 0; mt < T::MP / 16; ++mt) {
      float acc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kHk; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, wy_s + (mt * 16 + (lane & 15)) * kLdH + kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[j], a, bfr[kk][j][0], bfr[kk][j][1]);
      }
      // t rounded to bf16 into shared memory (columns n, n + 1: w, w + 1)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = mt * 16 + (lane >> 2) + half * 8;
        if (m >= T::M) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + j * 8 + (lane & 3) * 2;
          *reinterpret_cast<__nv_bfloat162*>(t_s + (m * kCt + n / kWc) * kLdT + n % kWc) =
              __floats2bfloat162_rn(acc[j][2 * half], acc[j][2 * half + 1]);
        }
      }
    }
    __syncthreads();

    // second product: out^T[(py, c), px] += t_k[(py, c), w] wx_k[px, w]^T
#pragma unroll
    for (int j = 0; j < T::TILES2; ++j) {
      const int i = warp + j * kWarps;  // (k, py) = (i / kP, i % kP)
      uint32_t a[4];
      uint32_t b[2];
      ldmatrix_x4(a, t_s + (i * kCt + (lane & 15)) * kLdT + (lane >> 4) * 8);
      ldmatrix_x2(b, wx_s + ((i / kP) * 8 + (lane & 7)) * lx + w0 + ((lane >> 3) & 1) * 8);
      mma_bf16(acc2[j], a, b[0], b[1]);
    }
  }

  __syncthreads();
  bf16* o_s = f_s;  // KB * 49 * kCt values
#pragma unroll
  for (int j = 0; j < T::TILES2; ++j) {
    const int i = warp + j * kWarps;
    const int k = i / kP;
    const int py = i % kP;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = (lane >> 2) + half * 8;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int px = (lane & 3) * 2 + e;
        if (px >= kP) continue;
        o_s[(c * KB + k) * kP * kP + px * kP + py] = __float2bfloat16(acc2[j][2 * half + e]);
      }
    }
  }
  __syncthreads();
  // per channel one run of KB * 49 values (k, px, py) -> [K / KB, C, KB * kP, kP]
  constexpr int kRun = KB * kP * kP / 8;
  for (int i = tid; i < kCt * kRun; i += kThreads) {
    const int c = i / kRun;
    const int j = i % kRun;
    reinterpret_cast<uint4*>(
        out + (static_cast<long long>(blockIdx.x) * C + c0 + c) * KB * kP * kP)[j] =
        reinterpret_cast<const uint4*>(o_s + c * KB * kP * kP)[j];
  }
}

template <int KB>
int launch_e(const void* f, const void* wy, const void* wx, void* out, int K, int C, int W,
             void* stream) {
  const size_t smem = smem_bytes<KB>(W);
  const auto kernel = roi_fused_e_kernel<KB>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(K / KB, C / kCt);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(f), static_cast<const bf16*>(wy), static_cast<const bf16*>(wx),
      static_cast<bf16*>(out), C, W);
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
  return launch_hopper<true>(f, wy, wx, out, K, C, W, wx_pitch, 0, stream);
}

// Row 11: f, wy as row 9, wx: bf16 [K, 7, W]; out: bf16 [K / kb, C, kb *
// 7, 7] as (block, c, (k, px), py). Returns a cudaError_t code.
int roi_fused_e(const void* f, const void* wy, const void* wx, void* out, int K, int kb, int C,
                int W, void* stream) {
  if (!valid(K, kb, C, W, kCt)) return static_cast<int>(cudaErrorInvalidValue);
  return kb == 8 ? launch_e<8>(f, wy, wx, out, K, C, W, stream)
                 : launch_e<16>(f, wy, wx, out, K, C, W, stream);
}

// Row 10: f, wy as row 9; out: bf16 [K * 7 * W, C], rows (k, w, py) if
// relayout else (k, py, w). C a multiple of 64. Returns a cudaError_t code.
int roi_fused_a0(const void* f, const void* wy, void* out, int K, int kb, int C, int W,
                 int relayout, void* stream) {
  if (!valid(K, kb, C, W, 64)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_hopper<false>(f, wy, nullptr, out, K, C, W, 0, relayout, stream);
}

}  // extern "C"
