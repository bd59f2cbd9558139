// Short-sequence attention, forward and backward, for Hopper (sm_90a),
// plain C interface. Two families of kernels, chosen by the head dim D:
//   - D = 64, every preset's width: three warp-specialised Hopper kernels,
//     the forward (short_fwd_hopper), the backward's dq kernel
//     (short_dq_hopper) and its dkdv kernel (short_dkdv_hopper), on wgmma
//     and TMA with a persistent grid; their notes follow.
//   - D = 32 (the convergence recipe) and D = 128: the mma.sync kernels
//     further down (short_attention_fwd_kernel, short_attention_bwd_kernel),
//     which stage the head in shared memory with cp.async. The Hopper
//     kernels' tiles are one 128-byte swizzle atom a row (64 bf16). D = 32
//     would fit them with 64-byte-swizzled maps and descriptors and n32
//     products; that has not been tried yet. At D = 128 a head slot
//     needs twice the shared memory, and two slots no longer fit.
//
// Forward. Replaces layoutdit_tpu/ops/short_attention.py::_fwd_kernel (via
// _short_fwd): o = softmax(Q K^T * scale) V for one head whose whole
// sequence fits on the chip (N <= 256), and on request the row's
// log-sum-exp lse, fp32 [B, H, N] in the natural-log domain, which the
// backward reads. The paths run it at D = 64 with N = 197 (224 px), 256
// (16 x 16 windows), 196 (dit-large's 14 x 14 windows, with a key mask) and
// 1 (the CLS token of a windowed layer).
//
// Backward. Replaces layoutdit_tpu/ops/short_attention.py::_bwd_kernel (via
// _short_bwd): from q, k, v, o, the forward's lse and dO, with
//   P = exp(Q K^T * scale - lse),  delta = rowsum(dO o O),
//   dV = P^T dO,  dS = P o (dO V^T - delta),
//   dQ = dS K * scale,  dK = dS^T Q * scale.
// The TPU kernel recomputes the softmax from q and k in one pass (its whole
// [Np, Np] tile sits in VMEM); here the forward's lse takes its place, so P
// costs no product of its own.
//
// Bound on the H100: bytes. Forward at B=64, H=12, N=256, D=64: Q, K, V in
// and O out, 100 MB (0.030 ms at 3.35 TB/s), against 12.9 GFLOP (0.013 ms
// at the bf16 peak). Backward: q, k, v, o and dO in, dq, dk, dv out,
// 201 MB (0.060 ms), against five products, 32 GFLOP (0.033 ms); the lse
// this design reads is not counted (the TPU kernel needs none).
//
// The Hopper kernels' shared shape (D = 64):
//   - A unit is 128 rows of one head, 64 for each of two consumer
//     warpgroups (query rows in the forward and the dq kernel, key rows in
//     the dkdv kernel); a head has ceil(N / 128) units. The grid is
//     persistent, one block an SM: block x takes a contiguous run of the
//     B * H * ceil(N / 128) units, head by head, so the units of one head
//     follow each other on one SM and no wave is left part-full. The heads
//     run batch element by batch element (the H heads of a row are
//     neighbours in memory), the elements in a stride coprime with B, so
//     that the windows a mask pads (slower, below) spread over the runs.
//   - A producer warpgroup (setmaxnreg: 40 registers a thread; one thread
//     issues) loads by TMA, through 4-d tensor maps over the [B, N, H, D]
//     strides (the fused projection's slices are read in place, rows 128
//     bytes, 128-byte swizzled), each new head's resident pair of tensors
//     (rows [0, 128 * units), rows past N zero-filled by TMA) into one of two
//     head slots, and each unit's 128 rows of its own tensors into one of
//     two unit stages. Slots and stages complete on "full" mbarriers and are
//     handed back on "empty" ones, so the next head's K and V (64 KB at N =
//     256) load while the consumers work on this one.
//   - The consumers (232 registers a thread) run every product as wgmma
//     (bf16 in, fp32 accumulate; helpers in hopper_mma.cuh), the softmax
//     and the gradient algebra in registers in the exp2 domain with the
//     scale folded into one FFMA. A product that a loop issues again reads
//     its A operand from shared memory, or from registers written just
//     before it (P, dS): Q and dO held in registers across a loop's
//     iterations gave a wrong dq on the card once the loop also read the
//     mask (ptxas may move registers an in-flight wgmma still reads).
//   - The key mask (Masked = true, uint8 [mask_rows, N], row b % mask_rows
//     for batch b) comes with the head: its row, the 16-byte-aligned span
//     around it, by one bulk copy into the head slot. A row that drops no
//     key below N takes the unmasked path (so an all-True mask gives the
//     unmasked kernels' bits); otherwise each warp turns the row into
//     words of kept keys with one ballot per 32 keys (kept_words), and a
//     dropped key's score is -inf, so its P is exactly 0 in the forward and
//     in both backward kernels, and its dK and dV rows are exactly 0.
//     Every row must keep one real key (a window always does); it is not
//     checked. Without a mask, keys past N get the TPU kernel's finite
//     -1e30.
//   - Every sum is kept in one thread's registers and written once: no
//     atomics, the same bits every run.
//
// short_fwd_hopper. Resident: K and V of the head; unit: Q. Each consumer
// sweeps the head in 128-key halves: S = Q K^T (m64n128, Q and K both read
// from shared memory, K-major), the online softmax, O += P V (P packed as
// the register A operand, V read MN-major); the next half's S is issued
// with this half's P V, so the softmax runs while P V does, and the two
// consumers take turns to issue (named barriers), so one's softmax runs
// under the other's products. O is normalised, rounded to bf16 into a
// swizzled [64, 64] tile and stored by TMA into [B, N, H, D], clipped at
// N; lse, when asked for, goes to [B, H, N].
//
// short_dq_hopper. Resident: K and V; unit: Q and dO. Each consumer
// computes delta = rowsum(dO o O) of its rows (from O and dO in device
// memory, four lanes a row) and writes it to an fp32 [B, H, N] buffer for the
// dkdv kernel, launched after it on the same stream; reads its rows' lse;
// then sweeps the head's 64-key tiles: S = Q K^T and dP = dO V^T (all
// operands from shared memory), P while dP runs, dS = P o (dP - delta),
// dQ += dS K (K read MN-major). dQ goes out through the caller's strides,
// times scale.
//
// short_dkdv_hopper. Resident: Q, dO, and the head's lse and delta rows
// (bulk copies of their 16-byte-aligned spans); unit: K and V. Each consumer
// sweeps the head's 64-query tiles: S^T = K Q^T and dP^T = V dO^T (both
// operands from shared memory), P^T while dP^T runs (0 for queries past N
// and for dropped keys), dV += P^T dO while dS^T = P^T o (dP^T - delta)
// forms, dK += dS^T Q. dK (times scale) and dV go out through the caller's
// strides.
//
// Products: 2 in the forward, 3 + 4 = 7 in the backward (the one-block
// backward of the first port, which recomputed lse, needed 8). Tried and
// not kept (PERF.md): Q and dO as register A operands reloaded each tile
// (within 1%), turns in the backward kernels (+-1-3% by shape), the
// forward's exponentials in f16x2 (3% slower). ptxas (CUDA 12, sm_90a):
// each of the three kernels 168 registers at its launch bound (384
// threads, one block an SM; the consumers raise theirs to 232 with
// setmaxnreg), no spills; dynamic shared memory 187,392 bytes (forward)
// and 203,776 (dq, dkdv), chip_smoke.py prints both.

#include <math_constants.h>

#include <atomic>
#include <mutex>
#include <set>
#include <utility>

#include "attention_f32.cuh"
#include "hopper_mma.cuh"

namespace {

constexpr int kMaxN = 256;
constexpr int kMaxDevices = 64;  // devices whose SM count a process keeps

// --------------------------------------------------------------------------
// Hopper kernels, D = 64

constexpr int kHd = 64;                        // the head dim they take
constexpr int kBox = 64;                       // rows of a TMA box and of a wgmma M
constexpr int kBoxBytes = kBox * kHd * 2;      // one bf16 [64, 64] tile
constexpr int kUnitRows = 2 * kBox;            // a unit: two consumer warpgroups
constexpr int kHopperThreads = 3 * 128;        // two consumers, one producer
constexpr int kMaxBoxes = kMaxN / kBox;        // tiles of a resident tensor
constexpr int kVecPitch = kMaxN + 8;           // floats of a resident lse or delta span
constexpr int kSlotVecBytes = 3 * 1024;        // a slot's mask span, or lse and delta
constexpr int kSlotBytes = 2 * kMaxBoxes * kBoxBytes + kSlotVecBytes;  // 1024-aligned
constexpr int kConsumerRegs = 232;
constexpr int kProducerRegs = 40;
static_assert(kSlotBytes % 1024 == 0 && 2 * kVecPitch * 4 <= kSlotVecBytes,
              "head slots start on swizzle atoms and hold their vectors");

// what a head slot carries beside its two tensors
enum SlotVec { kNoVec, kMaskVec, kLseDelta };

// One head's resident rows: tensors a and b, [256, 64] each (K and V in the
// forward and the dq kernel, Q and dO in the dkdv kernel), then the mask
// span or the lse and delta spans.
struct HeadSlot {
  uint8_t* base;
  __device__ __forceinline__ bf16* a() const { return reinterpret_cast<bf16*>(base); }
  __device__ __forceinline__ bf16* b() const {
    return reinterpret_cast<bf16*>(base + kMaxBoxes * kBoxBytes);
  }
  __device__ __forceinline__ uint8_t* vec() const { return base + 2 * kMaxBoxes * kBoxBytes; }
};

// the block's contiguous run [first, last) of the B * H * pairs units
// (pairs = ceil(N / 128) a head), head-major; the heads run batch element by
// batch element, h fastest (the heads of one row are neighbours in memory),
// and the batch elements in steps of b_step, coprime with B (head_of): the
// windows whose padding the mask drops (9 of dit-large's 25, one batch
// element each, slower than the rest) spread over the blocks' runs rather
// than filling some
struct Units {
  int first, last, pairs;
};
struct Head {
  int b, h;
};
__device__ __forceinline__ Head head_of(int hi, int H, int B, int b_step) {
  const int i = hi / H;
  return Head{static_cast<int>(static_cast<long long>(i) * b_step % B), hi - i * H};
}

__device__ __forceinline__ Units block_units(int B, int H, int N) {
  const int pairs = (N + kUnitRows - 1) / kUnitRows;
  const long long units = static_cast<long long>(B) * H * pairs;
  return Units{static_cast<int>(units * blockIdx.x / gridDim.x),
               static_cast<int>(units * (blockIdx.x + 1) / gridDim.x), pairs};
}

// Masked: does the staged mask row drop any key below N? (one answer for the
// whole warp, from at most eight loads a lane; a row that drops none takes the
// unmasked kernels' path, so an all-True mask gives their bits)
__device__ __forceinline__ bool drops_keys(const uint8_t* keep, int N, int lane) {
  bool all = true;
  for (int i = lane; i < N; i += 32) all = all && keep[i] != 0;
  return !__all_sync(0xffffffffu, all);
}

// What the producer copies beside the tiles: the key mask, or the head's lse
// and delta rows.
struct VecSrc {
  const uint8_t* mask;
  int mask_rows;
  const float* lse;
  const float* delta;
};

// The mbarriers of a kernel: two head slots and two unit stages.
struct Bars {
  uint64_t head_full[2], head_empty[2], unit_full[2], unit_empty[2];
};

__device__ __forceinline__ void init_bars(Bars& bars) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&bars.head_full[i], 1);   // the producer's arrival with its bytes
      mbar_init(&bars.head_empty[i], 8);  // one arrival per consumer warp
      mbar_init(&bars.unit_full[i], 1);
      mbar_init(&bars.unit_empty[i], 8);
    }
    mbar_init_fence();
  }
  __syncthreads();
}

// The producer's one issuing thread: walks the block's units; at each new
// head waits for the head slot it takes to be handed back, then loads the
// head's tensors a and b (rows [0, 128 * pairs), by 64-row TMA boxes, rows
// past N as zeros) and its vector spans; at each unit waits for its stage
// and loads the unit's 128 rows of its kUnitTensors tensors (unit row 128 u
// + 64 x + r into stage rows 64 x + r; tensor 1 after tensor 0's 128 rows).
template <int kUnitTensors, SlotVec kVec>
__device__ __forceinline__ void produce(const CUtensorMap* head_a, const CUtensorMap* head_b,
                                        const CUtensorMap* unit_a, const CUtensorMap* unit_b,
                                        VecSrc vs, uint8_t* slots, uint8_t* stages, Bars& bars,
                                        int B, int H, int N, int b_step) {
  const Units wk = block_units(B, H, N);
  const int boxes = 2 * wk.pairs;
  int heads = 0, prev = -1;
  for (int u = wk.first, n = 0; u < wk.last; ++u, ++n) {
    const int hi = u / wk.pairs;
    const Head hd = head_of(hi, H, B, b_step);
    const int b = hd.b, h = hd.h;
    const long long bh = static_cast<long long>(b) * H + h;  // the lse and delta row
    if (hi != prev) {
      const int slot = heads & 1;
      mbar_wait(&bars.head_empty[slot], ((heads >> 1) & 1) ^ 1);
      const HeadSlot hs{slots + slot * kSlotBytes};
      Span s0{nullptr, 0}, s1{nullptr, 0};
      if constexpr (kVec == kMaskVec) s0 = byte_span(mask_row(vs.mask, vs.mask_rows, b, N), N);
      if constexpr (kVec == kLseDelta) {
        s0 = aligned_span(vs.lse + bh * N, N);
        s1 = aligned_span(vs.delta + bh * N, N);
      }
      mbar_expect_tx(&bars.head_full[slot], 2 * boxes * kBoxBytes + s0.bytes + s1.bytes);
      for (int x = 0; x < boxes; ++x) {
        tma_load_4d(hs.a() + x * kBox * kHd, head_a, 0, h, x * kBox, b, &bars.head_full[slot]);
        tma_load_4d(hs.b() + x * kBox * kHd, head_b, 0, h, x * kBox, b, &bars.head_full[slot]);
      }
      if (s0.bytes != 0) bulk_load(hs.vec(), s0.src, s0.bytes, &bars.head_full[slot]);
      if (s1.bytes != 0)
        bulk_load(hs.vec() + kVecPitch * 4, s1.src, s1.bytes, &bars.head_full[slot]);
      ++heads;
      prev = hi;
    }
    const int s = n & 1;
    mbar_wait(&bars.unit_empty[s], ((n >> 1) & 1) ^ 1);
    mbar_expect_tx(&bars.unit_full[s], kUnitTensors * 2 * kBoxBytes);
    const int r0 = (u - hi * wk.pairs) * kUnitRows;
    bf16* st = reinterpret_cast<bf16*>(stages + s * kUnitTensors * 2 * kBoxBytes);
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      tma_load_4d(st + x * kBox * kHd, unit_a, 0, h, r0 + x * kBox, b, &bars.unit_full[s]);
      if constexpr (kUnitTensors == 2)
        tma_load_4d(st + (2 + x) * kBox * kHd, unit_b, 0, h, r0 + x * kBox, b,
                    &bars.unit_full[s]);
    }
  }
}

// A consumer warpgroup's walk of the same units, in step with the producer:
// per unit it waits for the head slot and the unit stage (also when its 64
// rows lie past N, so that every warp arrives once a phase), and hands the
// previous head's slot back when the head changes. body(stage, slot, b, h,
// the warpgroup's first row) hands the stage back itself.
template <typename Body>
__device__ __forceinline__ void consume(Bars& bars, int B, int H, int N, int b_step, int c,
                                        int lane, Body&& body) {
  const Units wk = block_units(B, H, N);
  int heads = 0, prev = -1;
  for (int u = wk.first, n = 0; u < wk.last; ++u, ++n) {
    const int hi = u / wk.pairs;
    if (hi != prev) {
      if (prev >= 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&bars.head_empty[(heads - 1) & 1]);
      }
      ++heads;
      prev = hi;
    }
    const int slot = (heads - 1) & 1;
    const int s = n & 1;
    mbar_wait(&bars.head_full[slot], ((heads - 1) >> 1) & 1);
    mbar_wait(&bars.unit_full[s], (n >> 1) & 1);
    const Head hd = head_of(hi, H, B, b_step);
    body(s, slot, hd.b, hd.h, (u - hi * wk.pairs) * kUnitRows + c * kBox);
  }
}

// hand the unit stage s back (every lane of the warp has done reading it)
__device__ __forceinline__ void release(Bars& bars, int s, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(&bars.unit_empty[s]);
}

// TMA store of a shared-memory tile to the box at (c0, c1, c2, c3) of a 4-d
// tensor map, in this thread's bulk group, with the default L2 policy (the
// output is read again soon: the projection after attention)
__device__ __forceinline__ void tma_store_4d_keep(const CUtensorMap* map, const void* src, int c0,
                                                  int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::
          "l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// dynamic shared memory of the Hopper kernels, 1024 bytes of alignment
// slack included: two head slots, two unit stages, and in the forward two
// [64, 64] O tiles
constexpr int hopper_smem_bytes(int unit_tensors, bool o_tiles) {
  return 1024 + 2 * kSlotBytes + 2 * unit_tensors * 2 * kBoxBytes + (o_tiles ? 2 * kBoxBytes : 0);
}

template <bool Masked>
__global__ void __launch_bounds__(kHopperThreads, 1) short_fwd_hopper(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
    float* __restrict__ lse, const uint8_t* __restrict__ mask, int mask_rows, int B, int H,
    int N, int b_step, float scale) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ Bars bars;
  uint8_t* sm = align1024(smem_raw);
  uint8_t* slots = sm;
  uint8_t* stages = sm + 2 * kSlotBytes;                                   // 2 x Q [128, 64]
  bf16* o_tiles = reinterpret_cast<bf16*>(stages + 2 * 2 * kBoxBytes);     // 2 x [64, 64]
  init_bars(bars);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= 8) {  // producer warpgroup
    warpgroup_regs_dec<kProducerRegs>();
    if (threadIdx.x == 256)
      produce<1, Masked ? kMaskVec : kNoVec>(&tk, &tv, &tq, nullptr,
                                             VecSrc{mask, mask_rows, nullptr, nullptr}, slots,
                                             stages, bars, B, H, N, b_step);
    return;
  }
  warpgroup_regs_inc<kConsumerRegs>();
  const int c = warp >> 2;  // consumer warpgroup: rows 64 c + [0, 64) of a unit
  const int w = warp & 3;
  const int quad = lane & 3;
  const int wt = threadIdx.x & 127;
  const float scale2 = scale * kLog2e;  // scale > 0: the raw scores' max is the scaled ones'
  const int halves = (N + kUnitRows - 1) / kUnitRows;  // 128-key halves of the head
  bf16* o_tile = o_tiles + c * kBox * kHd;
  // a dropped key's score: -inf where a mask may drop keys anywhere (a
  // 128-key half may then hold none), else the TPU kernel's finite -1e30
  const float dropped = Masked ? -CUDART_INF_F : kNegInf;

  // the two consumers take turns to issue their products (named barriers 3
  // and 4 over both warpgroups), so one's softmax runs while the other's
  // products do
  auto turn = [&] { named_barrier_sync(3 + c, 256); };
  auto pass = [&] { named_barrier_arrive(4 - c, 256); };
  if (c == 1) pass();  // consumer 0 issues first
  consume(bars, B, H, N, b_step, c, lane, [&](int s, int slot, int b, int h, int r0) {
    if (r0 >= N) {  // rows all past N: nothing to compute or store, turns to pass
      release(bars, s, lane);
      for (int i = 0; i <= halves; ++i) {
        turn();
        pass();
      }
      return;
    }
    const HeadSlot hs{slots + slot * kSlotBytes};
    const uint8_t* keep = nullptr;
    bool use_mask = false;
    if constexpr (Masked) {
      keep = hs.vec() + (reinterpret_cast<uintptr_t>(mask_row(mask, mask_rows, b, N)) & 15u);
      use_mask = drops_keys(keep, N, lane);
    }
    // this warpgroup's Q rows, read from the stage by both S products
    const bf16* qa = reinterpret_cast<const bf16*>(stages + s * 2 * kBoxBytes) + c * kBox * kHd;

    float acc[8][4], sc[16][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    // running max (exp2 domain) and per-lane partial sum of this lane's rows
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, corr[2];
    uint32_t pa[8][4];

    auto issue_s = [&](int t) {  // S = Q K^T over keys 128 t + [0, 128)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<0>(sc, sw128_desc(qa + kk * 16),
                    sw128_desc(hs.a() + t * kUnitRows * kHd + kk * 16), kk);
      wgmma_commit();
    };
    auto issue_pv = [&](int t) {  // O += P V over the same keys
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_rs<1>(acc, pa[kk], sw128_desc(hs.b() + (t * kUnitRows + kk * 16) * kHd));
      wgmma_commit();
    };
    auto softmax = [&](int t) {  // sc of half t becomes P; m, l and corr updated
      const int kv0 = t * kUnitRows;
      if (use_mask || kv0 + kUnitRows > N) {  // a half with keys to drop
        uint32_t kw[4];
        kept_words(kw, keep, use_mask, kv0, N, lane, quad);
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (!kept_bit(kw, j, e)) sc[j][e] = dropped;
      }
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mn = fmaxf(m[r], quad_max(mx[r]) * scale2);
        corr[r] = exp2_ftz(m[r] - mn);
        m[r] = mn;
      }
      float ps[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[j][e] = exp2_ftz(fmaf(sc[j][e], scale2, -m[e >> 1]));
          ps[e >> 1] += sc[j][e];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + ps[r];
    };
    auto pack = [&] {
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) pack_a(pa[kk], sc, kk);
    };
    auto fence_operands = [&] {
      fence_acc(acc);
      fence_frag(pa);
      wgmma_fence();
    };

    turn();
    wgmma_fence();
    issue_s(0);
    pass();
    wgmma_wait<0>();
    fence_acc(sc);
    softmax(0);
    pack();
    for (int t = 0; t + 1 < halves; ++t) {  // at most once: N <= 256
      turn();
      fence_operands();
      issue_s(t + 1);
      issue_pv(t);
      pass();
      wgmma_wait<1>();
      fence_acc(sc);
      softmax(t + 1);
      wgmma_wait<0>();
      fence_acc(acc);
      fence_frag(pa);  // P V read them until here
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[j][0] *= corr[0];
        acc[j][1] *= corr[0];
        acc[j][2] *= corr[1];
        acc[j][3] *= corr[1];
      }
      pack();
    }
    turn();
    fence_operands();
    issue_pv(halves - 1);
    pass();
    wgmma_wait<0>();
    fence_acc(acc);
    fence_frag(pa);
    release(bars, s, lane);  // Q was read by the S products until here

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = fmaxf(quad_sum(l[r]), 1e-30f);
      inv[r] = 1.f / l[r];
    }
    // O as bf16 into the warpgroup's swizzled tile (the last TMA store from
    // it has read it), then one TMA store, clipped at N
    if (wt == 0) bulk_wait_read<0>();
    named_barrier_sync(1 + c, 128);
    uint8_t* tile = reinterpret_cast<uint8_t*>(o_tile);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = w * 16 + (lane >> 2) + 8 * r;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(tile + row * 128 + ((j ^ (row & 7)) << 4) + 4 * quad) =
            pack_bf16(acc[j][2 * r] * inv[r], acc[j][2 * r + 1] * inv[r]);
    }
    fence_proxy_async();
    named_barrier_sync(1 + c, 128);
    if (wt == 0) {
      tma_store_4d_keep(&to, o_tile, 0, h, r0, b);
      bulk_commit();
    }
    if (lse != nullptr && quad == 0) {
      float* lse_bh = lse + static_cast<long long>(b * H + h) * N;
      const int row0 = r0 + w * 16 + (lane >> 2);
      if (row0 < N) lse_bh[row0] = (m[0] + log2f(l[0])) * kLn2;
      if (row0 + 8 < N) lse_bh[row0 + 8] = (m[1] + log2f(l[1])) * kLn2;
    }
  });
  if (wt == 0) bulk_wait<0>();
}

template <bool Masked>
__global__ void __launch_bounds__(kHopperThreads, 1) short_dq_hopper(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
    const bf16* __restrict__ o, const bf16* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ delta, bf16* __restrict__ dq, const uint8_t* __restrict__ mask,
    int mask_rows, int B, int H, int N, int b_step, Strides os, Strides dos, Strides dqs,
    float scale) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ Bars bars;
  uint8_t* sm = align1024(smem_raw);
  uint8_t* slots = sm;                     // K, V, mask span
  uint8_t* stages = sm + 2 * kSlotBytes;   // 2 x (Q [128, 64], dO [128, 64])
  init_bars(bars);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= 8) {
    warpgroup_regs_dec<kProducerRegs>();
    if (threadIdx.x == 256)
      produce<2, Masked ? kMaskVec : kNoVec>(&tk, &tv, &tq, &tdo,
                                             VecSrc{mask, mask_rows, nullptr, nullptr}, slots,
                                             stages, bars, B, H, N, b_step);
    return;
  }
  warpgroup_regs_inc<kConsumerRegs>();
  const int c = warp >> 2;
  const int w = warp & 3;
  const int quad = lane & 3;
  const float scale2 = scale * kLog2e;
  const int tiles = (N + kBox - 1) / kBox;  // 64-key tiles of the head

  consume(bars, B, H, N, b_step, c, lane, [&](int s, int slot, int b, int h, int r0) {
    if (r0 >= N) {
      release(bars, s, lane);
      return;
    }
    const HeadSlot hs{slots + slot * kSlotBytes};
    const uint8_t* keep = nullptr;
    bool use_mask = false;
    if constexpr (Masked) {
      keep = hs.vec() + (reinterpret_cast<uintptr_t>(mask_row(mask, mask_rows, b, N)) & 15u);
      use_mask = drops_keys(keep, N, lane);
    }
    const int row0 = r0 + w * 16 + (lane >> 2);
    const int row1 = row0 + 8;
    const long long bh = static_cast<long long>(b) * H + h;
    // delta and lse (exp2 domain) of this lane's two rows; 0 past N
    const float dl0 = quad_row_dot<64>(o + b * os.b + row0 * os.n + h * os.h,
                                       dout + b * dos.b + row0 * dos.n + h * dos.h, row0 < N, quad);
    const float dl1 = quad_row_dot<64>(o + b * os.b + row1 * os.n + h * os.h,
                                       dout + b * dos.b + row1 * dos.n + h * dos.h, row1 < N, quad);
    const float lse0 = row0 < N ? lse[bh * N + row0] * kLog2e : 0.f;
    const float lse1 = row1 < N ? lse[bh * N + row1] * kLog2e : 0.f;
    if (quad == 0) {
      if (row0 < N) delta[bh * N + row0] = dl0;
      if (row1 < N) delta[bh * N + row1] = dl1;
    }
    // this warpgroup's Q and dO rows, read from the stage by S and dP
    const bf16* st = reinterpret_cast<const bf16*>(stages + s * 4 * kBoxBytes);
    const bf16* qa = st + c * kBox * kHd;
    const bf16* da = st + (2 + c) * kBox * kHd;

    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    for (int t = 0; t < tiles; ++t) {
      const bf16* kt = hs.a() + t * kBox * kHd;
      const bf16* vt = hs.b() + t * kBox * kHd;
      float sc[8][4], dp[8][4];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // S = Q K^T
        wgmma_ss<0>(sc, sw128_desc(qa + kk * 16), sw128_desc(kt + kk * 16), kk);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // dP = dO V^T
        wgmma_ss<0>(dp, sw128_desc(da + kk * 16), sw128_desc(vt + kk * 16), kk);
      wgmma_commit();

      // P = exp(S * scale - lse), 0 for keys past N or dropped, while dP runs
      uint32_t kw[2];  // the tile's keys that take part
      kept_words(kw, keep, use_mask, t * kBox, N, lane, quad);
      wgmma_wait<1>();
      fence_acc(sc);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[j][e] = kept_bit(kw, j, e)
                         ? exp2_ftz(fmaf(sc[j][e], scale2, -(e < 2 ? lse0 : lse1)))
                         : 0.f;
      // dS = P o (dP - delta), then dQ += dS K
      wgmma_wait<0>();
      fence_acc(dp);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] *= dp[j][e] - (e < 2 ? dl0 : dl1);
      uint32_t ds[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) pack_a(ds[kk], sc, kk);
      fence_acc(acc);
      fence_frag(ds);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<1>(acc, ds[kk], sw128_desc(kt + kk * 16 * kHd));
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc);
      fence_frag(ds);
    }
    release(bars, s, lane);  // Q and dO were read by S and dP until here
    store_rows<64>(dq + b * dqs.b + h * dqs.h, dqs.n, acc, row0, N, quad, scale);
  });
}

template <bool Masked>
__global__ void __launch_bounds__(kHopperThreads, 1) short_dkdv_hopper(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
    const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dk,
    bf16* __restrict__ dv, const uint8_t* __restrict__ mask, int mask_rows, int B, int H, int N,
    int b_step, Strides dks, Strides dvs, float scale) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ Bars bars;
  uint8_t* sm = align1024(smem_raw);
  uint8_t* slots = sm;                     // Q, dO, lse and delta spans
  uint8_t* stages = sm + 2 * kSlotBytes;   // 2 x (K [128, 64], V [128, 64])
  init_bars(bars);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= 8) {
    warpgroup_regs_dec<kProducerRegs>();
    if (threadIdx.x == 256)
      produce<2, kLseDelta>(&tq, &tdo, &tk, &tv, VecSrc{nullptr, 0, lse, delta}, slots, stages,
                            bars, B, H, N, b_step);
    return;
  }
  warpgroup_regs_inc<kConsumerRegs>();
  const int c = warp >> 2;
  const int w = warp & 3;
  const int quad = lane & 3;
  const float scale2 = scale * kLog2e;
  const int tiles = (N + kBox - 1) / kBox;  // 64-query tiles of the head

  consume(bars, B, H, N, b_step, c, lane, [&](int s, int slot, int b, int h, int k0) {
    if (k0 >= N) {
      release(bars, s, lane);
      return;
    }
    const HeadSlot hs{slots + slot * kSlotBytes};
    const long long bh = static_cast<long long>(b) * H + h;
    // this lane's two keys (accumulator rows lane / 4 and lane / 4 + 8): do
    // they take part (below N and, Masked, kept)?
    const int key0 = k0 + w * 16 + (lane >> 2);
    const int key1 = key0 + 8;
    bool keep0 = key0 < N, keep1 = key1 < N;
    if constexpr (Masked) {
      const uint8_t* row = mask_row(mask, mask_rows, b, N);
      keep0 = keep0 && row[key0];
      keep1 = keep1 && row[key1];
    }
    const float* lse_v = reinterpret_cast<const float*>(hs.vec()) + span_shift(lse + bh * N);
    const float* dl_v = reinterpret_cast<const float*>(hs.vec()) + kVecPitch +
                        span_shift(delta + bh * N);
    const bf16* st = reinterpret_cast<const bf16*>(stages + s * 4 * kBoxBytes);
    const bf16* ka = st + c * kBox * kHd;
    const bf16* va = st + (2 + c) * kBox * kHd;

    float dka[8][4], dva[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      dka[j][0] = dka[j][1] = dka[j][2] = dka[j][3] = 0.f;
      dva[j][0] = dva[j][1] = dva[j][2] = dva[j][3] = 0.f;
    }
    for (int t = 0; t < tiles; ++t) {
      const bf16* qt = hs.a() + t * kBox * kHd;
      const bf16* dt = hs.b() + t * kBox * kHd;
      float sct[8][4], dpt[8][4];
      fence_acc(dka);
      fence_acc(dva);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // S^T = K Q^T
        wgmma_ss<0>(sct, sw128_desc(ka + kk * 16), sw128_desc(qt + kk * 16), kk);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // dP^T = V dO^T
        wgmma_ss<0>(dpt, sw128_desc(va + kk * 16), sw128_desc(dt + kk * 16), kk);
      wgmma_commit();

      const int q0 = t * kBox;
      // lse (exp2 domain) and delta of this lane's queries; past N neither is
      // used (P^T is 0 there, and delta is set to 0 in a branch of its own)
      float ls[8][2], dl[8][2];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          ls[j][e] = lse_v[q0 + j * 8 + 2 * quad + e] * kLog2e;
          dl[j][e] = dl_v[q0 + j * 8 + 2 * quad + e];
        }
      if (q0 + kBox > N) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (q0 + j * 8 + 2 * quad + e >= N) dl[j][e] = 0.f;
      }

      // P^T while dP^T runs; then dV += P^T dO
      wgmma_wait<1>();
      fence_acc(sct);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool kept = (e < 2 ? keep0 : keep1) && q0 + j * 8 + 2 * quad + (e & 1) < N;
          sct[j][e] = kept ? exp2_ftz(fmaf(sct[j][e], scale2, -ls[j][e & 1])) : 0.f;
        }
      uint32_t pa[4][4], da[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) pack_a(pa[kk], sct, kk);
      fence_frag(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // dV += P^T dO
        wgmma_rs<1>(dva, pa[kk], sw128_desc(dt + kk * 16 * kHd));
      wgmma_commit();

      // dS^T = P^T o (dP^T - delta) while dV runs; then dK += dS^T Q
      wgmma_wait<1>();
      fence_acc(dpt);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dpt[j][e] = sct[j][e] * (dpt[j][e] - dl[j][e & 1]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) pack_a(da[kk], dpt, kk);
      fence_frag(da);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // dK += dS^T Q
        wgmma_rs<1>(dka, da[kk], sw128_desc(qt + kk * 16 * kHd));
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(dka);
      fence_acc(dva);
      fence_frag(pa);
      fence_frag(da);
    }
    release(bars, s, lane);  // K and V were read by the products until here
    store_rows<64>(dk + b * dks.b + h * dks.h, dks.n, dka, key0, N, quad, scale);
    store_rows<64>(dv + b * dvs.b + h * dvs.h, dvs.n, dva, key0, N, quad, 1.f);
  });
}

// A 4-d tensor map over a bf16 [B, N, H, 64] tensor with element strides s
// (dims innermost first: d, h, n, b), box one head's [64 rows, 64], 128-byte
// swizzle, zeros past the extent on loads, clipped on stores. TMA needs a
// 16-byte-aligned base and byte strides that are multiples of 16 (the
// wrapper's _check_heads).
bool encode_heads(CUtensorMap* map, const void* base, int B, int N, int H, Strides s) {
  const cuuint64_t dims[4] = {kHd, static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s.h) * 2,
                                 static_cast<cuuint64_t>(s.n) * 2,
                                 static_cast<cuuint64_t>(s.b) * 2};
  const cuuint32_t box[4] = {kHd, 1, kBox, 1};
  return encode_bf16(map, base, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_128B);
}

// the step of the kernels' batch order (head_of): the first integer from
// 0.618 B up that is coprime with B, so that neighbouring heads in a block's
// run come from batch elements far apart
int batch_step(int B) {
  auto gcd = [](int a, int b) {
    while (b != 0) {
      const int t = a % b;
      a = b;
      b = t;
    }
    return a;
  };
  int step = (B * 618) / 1000;
  while (step < 1 || gcd(step, B) != 1) ++step;
  return step;
}

// grid of a persistent kernel on device dev: one block an SM, at most one
// a unit; the SM count is read at the device's first launch and kept
cudaError_t persistent_grid(int dev, int B, int H, int N, int* blocks) {
  static std::atomic<int> sms_of[kMaxDevices];
  int sms = dev < kMaxDevices ? sms_of[dev].load(std::memory_order_relaxed) : 0;
  if (sms == 0) {
    const cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) sms_of[dev].store(sms, std::memory_order_relaxed);
  }
  const long long units = static_cast<long long>(B) * H * ((N + kUnitRows - 1) / kUnitRows);
  *blocks = static_cast<int>(units < sms ? units : sms);
  return cudaSuccess;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// allow_smem for a Hopper kernel, whose shared memory is the same at every
// shape: set at the kernel's first launch on device dev and not again (the
// attribute holds for the process), so that a launch costs the host no
// more than its map encodes and the launch itself
template <typename Kernel>
cudaError_t allow_smem_once(Kernel kernel, int bytes, int dev) {
  static std::mutex mu;
  static std::set<std::pair<const void*, int>> raised;
  const std::pair<const void*, int> key(reinterpret_cast<const void*>(kernel), dev);
  const std::lock_guard<std::mutex> lock(mu);
  if (raised.count(key) != 0) return cudaSuccess;
  const cudaError_t err = allow_smem(kernel, bytes);
  if (err == cudaSuccess) raised.insert(key);
  return err;
}

int launch_fwd_hopper(const void* q, const void* k, const void* v, void* o, void* lse,
                      const void* mask, int mask_rows, int B, int N, int H, const Strides (&s)[4],
                      float scale, cudaStream_t stream) {
  const DeviceOf device(q);
  if (device.error() != cudaSuccess) return static_cast<int>(device.error());
  CUtensorMap maps[4];
  const void* ptrs[4] = {q, k, v, o};
  for (int t = 0; t < 4; ++t)
    if (!encode_heads(&maps[t], ptrs[t], B, N, H, s[t]))
      return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = mask != nullptr ? short_fwd_hopper<true> : short_fwd_hopper<false>;
  const int smem = hopper_smem_bytes(1, true);
  int blocks = 0;
  cudaError_t err = persistent_grid(device.device(), B, H, N, &blocks);
  if (err == cudaSuccess) err = allow_smem_once(kernel, smem, device.device());
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, kHopperThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<float*>(lse),
      static_cast<const uint8_t*>(mask), mask_rows, B, H, N, batch_step(B), scale);
  return static_cast<int>(cudaGetLastError());
}

// s: q, k, v, o, dout, dq, dk, dv
int launch_bwd_hopper(const void* q, const void* k, const void* v, const void* o,
                      const void* dout, const void* lse, void* delta, void* dq, void* dk,
                      void* dv, const void* mask, int mask_rows, int B, int N, int H,
                      const Strides (&s)[8], float scale, cudaStream_t stream) {
  const DeviceOf device(q);
  if (device.error() != cudaSuccess) return static_cast<int>(device.error());
  CUtensorMap maps[4];  // q, k, v, dout
  const void* ptrs[4] = {q, k, v, dout};
  const int at[4] = {0, 1, 2, 4};
  for (int t = 0; t < 4; ++t)
    if (!encode_heads(&maps[t], ptrs[t], B, N, H, s[at[t]]))
      return static_cast<int>(cudaErrorInvalidValue);
  const bool masked = mask != nullptr;
  const auto dq_kernel = masked ? short_dq_hopper<true> : short_dq_hopper<false>;
  const auto dkdv_kernel = masked ? short_dkdv_hopper<true> : short_dkdv_hopper<false>;
  const int smem = hopper_smem_bytes(2, false);
  int blocks = 0;
  cudaError_t err = persistent_grid(device.device(), B, H, N, &blocks);
  if (err == cudaSuccess) err = allow_smem_once(dq_kernel, smem, device.device());
  if (err == cudaSuccess) err = allow_smem_once(dkdv_kernel, smem, device.device());
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* m = static_cast<const uint8_t*>(mask);
  dq_kernel<<<blocks, kHopperThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const bf16*>(o),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse), static_cast<float*>(delta),
      static_cast<bf16*>(dq), m, mask_rows, B, H, N, batch_step(B), s[3], s[4], s[5], scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv_kernel<<<blocks, kHopperThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), m,
      mask_rows, B, H, N, batch_step(B), s[6], s[7], scale);
  return static_cast<int>(cudaGetLastError());
}

// --------------------------------------------------------------------------
// mma.sync kernels, D = 32 and 128 (the backward reads the forward's lse
// rather than recomputing it)
//
// Forward: a block owns 128 query rows of one head (8 warps x 16 rows) and
// stages the head's whole K and V in shared memory (N rounded up to 16
// rows, pitch D + 8) with cp.async, one commit group per 64-key chunk, so
// the first chunk's products start while the others land. Each warp holds
// its Q fragments (straight from device memory in mma.sync's A layout), a
// 16 x 64 fp32 score tile and its 16 x D output accumulator in registers;
// S = Q K^T and O += P V run on mma.sync m16n8k16 (K and V through
// ldmatrix), P rounded to bf16 as the A operand, the online softmax over at
// most four 64-key chunks in the exp2 domain. Keys past N are zero-filled
// and scored -1e30; with a mask (Masked) the head's mask row is staged and
// dropped keys scored -inf.
//
// Backward: one block per (b, h), 4 warps, K, V and Q staged once with
// cp.async. A: per 16-row query tile, delta = rowsum(dO o O), lse from the
// forward, a sweep of the 64-key chunks forming S and dP = dO V^T, dS = P o
// (dP - delta), dQ += dS K; lse and delta go to shared memory. Then dO is
// staged where V was. B: per 16-row key tile, S^T = K Q^T and dP^T = V dO^T
// per 64-query chunk, dV += P^T dO, dK += dS^T Q. No atomics. At D = 128
// phase B keeps twice the fragments and spills (ptxas).

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
    bf16* __restrict__ o, float* __restrict__ lse, const uint8_t* __restrict__ mask,
    int mask_rows, int H, int N, Strides qs, Strides ks, Strides vs, Strides os, float scale) {
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
    const float corr0 = exp2_ftz(m0 - mn0);
    const float corr1 = exp2_ftz(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < kChunk / 8; ++j) {
      s[j][0] = exp2_ftz(fmaf(s[j][0], scale2, -m0));
      s[j][1] = exp2_ftz(fmaf(s[j][1], scale2, -m0));
      s[j][2] = exp2_ftz(fmaf(s[j][2], scale2, -m1));
      s[j][3] = exp2_ftz(fmaf(s[j][3], scale2, -m1));
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

  l0 = fmaxf(quad_sum(l0), 1e-30f);
  l1 = fmaxf(quad_sum(l1), 1e-30f);
  const float inv0 = 1.f / l0;
  const float inv1 = 1.f / l1;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    acc[nt][0] *= inv0;
    acc[nt][1] *= inv0;
    acc[nt][2] *= inv1;
    acc[nt][3] *= inv1;
  }
  store_rows<D>(o + b * os.b + h * os.h, os.n, acc, row0, N, quad, 1.f);
  if (lse != nullptr && quad == 0) {
    float* lse_bh = lse + static_cast<long long>(bh) * N;
    if (row0 < N) lse_bh[row0] = (m0 + log2f(l0)) * kLn2;
    if (row0 + 8 < N) lse_bh[row0 + 8] = (m1 + log2f(l1)) * kLn2;
  }
}

template <int D, bool Masked>
__global__ void __launch_bounds__(kBwdThreads) short_attention_bwd_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ o, const bf16* __restrict__ dout, const float* __restrict__ lse,
    bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv,
    const uint8_t* __restrict__ mask, int mask_rows, int H, int N, Strides qs, Strides ks,
    Strides vs, Strides os, Strides dos, Strides dqs, Strides dks, Strides dvs, float scale) {
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
  const float* lse_bh = lse + static_cast<long long>(blockIdx.x) * N;
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

  // phase A: delta and dQ per 16-row query tile
  for (int t = warp; t < tiles; t += kBwdWarps) {
    const int row0 = t * 16 + (lane >> 2);
    const int row1 = row0 + 8;
    uint32_t qf[D / 16][4], df[D / 16][4];
    load_a_frags<D>(qf, q_s, t, lane);
    load_a_frags_global<D>(df, dob, dos.n, t * 16, N, lane);
    const float dl0 = quad_row_dot<D>(ob + row0 * os.n, dob + row0 * dos.n, row0 < N, quad);
    const float dl1 = quad_row_dot<D>(ob + row1 * os.n, dob + row1 * dos.n, row1 < N, quad);
    const float lse0 = row0 < N ? lse_bh[row0] * kLog2e : 0.f;
    const float lse1 = row1 < N ? lse_bh[row1] * kLog2e : 0.f;

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
        s[j][0] = exp2_ftz(fmaf(s[j][0], scale2, -lse0)) * (dp[j][0] - dl0);
        s[j][1] = exp2_ftz(fmaf(s[j][1], scale2, -lse0)) * (dp[j][1] - dl0);
        s[j][2] = exp2_ftz(fmaf(s[j][2], scale2, -lse1)) * (dp[j][2] - dl1);
        s[j][3] = exp2_ftz(fmaf(s[j][3], scale2, -lse1)) * (dp[j][3] - dl1);
      }
      mma_xt<D>(acc, s, k_s + kv0 * LD, lane, rows);  // dQ += dS K
    }
    store_rows<D>(dq + b * dqs.b + h * dqs.h, dqs.n, acc, row0, N, quad, scale);
    if (quad == 0) {
      lse_s[row0] = lse0;  // 0 past N
      lse_s[row1] = lse1;
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
      if (q0 + kChunk > N) mask_keys(s, q0, N, quad);
#pragma unroll
      for (int j = 0; j < kChunk / 8; ++j) {
        const int qi = q0 + j * 8 + 2 * quad;
        const float2 ls = *reinterpret_cast<const float2*>(lse_s + qi);
        const float2 dl = *reinterpret_cast<const float2*>(dl_s + qi);
        s[j][0] = keep0 ? exp2_ftz(fmaf(s[j][0], scale2, -ls.x)) : 0.f;
        s[j][1] = keep0 ? exp2_ftz(fmaf(s[j][1], scale2, -ls.y)) : 0.f;
        s[j][2] = keep1 ? exp2_ftz(fmaf(s[j][2], scale2, -ls.x)) : 0.f;
        s[j][3] = keep1 ? exp2_ftz(fmaf(s[j][3], scale2, -ls.y)) : 0.f;
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
int launch_fwd_mma(const void* q, const void* k, const void* v, void* o, void* lse,
                   const void* mask, int mask_rows, int B, int N, int H, const Strides (&s)[4],
                   float scale, cudaStream_t stream) {
  const bool masked = mask != nullptr;
  auto kernel = masked ? short_attention_fwd_kernel<D, true>
                       : short_attention_fwd_kernel<D, false>;
  const size_t smem = fwd_smem(N, D, masked);
  const cudaError_t err = allow_smem(kernel, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (N + kFwdRows - 1) / kFwdRows;
  kernel<<<B * H * tiles, kFwdThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), static_cast<float*>(lse), static_cast<const uint8_t*>(mask),
      mask_rows, H, N, s[0], s[1], s[2], s[3], scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bwd_mma(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const void* lse, void* dq, void* dk, void* dv, const void* mask,
                   int mask_rows, int B, int N, int H, const Strides (&s)[8], float scale,
                   cudaStream_t stream) {
  const bool masked = mask != nullptr;
  auto kernel = masked ? short_attention_bwd_kernel<D, true>
                       : short_attention_bwd_kernel<D, false>;
  const size_t smem = bwd_smem(N, D, masked);
  const cudaError_t err = allow_smem(kernel, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B * H, kBwdThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      static_cast<const uint8_t*>(mask), mask_rows, H, N, s[0], s[1], s[2], s[3], s[4], s[5],
      s[6], s[7], scale);
  return static_cast<int>(cudaGetLastError());
}

bool valid_shape(int B, int N, int H, int D, const void* mask, int mask_rows) {
  return B >= 1 && H >= 1 && N >= 1 && N <= kMaxN && (D == 32 || D == 64 || D == 128) &&
         (mask == nullptr || mask_rows >= 1);
}

template <int T>
void read_strides(Strides (&s)[T], const long long* strides) {
  for (int t = 0; t < T; ++t)
    s[t] = Strides{strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The forward. q, k, v: bf16 [B, N, H, D] with the element strides in
// strides[0..8] (three each, B, N, H; last dim contiguous, 16-byte aligned
// base and strides: D = 64 reads them by TMA); o: bf16 [B, N, H, D] with
// strides[9..11]; lse: null, or fp32 [B, H, N] contiguous, written (natural
// log); mask: null, or a contiguous uint8 [mask_rows, N] key mask (row
// b % mask_rows for batch b; 0 drops the key). D is 32, 64 or 128, N at most
// 256, scale > 0. Returns a cudaError_t code.
int short_attention_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                        const void* mask, int mask_rows, int B, int N, int H, int D,
                        const long long* strides, float scale, void* stream) {
  if (!valid_shape(B, N, H, D, mask, mask_rows)) return static_cast<int>(cudaErrorInvalidValue);
  Strides s[4];
  read_strides(s, strides);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_fwd_hopper(q, k, v, o, lse, mask, mask_rows, B, N, H, s, scale, st);
  if (D == 32)
    return launch_fwd_mma<32>(q, k, v, o, lse, mask, mask_rows, B, N, H, s, scale, st);
  return launch_fwd_mma<128>(q, k, v, o, lse, mask, mask_rows, B, N, H, s, scale, st);
}

// The float32 forward (attention_f32.cuh, FFMA): the arguments of
// short_attention_fwd with fp32 q, k, v and o (element strides multiples of
// 4, the data 16-byte aligned). Returns a cudaError_t code.
int short_attention_fwd_f32(const void* q, const void* k, const void* v, void* o, void* lse,
                            const void* mask, int mask_rows, int B, int N, int H, int D,
                            const long long* strides, float scale, void* stream) {
  if (!valid_shape(B, N, H, D, mask, mask_rows)) return static_cast<int>(cudaErrorInvalidValue);
  return attention_f32::forward(q, k, v, nullptr, mask, mask_rows, o, lse, B, N, H, D, N,
                                strides, scale, stream);
}

// The backward: at D = 64 the dq kernel, then the dkdv kernel on the same
// stream; at D = 32 and 128 one mma.sync kernel. q, k, v, o, dout: bf16
// [B, N, H, D] with the element strides in strides[0..14] (as for the
// forward); dq, dk, dv: bf16 [B, N, H, D] outputs with strides[15..23] (the
// wrapper points them into one fused [B, N, 3*H*D] gradient); lse: fp32
// [B, H, N] from the forward; delta: fp32 [B, H, N] scratch, written (D = 64
// only); mask: as for the forward. Returns a cudaError_t code.
int short_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, const void* lse, void* delta, void* dq, void* dk,
                        void* dv, const void* mask, int mask_rows, int B, int N, int H, int D,
                        const long long* strides, float scale, void* stream) {
  if (!valid_shape(B, N, H, D, mask, mask_rows) || lse == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Strides s[8];
  read_strides(s, strides);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) {
    if (delta == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return launch_bwd_hopper(q, k, v, o, dout, lse, delta, dq, dk, dv, mask, mask_rows, B, N, H,
                             s, scale, st);
  }
  if (D == 32)
    return launch_bwd_mma<32>(q, k, v, o, dout, lse, dq, dk, dv, mask, mask_rows, B, N, H, s,
                              scale, st);
  return launch_bwd_mma<128>(q, k, v, o, dout, lse, dq, dk, dv, mask, mask_rows, B, N, H, s,
                             scale, st);
}

// Dynamic shared memory of the D = 64 kernels, in bytes, for the build
// report: the forward (which = 0) or a backward kernel (1: dq and dkdv, the
// same size).
int short_attention_smem_bytes(int which) {
  return which == 0 ? hopper_smem_bytes(1, true) : hopper_smem_bytes(2, false);
}

}  // extern "C"
