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
// (py, c) <-> w relayout of t; here that relayout is a shared-memory
// layout, so the kernels take the real wx [K, P, W].
//
// Bound on the H100 at the probe's shapes (K = 8192, P = 7, C = 256,
// H = 109, W = 56): rows 9 and 11 by operations (the first product,
// 1.79e11, dominates: 0.193 ms at the bf16 peak; out, the only large
// transfer, is 205 MB), row 10 by bytes (it writes t, 1.64 GB: 0.495 ms).
// The unfused form moves t through device memory twice (about 1.05 ms).
//
// Design. A block takes KB RoIs (KB = 8 or 16: M = KB * 7 rows (k, py) of
// the first product, padded to 64 or 112) and a channel tile, and loops
// over W in chunks. The 3.2 MB atlas cannot sit in 227 KB of shared
// memory, so each block stages, per chunk, its slice [c-tile x w-chunk
// rows, 112 h] (h zero-padded, the wrapper lays the atlas out as
// [C, W, 112]), and holds its RoIs' wy rows for the whole loop. Summed
// over blocks the atlas is read (K / KB) times (3.2 GB at KB = 8), from
// L2, which holds all of it; blocks of one channel tile are adjacent in
// the grid. Each warp computes 32 columns (c, w) of the first product
// for every row tile with mma.sync m16n8k16 (bf16 in, fp32 accumulate;
// its B fragments stay in registers across the row tiles), rounds t to
// bf16 and writes it to shared memory, where
//   - rows 9 / 11 (channel tile 16, chunk 16 w) keep t as [k][py][c][w]:
//     the second product, per RoI k, is then out^T[(py, c), px] =
//     t_k[(py, c), w] wx_k[px, w]^T, an m16n8k16 product with the 7 px
//     padded to 8 (so only 8/7 of its useful work), summed in fp32
//     registers over the chunks. Only the product the function needs is
//     done (the TPU's block-diagonal form spent KB times as much). At the
//     end the tile goes through shared memory so the stores are 16 bytes
//     a thread: rows (k, px, py) of 16 channels for row 9, runs of
//     KB * 49 (k, px, py) values per channel for row 11.
//   - row 10 (channel tile 64, chunk 4 w) keeps t as [(k, py)][w][c] and
//     stores each chunk at once, 16 bytes a thread along C, 128-byte runs;
//     the relayout is only the row index of the store.
// Still simple: no TMA, no wgmma, no cp.async pipelining of the chunks;
// one block of 8 warps per SM (129-193 KB of shared memory).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kP = 7;
constexpr int kHp = 112;        // contraction, zero-padded
constexpr int kHk = kHp / 16;   // its k-steps
constexpr int kLdH = kHp + 8;   // smem pitch of wy and atlas rows (conflict-free ldmatrix)
constexpr int kN = 256;         // first-product columns (c, w) per chunk
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxW = 128;

enum Mode { kModeA = 0, kModeE = 1, kModeA0 = 2 };

template <int KB, int MODE>
struct Tile {
  static constexpr int CT = MODE == kModeA0 ? 64 : 16;  // channels per block
  static constexpr int WC = kN / CT;                    // w per chunk
  static constexpr int M = KB * kP;                     // rows (k, py)
  static constexpr int MP = (M + 15) / 16 * 16;
  static constexpr int LDT = MODE == kModeA0 ? CT + 8 : WC + 8;  // t pitch
  static constexpr int T_ROWS = MODE == kModeA0 ? M * WC : M * CT;
  static constexpr int TILES2 = M / kWarps;  // second-product tiles (k, py) per warp
};

__host__ __device__ constexpr int wx_pitch(int W) { return (W + 15) / 16 * 16 + 8; }

template <int KB, int MODE>
constexpr size_t smem_bytes(int W) {
  using T = Tile<KB, MODE>;
  return sizeof(bf16) * (static_cast<size_t>(T::MP) * kLdH + kN * kLdH + T::T_ROWS * T::LDT +
                         (MODE == kModeA0 ? 0 : KB * 8 * wx_pitch(W)));
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p))
               : "memory");
}

// c[16x8] += a[16x16] b[16x8], bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// f: bf16 [C, W, kHp]; wy: bf16 [K * kP, kHp]; wx: bf16 [K, kP, W] (rows
// 9 / 11). out: row 9 [K, kP, kP, C]; row 11 [K / KB, C, KB * kP, kP];
// row 10 [K * kP * W, C], rows (k, w, py) if relayout else (k, py, w).
// Grid (K / KB, C / CT), kThreads threads, smem_bytes<KB, MODE>(W).
template <int KB, int MODE>
__global__ void __launch_bounds__(kThreads, 1) roi_fused_kernel(
    const bf16* __restrict__ f, const bf16* __restrict__ wy, const bf16* __restrict__ wx,
    bf16* __restrict__ out, int C, int W, int relayout) {
  using T = Tile<KB, MODE>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* wy_s = reinterpret_cast<bf16*>(smem_raw);  // [MP][kLdH]
  bf16* f_s = wy_s + T::MP * kLdH;                 // [kN = (c, w)][kLdH]
  bf16* t_s = f_s + kN * kLdH;                     // [T_ROWS][LDT]
  bf16* wx_s = t_s + T::T_ROWS * T::LDT;           // [KB * 8 (k, px)][wx_pitch]
  const int lx = wx_pitch(W);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long k0 = static_cast<long long>(blockIdx.x) * KB;
  const int c0 = blockIdx.y * T::CT;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  // the block's wy rows, zero past M
  for (int i = tid; i < T::MP * (kHp / 8); i += kThreads) {
    const int m = i / (kHp / 8);
    const int j = i % (kHp / 8);
    const uint4 v = m < T::M ? reinterpret_cast<const uint4*>(wy + (k0 * kP + m) * kHp)[j] : zero;
    *reinterpret_cast<uint4*>(wy_s + m * kLdH + j * 8) = v;
  }
  // the block's wx as [k][px 0..7][w], zero for px = 7 and past W
  if (MODE != kModeA0) {
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

  float acc2[MODE == kModeA0 ? 1 : T::TILES2][4];
#pragma unroll
  for (int j = 0; j < (MODE == kModeA0 ? 1 : T::TILES2); ++j)
    acc2[j][0] = acc2[j][1] = acc2[j][2] = acc2[j][3] = 0.f;

  const int n0 = warp * 32;  // this warp's first-product columns
  for (int w0 = 0; w0 < W; w0 += T::WC) {
    __syncthreads();  // the previous chunk's readers of f_s and t_s are done
    // atlas slice: row n = c * WC + w holds f[c0 + c, :, w0 + w], zero past W
    for (int i = tid; i < kN * (kHp / 8); i += kThreads) {
      const int n = i / (kHp / 8);
      const int j = i % (kHp / 8);
      const int w = w0 + n % T::WC;
      const uint4 v =
          w < W ? reinterpret_cast<const uint4*>(
                      f + (static_cast<long long>(c0 + n / T::WC) * W + w) * kHp)[j]
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
          const int c = n / T::WC;
          const int w = n % T::WC;
          const float lo = acc[j][2 * half];
          const float hi = acc[j][2 * half + 1];
          if (MODE == kModeA0) {
            t_s[(m * T::WC + w) * T::LDT + c] = __float2bfloat16(lo);
            t_s[(m * T::WC + w + 1) * T::LDT + c] = __float2bfloat16(hi);
          } else {
            *reinterpret_cast<__nv_bfloat162*>(t_s + (m * T::CT + c) * T::LDT + w) =
                __floats2bfloat162_rn(lo, hi);
          }
        }
      }
    }
    __syncthreads();

    if (MODE == kModeA0) {
      // store t rows of CT channels: (k, py, w), or (k, w, py) with relayout
      constexpr int kVec = T::CT / 8;
      for (int i = tid; i < T::M * T::WC * kVec; i += kThreads) {
        const int j = i % kVec;
        const int r = i / kVec;  // m * WC + w
        const int wg = w0 + r % T::WC;
        if (wg >= W) continue;
        const int m = r / T::WC;
        const long long kg = k0 + m / kP;
        const int py = m % kP;
        const long long row = relayout ? (kg * W + wg) * kP + py : (kg * kP + py) * W + wg;
        reinterpret_cast<uint4*>(out + row * C + c0)[j] =
            *reinterpret_cast<const uint4*>(t_s + r * T::LDT + j * 8);
      }
    } else {
      // second product: out^T[(py, c), px] += t_k[(py, c), w] wx_k[px, w]^T
#pragma unroll
      for (int j = 0; j < T::TILES2; ++j) {
        const int i = warp + j * kWarps;  // (k, py) = (i / kP, i % kP)
        uint32_t a[4];
        uint32_t b[2];
        ldmatrix_x4(a, t_s + (i * T::CT + (lane & 15)) * T::LDT + (lane >> 4) * 8);
        ldmatrix_x2(b, wx_s + ((i / kP) * 8 + (lane & 7)) * lx + w0 + ((lane >> 3) & 1) * 8);
        mma_bf16(acc2[j], a, b[0], b[1]);
      }
    }
  }

  if (MODE != kModeA0) {
    __syncthreads();
    bf16* o_s = f_s;  // KB * 49 * CT values
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
          const int idx = MODE == kModeA ? ((k * kP + px) * kP + py) * T::CT + c
                                         : (c * KB + k) * kP * kP + px * kP + py;
          o_s[idx] = __float2bfloat16(acc2[j][2 * half + e]);
        }
      }
    }
    __syncthreads();
    if (MODE == kModeA) {
      // rows (k, px, py) of CT channels -> out [K, kP, kP, C]
      constexpr int kVec = T::CT / 8;
      for (int i = tid; i < KB * kP * kP * kVec; i += kThreads) {
        const int r = i / kVec;
        const int j = i % kVec;
        reinterpret_cast<uint4*>(out + (k0 * kP * kP + r) * C + c0)[j] =
            reinterpret_cast<const uint4*>(o_s + r * T::CT)[j];
      }
    } else {
      // per channel one run of KB * 49 values (k, px, py) -> [K / KB, C, KB * kP, kP]
      constexpr int kRun = KB * kP * kP / 8;
      for (int i = tid; i < T::CT * kRun; i += kThreads) {
        const int c = i / kRun;
        const int j = i % kRun;
        reinterpret_cast<uint4*>(
            out + (static_cast<long long>(blockIdx.x) * C + c0 + c) * KB * kP * kP)[j] =
            reinterpret_cast<const uint4*>(o_s + c * KB * kP * kP)[j];
      }
    }
  }
}

template <int KB, int MODE>
int launch(const void* f, const void* wy, const void* wx, void* out, int K, int C, int W,
           int relayout, void* stream) {
  const size_t smem = smem_bytes<KB, MODE>(W);
  const auto kernel = roi_fused_kernel<KB, MODE>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(K / KB, C / Tile<KB, MODE>::CT);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(f), static_cast<const bf16*>(wy), static_cast<const bf16*>(wx),
      static_cast<bf16*>(out), C, W, relayout);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int dispatch(const void* f, const void* wy, const void* wx, void* out, int K, int kb, int C,
             int W, int relayout, void* stream) {
  constexpr int ct = Tile<8, MODE>::CT;
  if (K < 1 || C < ct || C % ct != 0 || W < 1 || W > kMaxW || (kb != 8 && kb != 16) ||
      K % kb != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return kb == 8 ? launch<8, MODE>(f, wy, wx, out, K, C, W, relayout, stream)
                 : launch<16, MODE>(f, wy, wx, out, K, C, W, relayout, stream);
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Row 9. f: bf16 [C, W, 112] (the atlas, h fastest, zero past H); wy:
// bf16 [K * 7, 112] (zero past H); wx: bf16 [K, 7, W]; out: bf16
// [K, 7, 7, C] as (k, px, py, c). kb: 8 or 16, dividing K; C a multiple
// of 16; W <= 128. Returns a cudaError_t code.
int roi_fused_a(const void* f, const void* wy, const void* wx, void* out, int K, int kb, int C,
                int W, void* stream) {
  return dispatch<kModeA>(f, wy, wx, out, K, kb, C, W, 0, stream);
}

// Row 11: row 9's operands; out: bf16 [K / kb, C, kb * 7, 7] as
// (block, c, (k, px), py). Returns a cudaError_t code.
int roi_fused_e(const void* f, const void* wy, const void* wx, void* out, int K, int kb, int C,
                int W, void* stream) {
  return dispatch<kModeE>(f, wy, wx, out, K, kb, C, W, 0, stream);
}

// Row 10: f, wy as row 9; out: bf16 [K * 7 * W, C], rows (k, w, py) if
// relayout else (k, py, w). C a multiple of 64. Returns a cudaError_t code.
int roi_fused_a0(const void* f, const void* wy, void* out, int K, int kb, int C, int W,
                 int relayout, void* stream) {
  return dispatch<kModeA0>(f, wy, nullptr, out, K, kb, C, W, relayout, stream);
}

}  // extern "C"
