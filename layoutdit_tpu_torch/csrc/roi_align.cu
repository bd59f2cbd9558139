// Multiscale RoIAlign, forward and backward, for Hopper (sm_90a), plain C
// interface. Both kernels read and write the pyramid as the detector makes
// it: [B, C, H, W] tensors with channel stride 1 (channels-last) and any
// batch, row and column strides that keep 16-byte alignment, so the FPN's
// levels and the fifth level's strided view x[..., ::2, ::2] reach them as
// they are. A lane takes 8 consecutive channels (one 16-byte access); a
// warp covers 256 channels, wider features loop over 256-channel chunks.
// The RoI geometry is general; the output size P and sampling ratio G are
// template parameters, instantiated for (7, 2), the box head, and (14, 2),
// a mask head. compute_taps is the single source of the bilinear taps; it
// reproduces roi_align.py's _bilinear_weight_matrix / build_roi_weights
// (samples outside [-1, size] give 0, coordinates clamp at 0, the top edge
// collapses to the last cell, roi sizes floor at 1, sample offsets
// (i % G + 0.5) / G). bin_taps folds a bin row's (or column's) G samples
// into one list of taps, each pixel once with its summed weight.
//
// Forward. Replaces layoutdit_tpu/ops/roi_align_pallas.py::_fwd_kernel (via
// _fwd and pooled_atlas_pallas). The TPU kernel contracts a level atlas
// [C, H_atlas, W_max] with level-masked separable bilinear weights
// Wy [K, P, H_atlas] and Wx [K, P, W_max]; at 1024 px that atlas alone is
// 65 MB against 227 KB of shared memory, and each weight row has at most
// two non-zeros per sample. So this kernel samples directly, the same
// function without the atlas: one block of four warps per RoI; 2P threads
// write each bin row's and column's taps (bin_taps) to shared memory as
// element offsets (32-bit, within one image's level) and weights; each
// warp takes bin columns, their taps in registers, and walks the bin rows;
// per bin a lane issues the 16-byte loads of every weighted tap (up to
// (2G)^2, 4 to 9 for a bin of a pixel or less, whose samples share
// pixels) before it sums them in fp32, and writes the bin's 8 channels
// with one 16-byte store. A RoI with level -1 (masked or invalid) gives
// zeros, written with 16-byte stores.
//
// Bound on the H100: bytes. It reads the feature pixels the RoIs touch and
// writes R * P * P * C bf16 (205 MB at B=16, K=512, C=256); its 16
// multiply-adds per output are far below the FP32 rate. P and G are
// constants, so the inner loops unroll and no division or 64-bit multiply
// is left in them; taps with zero weight are neither loaded nor added.
//
// The forward is also instantiated over fp32 levels and output
// (roi_align_fwd_f32, a float32 compute dtype): the same kernel with 4
// channels in a lane's 16-byte access (128 a warp), the same fp32 sums, no
// rounding at the store, twice the bytes. The bf16 instantiation is the
// same code as before the template.
//
// Backward. Replaces layoutdit_tpu/ops/roi_align_pallas.py::_bwd_kernel
// (via _bwd): dF_l = sum over the RoIs assigned to level l of
// Wy^T . dout . Wx. The TPU kernel carries an fp32 VMEM accumulator across
// RoI blocks on a sequential ("arbitrary") grid axis, so every run sums in
// the same order. Blocks on the H100 run in no order, so this kernel
// gathers instead of scattering: each dF element is owned by one lane,
// summed in fp32 registers in a fixed order (RoI index, then bin) and
// written once, in bf16, straight into a tensor laid out as its feature
// (channels-last). No atomics and no pyramid-sized scratch: two runs give
// the same bits. A first pass (roi_taps_kernel, one warp a RoI) writes
// each RoI's bin taps (bin_taps) to a small table (448 bytes a RoI at
// P = 7) and its footprint on its level, the inclusive row and column span
// of the pixels its taps weight (roi_align.py's roi_footprints is its
// spec). Then one block of eight warps per (image, level, 4 x 8 pixel
// tile, 256 channels): the block lists, in index order, its image's RoIs
// of its level whose footprint meets the tile (a ballot per 256 RoIs);
// each warp owns a strip of four pixels of one row and walks the listed
// RoIs that reach it on its own, with no barrier between RoIs: lanes
// p < P read the RoI's taps from the table and form Wy[p][y] and
// Wx[p][x] for the strip, two ballots give the bins whose weights reach
// it, and the warp sums those bins in index order, each bin's dout loaded
// once (16 bytes a lane, the next bin's load issued before the current
// one's 32 multiply-adds). Pixels that no RoI touches are written as
// zeros by the same pass.
//
// Bound on the H100: bytes, dout read once (R_valid * P * P * C bf16,
// 165 MB at B=16, K=512, 6562 valid RoIs) plus dF written once (the
// pyramid, 34 MB). A bin that reaches two rows or strips is loaded by
// each of their warps, from L2 or L1.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <climits>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kVec = 8;              // bf16 channels a lane: one 16-byte access
constexpr int kChunk = 32 * kVec;    // channels a warp covers (the backward's)
constexpr int kFwdWarps = 4;         // forward: warps a RoI
constexpr int kStrip = 4;            // backward: pixels of one row a warp owns
constexpr int kTileY = 4;            // backward: pixel rows of a tile
constexpr int kTileX = 2 * kStrip;   // backward: pixel columns of a tile
constexpr int kBwdWarps = kTileY * kTileX / kStrip;
constexpr int kBwdThreads = 32 * kBwdWarps;

using bf16 = __nv_bfloat16;

// channels of element type E in one 16-byte access: 8 bf16, 4 fp32
template <typename E>
struct Vec {
  static constexpr int n = 16 / static_cast<int>(sizeof(E));
};

// a level of element type E (the forward reads bf16 or fp32 levels; the
// backward bf16 ones)
template <typename E>
struct LevelOf {
  const E* data;  // [B, C, H, W], channel stride 1, other strides below
  long long sb, sy, sx;
  int h, w;
  float scale;
};

template <typename E>
struct LevelsOf {
  LevelOf<E> l[kMaxLevels];
  int n;
};

using Level = LevelOf<bf16>;
using Levels = LevelsOf<bf16>;

struct GradLevels {
  bf16* data[kMaxLevels];  // dF [B, C, H_l, W_l], channel stride 1
  long long sb[kMaxLevels], sy[kMaxLevels], sx[kMaxLevels];
  int tile_start[kMaxLevels + 1];  // first block of each level's tiles
};

struct Tap {
  int lo, hi;
  float wlo, whi;
};

// The bilinear taps of sample i (0 <= i < P * G) of RoI `box` on level L,
// along rows (axis 0) or columns (axis 1). Plain rounding, no FMA
// contraction, to keep the coordinates of build_roi_weights. The single
// source of the taps: the forward gathers through them, the footprint pass
// bounds them and the backward's weights sum them.
template <int P, int G, typename E>
__device__ __forceinline__ Tap compute_taps(const LevelOf<E>& L, const float* box, int axis,
                                            int i) {
  const float start = __fmul_rn(box[axis ? 0 : 1], L.scale);
  const float end = __fmul_rn(box[axis ? 2 : 3], L.scale);
  const float extent = fmaxf(__fsub_rn(end, start), 1.f);
  const float bin = __fdiv_rn(extent, static_cast<float>(P));
  const float grid = static_cast<float>(i / G) +
                     __fdiv_rn(static_cast<float>(i % G) + 0.5f, static_cast<float>(G));
  float c = __fadd_rn(start, __fmul_rn(grid, bin));
  const int size = axis ? L.w : L.h;
  const bool in_range = (c >= -1.f) && (c <= static_cast<float>(size));
  c = fmaxf(c, 0.f);
  float low = floorf(c);
  const bool top = low >= static_cast<float>(size - 1);
  low = fminf(low, static_cast<float>(size - 1));
  const float frac = top ? 0.f : __fsub_rn(c, low);
  Tap t;
  t.lo = static_cast<int>(low);
  t.hi = top ? t.lo : t.lo + 1;
  t.wlo = in_range ? __fsub_rn(1.f, frac) : 0.f;
  t.whi = in_range ? frac : 0.f;
  return t;
}

template <typename E>
__device__ __forceinline__ uint4 load16(const E* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ void unpack(const uint4& v, float (&f)[kVec]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int k = 0; k < kVec / 2; ++k) {
    const float2 t = __bfloat1622float2(h[k]);
    f[2 * k] = t.x;
    f[2 * k + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack(const float (&f)[kVec]) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int k = 0; k < kVec / 2; ++k) h[k] = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
  return v;
}

// the fp32 forms: 4 channels in 16 bytes, no rounding
__device__ __forceinline__ void unpack(const uint4& v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}

__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}

// The 2G taps of bin row (axis 0) or column (axis 1) p: its G samples'
// taps (compute_taps) in sample order, a tap on the pixel of an earlier
// one with a weight folded into that one (its own weight left 0), so each
// pixel appears once, with the bin's summed weight.
template <int P, int G, typename E>
__device__ __forceinline__ void bin_taps(const LevelOf<E>& L, const float* box, int axis, int p,
                                         int (&id)[2 * G], float (&w)[2 * G]) {
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const Tap t = compute_taps<P, G>(L, box, axis, p * G + g);
    id[2 * g] = t.lo;
    w[2 * g] = t.wlo;
    id[2 * g + 1] = t.hi;
    w[2 * g + 1] = t.whi;
  }
#pragma unroll
  for (int q = 1; q < 2 * G; ++q) {
#pragma unroll
    for (int e = 0; e < q; ++e) {
      if (w[q] != 0.f && w[e] != 0.f && id[e] == id[q]) {
        w[e] += w[q];
        w[q] = 0.f;
      }
    }
  }
}

// E: the levels' and the output's element type, bf16 or fp32 (V channels
// a lane, 32 V a warp); the sums are fp32 for both
template <int P, int G, typename E>
__global__ void __launch_bounds__(32 * kFwdWarps) roi_align_fwd_kernel(
    LevelsOf<E> levels, const float* __restrict__ rois, const int* __restrict__ roi_level,
    E* __restrict__ out, int K, int C) {
  constexpr int V = Vec<E>::n;    // channels a lane
  constexpr int T = 2 * G;        // taps of one bin row or column: 2 a sample
  __shared__ int off[2][P][T];    // [axis][bin row / column][tap]: element offset
  __shared__ float wt[2][P][T];   // its weight summed over the bin's samples; 0 = skip

  const int r = blockIdx.x;
  const int lvl = roi_level[r];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  E* o = out + static_cast<long long>(r) * (P * P) * C;
  if (lvl < 0) {
    uint4* ov = reinterpret_cast<uint4*>(o);
    for (int i = threadIdx.x; i < P * P * C / V; i += blockDim.x) ov[i] = make_uint4(0, 0, 0, 0);
    return;
  }
  const LevelOf<E> L = levels.l[lvl];
  if (threadIdx.x < 2 * P) {
    const int axis = threadIdx.x >= P;
    const int p = threadIdx.x - axis * P;
    int id[T];
    float w[T];
    bin_taps<P, G>(L, rois + 4LL * r, axis, p, id, w);
    const int stride = static_cast<int>(axis ? L.sx : L.sy);
#pragma unroll
    for (int q = 0; q < T; ++q) {
      off[axis][p][q] = id[q] * stride;
      wt[axis][p][q] = w[q];
    }
  }
  __syncthreads();

  constexpr float norm = 1.f / static_cast<float>(G * G);
  const E* f = L.data + static_cast<long long>(r / K) * L.sb;
  // each warp takes bin columns px = warp, warp + kFwdWarps, .. with their
  // taps in registers, and walks the bin rows
  for (int px = warp; px < P; px += kFwdWarps) {
    int xo[T];
    float xw[T];
#pragma unroll
    for (int j = 0; j < T; ++j) {
      xo[j] = off[1][px][j];
      xw[j] = wt[1][px][j];
    }
    for (int py = 0; py < P; ++py) {
      E* ob = o + (px * P + py) * C;
      for (int c = lane * V; c < C; c += 32 * V) {
        // every weighted tap's load issued before the sums
        uint4 v[T][T];
#pragma unroll
        for (int i = 0; i < T; ++i) {
          const E* row = f + off[0][py][i] + c;
          const bool yi = wt[0][py][i] != 0.f;
#pragma unroll
          for (int j = 0; j < T; ++j)
            v[i][j] = yi && xw[j] != 0.f ? load16(row + xo[j]) : make_uint4(0, 0, 0, 0);
        }
        float acc[V] = {};
#pragma unroll
        for (int i = 0; i < T; ++i) {
          const float wy = wt[0][py][i];
          if (wy == 0.f) continue;
          float sum[V] = {};
#pragma unroll
          for (int j = 0; j < T; ++j) {
            if (xw[j] == 0.f) continue;
            float a[V];
            unpack(v[i][j], a);
#pragma unroll
            for (int k = 0; k < V; ++k) sum[k] = fmaf(xw[j], a[k], sum[k]);
          }
#pragma unroll
          for (int k = 0; k < V; ++k) acc[k] = fmaf(wy, sum[k], acc[k]);
        }
#pragma unroll
        for (int k = 0; k < V; ++k) acc[k] *= norm;
        *reinterpret_cast<uint4*>(ob + c) = pack(acc);
      }
    }
  }
}

// The backward's first pass, one warp a RoI, lane (axis, p) for each bin
// row and column: the bin's taps (bin_taps) into the table, (id, w) pairs
// as int4 [R][2][P][G], and the RoI's footprint (y0, y1, x0, x1) on its
// level, the inclusive spans of the rows and columns its taps weight;
// (0, -1, 0, -1) for level -1 (whose taps are not written) or a RoI none of
// whose samples falls inside.
constexpr int kTapWarps = 4;

template <int P, int G>
__global__ void __launch_bounds__(32 * kTapWarps) roi_taps_kernel(
    Levels levels, const float* __restrict__ rois, const int* __restrict__ roi_level,
    int4* __restrict__ taps, int4* __restrict__ fp, int R) {
  static_assert(2 * P <= 32, "a lane a bin row or column");
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kTapWarps + (threadIdx.x >> 5);
  if (r >= R) return;
  const int lvl = roi_level[r];
  if (lvl < 0) {
    if (lane == 0) fp[r] = make_int4(0, -1, 0, -1);
    return;
  }
  const Level L = levels.l[lvl];
  const int axis = lane >= P;
  const int p = lane - axis * P;
  int lo = INT_MAX;
  int hi = -1;
  if (lane < 2 * P) {
    int id[2 * G];
    float w[2 * G];
    bin_taps<P, G>(L, rois + 4LL * r, axis, p, id, w);
    int4* t = taps + ((static_cast<long long>(r) * 2 + axis) * P + p) * G;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      t[g] = make_int4(id[2 * g], __float_as_int(w[2 * g]), id[2 * g + 1],
                       __float_as_int(w[2 * g + 1]));
#pragma unroll
      for (int e = 2 * g; e < 2 * g + 2; ++e) {
        if (w[e] != 0.f) {
          lo = min(lo, id[e]);
          hi = max(hi, id[e]);
        }
      }
    }
  }
  const bool rows = lane < P;
  const bool cols = lane >= P && lane < 2 * P;
  const int y0 = __reduce_min_sync(0xffffffffu, rows ? lo : INT_MAX);
  const int y1 = __reduce_max_sync(0xffffffffu, rows ? hi : -1);
  const int x0 = __reduce_min_sync(0xffffffffu, cols ? lo : INT_MAX);
  const int x1 = __reduce_max_sync(0xffffffffu, cols ? hi : -1);
  if (lane == 0)
    fp[r] = y1 >= 0 && x1 >= 0 ? make_int4(y0, y1, x0, x1) : make_int4(0, -1, 0, -1);
}

template <int P, int G>
__global__ void __launch_bounds__(kBwdThreads) roi_align_bwd_kernel(
    Levels levels, GradLevels grads, const int* __restrict__ roi_level,
    const int4* __restrict__ taps, const int4* __restrict__ fp, const bf16* __restrict__ dout,
    int K, int C) {
  static_assert(P <= 32, "a lane a bin row or column");
  __shared__ int list[kBwdThreads];
  __shared__ int4 list_fp[kBwdThreads];
  __shared__ int warp_hits[kBwdWarps];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int lvl = 0;
  while (lvl + 1 < levels.n && static_cast<int>(blockIdx.x) >= grads.tile_start[lvl + 1]) ++lvl;
  const Level L = levels.l[lvl];
  const int tiles_x = (L.w + kTileX - 1) / kTileX;
  const int tiles = tiles_x * ((L.h + kTileY - 1) / kTileY);
  int t = blockIdx.x - grads.tile_start[lvl];
  const int b = t / tiles;
  t -= b * tiles;
  const int y0 = (t / tiles_x) * kTileY;
  const int x0 = (t % tiles_x) * kTileX;
  // this warp's strip: row y, columns xs .. xs + kStrip - 1
  const int y = y0 + warp / (kTileX / kStrip);
  const int xs = x0 + (warp % (kTileX / kStrip)) * kStrip;
  const int c = blockIdx.y * kChunk + lane * kVec;
  const bool c_ok = c < C;

  float acc[kStrip][kVec] = {};
  for (int first = 0; first < K; first += kBwdThreads) {
    // the image's RoIs of this level whose footprint meets the tile, in
    // index order
    const int k = first + threadIdx.x;
    bool hit = false;
    int4 span = make_int4(0, -1, 0, -1);
    if (k < K) {
      const int lv = roi_level[b * K + k];
      span = fp[b * K + k];
      hit = lv == lvl && span.x <= y0 + kTileY - 1 && span.y >= y0 &&
            span.z <= x0 + kTileX - 1 && span.w >= x0;
    }
    const unsigned m = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_hits[warp] = __popc(m);
    __syncthreads();
    int pos = __popc(m & ((1u << lane) - 1u));
    int n = 0;
#pragma unroll
    for (int w = 0; w < kBwdWarps; ++w) {
      pos += w < warp ? warp_hits[w] : 0;
      n += warp_hits[w];
    }
    if (hit) {
      list[pos] = b * K + k;
      list_fp[pos] = span;
    }
    __syncthreads();

    // each warp on its own: the listed RoIs that reach its strip
    for (int j = 0; j < n; ++j) {
      const int4 s = list_fp[j];
      if (s.x > y || s.y < y || s.z > xs + kStrip - 1 || s.w < xs) continue;
      const int r = list[j];
      // lane p < P: Wy[p][y], the weight bin row p gives row y, and
      // Wx[p][xs + e], bin column p's on the strip, from the first pass's
      // taps (each pixel once in a bin's taps)
      float wy = 0.f;
      float wx[kStrip] = {};
      if (lane < P) {
        const int4* t = taps + (static_cast<long long>(r) * 2 * P + lane) * G;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const int4 ty = t[g];
          const int4 tx = t[P * G + g];
          wy += (ty.x == y ? __int_as_float(ty.y) : 0.f) + (ty.z == y ? __int_as_float(ty.w) : 0.f);
#pragma unroll
          for (int e = 0; e < kStrip; ++e)
            wx[e] += (tx.x == xs + e ? __int_as_float(tx.y) : 0.f) +
                     (tx.z == xs + e ? __int_as_float(tx.w) : 0.f);
        }
      }
      bool any_x = false;
#pragma unroll
      for (int e = 0; e < kStrip; ++e) any_x |= wx[e] != 0.f;
      const unsigned ymask = __ballot_sync(0xffffffffu, wy != 0.f);
      const unsigned xmask = __ballot_sync(0xffffffffu, any_x);
      if (!ymask || !xmask) continue;
      // the bins that reach the strip, in index order (px, then py); each
      // bin's dout loaded once, the next one's load issued first
      const bf16* g = dout + static_cast<long long>(r) * (P * P) * C + c;
      unsigned mx = xmask;
      unsigned my = ymask;
      int px = __ffs(mx) - 1;
      int py = __ffs(my) - 1;
      uint4 next = c_ok ? load16(g + (px * P + py) * C) : make_uint4(0, 0, 0, 0);
      while (true) {
        const int cx = px;
        const int cy = py;
        const uint4 cur = next;
        my &= my - 1;
        if (!my) {
          mx &= mx - 1;
          my = ymask;
        }
        const bool more = mx != 0;
        if (more) {
          px = __ffs(mx) - 1;
          py = __ffs(my) - 1;
          if (c_ok) next = load16(g + (px * P + py) * C);
        }
        float v[kVec];
        unpack(cur, v);
        const float wyv = __shfl_sync(0xffffffffu, wy, cy);
#pragma unroll
        for (int e = 0; e < kStrip; ++e) {
          const float w = wyv * __shfl_sync(0xffffffffu, wx[e], cx);
#pragma unroll
          for (int q = 0; q < kVec; ++q) acc[e][q] = fmaf(w, v[q], acc[e][q]);
        }
        if (!more) break;
      }
    }
    __syncthreads();  // the next chunk rewrites the list
  }

  if (!c_ok || y >= L.h) return;
  constexpr float norm = 1.f / static_cast<float>(G * G);
  bf16* d = grads.data[lvl] + b * grads.sb[lvl] + y * grads.sy[lvl] + c;
#pragma unroll
  for (int e = 0; e < kStrip; ++e) {
    const int x = xs + e;
    if (x >= L.w) break;
#pragma unroll
    for (int q = 0; q < kVec; ++q) acc[e][q] *= norm;
    *reinterpret_cast<uint4*>(d + x * grads.sx[lvl]) = pack(acc[e]);
  }
}

template <typename E>
int fill_levels(LevelsOf<E>& levels, const int* level_hw, const float* level_scales,
                int num_levels) {
  if (num_levels < 1 || num_levels > kMaxLevels) return 1;
  levels.n = num_levels;
  for (int l = 0; l < num_levels; ++l) {
    levels.l[l].h = level_hw[2 * l + 0];
    levels.l[l].w = level_hw[2 * l + 1];
    levels.l[l].scale = level_scales[l];
    if (levels.l[l].h < 1 || levels.l[l].w < 1) return 1;
  }
  return 0;
}

bool supported(int P, int G) { return (P == 7 || P == 14) && G == 2; }

// 16-byte accesses: the data aligned, and the batch, row and column strides
// of dimensions longer than 1 multiples of vec elements (8 bf16, 4 fp32)
bool aligned(const void* data, long long sb, long long sy, long long sx, int b, int h, int w,
             int vec = kVec) {
  return reinterpret_cast<unsigned long long>(data) % 16 == 0 && (b == 1 || sb % vec == 0) &&
         (h == 1 || sy % vec == 0) && (w == 1 || sx % vec == 0);
}

template <int P, int G, typename E>
void launch_fwd(const LevelsOf<E>& levels, const float* rois, const int* roi_level, E* out, int R,
                int K, int C, cudaStream_t stream) {
  roi_align_fwd_kernel<P, G, E><<<R, 32 * kFwdWarps, 0, stream>>>(levels, rois, roi_level, out,
                                                                  K, C);
}

// The forward's host side for levels and output of element type E (the
// arguments of roi_align_fwd below). Returns a cudaError_t code.
template <typename E>
int fwd(const void* const* level_ptrs, const long long* level_strides, const int* level_hw,
        const float* level_scales, int num_levels, const void* rois, const void* roi_level,
        void* out, int R, int K, int C, int P, int G, void* stream) {
  constexpr int V = Vec<E>::n;
  LevelsOf<E> levels{};
  if (fill_levels(levels, level_hw, level_scales, num_levels) || R < 0 || K < 1 || R % K ||
      C < 1 || C % V || !supported(P, G))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int l = 0; l < num_levels; ++l) {
    LevelOf<E>& L = levels.l[l];
    L.data = static_cast<const E*>(level_ptrs[l]);
    L.sb = level_strides[4 * l + 0];
    L.sy = level_strides[4 * l + 2];
    L.sx = level_strides[4 * l + 3];
    // the taps' offsets within one image's level are 32-bit
    if (level_strides[4 * l + 1] != 1 || !aligned(L.data, L.sb, L.sy, L.sx, R / K, L.h, L.w, V) ||
        (L.h - 1) * L.sy + (L.w - 1) * L.sx + C > static_cast<long long>(INT_MAX))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (R == 0) return 0;
  const auto* r = static_cast<const float*>(rois);
  const auto* lv = static_cast<const int*>(roi_level);
  auto* o = static_cast<E*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (P == 7)
    launch_fwd<7, 2>(levels, r, lv, o, R, K, C, s);
  else
    launch_fwd<14, 2>(levels, r, lv, o, R, K, C, s);
  return static_cast<int>(cudaGetLastError());
}

template <int P, int G>
void launch_taps(const Levels& levels, const float* rois, const int* roi_level, int4* taps,
                 int4* fp, int R, cudaStream_t stream) {
  roi_taps_kernel<P, G><<<(R + kTapWarps - 1) / kTapWarps, 32 * kTapWarps, 0, stream>>>(
      levels, rois, roi_level, taps, fp, R);
}

template <int P, int G>
void launch_bwd(const Levels& levels, const GradLevels& grads, const float* rois,
                const int* roi_level, int4* taps, int4* fp, const bf16* dout, int R, int K, int C,
                cudaStream_t stream) {
  launch_taps<P, G>(levels, rois, roi_level, taps, fp, R, stream);
  const dim3 grid(grads.tile_start[levels.n], (C + kChunk - 1) / kChunk);
  roi_align_bwd_kernel<P, G><<<grid, kBwdThreads, 0, stream>>>(levels, grads, roi_level, taps,
                                                               fp, dout, K, C);
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// level_ptrs[l]: bf16 [B, C, H_l, W_l] feature maps; level_strides[4l..4l+3]:
// their (b, c, y, x) element strides, c's 1, the others multiples of 8 and
// the data 16-byte aligned; level_hw[2l..2l+1]: (H_l, W_l); level_scales[l]:
// spatial scale. rois: fp32 [R, 4] (R = B * K, image b = r / K); roi_level:
// int32 [R], -1 = zeros; out: bf16 [R, P, P, C] in (px, py, c) order,
// contiguous. C a multiple of 8; (P, G) (7, 2) or (14, 2). Returns a
// cudaError_t code.
int roi_align_fwd(const void* const* level_ptrs, const long long* level_strides,
                  const int* level_hw, const float* level_scales, int num_levels,
                  const void* rois, const void* roi_level, void* out, int R, int K, int C,
                  int P, int G, void* stream) {
  return fwd<bf16>(level_ptrs, level_strides, level_hw, level_scales, num_levels, rois, roi_level,
                   out, R, K, C, P, G, stream);
}

// The float32 forward: the arguments of roi_align_fwd with fp32 levels and
// output, C a multiple of 4 and the level strides (other than the
// channel's) multiples of 4 elements. Returns a cudaError_t code.
int roi_align_fwd_f32(const void* const* level_ptrs, const long long* level_strides,
                      const int* level_hw, const float* level_scales, int num_levels,
                      const void* rois, const void* roi_level, void* out, int R, int K, int C,
                      int P, int G, void* stream) {
  return fwd<float>(level_ptrs, level_strides, level_hw, level_scales, num_levels, rois,
                    roi_level, out, R, K, C, P, G, stream);
}

// The backward's first pass alone: taps: int32 [R, 2, P, 2G, 2] scratch,
// (pixel, weight bits) of each bin row and column's taps; footprints: int32
// [R, 4] (y0, y1, x0, x1).
int roi_align_footprints(const int* level_hw, const float* level_scales, int num_levels,
                         const void* rois, const void* roi_level, void* taps, void* footprints,
                         int R, int P, int G, void* stream) {
  Levels levels{};
  if (fill_levels(levels, level_hw, level_scales, num_levels) || R < 0 || !supported(P, G))
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return 0;
  const auto* r = static_cast<const float*>(rois);
  const auto* lv = static_cast<const int*>(roi_level);
  auto* tp = static_cast<int4*>(taps);
  auto* fp = static_cast<int4*>(footprints);
  auto s = static_cast<cudaStream_t>(stream);
  if (P == 7)
    launch_taps<7, 2>(levels, r, lv, tp, fp, R, s);
  else
    launch_taps<14, 2>(levels, r, lv, tp, fp, R, s);
  return static_cast<int>(cudaGetLastError());
}

// The forward's geometry (level_hw, level_scales) and RoIs; grad_ptrs[l]:
// bf16 dF [B, C, H_l, W_l], every element written, with element strides
// grad_strides[4l..4l+3] as the forward's features; dout: bf16
// [R, P, P, C] in (px, py, c) order, contiguous, 16-byte aligned;
// taps and footprints: the first pass's scratch, as roi_align_footprints.
// Returns a cudaError_t code.
int roi_align_bwd(void* const* grad_ptrs, const long long* grad_strides, const int* level_hw,
                  const float* level_scales, int num_levels, const void* rois,
                  const void* roi_level, const void* dout, void* taps, void* footprints, int R,
                  int K, int C, int P, int G, void* stream) {
  Levels levels{};
  if (fill_levels(levels, level_hw, level_scales, num_levels) || R < 0 || K < 1 || R % K ||
      C < 1 || C % kVec || !supported(P, G) ||
      reinterpret_cast<unsigned long long>(dout) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  GradLevels grads{};
  long long tiles = 0;
  for (int l = 0; l < num_levels; ++l) {
    grads.data[l] = static_cast<bf16*>(grad_ptrs[l]);
    grads.sb[l] = grad_strides[4 * l + 0];
    grads.sy[l] = grad_strides[4 * l + 2];
    grads.sx[l] = grad_strides[4 * l + 3];
    if (grad_strides[4 * l + 1] != 1 || !aligned(grads.data[l], grads.sb[l], grads.sy[l],
                                                 grads.sx[l], R / K, levels.l[l].h,
                                                 levels.l[l].w))
      return static_cast<int>(cudaErrorInvalidValue);
    grads.tile_start[l] = static_cast<int>(tiles);
    const Level& L = levels.l[l];
    tiles += static_cast<long long>(R / K) * ((L.h + kTileY - 1) / kTileY) *
             ((L.w + kTileX - 1) / kTileX);
    if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  }
  grads.tile_start[num_levels] = static_cast<int>(tiles);
  if (R == 0) return 0;
  const auto* r = static_cast<const float*>(rois);
  const auto* lv = static_cast<const int*>(roi_level);
  auto* tp = static_cast<int4*>(taps);
  auto* fp = static_cast<int4*>(footprints);
  const auto* g = static_cast<const bf16*>(dout);
  auto s = static_cast<cudaStream_t>(stream);
  if (P == 7)
    launch_bwd<7, 2>(levels, grads, r, lv, tp, fp, g, R, K, C, s);
  else
    launch_bwd<14, 2>(levels, grads, r, lv, tp, fp, g, R, K, C, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
