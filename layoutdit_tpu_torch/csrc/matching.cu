// Exact linear-sum assignment (Hungarian / Jonker-Volgenant) for Hopper
// (sm_90a), plain C interface: one warp solves one problem, all problems
// in one launch.
//
// Replaces no Pallas kernel: layoutdit_tpu/ops/matching.py::
// linear_sum_assignment is an XLA while_loop of Dijkstra steps inside a
// fori_loop over the rows, vmapped over DETR's [L * B] (decoder layer,
// image) problems. In PyTorch the same lane-masked loop costs a dozen
// small launches and a host read per Dijkstra step, some 40-170 steps a
// problem at DETR's shapes (R = 32-64 gt slots, C = 100 queries); this
// kernel runs them all on the card with no host in between.
//
// Design. The solve is serial: a row insertion is a chain of Dijkstra
// steps, each an O(C) relaxation, an argmin over the columns and an O(C)
// potential update, and the next step depends on the argmin. So the work
// of a problem goes to one warp (blockDim 32, one block a problem): a lane
// owns the columns j = lane + 32k, whose v, minv, way and used live in
// shared memory beside the row potentials u and the column-to-row map p;
// the argmin is five xor shuffles of (value, column) that keep the lower
// column on equal values; no block barrier, __syncwarp between the
// phases of a step. A cost row is read from global memory (L2 after its
// first read) once per step that reaches it, 32 lanes on consecutive
// floats. Lane 0 walks the augmenting path.
//
// Exactness. The float32 operations are JAX's, in JAX's order: cur =
// (a[i0][j] - u[i0]) - v[j]; on used columns u[p[j]] += delta and v[j] -=
// delta, on the others minv[j] -= delta; the virtual column 0 never
// relaxes; BIG = FLT_MAX / 4; ties of the argmin go to the lowest column.
// There is no multiply, so no FMA contraction can change a rounding: the
// kernel returns JAX's assignment bit for bit on the same float32 costs.
// Where a cost is not finite no column may be reachable, and JAX's loop
// never ends; the kernel then gives row r column r and steps -1.
//
// Bound on the H100: neither bytes nor operations but latency. The bytes
// are the costs read once and the indices written once (13 KB a problem
// at R = 32, C = 100), the operations a few per column a step; the time
// is the longest problem's serial chain of steps, each a shared-memory
// round trip, an L2 read and five shuffles.

#include <cuda_runtime.h>

#include <cfloat>
#include <climits>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxCols = 1024;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kWarp)
lsa_kernel(const float* __restrict__ cost, long long* __restrict__ out,
           int* __restrict__ steps_out, int R, int C) {
  extern __shared__ float smem[];
  const float big = FLT_MAX / 4.0f;
  const int cols = C + 1;  // column 0 is the virtual start column
  float* v = smem;
  float* minv = v + cols;
  float* u = minv + cols;  // rows 1..R, row 0 unused
  int* way = reinterpret_cast<int*>(u + R + 1);
  int* p = way + cols;      // column -> row (1-indexed), 0 = free
  int* used = p + cols;
  const int lane = threadIdx.x;
  const float* a = cost + static_cast<long long>(blockIdx.x) * R * C;

  for (int j = lane; j < cols; j += kWarp) {
    v[j] = 0.0f;
    p[j] = 0;
  }
  for (int r = lane; r <= R; r += kWarp) u[r] = 0.0f;
  __syncwarp();

  int steps = 0;
  bool failed = false;
  for (int i = 1; i <= R; ++i) {
    for (int j = lane; j < cols; j += kWarp) {
      minv[j] = big;
      way[j] = 0;
      used[j] = 0;
    }
    if (lane == 0) p[0] = i;
    __syncwarp();
    int j0 = 0;
    do {
      ++steps;
      if (lane == 0) used[j0] = 1;
      __syncwarp();
      const int i0 = j0 == 0 ? i : p[j0];
      const float ui0 = u[i0];
      const float* row = a + static_cast<long long>(i0 - 1) * C;
      // relax the free columns and keep this lane's first minimum of the
      // masked minv (used columns and column 0 count as BIG)
      float best = __int_as_float(0x7f800000);  // +inf: an all-BIG row picks column 0
      int best_j = INT_MAX;
      for (int j = lane; j < cols; j += kWarp) {
        float m = minv[j];
        const bool is_used = used[j] != 0;
        if (j != 0 && !is_used) {
          const float cur = (row[j - 1] - ui0) - v[j];
          if (cur < m) {
            m = cur;
            minv[j] = cur;
            way[j] = j0;
          }
        }
        const float masked = (is_used || j == 0) ? big : m;
        if (masked < best) {
          best = masked;
          best_j = j;
        }
      }
#pragma unroll
      for (int off = kWarp / 2; off > 0; off >>= 1) {
        const float ob = __shfl_xor_sync(kFull, best, off);
        const int oj = __shfl_xor_sync(kFull, best_j, off);
        if (ob < best || (ob == best && oj < best_j)) {
          best = ob;
          best_j = oj;
        }
      }
      if (best_j == 0) {  // no column reachable: the costs are not finite
        j0 = 0;
        break;
      }
      const float delta = best;
      for (int j = lane; j < cols; j += kWarp) {
        if (used[j]) {
          const int r = j == 0 ? i : p[j];  // distinct rows: no two lanes meet
          u[r] = u[r] + delta;
          v[j] = v[j] - delta;
        } else {
          minv[j] = minv[j] - delta;
        }
      }
      j0 = best_j;
      __syncwarp();
    } while (p[j0] != 0);
    if (j0 == 0) {  // (p[0] = i: a path that ends ends on a column j > 0)
      failed = true;
      break;
    }
    if (lane == 0) {  // augment along the path back to the virtual column
      int j = j0;
      while (j != 0) {
        const int jn = way[j];
        p[j] = jn == 0 ? i : p[jn];
        j = jn;
      }
    }
    __syncwarp();
  }
  long long* o = out + static_cast<long long>(blockIdx.x) * R;
  if (failed) {  // row r to column r, flagged by steps -1
    for (int r = lane; r < R; r += kWarp) o[r] = r;
  } else {
    for (int j = lane + 1; j < cols; j += kWarp)
      if (p[j] != 0) o[p[j] - 1] = j - 1;
  }
  if (lane == 0) steps_out[blockIdx.x] = failed ? -1 : steps;
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// cost: fp32 [P, R, C] contiguous, finite; out: int64 [P, R], the column
// of each row; steps: int32 [P], each problem's Dijkstra steps (-1: a row
// reached no column, the costs not finite; rows then get columns 0..R-1). 0 <= R <=
// C <= 1024. Returns a cudaError_t code.
int linear_sum_assignment(const void* cost, void* out, void* steps, int P, int R, int C,
                          void* stream) {
  if (P < 0 || R < 0 || R > C || C > kMaxCols) return static_cast<int>(cudaErrorInvalidValue);
  if (P == 0 || R == 0) return 0;
  const size_t smem = sizeof(float) * (2 * (C + 1) + R + 1) + sizeof(int) * 3 * (C + 1);
  lsa_kernel<<<P, kWarp, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cost), static_cast<long long*>(out), static_cast<int*>(steps),
      R, C);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
