// K8: delta-temporal input gating (EdgeDRNN) with the held-input product.
//
// Replaces the TPU kernel src/repro/kernels/delta_step.py `delta_step`
// (pl.pallas_call at line 57, body `_delta_step_kernel`).
//
//   mask  = |x - x_prev| > thr                       (strict)
//   x_hat = mask ? x : x_prev
//   pre   = any(mask[b]) ? x_hat[b] @ W : pre_prev[b]  (the cached row's bits)
//
// Shapes: x/x_prev (B, D), pre_prev (B, H), W (D, H), thr a float; out
// x_hat (B, D), pre (B, H), mask (B, D) float {0, 1}, all float32.  A row
// with no propagated element copies pre_prev unchanged, so threshold 0
// reproduces the dense path wherever a frame repeats.
//
// Bound on the H100: bytes — at the main path's B = 256, D = 40, H = 128 a
// call reads x and x_prev (41 KB each), W (20 KB) and the cached rows of
// pre_prev, and writes x_hat, mask (41 KB each) and pre (131 KB): ~0.32 MB,
// 0.1 us.  The product, 2 x D x H float32 operations per recomputed row
// (67 TFLOP/s: the dequantized weights are not exact in TF32), is below
// the byte time.  The launch and one round of loads set the time.
//
// Design: a block owns `rows` batch rows by `cols` outputs (the tile plan,
// chosen by the wrapper from (B, D, H) so that the grid has a block for
// every SM); a thread owns kVec = 4 adjacent outputs of one row.  The block
// starts a cp.async copy of W's column tile (D x cols float32) into shared
// memory; while it is in flight each thread loads its four pre_prev values
// (one float4 where the row allows), and the block gates its rows x D
// elements over all its threads (eight elements' loads a thread ahead of
// their compares, so one round of loads serves a small block): x_hat goes
// to shared memory (the blocks of the first column tile also write x_hat
// and mask, so each element is written exactly once across the grid) and
// a changed element flags its row.  Then a thread of a changed row runs
// its four sums over D, each one fmaf chain in ascending k, x_hat broadcast
// and a float4 of W from shared memory per k (four k's loads ahead); a
// thread of a held row stores pre_prev's values as loaded.  The launch
// refuses a plan it does not take (kErrTilePlan) and one whose tiles pass
// 227 KB (kErrSharedMemory).  Rows and columns past the edge are masked,
// with no divisibility rule.
#include "common.cuh"

namespace {

constexpr int kVec = 4;  // outputs a thread: adjacent columns of one row
constexpr int kGateAhead = 8;  // gate elements a thread loads ahead

// Shared memory of one block, in floats: W's column tile [d][cols], the
// rows' x_hat [rows][d], then one changed flag (int) a row.  The wrapper's
// tile_plans compute the same bytes.
struct DeltaLayout {
  size_t x_hat, changed, bytes;
  __host__ __device__ DeltaLayout(int rows, int cols, int d) {
    x_hat = static_cast<size_t>(d) * cols;
    changed = x_hat + static_cast<size_t>(rows) * d;
    bytes = sizeof(float) * (changed + rows);
  }
};

__global__ void __launch_bounds__(1024) delta_step_kernel(
    const float* __restrict__ x, const float* __restrict__ x_prev,
    const float* __restrict__ pre_prev, const float* __restrict__ w, float thr,
    float* __restrict__ x_hat, float* __restrict__ pre,
    float* __restrict__ mask, int b, int d, int h, int rows_b, int cols,
    bool w16, bool vec) {
  extern __shared__ __align__(16) float sh[];
  const DeltaLayout lay(rows_b, cols, d);
  float* w_sh = sh;
  float* xh_sh = sh + lay.x_hat;
  int* changed_sh = reinterpret_cast<int*>(sh + lay.changed);
  const int c0 = blockIdx.x * cols;
  const int row0 = blockIdx.y * rows_b;
  const int rows = min(rows_b, b - row0);

  reprotorch::stage_column_tile(w, d, h, c0, cols, w16, w_sh);

  // this thread's outputs: row r, columns n0..n0+3; pre_prev's values load
  // while the tile is in flight, for the row that turns out to be held
  const int per_row = cols / kVec;
  const int r = threadIdx.x / per_row;
  const int n0 = c0 + kVec * (threadIdx.x - r * per_row);
  const long long row = row0 + r;
  const bool live = r < rows && n0 < h;
  const bool vec4 = vec && n0 + kVec <= h;
  if (threadIdx.x < rows) changed_sh[threadIdx.x] = 0;
  float held[kVec] = {};
  if (live) {
    const float* p = pre_prev + row * h + n0;
    if (vec4) {
      reprotorch::load_vec<kVec>(p, held);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) held[j] = n0 + j < h ? p[j] : 0.0f;
    }
  }

  __syncthreads();  // the flags are reset before any gate sets one

  // the gate: the block's rows x d elements over all its threads, kGateAhead
  // elements' loads a thread ahead of their compares; a changed element
  // flags its row
  const int elements = rows * d;
  const long long base = static_cast<long long>(row0) * d;
  for (int i0 = threadIdx.x; i0 < elements; i0 += kGateAhead * blockDim.x) {
    float xv[kGateAhead], pv[kGateAhead];
#pragma unroll
    for (int u = 0; u < kGateAhead; ++u) {
      const int i = i0 + u * blockDim.x;
      xv[u] = i < elements ? x[base + i] : 0.0f;
      pv[u] = i < elements ? x_prev[base + i] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kGateAhead; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i >= elements) break;
      const bool m = fabsf(__fsub_rn(xv[u], pv[u])) > thr;
      const float xh = m ? xv[u] : pv[u];
      xh_sh[i] = xh;
      if (blockIdx.x == 0) {
        x_hat[base + i] = xh;
        mask[base + i] = m ? 1.0f : 0.0f;
      }
      if (m) changed_sh[i / d] = 1;
    }
  }
  reprotorch::cp_async_wait_all();
  __syncthreads();
  if (!live) return;

  float out[kVec];
  if (changed_sh[r]) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) out[j] = 0.0f;
    const float* xr = xh_sh + r * d;
    const float* wc = w_sh + (n0 - c0);
    int k = 0;
    for (; k + 4 <= d; k += 4) {  // four k's loads ahead of their fmafs
      float xk[4], wv[4][kVec];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        xk[q] = xr[k + q];
        reprotorch::load_vec<kVec>(wc + (k + q) * cols, wv[q]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int j = 0; j < kVec; ++j) out[j] = fmaf(xk[q], wv[q][j], out[j]);
      }
    }
    for (; k < d; ++k) {
      float wv[kVec];
      reprotorch::load_vec<kVec>(wc + k * cols, wv);
#pragma unroll
      for (int j = 0; j < kVec; ++j) out[j] = fmaf(xr[k], wv[j], out[j]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) out[j] = held[j];
  }
  float* o = pre + row * h + n0;
  if (vec4) {
    reprotorch::store_vec<kVec>(o, out);
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      if (n0 + j < h) o[j] = out[j];
    }
  }
}

// The plans the kernel takes: 1-32 rows by 32, 64 or 128 columns (a warp
// spans at most four rows), one to 32 warps of kVec outputs a thread.
bool takes_plan(int rows, int cols) {
  const bool r = rows >= 1 && rows <= 32 && (rows & (rows - 1)) == 0;
  const bool c = cols == 32 || cols == 64 || cols == 128;
  const int threads = rows * cols / kVec;
  return r && c && threads >= 32 && threads <= 1024;
}

}  // namespace

extern "C" int delta_step_launch(const void* x, const void* x_prev,
                                 const void* pre_prev, const void* w,
                                 float thr, void* x_hat, void* pre,
                                 void* mask, int b, int d, int h, int rows,
                                 int cols, void* stream) {
  if (!takes_plan(rows, cols)) return reprotorch::kErrTilePlan;
  const DeltaLayout lay(rows, cols, d);
  if (lay.bytes > reprotorch::kMaxOptInSharedBytes) {
    return reprotorch::kErrSharedMemory;
  }
  const int opt = reprotorch::opt_in_shared(delta_step_kernel, lay.bytes);
  if (opt != 0) return opt;
  const bool w16 = h % 4 == 0 && reprotorch::aligned_to(w, 16);
  const bool vec = h % kVec == 0 && reprotorch::aligned_to(pre_prev, 16) &&
                   reprotorch::aligned_to(pre, 16);
  const dim3 grid((h + cols - 1) / cols, (b + rows - 1) / rows);
  delta_step_kernel<<<grid, rows * cols / kVec, lay.bytes,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(x_prev),
      static_cast<const float*>(pre_prev), static_cast<const float*>(w), thr,
      static_cast<float*>(x_hat), static_cast<float*>(pre),
      static_cast<float*>(mask), b, d, h, rows, cols, w16, vec);
  return static_cast<int>(cudaGetLastError());
}
