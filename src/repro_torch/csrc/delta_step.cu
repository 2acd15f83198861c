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
// the byte time.
//
// Design: kRows batch rows per block, one thread per output column.  The
// block gates its rows into shared memory (the first column block also
// writes x_hat and mask) and flags each row that propagated; each thread
// then loads W[k][n] once per k (coalesced across n) for all its rows, and
// stores the sum for a flagged row or pre_prev's value for the others.  A
// block whose rows all hold skips the product.  The ragged edge is
// masked: B need not be a multiple of any block.
#include "common.cuh"

namespace {

using reprotorch::kCols;
using reprotorch::kRows;

__global__ void delta_step_kernel(const float* __restrict__ x,
                                  const float* __restrict__ x_prev,
                                  const float* __restrict__ pre_prev,
                                  const float* __restrict__ w, float thr,
                                  float* __restrict__ x_hat,
                                  float* __restrict__ pre,
                                  float* __restrict__ mask, int b, int d,
                                  int h) {
  extern __shared__ float xh_sh[];  // [rows][d]
  __shared__ int changed_sh[kRows];
  const int col = blockIdx.x * kCols + threadIdx.x;
  const int row0 = blockIdx.y * kRows;
  const int rows = min(kRows, b - row0);
  if (threadIdx.x < kRows) changed_sh[threadIdx.x] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < rows * d; i += blockDim.x) {
    const int r = i / d;
    const long long at = static_cast<long long>(row0) * d + i;
    const float xv = x[at];
    const float pv = x_prev[at];
    const bool m = fabsf(__fsub_rn(xv, pv)) > thr;
    const float xh = m ? xv : pv;
    xh_sh[i] = xh;
    if (blockIdx.x == 0) {
      x_hat[at] = xh;
      mask[at] = m ? 1.0f : 0.0f;
    }
    if (m) changed_sh[r] = 1;
  }
  __syncthreads();
  if (col >= h) return;

  bool any = false;
  for (int r = 0; r < rows; ++r) any = any || changed_sh[r];
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
  if (any) {
    for (int k = 0; k < d; ++k) {
      const float wk = w[static_cast<long long>(k) * h + col];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < rows) acc[r] = fmaf(xh_sh[r * d + k], wk, acc[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r >= rows) continue;
    const long long at = static_cast<long long>(row0 + r) * h + col;
    pre[at] = changed_sh[r] ? acc[r] : pre_prev[at];
  }
}

}  // namespace

extern "C" int delta_step_launch(const void* x, const void* x_prev,
                                 const void* pre_prev, const void* w,
                                 float thr, void* x_hat, void* pre,
                                 void* mask, int b, int d, int h,
                                 void* stream) {
  const size_t smem = sizeof(float) * static_cast<size_t>(b < kRows ? b : kRows) * d;
  if (smem > reprotorch::kMaxSharedBytes) return reprotorch::kErrSharedMemory;
  const dim3 grid((h + kCols - 1) / kCols, (b + kRows - 1) / kRows);
  delta_step_kernel<<<grid, kCols, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(x_prev),
      static_cast<const float*>(pre_prev), static_cast<const float*>(w), thr,
      static_cast<float*>(x_hat), static_cast<float*>(pre),
      static_cast<float*>(mask), b, d, h);
  return static_cast<int>(cudaGetLastError());
}
