// K9: event-driven spike-broadcast matmul (activation-side zero skip).
//
// Replaces the TPU kernel src/repro/kernels/spike_broadcast.py
// `spike_broadcast` (pl.pallas_call at line 132, body
// `_spike_broadcast_kernel` over `compact_spikes`/`gather_matmul`).
//
//   m[r]      = sum_t x[t][r]                  (ts = 1: the row itself)
//   events(r) = the first cap nonzeros of m[r], ascending index
//   out[r][n] = sum_{(i, v) in events(r)} v * W[i][n]
//
// Shapes: x (ts, R, K) float32 (a 2-D (R, K) input is ts = 1; the FC
// readout's 3-D (TS, B, K) spike trains merge over TS first, values in
// {0..TS}: the value is gathered, never assumed 1), W (K, N) float32
// (dequantized int4); out (R, N) float32.  cap in [1, K]; the reference's
// padding events (index K-1, value 0) add nothing and are not visited.
//
// Bound on the H100, at the main path's shapes: L1 feed-forward, R = 512
// spike rows x 128 -> 128: x 262 KB, the named rows of W (at most 64 KB),
// out 262 KB: bytes, 0.18 us.  FC union, (2, 256, 128) -> 1920: x 262 KB,
// W rows up to 983 KB, out 1.97 MB: 0.96 us of bytes.  The gathered
// products are float32 (67 TFLOP/s outside the tensor cores: the
// dequantized weights are not exact in TF32), 2 x events x N of them: at
// the served union density (~0.24) they take half the byte time, at 0.5
// (two trains of 0.3) as long.
//
// Design: kRows rows per block, one thread per output column.  Each warp
// compacts its rows with compact_row (one __ballot_sync + __popc per 32
// columns: the reference's ascending order and tail truncation, with no
// (R, cap, K) cascade) into shared memory; then each thread walks every
// row's event list and reads only the named rows of W (coalesced across
// n), so zero activations cost nothing.  Rows and columns past the edge
// are masked, with no divisibility rule.
#include "common.cuh"

namespace {

using reprotorch::kCols;
using reprotorch::kRows;

__global__ void spike_broadcast_kernel(const float* __restrict__ x,
                                       const float* __restrict__ w,
                                       float* __restrict__ out, int ts,
                                       int r_total, int k, int n, int cap) {
  extern __shared__ int ev_sh[];  // idx [rows][cap], then val [rows][cap]
  __shared__ int cnt_sh[kRows];
  const int rows_max = min(kRows, r_total);
  int* idx_sh = ev_sh;
  float* val_sh = reinterpret_cast<float*>(ev_sh + rows_max * cap);
  const int col = blockIdx.x * kCols + threadIdx.x;
  const int row0 = blockIdx.y * kRows;
  const int rows = min(kRows, r_total - row0);
  const int warp = threadIdx.x >> 5;
  for (int r = warp; r < rows; r += kCols / 32) {
    const int c = reprotorch::compact_row(
        x + static_cast<long long>(row0 + r) * k,
        static_cast<long long>(r_total) * k, ts, k, cap, idx_sh + r * cap,
        val_sh + r * cap);
    if ((threadIdx.x & 31) == 0) cnt_sh[r] = c;
  }
  __syncthreads();
  if (col >= n) return;
  for (int r = 0; r < rows; ++r) {
    const int* ir = idx_sh + r * cap;
    const float* vr = val_sh + r * cap;
    float acc = 0.0f;
    for (int e = 0; e < cnt_sh[r]; ++e) {
      acc = fmaf(vr[e], w[static_cast<long long>(ir[e]) * n + col], acc);
    }
    out[static_cast<long long>(row0 + r) * n + col] = acc;
  }
}

}  // namespace

extern "C" int spike_broadcast_launch(const void* x, const void* w,
                                      void* out, int ts, int r_total, int k,
                                      int n, int cap, void* stream) {
  if (cap < 1 || cap > k) return reprotorch::kErrCapacity;
  const int rows_max = r_total < kRows ? r_total : kRows;
  const size_t smem = 2 * sizeof(int) * static_cast<size_t>(rows_max) * cap;
  if (smem > reprotorch::kMaxSharedBytes) return reprotorch::kErrSharedMemory;
  const dim3 grid((n + kCols - 1) / kCols, (r_total + kRows - 1) / kRows);
  spike_broadcast_kernel<<<grid, kCols, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(out), ts, r_total, k, n, cap);
  return static_cast<int>(cudaGetLastError());
}
