// K3: merged-spike FC readout with int4 weights (paper §II-D2).
//
// Replaces the TPU kernel src/repro/kernels/merged_spike_fc.py
// `merged_spike_fc` (pl.pallas_call at line 43, body `_merged_fc_kernel`).
//
//   out[b][n] = (sum_k (sum_t spikes[t][b][k]) * unpack(packed)[k][n]) * scale[n]
//
// Shapes: spikes (TS, B, H) float32 in {0, 1}, packed (H/2, N) int8, scale
// (N,) float32; out (B, N) float32.  Merged spikes lie in {0..TS}, so the
// sums are exact integers and the result is bit-equal to the plain version.
//
// Bound on the H100: at B = 256, H = 128, N = 1920 the call moves 2.36 MB
// (the 1.97 MB output dominates) and does 126 M operations on spikes in
// {0..TS} and int4 weights, exact on the int8 tensor cores (1,979 TOP/s):
// bytes bound it, at 0.70 us.  The measured time (PERF.md, from
// chip_smoke.py) is far above it: each thread's loop waits on one packed
// byte per step.
//
// Design: the TS trains of kRows rows are summed once into shared memory
// (one weight pass serves every time step), then each thread walks one
// output column's packed bytes, unpacking nibbles in registers.
#include "common.cuh"

namespace {

using reprotorch::kCols;
using reprotorch::kRows;

__global__ void merged_spike_fc_kernel(const float* __restrict__ spikes,
                                       const int8_t* __restrict__ packed,
                                       const float* __restrict__ scale,
                                       float* __restrict__ out, int ts, int b,
                                       int h, int n) {
  extern __shared__ float m_sh[];  // [rows][h]
  const int col = blockIdx.x * kCols + threadIdx.x;
  const int row0 = blockIdx.y * kRows;
  const int rows = min(kRows, b - row0);
  reprotorch::stage_merged_rows(spikes, ts, b, h, row0, rows, m_sh);
  __syncthreads();
  if (col >= n) return;

  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
  reprotorch::int4_column_dot(m_sh, rows, h, packed, n, col, acc);
  const float s = scale[col];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r < rows) out[static_cast<long long>(row0 + r) * n + col] = __fmul_rn(acc[r], s);
  }
}

}  // namespace

extern "C" int merged_spike_fc_launch(const void* spikes, const void* packed,
                                      const void* scale, void* out, int ts,
                                      int b, int h, int n, void* stream) {
  const dim3 grid((n + kCols - 1) / kCols, (b + kRows - 1) / kRows);
  const size_t smem = sizeof(float) * static_cast<size_t>(b < kRows ? b : kRows) * h;
  if (smem > reprotorch::kMaxSharedBytes) return reprotorch::kErrSharedMemory;
  merged_spike_fc_kernel<<<grid, kCols, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(spikes), static_cast<const int8_t*>(packed),
      static_cast<const float*>(scale), static_cast<float*>(out), ts, b, h, n);
  return static_cast<int>(cudaGetLastError());
}
