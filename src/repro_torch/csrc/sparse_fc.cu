// K4: zero-skip FC readout over padded-CSC columns (merged-spike input).
//
// Replaces the TPU kernel src/repro/kernels/sparse_fc.py `sparse_fc`
// (pl.pallas_call at line 69, body `_sparse_fc_kernel`).
//
//   merged   = sum_t spikes[t]                                    (B, H)
//   out[b][n] = (sum_e merged[b][indices[e][n]] * values[e][n]) * scale[n]
//
// Shapes: spikes (TS, B, H) float32, indices (nnz_max, N) int32, values
// (nnz_max, N) float32 (int4 values, 0 on padding), scale (N,) float32; out
// (B, N) float32.  Padded entries are (index 0, value 0) and add nothing;
// an index outside [0, H) is skipped, so the gather never leaves the row
// (the engine validates indices when it loads an artifact).  Products are
// integers in [-16, 14] and sums stay below 2^24: bit-equal to the plain
// version.
//
// Bound on the H100: bytes — the 8 bytes of index + value per padded
// entry (nnz_max x 1920 x 8 B, 1.5 MB at 40% pruning) and the 1.97 MB
// output at B = 256: 1.1 us.  The measured time (PERF.md, from
// chip_smoke.py) is far above it: each thread's loop waits on one index,
// then one value, per step.
//
// Design: the merged spikes of kRows rows sit in shared
// memory; each thread walks one output column's index/value lists
// (coalesced across n) and gathers from shared memory for kRows rows, so
// the TPU kernel's (B, nnz_max, N) gather intermediate never exists.
#include "common.cuh"

namespace {

using reprotorch::kCols;
using reprotorch::kRows;

__global__ void sparse_fc_kernel(const float* __restrict__ spikes,
                                 const int* __restrict__ indices,
                                 const float* __restrict__ values,
                                 const float* __restrict__ scale,
                                 float* __restrict__ out, int ts, int b,
                                 int h, int nnz, int n) {
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
  for (int e = 0; e < nnz; ++e) {
    const long long at = static_cast<long long>(e) * n + col;
    const int row = indices[at];
    if (static_cast<unsigned>(row) >= static_cast<unsigned>(h)) continue;
    const float v = values[at];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < rows) acc[r] = fmaf(m_sh[r * h + row], v, acc[r]);
    }
  }
  const float s = scale[col];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r < rows) out[static_cast<long long>(row0 + r) * n + col] = __fmul_rn(acc[r], s);
  }
}

}  // namespace

extern "C" int sparse_fc_launch(const void* spikes, const void* indices,
                                const void* values, const void* scale,
                                void* out, int ts, int b, int h, int nnz,
                                int n, void* stream) {
  const dim3 grid((n + kCols - 1) / kCols, (b + kRows - 1) / kRows);
  const size_t smem = sizeof(float) * static_cast<size_t>(b < kRows ? b : kRows) * h;
  if (smem > reprotorch::kMaxSharedBytes) return reprotorch::kErrSharedMemory;
  sparse_fc_kernel<<<grid, kCols, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(spikes), static_cast<const int*>(indices),
      static_cast<const float*>(values), static_cast<const float*>(scale),
      static_cast<float*>(out), ts, b, h, nnz, n);
  return static_cast<int>(cudaGetLastError());
}
