// K2: matmul against nibble-packed int4 weights, scale in the epilogue.
//
// Replaces the TPU kernel src/repro/kernels/int4_matmul.py `int4_matmul`
// (pl.pallas_call at line 65, bodies `_int4_matmul_kernel`/`_unpack_block`).
//
//   out[m][n] = (sum_k x[m][k] * unpack(packed)[k][n]) * scale[n]
//
// Shapes: x (M, K) float32, packed (K/2, N) int8 (low nibble = even row),
// scale (N,) float32; out (M, N) float32.  On the served path x holds 8-bit
// integer inputs (L0, K = 40) or spikes (L1, M = TS*B, K = 128); every
// partial sum is then an integer below 2^24, exact in float32 in any order,
// and the single multiply by the scale rounds once: bit-equal to the plain
// version.
//
// Bound on the H100: the operands are 8-bit integers or spikes times int4
// weights, exact on the int8 tensor cores (1,979 TOP/s), so bytes bound
// both calls at B = 256: 0.175 MB for L0 (0.052 us) and 0.533 MB for L1
// (0.159 us).  The measured time (PERF.md, from chip_smoke.py) is far above
// it: 32-64 blocks, each thread waiting on one packed byte per step of its
// loop.
//
// Design: one thread per output column, kRows rows of x in shared memory, each packed byte loaded once
// (coalesced across n) and unpacked in registers for kRows rows — the int4
// weights never exist in memory at float precision.
#include "common.cuh"

namespace {

using reprotorch::kCols;
using reprotorch::kRows;

__global__ void int4_matmul_kernel(const float* __restrict__ x,
                                   const int8_t* __restrict__ packed,
                                   const float* __restrict__ scale,
                                   float* __restrict__ out, int m, int k,
                                   int n) {
  extern __shared__ float x_sh[];  // [rows][k]
  const int col = blockIdx.x * kCols + threadIdx.x;
  const int row0 = blockIdx.y * kRows;
  const int rows = min(kRows, m - row0);
  for (int i = threadIdx.x; i < rows * k; i += blockDim.x) {
    x_sh[i] = x[static_cast<long long>(row0) * k + i];
  }
  __syncthreads();
  if (col >= n) return;

  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
  reprotorch::int4_column_dot(x_sh, rows, k, packed, n, col, acc);
  const float s = scale[col];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r < rows) out[static_cast<long long>(row0 + r) * n + col] = __fmul_rn(acc[r], s);
  }
}

}  // namespace

extern "C" int int4_matmul_launch(const void* x, const void* packed,
                                  const void* scale, void* out, int m, int k,
                                  int n, void* stream) {
  const dim3 grid((n + kCols - 1) / kCols, (m + kRows - 1) / kRows);
  const size_t smem = sizeof(float) * static_cast<size_t>(m < kRows ? m : kRows) * k;
  if (smem > reprotorch::kMaxSharedBytes) return reprotorch::kErrSharedMemory;
  int4_matmul_kernel<<<grid, kCols, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(packed),
      static_cast<const float*>(scale), static_cast<float*>(out), m, k, n);
  return static_cast<int>(cudaGetLastError());
}
