// K1: fused recurrent spiking layer over TS parallel time steps.
//
// Replaces the TPU kernel src/repro/kernels/rsnn_cell.py `rsnn_cell`
// (pl.pallas_call at line 53, body `_rsnn_cell_kernel`).
//
//   rec[t]  = s_prev[t] @ W            (W read once for every time step)
//   stim[t] = stim_base[t] + rec[t]
//   u       = stim[t] + (beta * u) * (1 - h);  h = (u >= vth)   for t = 0..TS-1
//
// Shapes: stim_base (TS, B, H) with free strides on its first two axes (the
// L0 stimulus is one (B, H) row broadcast over TS: stride 0), s_prev
// (TS, B, H), W (H, H), u0/h0 (B, H), beta/vth (H,); out spikes (TS, B, H),
// u (B, H), all float32.
//
// Bound on the H100: at the main path's B = 256, H = 128, TS = 2 a call
// moves 1.1-1.2 MB and does 17 MFLOP of float32 (67 TFLOP/s outside the
// tensor cores, which hold no float32 product exactly): bytes bound it, at
// 0.33-0.37 us.  The measured time (PERF.md, from chip_smoke.py) is far
// above it: with 8 rows a block there are only 32 blocks, and each
// thread's loop over k waits on one W load per step, so the kernel is
// latency-bound.
//
// Design: one thread per output neuron n and kRows batch rows per block; the rows' previous spikes sit in shared memory, each
// W[k][n] is loaded once (coalesced across n) and feeds kRows x TS
// accumulators in registers, and the LIF chain runs in the epilogue so the
// stimulus never goes back to global memory.  The chain rounds every
// operation as the reference does (__fmul_rn/__fadd_rn: no FMA contraction).
#include "common.cuh"

namespace {

using reprotorch::kCols;
using reprotorch::kMaxTs;
using reprotorch::kRows;

__global__ void rsnn_cell_kernel(
    const float* __restrict__ stim, long long stim_st, long long stim_sb,
    const float* __restrict__ s_prev, const float* __restrict__ w,
    const float* __restrict__ u0, const float* __restrict__ h0,
    const float* __restrict__ beta, const float* __restrict__ vth,
    float* __restrict__ spikes, float* __restrict__ u_out, int ts, int b,
    int h) {
  extern __shared__ float s_sh[];  // [rows][ts][h]
  const int n = blockIdx.x * kCols + threadIdx.x;
  const int row0 = blockIdx.y * kRows;
  const int rows = min(kRows, b - row0);

  for (int i = threadIdx.x; i < rows * ts * h; i += blockDim.x) {
    const int r = i / (ts * h);
    const int rem = i - r * ts * h;
    const int t = rem / h;
    const int k = rem - t * h;
    s_sh[i] = s_prev[(static_cast<long long>(t) * b + row0 + r) * h + k];
  }
  __syncthreads();
  if (n >= h) return;

  float acc[kRows][kMaxTs];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int t = 0; t < kMaxTs; ++t) acc[r][t] = 0.0f;
  }
  for (int k = 0; k < h; ++k) {
    const float wk = w[static_cast<long long>(k) * h + n];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int t = 0; t < kMaxTs; ++t) {
        if (r < rows && t < ts) {
          acc[r][t] = fmaf(s_sh[(r * ts + t) * h + k], wk, acc[r][t]);
        }
      }
    }
  }

  const float bt = beta[n];
  const float vt = vth[n];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r >= rows) continue;
    const long long bi = row0 + r;
    float u = u0[bi * h + n];
    float hh = h0[bi * h + n];
#pragma unroll
    for (int t = 0; t < kMaxTs; ++t) {
      if (t >= ts) continue;
      const float st = __fadd_rn(stim[t * stim_st + bi * stim_sb + n], acc[r][t]);
      u = __fadd_rn(st, __fmul_rn(__fmul_rn(bt, u), __fsub_rn(1.0f, hh)));
      hh = (u >= vt) ? 1.0f : 0.0f;
      spikes[(static_cast<long long>(t) * b + bi) * h + n] = hh;
    }
    u_out[bi * h + n] = u;
  }
}

}  // namespace

extern "C" int rsnn_cell_launch(const void* stim, long long stim_st,
                                long long stim_sb, const void* s_prev,
                                const void* w, const void* u0, const void* h0,
                                const void* beta, const void* vth,
                                void* spikes, void* u_out, int ts, int b,
                                int h, void* stream) {
  const dim3 grid((h + kCols - 1) / kCols, (b + kRows - 1) / kRows);
  const size_t smem = sizeof(float) * static_cast<size_t>(b < kRows ? b : kRows) * ts * h;
  if (ts > kMaxTs) return reprotorch::kErrTooManySteps;
  if (smem > reprotorch::kMaxSharedBytes) return reprotorch::kErrSharedMemory;
  rsnn_cell_kernel<<<grid, kCols, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(stim), stim_st, stim_sb,
      static_cast<const float*>(s_prev), static_cast<const float*>(w),
      static_cast<const float*>(u0), static_cast<const float*>(h0),
      static_cast<const float*>(beta), static_cast<const float*>(vth),
      static_cast<float*>(spikes), static_cast<float*>(u_out), ts, b, h);
  return static_cast<int>(cudaGetLastError());
}
