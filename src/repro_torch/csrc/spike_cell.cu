// K10: recurrent spiking layer with the event-gather recurrent product.
//
// Replaces the TPU kernel src/repro/kernels/spike_broadcast.py
// `spike_cell` (pl.pallas_call at line 183, body `_spike_cell_kernel`).
// It is K1 (csrc/rsnn_cell.cu) with `s_prev @ W` in K9's gather form:
//
//   rec[t][b] = sum_{(i, v) in events(s_prev[t][b])} v * W[i]
//   stim[t]   = stim_base[t] + rec[t]
//   u         = stim[t] + (beta * u) * (1 - h);  h = (u >= vth)   t = 0..TS-1
//
// TS folds into the event-row axis: the block's kRows x TS spike rows are
// compacted together and one pass over them serves every time step.
// Shapes as K1: stim_base (TS, B, H) with free strides on its first two
// axes (the L0 stimulus is one (B, H) row broadcast over TS with stride 0,
// never copied or read as dense), s_prev (TS, B, H), W (H, H), u0/h0
// (B, H), beta/vth (H,); out spikes (TS, B, H), u (B, H), float32.
// cap in [1, H] events per row (the first cap in index order are kept).
//
// W is 64 KB at H = 128, over kMaxSharedBytes (48 KB): it is not staged
// in shared memory.  As in K1, the grid tiles W's columns (kCols per
// block) and each thread reads its column of the rows its events name
// from global memory (coalesced across n, L1/L2-cached); only the event
// lists sit in shared memory (kRows x TS x cap x 8 B, 16 KB at TS = 2).
//
// Bound on the H100: bytes, as K1 — at B = 256, H = 128, TS = 2 a call
// moves ~1.1 MB (the broadcast stimulus counts its one row; W counts only
// its named rows): 0.33 us; the gathered float32 products (2 x events x H)
// are a fraction of K1's 17 MFLOP at 67 TFLOP/s.
//
// The LIF chain is K1's exactly: __fmul_rn/__fadd_rn in the reference's
// order, no FMA contraction.
#include "common.cuh"

namespace {

using reprotorch::kCols;
using reprotorch::kMaxTs;
using reprotorch::kRows;

__global__ void spike_cell_kernel(
    const float* __restrict__ stim, long long stim_st, long long stim_sb,
    const float* __restrict__ s_prev, const float* __restrict__ w,
    const float* __restrict__ u0, const float* __restrict__ h0,
    const float* __restrict__ beta, const float* __restrict__ vth,
    float* __restrict__ spikes, float* __restrict__ u_out, int ts, int b,
    int h, int cap) {
  extern __shared__ int ev_sh[];  // idx [lists][cap], then val [lists][cap]
  __shared__ int cnt_sh[kRows * kMaxTs];
  const int lists_max = min(kRows, b) * ts;
  int* idx_sh = ev_sh;
  float* val_sh = reinterpret_cast<float*>(ev_sh + lists_max * cap);
  const int n = blockIdx.x * kCols + threadIdx.x;
  const int row0 = blockIdx.y * kRows;
  const int rows = min(kRows, b - row0);
  const int warp = threadIdx.x >> 5;
  // list l = r * ts + t holds the events of s_prev[t][row0 + r]
  for (int l = warp; l < rows * ts; l += kCols / 32) {
    const int r = l / ts;
    const int t = l - r * ts;
    const int c = reprotorch::compact_row(
        s_prev + (static_cast<long long>(t) * b + row0 + r) * h, 0, 1, h,
        cap, idx_sh + l * cap, val_sh + l * cap);
    if ((threadIdx.x & 31) == 0) cnt_sh[l] = c;
  }
  __syncthreads();
  if (n >= h) return;

  float acc[kRows][kMaxTs];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int t = 0; t < kMaxTs; ++t) {
      acc[r][t] = 0.0f;
      if (r < rows && t < ts) {
        const int l = r * ts + t;
        const int* il = idx_sh + l * cap;
        const float* vl = val_sh + l * cap;
        float a = 0.0f;
        for (int e = 0; e < cnt_sh[l]; ++e) {
          a = fmaf(vl[e], w[static_cast<long long>(il[e]) * h + n], a);
        }
        acc[r][t] = a;
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

extern "C" int spike_cell_launch(const void* stim, long long stim_st,
                                 long long stim_sb, const void* s_prev,
                                 const void* w, const void* u0,
                                 const void* h0, const void* beta,
                                 const void* vth, void* spikes, void* u_out,
                                 int ts, int b, int h, int cap,
                                 void* stream) {
  if (ts > kMaxTs) return reprotorch::kErrTooManySteps;
  if (cap < 1 || cap > h) return reprotorch::kErrCapacity;
  const size_t lists = static_cast<size_t>(b < kRows ? b : kRows) * ts;
  const size_t smem = 2 * sizeof(int) * lists * cap;
  if (smem > reprotorch::kMaxSharedBytes) return reprotorch::kErrSharedMemory;
  const dim3 grid((h + kCols - 1) / kCols, (b + kRows - 1) / kRows);
  spike_cell_kernel<<<grid, kCols, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(stim), stim_st, stim_sb,
      static_cast<const float*>(s_prev), static_cast<const float*>(w),
      static_cast<const float*>(u0), static_cast<const float*>(h0),
      static_cast<const float*>(beta), static_cast<const float*>(vth),
      static_cast<float*>(spikes), static_cast<float*>(u_out), ts, b, h, cap);
  return static_cast<int>(cudaGetLastError());
}
