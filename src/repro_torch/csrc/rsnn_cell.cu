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
// 0.33-0.37 us.  The products stay on the FMA units: at that rate they take
// 0.25 us, so the launch and one round of staging, not the rate, set the
// time.
//
// Design: a block owns `rows` batch rows by `cols` neurons (the tile plan,
// chosen by the wrapper from (TS, B, H) so that the grid has a block for
// every SM).  It stages its column tile of W (H x cols float32) and its
// rows' TS spike trains (TS x rows x H) into shared memory with cp.async,
// and while they are in flight loads the stimulus, u0, h0, beta and vth its
// outputs' LIF chains will read.  Each thread owns 1 row x TS x 2 neurons
// of accumulators (kTs a template parameter, so no guard sits inside the
// loop) and runs k ascending over shared memory, four k at a time: a
// float2 of W for each k and a float4 of spikes for each of its steps are
// loaded ahead of their multiply-adds, and one W element loaded serves
// every time step of the thread, as on the TPU.  A thread's chain, not
// the number of blocks, sets the loop's time, and a block's threads share
// one staging, so the tile is small (a 2 x TS x 2 tile was slower at the
// picked plans: PERF.md).  Each output's sum is one fmaf chain in
// ascending k (pads past H add exact zeros).  The LIF chain runs in the
// epilogue so the stimulus never goes back to global memory; it rounds
// every operation as the reference does (__fmul_rn/__fadd_rn: no FMA
// contraction).  The launch refuses TS over
// kMaxTs (kErrTooManySteps), a plan whose tiles pass 227 KB
// (kErrSharedMemory) and one it does not take (kErrTilePlan).  Rows and
// neurons past the edge are masked, with no divisibility rule.
#include "common.cuh"

namespace {

constexpr int kThreadRows = 1;  // rows of a thread's accumulator tile
constexpr int kThreadCols = 2;  // neurons of a thread's accumulator tile
// threads of the largest plan, 32 rows x 64 neurons
constexpr int kMaxThreads = 32 * 64 / (kThreadRows * kThreadCols);

// Shared memory of one block, in floats: W's column tile [kp][cols] (k
// padded to 4, the pad rows zero), then the trains [ts][rows][kp + 4] (the
// row pad puts a warp's rows on distinct banks).  The wrapper's tile_plans
// compute the same bytes.
struct CellLayout {
  int kp, ld;
  size_t trains, bytes;
  __host__ __device__ CellLayout(int ts, int rows, int cols, int h)
      : kp((h + 3) & ~3), ld(kp + 4) {
    trains = static_cast<size_t>(kp) * cols;
    bytes = sizeof(float) * (trains + static_cast<size_t>(ts) * rows * ld);
  }
};

template <int kTs>
__global__ void __launch_bounds__(kMaxThreads, 1) rsnn_cell_kernel(
    const float* __restrict__ stim, long long stim_st, long long stim_sb,
    const float* __restrict__ s_prev, const float* __restrict__ w,
    const float* __restrict__ u0, const float* __restrict__ h0,
    const float* __restrict__ beta, const float* __restrict__ vth,
    float* __restrict__ spikes, float* __restrict__ u_out, int b, int h,
    int rows, int cols, bool w16, bool s16) {
  extern __shared__ __align__(16) float sh[];
  const CellLayout lay(kTs, rows, cols, h);
  const int kp = lay.kp, ld = lay.ld;
  float* w_sh = sh;
  float* s_sh = sh + lay.trains;
  const int c0 = blockIdx.x * cols;
  const int row0 = blockIdx.y * rows;

  // W's column tile (neurons past h zero-filled, pad rows zero), then the
  // rows' trains (rows past b and k past h zero-filled)
  reprotorch::stage_column_tile(w, h, h, c0, cols, w16, w_sh);
  for (int i = h * cols + threadIdx.x; i < kp * cols; i += blockDim.x) {
    w_sh[i] = 0.0f;
  }
  if (s16) {  // h a multiple of 4: kp = h
    const int quads = kp >> 2;
    for (int i = threadIdx.x; i < kTs * rows * quads; i += blockDim.x) {
      const int tr = i / quads;
      const int q = 4 * (i - tr * quads);
      const int t = tr / rows;
      const int row = row0 + (tr - t * rows);
      const bool in = row < b;
      reprotorch::cp_async16(
          s_sh + tr * ld + q,
          s_prev + (in ? (static_cast<long long>(t) * b + row) * h + q : 0),
          in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kTs * rows * kp; i += blockDim.x) {
      const int tr = i / kp;
      const int k = i - tr * kp;
      const int t = tr / rows;
      const int row = row0 + (tr - t * rows);
      const bool in = row < b && k < h;
      reprotorch::cp_async4(
          s_sh + tr * ld + k,
          s_prev + (in ? (static_cast<long long>(t) * b + row) * h + k : 0),
          in ? 4 : 0);
    }
  }

  // this thread's outputs: kThreadRows rows from r0 by kThreadCols neurons
  // from n0; their LIF operands load while the tiles are in flight
  const int half = cols / kThreadCols;
  const int ry = threadIdx.x / half;
  const int cx = threadIdx.x - ry * half;
  const int r0 = kThreadRows * ry;
  const int n0 = c0 + kThreadCols * cx;
  float st[kThreadRows][kTs][kThreadCols], u[kThreadRows][kThreadCols],
      hh[kThreadRows][kThreadCols], bt[kThreadCols], vt[kThreadCols];
#pragma unroll
  for (int j = 0; j < kThreadCols; ++j) {
    const bool in = n0 + j < h;
    bt[j] = in ? beta[n0 + j] : 0.0f;
    vt[j] = in ? vth[n0 + j] : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < kThreadRows; ++i) {
    const long long row = row0 + r0 + i;
#pragma unroll
    for (int j = 0; j < kThreadCols; ++j) {
      const bool in = row < b && n0 + j < h;
      const long long at = row * h + n0 + j;
      u[i][j] = in ? u0[at] : 0.0f;
      hh[i][j] = in ? h0[at] : 0.0f;
#pragma unroll
      for (int t = 0; t < kTs; ++t) {
        st[i][t][j] = in ? stim[t * stim_st + row * stim_sb + n0 + j] : 0.0f;
      }
    }
  }
  reprotorch::cp_async_wait_all();
  __syncthreads();

  float acc[kThreadRows][kTs][kThreadCols];
#pragma unroll
  for (int i = 0; i < kThreadRows; ++i) {
#pragma unroll
    for (int t = 0; t < kTs; ++t) {
#pragma unroll
      for (int j = 0; j < kThreadCols; ++j) acc[i][t][j] = 0.0f;
    }
  }
  const float* w_t = w_sh + kThreadCols * cx;
  const float* s_t = s_sh + r0 * ld;
  for (int k = 0; k < kp; k += 4) {
    float wv[4][kThreadCols];
    float4 sv[kThreadRows][kTs];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if constexpr (kThreadCols == 2) {
        const float2 v = *reinterpret_cast<const float2*>(w_t + (k + q) * cols);
        wv[q][0] = v.x;
        wv[q][1] = v.y;
      } else {
        wv[q][0] = w_t[(k + q) * cols];
      }
    }
#pragma unroll
    for (int i = 0; i < kThreadRows; ++i) {
#pragma unroll
      for (int t = 0; t < kTs; ++t) {
        sv[i][t] = *reinterpret_cast<const float4*>(s_t + (t * rows + i) * ld + k);
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int i = 0; i < kThreadRows; ++i) {
#pragma unroll
        for (int t = 0; t < kTs; ++t) {
          const float s = q == 0 ? sv[i][t].x : q == 1 ? sv[i][t].y
                        : q == 2 ? sv[i][t].z : sv[i][t].w;
#pragma unroll
          for (int j = 0; j < kThreadCols; ++j) {
            acc[i][t][j] = fmaf(s, wv[q][j], acc[i][t][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kThreadRows; ++i) {
    const long long row = row0 + r0 + i;
    if (row >= b) continue;
#pragma unroll
    for (int j = 0; j < kThreadCols; ++j) {
      const int n = n0 + j;
      if (n >= h) continue;
      float uu = u[i][j];
      float hj = hh[i][j];
#pragma unroll
      for (int t = 0; t < kTs; ++t) {
        const float s = __fadd_rn(st[i][t][j], acc[i][t][j]);
        uu = __fadd_rn(s, __fmul_rn(__fmul_rn(bt[j], uu), __fsub_rn(1.0f, hj)));
        hj = (uu >= vt[j]) ? 1.0f : 0.0f;
        spikes[(static_cast<long long>(t) * b + row) * h + n] = hj;
      }
      u_out[row * h + n] = uu;
    }
  }
}

using CellKernel = void (*)(const float*, long long, long long, const float*,
                            const float*, const float*, const float*,
                            const float*, const float*, float*, float*, int,
                            int, int, int, bool, bool);

CellKernel cell_kernel_for(int ts) {
  switch (ts) {
    case 1: return rsnn_cell_kernel<1>;
    case 2: return rsnn_cell_kernel<2>;
    case 3: return rsnn_cell_kernel<3>;
    case 4: return rsnn_cell_kernel<4>;
    default: return nullptr;
  }
}

// The plans the kernel takes: 4, 8, 16 or 32 rows by 16, 32 or 64 neurons,
// at least one warp of accumulator tiles.
bool takes_plan(int rows, int cols) {
  const bool r = rows == 4 || rows == 8 || rows == 16 || rows == 32;
  const bool c = cols == 16 || cols == 32 || cols == 64;
  return r && c && rows * cols >= 32 * kThreadRows * kThreadCols;
}

}  // namespace

extern "C" int rsnn_cell_launch(const void* stim, long long stim_st,
                                long long stim_sb, const void* s_prev,
                                const void* w, const void* u0, const void* h0,
                                const void* beta, const void* vth,
                                void* spikes, void* u_out, int ts, int b,
                                int h, int rows, int cols, void* stream) {
  const CellKernel kernel = cell_kernel_for(ts);
  if (kernel == nullptr) return reprotorch::kErrTooManySteps;
  if (!takes_plan(rows, cols)) return reprotorch::kErrTilePlan;
  const CellLayout lay(ts, rows, cols, h);
  if (lay.bytes > reprotorch::kMaxOptInSharedBytes) {
    return reprotorch::kErrSharedMemory;
  }
  const int opt = reprotorch::opt_in_shared(kernel, lay.bytes);
  if (opt != 0) return opt;
  const bool w16 = h % 4 == 0 && reprotorch::aligned_to(w, 16);
  const bool s16 = h % 4 == 0 && reprotorch::aligned_to(s_prev, 16);
  const dim3 grid((h + cols - 1) / cols, (b + rows - 1) / rows);
  const int threads = rows * cols / (kThreadRows * kThreadCols);
  kernel<<<grid, threads, lay.bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(stim), stim_st, stim_sb,
      static_cast<const float*>(s_prev), static_cast<const float*>(w),
      static_cast<const float*>(u0), static_cast<const float*>(h0),
      static_cast<const float*>(beta), static_cast<const float*>(vth),
      static_cast<float*>(spikes), static_cast<float*>(u_out), b, h, rows,
      cols, w16, s16);
  return static_cast<int>(cudaGetLastError());
}
