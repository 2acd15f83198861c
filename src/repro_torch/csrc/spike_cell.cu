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
// Shapes as K1: stim_base (TS, B, H) with free strides on its first two
// axes (the L0 stimulus is one (B, H) row broadcast over TS with stride 0,
// never copied or read as dense), s_prev (TS, B, H), W (H, H), u0/h0
// (B, H), beta/vth (H,); out spikes (TS, B, H), u (B, H), float32.
// cap in [1, H] events per list (the first cap in index order are kept).
//
// Bound on the H100: bytes, as K1 — at B = 256, H = 128, TS = 2 a call
// moves ~1.1 MB (the broadcast stimulus counts its one row; W counts only
// its named rows): 0.33 us; the gathered float32 products, 2 x events x H
// (67 TFLOP/s outside the tensor cores), take less.  As for K1, the launch
// and one round of staging, not either rate, set the time.
//
// Design: K1's block with K9's union event lists.  A block owns `rows`
// batch rows by cols = 32 x kVec neurons (the tile plan, chosen by the
// wrapper from (TS, B, H) so that the grid has a block for every SM).  It
// stages its rows' TS trains into shared memory with cp.async, list by
// list in (row, step) order, and then W's column tile (H x cols float32,
// opted-in shared memory); while both are in flight each thread loads the
// stimulus, u0, h0, beta and vth its outputs' LIF chains will read.  Once
// the trains have landed, warp g compacts the kUnionLists lists of its
// group (common.cuh compact_group, K9's): the TS steps of kGroupRows rows
// (TS = 1: four rows; 2: two; 3 and 4: one, TS = 3 leaving the fourth
// list empty).  Each list keeps its first cap events in index order, and
// the union holds every index some list keeps with each list's value (0
// where a list keeps no event there).  Once W has landed, lane l runs the
// union (common.cuh union_product): per entry it reads its kVec columns of
// W once from shared memory and issues one fmaf for each (row, step) of
// the group, so one W read serves every time step, as on the TPU, and no
// W load from global memory sits in the product loop.  kTs is a template
// parameter (as in K1), so no guard sits in the loop.  Each output's sum is
// one fmaf chain in ascending index, and an entry where the output's list
// keeps no event adds an exact zero: at lossless capacity on 0/1 trains
// K10 gives K1's bits (whose chain runs over every k and adds the same
// zeros).  The LIF chain then runs in the epilogue, K1's exactly
// (__fmul_rn/__fadd_rn in the reference's order, no FMA contraction).  The
// launch refuses TS over kMaxTs (kErrTooManySteps), a capacity outside
// [1, H] (kErrCapacity), a plan it does not take (kErrTilePlan) and one
// whose tiles pass 227 KB (kErrSharedMemory).  Rows and neurons past the
// edge are masked, with no divisibility rule.
#include "common.cuh"

namespace {

using reprotorch::kUnionLists;

constexpr int kMaxWarps = 8;  // warps a block: one per group

// Rows of one group at kTs steps: its kUnionLists lists are the kTs steps
// of each of its rows.
__host__ __device__ constexpr int group_rows(int ts) {
  return ts >= 3 ? 1 : kUnionLists / ts;
}

// Shared memory of one block, in bytes from its start: W's column tile
// [h][cols] float, the groups' union values [groups][kp] float4, the
// trains [rows][ts][kp] float (k padded to 4), the union offsets
// [groups][kp] int.  The wrapper's cell_tile_plans compute the same bytes.
struct CellLayout {
  int kp, groups;
  size_t val, trains, off, bytes;
  __host__ __device__ CellLayout(int ts, int rows, int cols, int h)
      : kp((h + 3) & ~3), groups((rows + group_rows(ts) - 1) / group_rows(ts)) {
    val = sizeof(float) * static_cast<size_t>(h) * cols;
    trains = val + sizeof(float4) * static_cast<size_t>(groups) * kp;
    off = trains + sizeof(float) * static_cast<size_t>(rows) * ts * kp;
    bytes = off + sizeof(int) * static_cast<size_t>(groups) * kp;
  }
};

template <int kTs, int kVec>
__global__ void __launch_bounds__(32 * kMaxWarps) spike_cell_kernel(
    const float* __restrict__ stim, long long stim_st, long long stim_sb,
    const float* __restrict__ s_prev, const float* __restrict__ w,
    const float* __restrict__ u0, const float* __restrict__ h0,
    const float* __restrict__ beta, const float* __restrict__ vth,
    float* __restrict__ spikes, float* __restrict__ u_out, int b, int h,
    int cap, int rows_b, bool w16, bool s16, bool out_vec) {
  constexpr int kGroupRows = group_rows(kTs);
  constexpr int kCols = 32 * kVec;
  extern __shared__ __align__(16) unsigned char sh[];
  const CellLayout lay(kTs, rows_b, kCols, h);
  const int kp = lay.kp;
  float* w_sh = reinterpret_cast<float*>(sh);
  float4* val_sh = reinterpret_cast<float4*>(sh + lay.val);
  float* s_sh = reinterpret_cast<float*>(sh + lay.trains);
  int* off_sh = reinterpret_cast<int*>(sh + lay.off);
  const int c0 = blockIdx.x * kCols;
  const int row0 = blockIdx.y * rows_b;
  const int rows = min(rows_b, b - row0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // the rows' trains, list r * kTs + t at s_sh + (r * kTs + t) * kp (only
  // rows < b and k < h: the compaction reads no further)
  if (s16) {  // h a multiple of 4: kp = h
    const int quads = kp >> 2;
    for (int i = threadIdx.x; i < rows * kTs * quads; i += blockDim.x) {
      const int l = i / quads;
      const int q = 4 * (i - l * quads);
      const int r = l / kTs;
      const int t = l - r * kTs;
      reprotorch::cp_async16(
          s_sh + l * kp + q,
          s_prev + (static_cast<long long>(t) * b + row0 + r) * h + q, 16);
    }
  } else {
    for (int i = threadIdx.x; i < rows * kTs * h; i += blockDim.x) {
      const int l = i / h;
      const int k = i - l * h;
      const int r = l / kTs;
      const int t = l - r * kTs;
      reprotorch::cp_async4(
          s_sh + l * kp + k,
          s_prev + (static_cast<long long>(t) * b + row0 + r) * h + k, 4);
    }
  }
  reprotorch::cp_async_commit();
  reprotorch::stage_column_tile(w, h, h, c0, kCols, w16, w_sh);
  reprotorch::cp_async_commit();

  // this lane's outputs: the group's kGroupRows rows from r0 by kVec
  // neurons from n0; their LIF operands load while the tiles are in flight
  const int r0 = warp * kGroupRows;
  const int n0 = c0 + lane * kVec;
  float st[kGroupRows][kTs][kVec], u[kGroupRows][kVec], hh[kGroupRows][kVec],
      bt[kVec], vt[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const bool in = n0 + j < h;
    bt[j] = in ? beta[n0 + j] : 0.0f;
    vt[j] = in ? vth[n0 + j] : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < kGroupRows; ++i) {
    const long long row = row0 + r0 + i;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const bool in = r0 + i < rows && n0 + j < h;
      const long long at = row * h + n0 + j;
      u[i][j] = in ? u0[at] : 0.0f;
      hh[i][j] = in ? h0[at] : 0.0f;
#pragma unroll
      for (int t = 0; t < kTs; ++t) {
        st[i][t][j] = in ? stim[t * stim_st + row * stim_sb + n0 + j] : 0.0f;
      }
    }
  }

  // the group's union, once its trains have landed (the warp alone reads
  // it: no block barrier between the compaction and the products)
  reprotorch::cp_async_wait_group<1>();
  __syncthreads();
  const int lists = min(kGroupRows, rows - r0) * kTs;
  int len = 0;
  if (lists > 0) {
    len = reprotorch::compact_group(s_sh + r0 * kTs * kp, 0, 1, kp, h, cap,
                                    lists, kCols, off_sh + warp * kp,
                                    val_sh + warp * kp);
  }
  reprotorch::cp_async_wait_all();
  __syncthreads();
  if (lists <= 0 || n0 >= h) return;  // no __syncthreads() below

  float acc[kUnionLists][kVec];
#pragma unroll
  for (int l = 0; l < kUnionLists; ++l) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc[l][j] = 0.0f;
  }
  reprotorch::union_product<kVec>(off_sh + warp * kp, val_sh + warp * kp, len,
                                  w_sh + lane * kVec, acc);

  const bool vec = out_vec && n0 + kVec <= h;
#pragma unroll
  for (int i = 0; i < kGroupRows; ++i) {
    if (r0 + i >= rows) break;
    const long long row = row0 + r0 + i;
    float spk[kTs][kVec], uu[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      float ui = u[i][j];
      float hj = hh[i][j];
#pragma unroll
      for (int t = 0; t < kTs; ++t) {
        const float s = __fadd_rn(st[i][t][j], acc[i * kTs + t][j]);
        ui = __fadd_rn(s, __fmul_rn(__fmul_rn(bt[j], ui), __fsub_rn(1.0f, hj)));
        hj = (ui >= vt[j]) ? 1.0f : 0.0f;
        spk[t][j] = hj;
      }
      uu[j] = ui;
    }
#pragma unroll
    for (int t = 0; t < kTs; ++t) {
      float* o = spikes + (static_cast<long long>(t) * b + row) * h + n0;
      if (vec) {
        reprotorch::store_vec<kVec>(o, spk[t]);
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          if (n0 + j < h) o[j] = spk[t][j];
        }
      }
    }
    float* o = u_out + row * h + n0;
    if (vec) {
      reprotorch::store_vec<kVec>(o, uu);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        if (n0 + j < h) o[j] = uu[j];
      }
    }
  }
}

using CellKernel = void (*)(const float*, long long, long long, const float*,
                            const float*, const float*, const float*,
                            const float*, const float*, float*, float*, int,
                            int, int, int, bool, bool, bool);

template <int kTs>
CellKernel cell_kernel_for_cols(int cols) {
  switch (cols) {
    case 32: return spike_cell_kernel<kTs, 1>;
    case 64: return spike_cell_kernel<kTs, 2>;
    case 128: return spike_cell_kernel<kTs, 4>;
    default: return nullptr;
  }
}

CellKernel cell_kernel_for(int ts, int cols) {
  switch (ts) {
    case 1: return cell_kernel_for_cols<1>(cols);
    case 2: return cell_kernel_for_cols<2>(cols);
    case 3: return cell_kernel_for_cols<3>(cols);
    case 4: return cell_kernel_for_cols<4>(cols);
    default: return nullptr;
  }
}

// The plans the kernel takes: 1-32 rows (a power of two), whole groups of
// group_rows(ts) rows, at most kMaxWarps groups; 32, 64 or 128 neurons.
bool takes_plan(int ts, int rows, int cols) {
  const int gr = group_rows(ts);
  const bool r = rows >= 1 && rows <= 32 && (rows & (rows - 1)) == 0 &&
                 rows % gr == 0 && rows / gr <= kMaxWarps;
  return r && (cols == 32 || cols == 64 || cols == 128);
}

}  // namespace

extern "C" int spike_cell_launch(const void* stim, long long stim_st,
                                 long long stim_sb, const void* s_prev,
                                 const void* w, const void* u0,
                                 const void* h0, const void* beta,
                                 const void* vth, void* spikes, void* u_out,
                                 int ts, int b, int h, int cap, int rows,
                                 int cols, void* stream) {
  if (ts < 1 || ts > reprotorch::kMaxTs) return reprotorch::kErrTooManySteps;
  if (cap < 1 || cap > h) return reprotorch::kErrCapacity;
  if (!takes_plan(ts, rows, cols)) return reprotorch::kErrTilePlan;
  const CellLayout lay(ts, rows, cols, h);
  if (lay.bytes > reprotorch::kMaxOptInSharedBytes) {
    return reprotorch::kErrSharedMemory;
  }
  const CellKernel kernel = cell_kernel_for(ts, cols);
  const int opt = reprotorch::opt_in_shared(kernel, lay.bytes);
  if (opt != 0) return opt;
  const int vec = cols / 32;
  const bool w16 = h % 4 == 0 && reprotorch::aligned_to(w, 16);
  const bool s16 = h % 4 == 0 && reprotorch::aligned_to(s_prev, 16);
  const bool out_vec = h % vec == 0 &&
                       reprotorch::aligned_to(spikes, 4u * vec) &&
                       reprotorch::aligned_to(u_out, 4u * vec);
  const dim3 grid((h + cols - 1) / cols, (b + rows - 1) / rows);
  kernel<<<grid, 32 * lay.groups, lay.bytes,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(stim), stim_st, stim_sb,
      static_cast<const float*>(s_prev), static_cast<const float*>(w),
      static_cast<const float*>(u0), static_cast<const float*>(h0),
      static_cast<const float*>(beta), static_cast<const float*>(vth),
      static_cast<float*>(spikes), static_cast<float*>(u_out), b, h, cap, rows,
      w16, s16, out_vec);
  return static_cast<int>(cudaGetLastError());
}
