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
// (dequantized int4, or the float engine's weights); out (R, N) float32.
// cap in [1, K]; the reference's padding events (index K-1, value 0) add
// nothing and are not visited.
//
// Bound on the H100, at the main path's shapes: L1 feed-forward, R = 512
// spike rows x 128 -> 128: x 262 KB, the named rows of W (at most 64 KB),
// out 262 KB: bytes, 0.18 us.  FC union, (2, 256, 128) -> 1920: x 262 KB,
// W rows up to 983 KB, out 1.97 MB: 0.96 us of bytes.  The gathered
// products are float32 (67 TFLOP/s outside the tensor cores: the
// dequantized weights are not exact in TF32), 2 x events x N of them.
//
// Design: a block owns rows_b rows by cols = 32 x kVec output columns
// (the tile plan, chosen by the wrapper from (ts, R, K, N)).  It starts a
// cp.async copy of its W column tile (K x cols float32) into opted-in
// shared memory.  While that is in flight, each warp compacts groups of
// kGroup rows (common.cuh compact_group, shared with K10: every load of
// the group's trains issued before its ballots): each row keeps its first
// cap events, and the group's event list is the union of the rows' kept
// indices, in ascending order, each with the kGroup rows' values (0 where
// a row has no kept event there).  Then lane l of the warp owns kVec
// adjacent columns of the group's rows (common.cuh union_product): per
// union entry it reads the index and the values as shared broadcasts and
// W[i][cols] once, as one float4/float2/float from the staged tile, for
// all kGroup rows, four entries' loads ahead of their multiply-adds.  So
// no L2 load sits in the product loop, one W read serves kGroup outputs
// wherever the rows' events overlap, and a row's sum is its fmaf chain in
// ascending event order with exact zero terms where only another row of
// the group has an event: the same float as the chain over its own events
// alone.  What holds it now: shared-memory bandwidth (the W reads of the
// union entries) and the tile's staging and compaction latency on the
// small L1 feed-forward.  The launch refuses a plan whose tiles do not fit
// 227 KB (kErrSharedMemory) or that it does not take (kErrTilePlan).  Rows
// and columns past the edge are masked, with no divisibility rule.
#include "common.cuh"

namespace {

constexpr int kGroup = reprotorch::kUnionLists;  // rows that share one union event list
constexpr int kMaxWarps = 8;  // warps a block: one per group, up to 8

template <int kVec>
__global__ void spike_broadcast_kernel(const float* __restrict__ x,
                                       const float* __restrict__ w,
                                       float* __restrict__ out, int ts,
                                       int r_total, int k, int n, int cap,
                                       int rows_b, bool w16, bool out_vec) {
  constexpr int kColsB = 32 * kVec;
  const int slots = (k + 3) & ~3;  // a group's union list, padded
  const int groups_b = (rows_b + kGroup - 1) / kGroup;
  extern __shared__ __align__(16) float sh[];
  float* w_sh = sh;  // [k][kColsB]
  float4* val_sh = reinterpret_cast<float4*>(sh + k * kColsB);  // [groups_b][slots]
  int* off_sh = reinterpret_cast<int*>(val_sh + groups_b * slots);  // [groups_b][slots]
  int* len_sh = off_sh + groups_b * slots;                          // [groups_b]
  const int c0 = blockIdx.x * kColsB;
  const int row0 = blockIdx.y * rows_b;
  const int rows = min(rows_b, r_total - row0);
  const int groups = (rows + kGroup - 1) / kGroup;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;

  reprotorch::stage_column_tile(w, k, n, c0, kColsB, w16, w_sh);
  for (int gr = warp; gr < groups; gr += warps) {
    const int len = reprotorch::compact_group(
        x + static_cast<long long>(row0 + kGroup * gr) * k,
        static_cast<long long>(r_total) * k, ts, k, k, cap,
        min(kGroup, rows - kGroup * gr), kColsB, off_sh + gr * slots,
        val_sh + gr * slots);
    if (lane == 0) len_sh[gr] = len;
  }
  reprotorch::cp_async_wait_all();
  __syncthreads();

  const int col = c0 + lane * kVec;
  if (col >= n) return;  // no __syncthreads() below
  const float* wl = w_sh + lane * kVec;
  for (int gr = warp; gr < groups; gr += warps) {
    const int* off = off_sh + gr * slots;
    const float4* val = val_sh + gr * slots;
    float acc[kGroup][kVec];
#pragma unroll
    for (int r = 0; r < kGroup; ++r) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) acc[r][j] = 0.0f;
    }
    reprotorch::union_product<kVec>(off, val, len_sh[gr], wl, acc);
#pragma unroll
    for (int r = 0; r < kGroup; ++r) {
      const int row = kGroup * gr + r;
      if (row >= rows) break;
      float* o = out + static_cast<long long>(row0 + row) * n + col;
      if (out_vec && col + kVec <= n) {
        reprotorch::store_vec<kVec>(o, acc[r]);
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          if (col + j < n) o[j] = acc[r][j];
        }
      }
    }
  }
}

}  // namespace

extern "C" int spike_broadcast_launch(const void* x, const void* w,
                                      void* out, int ts, int r_total, int k,
                                      int n, int cap, int rows_b, int cols,
                                      void* stream) {
  if (cap < 1 || cap > k) return reprotorch::kErrCapacity;
  if (rows_b < 1 || rows_b % kGroup != 0 ||
      (cols != 32 && cols != 64 && cols != 128)) {
    return reprotorch::kErrTilePlan;
  }
  const size_t groups = static_cast<size_t>(rows_b / kGroup);
  const size_t slots = static_cast<size_t>((k + 3) & ~3);
  const size_t smem = sizeof(float) * static_cast<size_t>(k) * cols +
                      (sizeof(float4) + sizeof(int)) * groups * slots +
                      sizeof(int) * groups;
  if (smem > reprotorch::kMaxOptInSharedBytes) {
    return reprotorch::kErrSharedMemory;
  }
  const int vec = cols / 32;
  void (*kernel)(const float*, const float*, float*, int, int, int, int, int,
                 int, bool, bool) =
      vec == 4 ? spike_broadcast_kernel<4>
               : (vec == 2 ? spike_broadcast_kernel<2> : spike_broadcast_kernel<1>);
  const int opt = reprotorch::opt_in_shared(kernel, smem);
  if (opt != 0) return opt;
  const bool w16 = n % 4 == 0 && reprotorch::aligned_to(w, 16);
  const bool out_vec = n % vec == 0 && reprotorch::aligned_to(out, 4u * vec);
  const dim3 grid((n + cols - 1) / cols, (r_total + rows_b - 1) / rows_b);
  const int threads =
      32 * (static_cast<int>(groups) < kMaxWarps ? static_cast<int>(groups) : kMaxWarps);
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(out), ts, r_total, k, n, cap, rows_b, w16, out_vec);
  return static_cast<int>(cudaGetLastError());
}
