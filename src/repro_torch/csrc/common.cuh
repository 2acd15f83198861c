// Shared pieces of the hand-written Hopper kernels of repro_torch.
//
// Every kernel here is a plain CUDA C++ kernel behind an extern "C" launch
// function: pointers and the stream arrive as void*, sizes as int, and the
// launch function returns cudaGetLastError() (or one of the kErr codes
// below, without launching) so that the Python wrapper raises on a refused
// launch.  No kernel allocates or synchronises.
//
// Tiling shared by the kernels: one thread per output column (kCols
// columns per block, neighbouring threads on neighbouring addresses, so
// every weight row is one coalesced load) and kRows batch rows per block,
// so each weight element loaded from global memory serves kRows rows.  The
// rows' operand vectors sit in shared memory.  Ragged edges (B not a
// multiple of kRows, N not a multiple of kCols) are masked, not asserted.
// K9 (spike_broadcast) and K4 (sparse_fc) take their tiles from a plan
// their wrappers choose, stage them with cp.async (stage_column_tile) and
// say how in their sources.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace reprotorch {

constexpr int kCols = 128;  // output columns per block, one per thread
constexpr int kRows = 8;    // batch rows per block
constexpr int kMaxTs = 4;   // time steps the recurrent cell keeps in registers
constexpr size_t kMaxSharedBytes = 48 * 1024;  // a block's shared memory without opting in
// megastep (K6/K7): threads a block (one per hidden column, all of them on
// the FC columns); the dynamic shared memory a kernel may opt in to, the
// H100's per-block maximum of 227 KB (megastep, spike_broadcast, sparse_fc)
constexpr int kMegaThreads = 256;
constexpr size_t kMaxOptInSharedBytes = 227 * 1024;
constexpr size_t kMaxMegastepSharedBytes = kMaxOptInSharedBytes;

// Status codes a launch function returns, besides the cudaError_t values
// (>= 0), for a shape its kernel cannot take; status.cu gives their text.
constexpr int kErrTooManySteps = -1;  // ts > kMaxTs
constexpr int kErrSharedMemory = -2;  // the block's rows exceed kMaxSharedBytes
                                      // (kMaxOptInSharedBytes for the kernels
                                      // that opt in: megastep, spike_broadcast,
                                      // sparse_fc)
constexpr int kErrCapacity = -3;      // event-list capacity outside [1, k]
constexpr int kErrTooWide = -4;       // megastep: hidden width > kMegaThreads
constexpr int kErrFcMode = -5;        // megastep: an FC mode it does not serve,
                                      // or not at the given weight precision
constexpr int kErrNmGeometry = -6;    // nm_fc, megastep nm mode: n < 1, n > m,
                                      // m > 16, or entries not a multiple of n
constexpr int kErrTilePlan = -7;      // spike_broadcast, sparse_fc: a tile plan
                                      // (rows, columns a block) they do not take

// Sign-extend one int4 nibble held in the low 4 bits of v: [0,15] -> [-8,7].
__device__ __forceinline__ float nibble(int v) {
  return static_cast<float>(((v & 0xF) ^ 8) - 8);
}

// Stage rows [row0, row0 + rows) of sum_t spikes[t] into sh[rows][h].
// spikes is (ts, b, h) contiguous.  The sum runs t = 0, 1, ... as the
// reference's sum over the time axis; spikes are 0/1, so it is exact.
__device__ __forceinline__ void stage_merged_rows(
    const float* __restrict__ spikes, int ts, int b, int h, int row0,
    int rows, float* sh) {
  for (int i = threadIdx.x; i < rows * h; i += blockDim.x) {
    const int r = i / h;
    const int k = i - r * h;
    float m = 0.0f;
    for (int t = 0; t < ts; ++t) {
      m = __fadd_rn(m, spikes[(static_cast<long long>(t) * b + row0 + r) * h + k]);
    }
    sh[i] = m;
  }
}

// acc[r] += sum_k rows_sh[r][k] * unpack(packed)[k][col] for one column.
// packed is (k/2, n) int8, low nibble = even row 2p, high nibble = row 2p+1.
// The order of the sum is p = 0, 1, ...; on integer-valued rows every
// partial sum is an exact integer, so any order gives the same float.
__device__ __forceinline__ void int4_column_dot(
    const float* rows_sh, int rows, int k, const int8_t* __restrict__ packed,
    int n, int col, float (&acc)[kRows]) {
  for (int p = 0; p < k / 2; ++p) {
    const int byte = packed[static_cast<long long>(p) * n + col];
    const float lo = nibble(byte);
    const float hi = nibble(byte >> 4);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < rows) {
        acc[r] = fmaf(rows_sh[r * k + 2 * p], lo, acc[r]);
        acc[r] = fmaf(rows_sh[r * k + 2 * p + 1], hi, acc[r]);
      }
    }
  }
}

// Priority-encode one row of k values into an ascending-index event list
// (K9/K10's form of the reference's compact_spikes): the row's value at i
// is sum_t row[t * ts_stride + i] for t < ts, summed t = 0, 1, ... (a
// merged spike count for ts > 1).  Every nonzero value is an event; the
// first cap events in index order land in idx[0..)/val[0..), the rest are
// dropped, as the reference truncates a row over capacity.  Each 32-wide
// chunk of the row is one __ballot_sync; an event's slot is the events
// before it: the running count plus the __popc of the lower lanes' bits.
// Called by all 32 lanes of one warp (base is uniform across it, so the
// early exit is too).  Returns the number of events kept, min(nnz, cap).
__device__ __forceinline__ int compact_row(const float* __restrict__ row,
                                           long long ts_stride, int ts,
                                           int k, int cap, int* idx,
                                           float* val) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  int base = 0;
  for (int k0 = 0; k0 < k && base < cap; k0 += 32) {
    const int i = k0 + lane;
    float v = 0.0f;
    if (i < k) {
      for (int t = 0; t < ts; ++t) v = __fadd_rn(v, row[t * ts_stride + i]);
    }
    const unsigned live = __ballot_sync(0xffffffffu, v != 0.0f);
    const int pos = base + __popc(live & below);
    if (v != 0.0f && pos < cap) {
      idx[pos] = i;
      val[pos] = v;
    }
    base += __popc(live);
  }
  return base < cap ? base : cap;
}

// Asynchronous global -> shared copies (cp.async, sm_80 and later).  A copy
// of src_bytes < size bytes fills the rest of its size with zeros (0: all
// zeros, nothing read).  A thread's copies land once it waits for them;
// others see them after the following __syncthreads().
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start copying columns [c0, c0 + cols) of the row-major (rows, n) matrix
// src into sh[rows][cols] with cp.async, all threads of the block taking
// part; columns at or past n are zero-filled.  vec16 (block-uniform): n is a
// multiple of 4 and src 16-byte aligned, so each thread copies 16 bytes at
// a time; else 4.  cols is a multiple of 4 and sh 16-byte aligned.  Then
// cp_async_wait_all() and __syncthreads() before sh is read.
template <typename T>
__device__ __forceinline__ void stage_column_tile(const T* __restrict__ src,
                                                  int rows, int n, int c0,
                                                  int cols, bool vec16,
                                                  T* sh) {
  static_assert(sizeof(T) == 4, "4-byte elements");
  if (vec16) {
    const int quads = cols >> 2;
    for (int i = threadIdx.x; i < rows * quads; i += blockDim.x) {
      const int row = i / quads;
      const int c = c0 + 4 * (i - row * quads);
      const bool in = c < n;
      cp_async16(sh + 4 * i, src + (in ? static_cast<long long>(row) * n + c : 0),
                 in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
      const int row = i / cols;
      const int c = c0 + (i - row * cols);
      const bool in = c < n;
      cp_async4(sh + i, src + (in ? static_cast<long long>(row) * n + c : 0),
                in ? 4 : 0);
    }
  }
}

}  // namespace reprotorch
