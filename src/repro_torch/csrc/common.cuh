// Shared pieces of the hand-written Hopper kernels of repro_torch.
//
// Every kernel here is a plain CUDA C++ kernel behind an extern "C" launch
// function: pointers and the stream arrive as void*, sizes as int, and the
// launch function returns cudaGetLastError() (or one of the kErr codes
// below, without launching) so that the Python wrapper raises on a refused
// launch.  No kernel allocates or synchronises.
//
// Tiling: every kernel takes its tiles from a plan its wrapper chooses
// (tile_plan), stages them with cp.async and says how in its source.  K9
// (spike_broadcast) and K10 (spike_cell) share the union event lists below
// (compact_group, union_product), K4 (sparse_fc) and K5 (nm_fc) the gather
// tile (stage_merged_transposed, gather_tile), K2, K3 and K6/K7's int4 FC
// the int8 tensor-core fragments (mma_s8_16832).
// Ragged edges (B not a multiple of the rows a block, N not one of its
// columns) are masked, not asserted.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace reprotorch {

constexpr int kMaxTs = 4;   // time steps the recurrent cell keeps in registers
constexpr size_t kMaxSharedBytes = 48 * 1024;  // a block's shared memory without opting in
// the dynamic shared memory every kernel may opt in to, the H100's
// per-block maximum of 227 KB
constexpr size_t kMaxOptInSharedBytes = 227 * 1024;
// megastep (K6/K7): the widest hidden layer (its event lists hold a hidden
// index in one byte)
constexpr int kMaxMegaHidden = 256;

// Status codes a launch function returns, besides the cudaError_t values
// (>= 0), for a shape its kernel cannot take; status.cu gives their text.
constexpr int kErrTooManySteps = -1;  // ts > kMaxTs
constexpr int kErrSharedMemory = -2;  // the block's tiles exceed
                                      // kMaxOptInSharedBytes
constexpr int kErrCapacity = -3;      // event-list capacity outside [1, k]
constexpr int kErrTooWide = -4;       // megastep: hidden width > kMaxMegaHidden
constexpr int kErrFcMode = -5;        // megastep: an FC mode it does not serve,
                                      // or not at the given weight precision
constexpr int kErrNmGeometry = -6;    // nm_fc, megastep nm mode: n < 1, n > m,
                                      // m > 16, or entries not a multiple of n
constexpr int kErrTilePlan = -7;      // a tile plan (rows, columns a block;
                                      // megastep's cluster) the kernel does
                                      // not take
constexpr int kErrCluster = -8;       // megastep: no cluster of the plan can
                                      // be resident on the card

// Sign-extend one int4 nibble held in the low 4 bits of v: [0,15] -> [-8,7].
__device__ __forceinline__ float nibble(int v) {
  return static_cast<float>(((v & 0xF) ^ 8) - 8);
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

__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// Close the thread's cp.async copies issued so far into one group; wait
// until at most `pending` of its groups are still in flight (groups land in
// the order they were committed).
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int pending>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
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

// ------------------------------------------ union event lists (K9, K10)
//
// kUnionLists spike lists (K9: rows of merged trains; K10: the TS steps of
// one or more rows) share one event list: the union of the indices each
// list keeps, ascending, each entry with every list's value (0 where a
// list keeps no event there).  One W row read per entry then serves every
// list, and a list's sum over the union is the fmaf chain over its own
// events with exact zero terms added: the same float.

constexpr int kUnionLists = 4;  // lists that share one union (a float4 of values)
constexpr int kUnionChunks = 4;  // 32-index chunks whose loads go ahead

template <int kVec>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[kVec]) {
  if constexpr (kVec == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else if constexpr (kVec == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  } else {
    v[0] = *p;
  }
}

template <int kVec>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[kVec]) {
  if constexpr (kVec == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (kVec == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// Compact the `lists` (<= kUnionLists) lists starting at `x`, list l at
// x + l * list_stride, into one union event list: list l's value at i is
// sum_m x[m * merge_stride + l * list_stride + i] for m < merges (summed
// m = 0, 1, ...: K9's merged trains; merges = 1 reads the list itself),
// its first cap nonzeros in index order are its kept events (the
// reference's compact_spikes truncation), and every index that some list
// keeps lands in off[pos] = i * scale (the W tile's row offset) and
// val[pos] = the lists' kept values there (0 for a list that does not keep
// i), pos ascending with i.  x may point to global or shared memory; every
// load of a 128-index chunk is issued before its ballots.  The list is
// padded with (0, zeros) entries to a multiple of 4.  Called by all 32
// lanes of one warp; returns the padded length, the same in every lane.
__device__ __forceinline__ int compact_group(const float* __restrict__ x,
                                             long long merge_stride,
                                             int merges, long long list_stride,
                                             int k, int cap, int lists,
                                             int scale, int* off, float4* val) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  int base[kUnionLists] = {};  // each list's events so far
  int len = 0;
  for (int g = 0; g < k; g += 32 * kUnionChunks) {
    float v[kUnionLists][kUnionChunks] = {};
    for (int m0 = 0; m0 < merges; m0 += 2) {
      float a[2][kUnionLists][kUnionChunks];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
#pragma unroll
        for (int l = 0; l < kUnionLists; ++l) {
#pragma unroll
          for (int c = 0; c < kUnionChunks; ++c) {
            const int i = g + 32 * c + lane;
            a[m][l][c] = (m0 + m < merges && l < lists && i < k)
                             ? x[(m0 + m) * merge_stride + l * list_stride + i]
                             : 0.0f;
          }
        }
      }
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        if (m0 + m < merges) {
#pragma unroll
          for (int l = 0; l < kUnionLists; ++l) {
#pragma unroll
            for (int c = 0; c < kUnionChunks; ++c) v[l][c] = __fadd_rn(v[l][c], a[m][l][c]);
          }
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kUnionChunks; ++c) {
      float kept[kUnionLists];
      unsigned any = 0u;
#pragma unroll
      for (int l = 0; l < kUnionLists; ++l) {
        const bool nz = v[l][c] != 0.0f;
        const unsigned live = __ballot_sync(0xffffffffu, nz);
        const bool keep = nz && base[l] + __popc(live & below) < cap;
        kept[l] = keep ? v[l][c] : 0.0f;
        any |= __ballot_sync(0xffffffffu, keep);
        base[l] += __popc(live);
      }
      if ((any >> lane) & 1u) {
        const int pos = len + __popc(any & below);
        off[pos] = (g + 32 * c + lane) * scale;
        val[pos] = make_float4(kept[0], kept[1], kept[2], kept[3]);
      }
      len += __popc(any);
    }
  }
  const int padded = (len + 3) & ~3;
  if (lane < padded - len) {
    off[len + lane] = 0;
    val[len + lane] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  return padded;
}

// The products over one union (compact_group's off/val, len entries): for
// each of its lists l and each of a lane's kVec columns j,
// acc[l][j] = fmaf(val[e].l, wl[off[e] + j], acc[l][j]) for e ascending,
// wl the lane's first column in a W tile whose rows are `scale` floats
// apart.  Four entries' loads go ahead of their multiply-adds.
template <int kVec>
__device__ __forceinline__ void union_product(const int* off,
                                              const float4* val, int len,
                                              const float* wl,
                                              float (&acc)[kUnionLists][kVec]) {
  static_assert(kUnionLists == 4, "a union entry's values are one float4");
  for (int e = 0; e < len; e += 4) {
    const int4 o = *reinterpret_cast<const int4*>(off + e);
    const int at[4] = {o.x, o.y, o.z, o.w};
    float vr[4][kUnionLists];
    float wv[4][kVec];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float4 v = val[e + u];
      vr[u][0] = v.x;
      vr[u][1] = v.y;
      vr[u][2] = v.z;
      vr[u][3] = v.w;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) load_vec<kVec>(wl + at[u], wv[u]);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int l = 0; l < kUnionLists; ++l) {
#pragma unroll
        for (int j = 0; j < kVec; ++j) acc[l][j] = fmaf(vr[u][l], wv[u][j], acc[l][j]);
      }
    }
  }
}

// ------------------------------------------- zero-skip gather tiles (K4, K5)
//
// out[b][c] = (sum_e merged[b][row(e, c)] * value(e, c)) * scale[c], where
// merged = sum_t spikes[t].  A block owns 32 x kRt batch rows by `cols`
// output columns.  Its kernel stages the rows' merged spikes transposed
// (stage_merged_transposed) and its columns' entries as (offset in m,
// float value) tiles, entries x cols each (K4 from padded CSC, K5 decoded
// from the one-byte N:M entries); gather_tile then runs the products.

constexpr int kGatherWarps = 8;
constexpr int kGatherThreads = 32 * kGatherWarps;

// Stage rows [row0, row0 + kRowsB) of sum_t spikes[t] transposed into
// m_sh[h][kRowsB + 1] (rows past b are zeros).  Warp w takes rows 4w..4w+3,
// 4w+32.., lanes run along h, so the reads are coalesced; the loads of four
// rows, four 32-column chunks and two trains go ahead of their adds (t = 0,
// 1, ..., as the reference sums over the time axis; spikes are 0/1, so the
// sum is exact); the pad column keeps the transposed writes free of bank
// conflicts.  spikes is (ts, b, h) contiguous.
template <int kRowsB>
__device__ __forceinline__ void stage_merged_transposed(
    const float* __restrict__ spikes, int ts, int b, int h, int row0,
    float* m_sh) {
  constexpr int kLd = kRowsB + 1;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int r0 = 4 * warp; r0 < kRowsB; r0 += 4 * kGatherWarps) {
    for (int k0 = 0; k0 < h; k0 += 32 * 4) {
      float m[4][4] = {};
      for (int t0 = 0; t0 < ts; t0 += 2) {
        float a[2][4][4];
#pragma unroll
        for (int t = 0; t < 2; ++t) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int k = k0 + 32 * c + lane;
              const int row = row0 + r0 + r;
              a[t][r][c] = (t0 + t < ts && row < b && k < h)
                               ? spikes[(static_cast<long long>(t0 + t) * b + row) * h + k]
                               : 0.0f;
            }
          }
        }
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          if (t0 + t < ts) {
#pragma unroll
            for (int r = 0; r < 4; ++r) {
#pragma unroll
              for (int c = 0; c < 4; ++c) m[r][c] = __fadd_rn(m[r][c], a[t][r][c]);
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int k = k0 + 32 * c + lane;
          if (k < h) m_sh[k * kLd + r0 + r] = m[r][c];
        }
      }
    }
  }
}

// The products of one block's tile, all kGatherThreads threads taking
// part: idx_sh and val_sh are [entries][cols], each an entry's offset in
// m_sh (row x (kRowsB + 1)) and its value (an entry that adds nothing holds
// offset 0 and value 0); m_sh as stage_merged_transposed leaves it.  Each
// warp takes four columns at a time: lane l owns rows l, l + 32, ..., so an
// entry's (offset, value) quad is one shared broadcast for the whole warp,
// and the warp's gathers m[row][l + 32 t] are 32 adjacent words, free of
// bank conflicts; four entries' loads go ahead of their multiply-adds, with
// no branch between them.  Entries run in ascending order, each an fmaf
// into a float sum, then one __fmul_rn by the scale.  out16: n a multiple
// of 4 and out 16-byte aligned (float4 stores).
template <int kRt>
__device__ __forceinline__ void gather_tile(
    const int* idx_sh, const float* val_sh, const float* m_sh, int entries,
    int cols, int c0, int row0, int b, int n,
    const float* __restrict__ scale, float* __restrict__ out, bool out16) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int quads = cols >> 2;
  const float* m_lane = m_sh + lane;
  for (int q = warp; q < quads; q += kGatherWarps) {
    const int c = c0 + 4 * q;
    if (c >= n) break;  // warp-uniform: later quads lie further right
    const int4* iq = reinterpret_cast<const int4*>(idx_sh) + q;
    const float4* vq = reinterpret_cast<const float4*>(val_sh) + q;
    float acc[4][kRt];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int t = 0; t < kRt; ++t) acc[j][t] = 0.0f;
    }
    // four entries' (offset, value) quads, then their 16 x kRt gathers,
    // are in flight before the multiply-adds, which run in entry order
    int e = 0;
    for (; e + 4 <= entries; e += 4) {
      int4 at[4];
      float4 val[4];
      float m[4][4][kRt];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        at[u] = iq[(e + u) * quads];
        val[u] = vq[(e + u) * quads];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int a4[4] = {at[u].x, at[u].y, at[u].z, at[u].w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int t = 0; t < kRt; ++t) m[u][j][t] = m_lane[a4[j] + 32 * t];
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float v4[4] = {val[u].x, val[u].y, val[u].z, val[u].w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int t = 0; t < kRt; ++t) acc[j][t] = fmaf(m[u][j][t], v4[j], acc[j][t]);
        }
      }
    }
    for (; e < entries; ++e) {
      const int4 at = iq[e * quads];
      const float4 val = vq[e * quads];
      const int a4[4] = {at.x, at.y, at.z, at.w};
      const float v4[4] = {val.x, val.y, val.z, val.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int t = 0; t < kRt; ++t) acc[j][t] = fmaf(m_lane[a4[j] + 32 * t], v4[j], acc[j][t]);
      }
    }
    float s[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) s[j] = c + j < n ? scale[c + j] : 0.0f;
#pragma unroll
    for (int t = 0; t < kRt; ++t) {
      const int row = row0 + lane + 32 * t;
      if (row >= b) continue;
      float* o = out + static_cast<long long>(row) * n + c;
      if (out16 && c + 4 <= n) {
        *reinterpret_cast<float4*>(o) =
            make_float4(__fmul_rn(acc[0][t], s[0]), __fmul_rn(acc[1][t], s[1]),
                        __fmul_rn(acc[2][t], s[2]), __fmul_rn(acc[3][t], s[3]));
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (c + j < n) o[j] = __fmul_rn(acc[j][t], s[j]);
        }
      }
    }
  }
}

// Opt a kernel in to `bytes` of dynamic shared memory when that is more
// than kMaxSharedBytes; a CUDA error as a status, else 0.
template <typename Kernel>
inline int opt_in_shared(Kernel kernel, size_t bytes) {
  if (bytes <= kMaxSharedBytes) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

// ------------------------------------------- int8 tensor-core tiles (K2, K3)
//
// out[m][n] = (sum_k a[m][k] * unpack(packed)[k][n]) * scale[n], where
// a[m][k] = sum_t src[t][m][k] (t = 0, 1, ..., ts - 1; K2 has ts = 1).  A
// block owns kRowsB rows by kCols columns (the wrapper's tile plan).  It
// stages the packed weight tile (k/2 x kCols bytes) and the rows' ts
// float32 trains with cp.async, unpacks the nibbles once into int8 laid out
// as mma's B operand (k-contiguous per column), merges the trains and
// converts the rows to int8 (mma's A operand, k-contiguous per row), and
// votes: when every staged value is an integer in [-128, 127] (s8_exact)
// the warps run mma.sync m16n8k32 s8 x s8 -> s32 and scale each exact
// integer sum once (bit-equal to the plain version wherever its float32
// sums stay exact, |sum| < 2^24); otherwise the whole block runs an fp32
// fmaf chain over the same staged tile, k ascending, as one float
// multiply-add a term.

constexpr int kMmaK = 32;     // depth of one m16n8k32 step, int8 elements
constexpr int kTilePad = 16;  // bytes after each int8 row: a fragment
                              // load's eight rows fall on distinct banks

__device__ __forceinline__ void mma_s8_16832(int (&d)[4],
                                             const unsigned (&a)[4],
                                             unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Whether v is exactly an s8 operand: an integer in [-128, 127] (NaN and
// infinities are not).
__device__ __forceinline__ bool s8_exact(float v) {
  return v == rintf(v) && v >= -128.0f && v <= 127.0f;
}

// A nibble in the low 4 bits of v, sign-extended: [0, 15] -> [-8, 7].
__device__ __forceinline__ unsigned nibble_s8(int v) {
  return static_cast<unsigned>((((v & 0xF) ^ 8) - 8) & 0xFF);
}

// The s8 weights k = 8q .. 8q + 7 of column c, unpacked from the packed
// int4 rows 4q .. 4q + 3 (row p's byte at wp[p * stride + c], low nibble
// first; rows at or past k2 zero): 8 bytes of a k-contiguous B operand.
__device__ __forceinline__ uint2 unpack_int4_8(const int8_t* wp, int stride,
                                               int c, int q, int k2) {
  unsigned word[2] = {0u, 0u};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int p = 4 * q + j;
    const int byte = p < k2 ? wp[p * stride + c] : 0;
    word[j >> 1] |= (nibble_s8(byte) | nibble_s8(byte >> 4) << 8) << (16 * (j & 1));
  }
  return make_uint2(word[0], word[1]);
}

// A warp's int8 tensor-core tile over k < kp: acc[i][j] += (rows 16i ..
// 16i + 15 of a8) x (columns 8j .. 8j + 7 of b8), both s8 and
// k-contiguous, ld bytes a row or a column.  Lane (g, tq) loads 4 bytes of
// rows g and g + 8 of A and of column g of each B (mma's fragments); its
// sums land at rows g, g + 8 and columns 2tq, 2tq + 1 of each n8 tile.
template <int kM, int kN>
__device__ __forceinline__ void mma_s8_warp_tile(const int8_t* a8,
                                                 const int8_t* b8, int ld,
                                                 int kp,
                                                 int (&acc)[kM][kN][4]) {
  const int lane = threadIdx.x & 31;
  const int at = (lane >> 2) * ld + 4 * (lane & 3);
  for (int k0 = 0; k0 < kp; k0 += kMmaK) {
    unsigned bf[kN][2];
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const int8_t* b = b8 + 8 * j * ld + at + k0;
      bf[j][0] = *reinterpret_cast<const unsigned*>(b);
      bf[j][1] = *reinterpret_cast<const unsigned*>(b + 16);
    }
#pragma unroll
    for (int i = 0; i < kM; ++i) {
      const int8_t* a = a8 + 16 * i * ld + at + k0;
      const unsigned af[4] = {
          *reinterpret_cast<const unsigned*>(a),
          *reinterpret_cast<const unsigned*>(a + 8 * ld),
          *reinterpret_cast<const unsigned*>(a + 16),
          *reinterpret_cast<const unsigned*>(a + 8 * ld + 16)};
#pragma unroll
      for (int j = 0; j < kN; ++j) mma_s8_16832(acc[i][j], af, bf[j][0], bf[j][1]);
    }
  }
}

// A lane's sums of one n8 tile, scaled once: out[row + 8h][col + e] =
// acc[2h + e] * sc[e] for rows below m and columns below n (sc[e] read
// there only); one float2 where out8 (n even, out 8-byte aligned).
__device__ __forceinline__ void store_scaled_n8(const int (&acc)[4], int row,
                                                int m, int col, int n,
                                                const float* sc,
                                                float* __restrict__ out,
                                                bool out8) {
  const float s0 = col < n ? sc[0] : 0.0f;
  const float s1 = col + 1 < n ? sc[1] : 0.0f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    if (r >= m) continue;
    const float v0 = __fmul_rn(__int2float_rn(acc[2 * h]), s0);
    const float v1 = __fmul_rn(__int2float_rn(acc[2 * h + 1]), s1);
    float* o = out + static_cast<long long>(r) * n + col;
    if (out8 && col + 1 < n) {
      *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
    } else {
      if (col < n) o[0] = v0;
      if (col + 1 < n) o[1] = v1;
    }
  }
}

// Byte offsets of one block's tiles in its dynamic shared memory:
//   raw  float [max(ts, 1)][rows][kp]  the trains as staged; t = 0 then
//                                      holds the merged rows (fp32 path)
//   a8   int8  [rows][ld]              the merged rows as s8
//   b8   int8  [cols][ld]              the unpacked weights
//   wp   int8  [k/2][cols]             the packed weight tile as staged
// kp is k rounded up to kMmaK (the pad is zero in a8 and b8), ld = kp +
// kTilePad.  The wrappers' tile_plans compute the same bytes.
struct Int4TileLayout {
  int kp, ld;
  size_t a8, b8, wp, bytes;
  __host__ __device__ Int4TileLayout(int ts, int rows, int cols, int k)
      : kp((k + kMmaK - 1) / kMmaK * kMmaK), ld(kp + kTilePad) {
    a8 = sizeof(float) * static_cast<size_t>(ts > 1 ? ts : 1) * rows * kp;
    b8 = a8 + static_cast<size_t>(rows) * ld;
    wp = b8 + static_cast<size_t>(cols) * ld;
    bytes = wp + static_cast<size_t>(k / 2) * cols;
  }
};

// n8 tiles a warp's tile spans, and threads a block, at kCols columns by
// kRowsB rows: a warp owns 16 rows by 8 * sub columns.
__host__ __device__ constexpr int int4_tile_sub(int cols) {
  return cols >= 16 ? 2 : 1;
}
__host__ __device__ constexpr int int4_tile_threads(int rows, int cols) {
  const int tiles = (rows / 16) * (cols / (8 * int4_tile_sub(cols)));
  return 32 * (tiles < 4 ? 4 : tiles > 8 ? 8 : tiles);
}

namespace {

template <int kRowsB, int kCols>
__global__ void __launch_bounds__(int4_tile_threads(kRowsB, kCols))
    int4_tile_kernel(const float* __restrict__ src,
                     const int8_t* __restrict__ packed,
                     const float* __restrict__ scale, float* __restrict__ out,
                     int ts, int m, int k, int n, bool rows16, bool w_vec,
                     bool out8) {
  constexpr int kThreads = int4_tile_threads(kRowsB, kCols);
  constexpr int kWarps = kThreads / 32;
  constexpr int kSub = int4_tile_sub(kCols);
  constexpr int kTilesN = kCols / (8 * kSub);
  constexpr int kTiles = kRowsB / 16 * kTilesN;
  constexpr int kChunk = kCols >= 16 ? 16 : kCols;  // bytes a weight copy
  extern __shared__ __align__(16) unsigned char sh[];
  const Int4TileLayout lay(ts, kRowsB, kCols, k);
  const int kp = lay.kp, ld = lay.ld, k2 = k / 2;
  const int tsa = ts > 1 ? ts : 1;
  float* raw = reinterpret_cast<float*>(sh);
  int8_t* a8 = reinterpret_cast<int8_t*>(sh + lay.a8);
  int8_t* b8 = reinterpret_cast<int8_t*>(sh + lay.b8);
  int8_t* wp = reinterpret_cast<int8_t*>(sh + lay.wp);
  const int row0 = blockIdx.y * kRowsB;
  const int c0 = blockIdx.x * kCols;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // group 0: the packed weight tile, kChunk bytes a copy (columns past n
  // zero-filled); byte loads where n is not a multiple of kChunk
  if (w_vec) {
    constexpr int kPerRow = kCols / kChunk;
    for (int i = threadIdx.x; i < k2 * kPerRow; i += kThreads) {
      const int p = i / kPerRow;
      const int c = c0 + (i % kPerRow) * kChunk;
      const bool in = c < n;
      const int8_t* s = packed + (in ? static_cast<long long>(p) * n + c : 0);
      if (kChunk == 16) {
        cp_async16(wp + i * kChunk, s, in ? 16 : 0);
      } else {
        cp_async8(wp + i * kChunk, s, in ? 8 : 0);
      }
    }
  } else {
    for (int i = threadIdx.x; i < k2 * kCols; i += kThreads) {
      const int p = i / kCols;
      const int c = c0 + i % kCols;
      wp[i] = c < n ? packed[static_cast<long long>(p) * n + c] : 0;
    }
  }
  cp_async_commit();
  // group 1: the rows' trains, a warp a row (rows past m, and every row
  // when ts = 0, zeros)
  for (int tr = warp; tr < tsa * kRowsB; tr += kWarps) {
    const int t = tr / kRowsB;
    const int row = row0 + tr % kRowsB;
    float* d = raw + static_cast<size_t>(tr) * kp;
    if (t >= ts || row >= m) {
      for (int q = lane; q < k; q += 32) d[q] = 0.0f;
      continue;
    }
    const float* s = src + (static_cast<long long>(t) * m + row) * k;
    if (rows16) {
      for (int q = 4 * lane; q < k; q += 128) cp_async16(d + q, s + q, 16);
    } else {
      for (int q = lane; q < k; q += 32) cp_async4(d + q, s + q, 4);
    }
  }
  cp_async_commit();

  // the weights land first: unpack them while the rows are in flight,
  // b8[c][8q .. 8q + 7] from packed rows 4q .. 4q + 3 of column c
  cp_async_wait_group<1>();
  __syncthreads();
  for (int i = threadIdx.x; i < kCols * (kp / 8); i += kThreads) {
    const int c = i % kCols;
    const int q = i / kCols;
    *reinterpret_cast<uint2*>(b8 + c * ld + 8 * q) = unpack_int4_8(wp, kCols, c, q, k2);
  }
  // then the rows: merge t = 0, 1, ... (zero past k), keep the float sum in
  // raw's t = 0 for the fp32 path, write the s8 copy, and vote
  cp_async_wait_group<0>();
  __syncthreads();
  bool exact = true;
  for (int r = warp; r < kRowsB; r += kWarps) {
    float* d0 = raw + r * kp;
    for (int q = 4 * lane; q < kp; q += 128) {
      float4 v = *reinterpret_cast<const float4*>(d0 + q);
      for (int t = 1; t < ts; ++t) {
        const float4 w = *reinterpret_cast<const float4*>(raw + (static_cast<size_t>(t) * kRowsB + r) * kp + q);
        v = make_float4(__fadd_rn(v.x, w.x), __fadd_rn(v.y, w.y),
                        __fadd_rn(v.z, w.z), __fadd_rn(v.w, w.w));
      }
      float e[4] = {v.x, v.y, v.z, v.w};
      unsigned word = 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (q + j >= k) e[j] = 0.0f;
        const bool ok = s8_exact(e[j]);
        exact &= ok;
        word |= static_cast<unsigned>((ok ? static_cast<int>(e[j]) : 0) & 0xFF) << (8 * j);
      }
      *reinterpret_cast<float4*>(d0 + q) = make_float4(e[0], e[1], e[2], e[3]);
      *reinterpret_cast<unsigned*>(a8 + r * ld + q) = word;
    }
  }
  const bool s8 = __syncthreads_and(exact);

  if (s8) {
    // warp tile: 16 rows by kSub n8 tiles (mma_s8_warp_tile); four lanes
    // write 32 contiguous bytes of a row
    const int g = lane >> 2;
    const int tq = lane & 3;
    for (int tile = warp; tile < kTiles; tile += kWarps) {
      const int mt = tile / kTilesN;
      const int nt = tile % kTilesN;
      int acc[1][kSub][4] = {};
      mma_s8_warp_tile<1, kSub>(a8 + 16 * mt * ld, b8 + 8 * kSub * nt * ld,
                                ld, kp, acc);
#pragma unroll
      for (int s = 0; s < kSub; ++s) {
        const int col = c0 + 8 * (kSub * nt + s) + 2 * tq;
        store_scaled_n8(acc[0][s], row0 + 16 * mt + g, m, col, n, scale + col,
                        out, out8);
      }
    }
  } else {
    // fp32 path: a thread an output, k ascending, over the merged floats
    for (int i = threadIdx.x; i < kRowsB * kCols; i += kThreads) {
      const int r = i / kCols;
      const int c = i % kCols;
      const int row = row0 + r;
      const int col = c0 + c;
      if (row >= m || col >= n) continue;
      const float* x = raw + r * kp;
      const int8_t* w = b8 + c * ld;
      float acc = 0.0f;
      for (int kk = 0; kk < k; ++kk) acc = fmaf(x[kk], static_cast<float>(w[kk]), acc);
      out[static_cast<long long>(row) * n + col] = __fmul_rn(acc, scale[col]);
    }
  }
}

using Int4TileKernel = void (*)(const float*, const int8_t*, const float*,
                                float*, int, int, int, int, bool, bool, bool);

template <int kRowsB>
Int4TileKernel int4_tile_kernel_for_cols(int cols) {
  switch (cols) {
    case 8: return int4_tile_kernel<kRowsB, 8>;
    case 16: return int4_tile_kernel<kRowsB, 16>;
    case 32: return int4_tile_kernel<kRowsB, 32>;
    case 64: return int4_tile_kernel<kRowsB, 64>;
    case 128: return int4_tile_kernel<kRowsB, 128>;
    default: return nullptr;
  }
}

inline bool aligned_to(const void* p, unsigned bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1u)) == 0;
}

// Launch int4_tile_kernel on the plan (rows, cols): rows 16, 32 or 64 and
// cols 8, 16, 32, 64 or 128 a block, else kErrTilePlan; a block's tiles
// over kMaxOptInSharedBytes, kErrSharedMemory.  src is (ts, m, k) float32
// (K2: ts = 1), packed (k/2, n) int8 (k even), scale (n,), out (m, n).
inline int launch_int4_tiles(const void* src, const void* packed,
                             const void* scale, void* out, int ts, int m,
                             int k, int n, int rows, int cols,
                             void* stream) {
  Int4TileKernel kernel = rows == 16   ? int4_tile_kernel_for_cols<16>(cols)
                          : rows == 32 ? int4_tile_kernel_for_cols<32>(cols)
                          : rows == 64 ? int4_tile_kernel_for_cols<64>(cols)
                                       : nullptr;
  if (kernel == nullptr) return kErrTilePlan;
  const Int4TileLayout lay(ts, rows, cols, k);
  if (lay.bytes > kMaxOptInSharedBytes) return kErrSharedMemory;
  const int opt = opt_in_shared(kernel, lay.bytes);
  if (opt != 0) return opt;
  const unsigned chunk = cols >= 16 ? 16u : static_cast<unsigned>(cols);
  const bool rows16 = k % 4 == 0 && aligned_to(src, 16);
  const bool w_vec = n % chunk == 0 && aligned_to(packed, chunk);
  const bool out8 = n % 2 == 0 && aligned_to(out, 8);
  const dim3 grid((n + cols - 1) / cols, (m + rows - 1) / rows);
  kernel<<<grid, int4_tile_threads(rows, cols), lay.bytes,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<const int8_t*>(packed),
      static_cast<const float*>(scale), static_cast<float*>(out), ts, m, k, n,
      rows16, w_vec, out8);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

}  // namespace reprotorch
