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
// output at B = 256: 1.1 us.
//
// Design: a block owns 32 x kRt batch rows by cols output columns (the
// tile plan, chosen by the wrapper from (ts, B, H, nnz_max, N)).  It starts
// a cp.async copy of its columns' index and value tiles (nnz_max x cols
// each) into opted-in shared memory and, while that is in flight, stages
// its rows' merged spikes transposed, m[h][rows + 1] (read coalesced along
// h, each warp's loads of four rows issued before their adds; the pad of
// one column keeps the transposed writes conflict-free).  One pass then
// turns each staged index into its offset in m (an index outside [0, H)
// into offset 0 with value 0).  Each warp takes four columns at a time:
// lane l owns rows l, l + 32, ..., so an entry's (offset, value) quad is
// one shared broadcast for the whole warp, and the warp's gathers
// m[index][l + 32 t] are 32 adjacent words, free of bank conflicts; four
// entries' loads go ahead of their multiply-adds, with no branch between
// them.  Entries run in ascending order, each an fmaf into a float sum
// that stays an exact integer (padding adds exact zeros), then one
// __fmul_rn by the scale.  What holds it now: shared-memory bandwidth, one
// 4-byte gather a multiply-add (padding included), and the restaging of
// the CSC tile once per row tile and of the merged rows once per column
// tile.  The launch refuses a plan whose tiles do not fit 227 KB
// (kErrSharedMemory) or that it does not take (kErrTilePlan).  Rows and
// columns past the edge are masked, with no divisibility rule.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

template <int kRt>
__global__ void sparse_fc_kernel(const float* __restrict__ spikes,
                                 const int* __restrict__ indices,
                                 const float* __restrict__ values,
                                 const float* __restrict__ scale,
                                 float* __restrict__ out, int ts, int b,
                                 int h, int nnz, int n, int cols, bool csc16,
                                 bool out16) {
  constexpr int kRowsB = 32 * kRt;
  constexpr int kLd = kRowsB + 1;
  extern __shared__ __align__(16) float sh[];
  int* idx_sh = reinterpret_cast<int*>(sh);  // [nnz][cols]
  float* val_sh = sh + nnz * cols;           // [nnz][cols]
  float* m_sh = val_sh + nnz * cols;         // [h][kLd], merged, transposed
  const int c0 = blockIdx.x * cols;
  const int row0 = blockIdx.y * kRowsB;

  reprotorch::stage_column_tile(indices, nnz, n, c0, cols, csc16, idx_sh);
  reprotorch::stage_column_tile(values, nnz, n, c0, cols, csc16, val_sh);
  // merged rows: warp w takes rows 4w..4w+3, 4w+32.., lanes run along h;
  // the loads of four rows, four 32-column chunks and two trains go ahead
  // of their adds (t = 0, 1, ..., as stage_merged_rows)
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int r0 = 4 * warp; r0 < kRowsB; r0 += 4 * kWarps) {
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
  reprotorch::cp_async_wait_all();
  __syncthreads();
  // each index becomes its gather offset in m_sh; one outside [0, h)
  // becomes (offset 0, value 0), whose product adds an exact zero, as a
  // padded entry's does
  for (int i = threadIdx.x; i < nnz * cols; i += kThreads) {
    const int at = idx_sh[i];
    const bool in = static_cast<unsigned>(at) < static_cast<unsigned>(h);
    idx_sh[i] = in ? at * kLd : 0;
    if (!in) val_sh[i] = 0.0f;
  }
  __syncthreads();

  const int quads = cols >> 2;
  const float* m_lane = m_sh + lane;
  for (int q = warp; q < quads; q += kWarps) {
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
    for (; e + 4 <= nnz; e += 4) {
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
    for (; e < nnz; ++e) {
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

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" int sparse_fc_launch(const void* spikes, const void* indices,
                                const void* values, const void* scale,
                                void* out, int ts, int b, int h, int nnz,
                                int n, int rows_b, int cols, void* stream) {
  if ((rows_b != 32 && rows_b != 64) || cols < 32 || cols % 32 != 0) {
    return reprotorch::kErrTilePlan;
  }
  const size_t smem =
      2 * sizeof(float) * static_cast<size_t>(nnz) * cols +
      sizeof(float) * static_cast<size_t>(h) * (rows_b + 1);
  if (smem > reprotorch::kMaxOptInSharedBytes) {
    return reprotorch::kErrSharedMemory;
  }
  void (*kernel)(const float*, const int*, const float*, const float*, float*,
                 int, int, int, int, int, int, bool, bool) =
      rows_b == 32 ? sparse_fc_kernel<1> : sparse_fc_kernel<2>;
  if (smem > reprotorch::kMaxSharedBytes) {  // opt in beyond 48 KB
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const bool csc16 = n % 4 == 0 && aligned16(indices) && aligned16(values);
  const bool out16 = n % 4 == 0 && aligned16(out);
  const dim3 grid((n + cols - 1) / cols, (b + rows_b - 1) / rows_b);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(spikes), static_cast<const int*>(indices),
      static_cast<const float*>(values), static_cast<const float*>(scale),
      static_cast<float*>(out), ts, b, h, nnz, n, cols, csc16, out16);
  return static_cast<int>(cudaGetLastError());
}
