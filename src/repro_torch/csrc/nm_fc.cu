// K5: zero-skip FC readout over the group-packed N:M layout (merged-spike
// input).
//
// Replaces the TPU kernel src/repro/kernels/nm_fc.py `nm_fc`
// (pl.pallas_call at line 77, body `_nm_fc_kernel`).
//
//   merged    = sum_t spikes[t]                                     (B, H)
//   row(e, c) = (e / nm_n) * nm_m + ((packed[e][c] >> 4) & 0xF)
//   out[b][c] = (sum_e merged[b][row(e, c)] * nibble(packed[e][c])) * scale[c]
//
// Shapes: spikes (TS, B, H) float32, packed (E, N) int8 (value in the low
// nibble, in-group row offset in the high nibble, E = ceil(K / m) * n),
// scale (N,) float32; out (B, N) float32.  Pad slots are (offset 0, value 0)
// and add nothing; a decoded row outside [0, H) is skipped, so the gather
// never leaves the row (the engine validates the rows when it loads an
// artifact).  Products are integers in [-16, 14] and sums stay below 2^24:
// bit-equal to the plain version, and to K4 over the same mask stored as
// padded CSC (both sum the same terms in ascending row order).
//
// Bound on the H100 at B = 256, TS = 2, H = 128, N = 1920, 2:4 (E = 64):
// bytes — 262,144 B of spikes, 122,880 B packed, 7,680 B scale and the
// 1,966,080 B of logits, 2.36 MB over 3.35 TB/s: 0.704 us.  Its 62.9 M
// integer multiply-adds are exact on the int8 tensor cores (1,979 TOP/s):
// 0.03 us.  Bytes bound it.
//
// Design: K4's.  The merged spikes of kRows rows sit in shared memory; each
// thread walks one output column's E bytes (coalesced across columns),
// decodes value and offset from the one byte, and gathers from shared
// memory for kRows rows: one byte load per entry where K4 loads an index
// and a value.  The group of entry e advances by a counter, not a division.
#include "common.cuh"

namespace {

using reprotorch::kCols;
using reprotorch::kRows;

__global__ void nm_fc_kernel(const float* __restrict__ spikes,
                             const int8_t* __restrict__ packed,
                             const float* __restrict__ scale,
                             float* __restrict__ out, int ts, int b, int h,
                             int entries, int n, int nm_n, int nm_m) {
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
  int group_row = 0;  // (e / nm_n) * nm_m
  int slot = 0;       // e % nm_n
  for (int e = 0; e < entries; ++e) {
    const int byte = packed[static_cast<long long>(e) * n + col];
    const int row = group_row + ((byte >> 4) & 0xF);
    if (++slot == nm_n) {
      slot = 0;
      group_row += nm_m;
    }
    if (row >= h) continue;
    const float v = reprotorch::nibble(byte);
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

extern "C" int nm_fc_launch(const void* spikes, const void* packed,
                            const void* scale, void* out, int ts, int b,
                            int h, int entries, int n, int nm_n, int nm_m,
                            void* stream) {
  if (nm_n < 1 || nm_n > nm_m || nm_m > 16 || entries % nm_n != 0) {
    return reprotorch::kErrNmGeometry;
  }
  const dim3 grid((n + kCols - 1) / kCols, (b + kRows - 1) / kRows);
  const size_t smem = sizeof(float) * static_cast<size_t>(b < kRows ? b : kRows) * h;
  if (smem > reprotorch::kMaxSharedBytes) return reprotorch::kErrSharedMemory;
  nm_fc_kernel<<<grid, kCols, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(spikes), static_cast<const int8_t*>(packed),
      static_cast<const float*>(scale), static_cast<float*>(out), ts, b, h,
      entries, n, nm_n, nm_m);
  return static_cast<int>(cudaGetLastError());
}
